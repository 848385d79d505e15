"""The port's stdlib telemetry modules (``tpufw_torch.obs.goodput``,
``health`` and ``promtext``) against ``tpufw``'s, case for case.

The first three sections are ``tests/test_goodput.py``,
``test_health.py`` and ``test_promtext.py`` run on the port's modules
(the crash bundle's env snapshot keeps the CUDA switches in place of the
JAX ones). The last feeds both packages the same spans, events, stalls
and samples and compares what they write byte for byte: the goodput
rollup and ``goodput.json`` (under one fake clock), the crash bundle's
manifest and files, a hang dump's recent events, and the exposition
parsed and re-rendered.
"""

import json
import math
import os
import signal
import sys
import threading
import time

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.obs import events as events_mod
from tpufw_torch.obs import goodput as goodput_mod
from tpufw_torch.obs import promtext
from tpufw_torch.obs import trace as trace_mod
from tpufw_torch.obs.goodput import GoodputLedger
from tpufw_torch.obs.health import (
    FlightRecorder,
    HangWatchdog,
    NullHangWatchdog,
    env_snapshot,
    format_thread_stacks,
)
from tpufw_torch.obs.registry import Registry

# ================================================== goodput (test_goodput.py)


def test_span_listener_maps_to_categories(tmp_path):
    """Spans completed on a real Tracer land in the ledger via the
    listener hook, through the TRAIN name->category table."""
    ledger = GoodputLedger()
    tracer = trace_mod.Tracer(str(tmp_path / "trace.json"))
    tracer.listeners.append(ledger.on_span)
    with tracer.span("tune"):
        time.sleep(0.01)
    with tracer.span("step_dispatch"):
        time.sleep(0.01)
    with tracer.span("host_sync"):
        pass
    with tracer.span("not_a_loop_span"):  # unmapped: ignored
        pass
    tracer.close()
    roll = ledger.rollup()
    cats = roll["categories"]
    assert cats["compile"] > 0
    assert cats["productive"] > 0
    assert "not_a_loop_span" not in cats
    assert roll["goodput_ratio"] > 0


def test_rollup_categories_sum_to_wall_exactly():
    """idle absorbs the unattributed remainder, so the categories sum
    to wall_s by construction — the invariant the CI smoke's 2% check
    rides on."""
    ledger = GoodputLedger()
    time.sleep(0.03)  # attribution must stay below real elapsed wall
    ledger.add("productive", 0.01)
    ledger.add("checkpoint", 0.005)
    roll = ledger.rollup()
    # abs tolerance: rollup rounds each category to 6 decimals.
    assert sum(roll["categories"].values()) == (
        pytest.approx(roll["wall_s"], abs=1e-4)
    )
    assert roll["categories"]["idle"] > 0


def test_over_attribution_floors_idle_at_zero():
    ledger = GoodputLedger()
    ledger.add("productive", 1e6)  # absurd: more than wall
    roll = ledger.rollup()
    assert roll["categories"]["idle"] == 0.0


def test_replay_reclassifies_productive_until_high_water(tmp_path):
    """A restart that resumes behind the previous run's max step books
    productive time as replay until it passes the high-water mark."""
    prior = tmp_path / "events.jsonl"
    log = events_mod.EventLog(str(prior))
    for s in (1, 2, 3, 10):
        log.emit("step", step=s, loss=1.0, step_time_s=0.1, data_wait_s=0.0)
    log.close()
    ledger = GoodputLedger(prior_events_path=str(prior))
    # Resumed from the step-4 checkpoint: everything to step 10 is
    # re-paid work.
    ledger.on_event({"kind": "run_start", "start_step": 4})
    ledger.on_span("step_dispatch", 0.5)
    ledger.on_event(
        {"kind": "step", "step": 9, "loss": 1.0}
    )
    ledger.on_span("step_dispatch", 0.5)  # still behind: replay
    ledger.on_event({"kind": "step", "step": 10, "loss": 1.0})
    ledger.on_span("step_dispatch", 0.25)  # caught up: productive
    roll = ledger.rollup()
    assert roll["categories"]["replay"] == 1.0
    assert roll["categories"]["productive"] == 0.25
    assert roll["replay_until_step"] == 10


def test_fresh_run_in_reused_dir_replays_nothing(tmp_path):
    """start_step == 0 means a NEW run reusing the telemetry dir, not
    a restart — its steps are first-time work even though an older
    run's events show a higher step."""
    prior = tmp_path / "events.jsonl"
    log = events_mod.EventLog(str(prior))
    log.emit("step", step=50, loss=1.0, step_time_s=0.1, data_wait_s=0.0)
    log.close()
    ledger = GoodputLedger(prior_events_path=str(prior))
    ledger.on_event({"kind": "run_start", "start_step": 0})
    ledger.on_span("step_dispatch", 0.5)
    assert ledger.rollup()["categories"]["productive"] == 0.5
    assert ledger.rollup()["replay_until_step"] == 0


def test_graceful_resume_at_high_water_replays_nothing(tmp_path):
    prior = tmp_path / "events.jsonl"
    log = events_mod.EventLog(str(prior))
    log.emit("step", step=7, loss=1.0, step_time_s=0.1, data_wait_s=0.0)
    log.close()
    ledger = GoodputLedger(prior_events_path=str(prior))
    # Preemption checkpointed at the stop step: resume == high water.
    ledger.on_event({"kind": "run_start", "start_step": 7})
    ledger.on_span("step_dispatch", 0.5)
    assert ledger.rollup()["categories"]["productive"] == 0.5


def test_torn_prior_events_file_tolerated(tmp_path):
    prior = tmp_path / "events.jsonl"
    prior.write_text(
        '{"kind": "step", "step": 5, "loss": 1.0}\n{"kind": "st'
    )
    ledger = GoodputLedger(prior_events_path=str(prior))
    assert ledger._prior_max == 5  # the parseable line still counts
    ledger2 = GoodputLedger(
        prior_events_path=str(tmp_path / "does-not-exist.jsonl")
    )
    assert ledger2._prior_max == 0


def test_publish_sets_gauge_and_badput_counters():
    reg = Registry()
    ledger = GoodputLedger(registry=reg)
    ledger.add("productive", 3.0)
    ledger.add("checkpoint", 1.0)
    ledger.publish()
    text = reg.render()
    assert "tpufw_goodput_ratio " in text
    assert 'tpufw_badput_seconds_total{category="checkpoint"} 1' in text
    # Productive categories are goodput, not badput.
    assert 'category="productive"' not in text


def test_publish_deltas_never_decrease_counters():
    """Counters only move forward: idle shrinks retroactively when a
    long span closes, so its per-publish delta clamps at 0."""
    reg = Registry()
    ledger = GoodputLedger(registry=reg)
    time.sleep(0.05)
    ledger.publish()  # everything so far is idle
    idle1 = reg.counter("tpufw_badput_seconds_total").value(category="idle")
    assert idle1 > 0
    # A span covering (more than) the whole run closes: idle collapses.
    ledger.add("productive", 10.0)
    ledger.publish()
    idle2 = reg.counter("tpufw_badput_seconds_total").value(category="idle")
    assert idle2 == idle1  # clamped, not decremented


def test_close_writes_rollup_and_emits_schema_valid_event(tmp_path):
    out = tmp_path / "goodput.json"
    elog_path = str(tmp_path / "events.jsonl")
    log = events_mod.EventLog(elog_path)
    ledger = GoodputLedger(events=log, out_path=str(out))
    time.sleep(0.02)  # keep attribution below real elapsed wall
    ledger.add("productive", 0.01)
    roll = ledger.close()
    log.close()
    doc = json.loads(out.read_text())
    assert doc["categories"] == roll["categories"]
    assert sum(doc["categories"].values()) == (
        pytest.approx(doc["wall_s"], abs=1e-4)
    )
    events = events_mod.read_events(elog_path)
    assert [e["kind"] for e in events] == ["goodput"]
    events_mod.validate(events[0])
    assert events[0]["goodput_ratio"] == roll["goodput_ratio"]
    # Idempotent: a second close neither re-emits nor re-books.
    ledger.close()
    ledger.add("productive", 99.0)
    assert ledger.rollup()["categories"].get("productive") == 0.01


def test_serve_tables_split_busy_from_wasted():
    ledger = GoodputLedger(
        span_categories=goodput_mod.SERVE_SPAN_CATEGORIES,
        productive=goodput_mod.SERVE_PRODUCTIVE,
    )
    ledger.on_span("serve_prefill", 0.2)
    ledger.on_span("serve_admit", 5.0)  # unmapped: would double-count
    ledger.add("busy", 0.3)
    ledger.add("wasted_slot", 0.1)
    cats = ledger.rollup()["categories"]
    assert cats["busy"] == pytest.approx(0.5)
    assert cats["wasted_slot"] == pytest.approx(0.1)


def test_ledger_threadsafe_under_concurrent_attribution():
    ledger = GoodputLedger()

    def work():
        for _ in range(500):
            ledger.add("productive", 0.001)
            ledger.on_event({"kind": "step", "step": 1, "loss": 1.0})

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ledger.rollup()["categories"]["productive"] == pytest.approx(
        2.0, rel=1e-6
    )


# ==================================================== health (test_health.py)


def _wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------- watchdog


def test_watchdog_fires_once_per_stall_with_dump_and_event(tmp_path):
    log = events_mod.EventLog(str(tmp_path / "events.jsonl"))
    recorder = FlightRecorder(str(tmp_path))
    log.listeners.append(recorder.on_event)
    wd = HangWatchdog(
        0.1, str(tmp_path), tracer=trace_mod.Tracer(
            str(tmp_path / "trace.json")
        ), events=log, recorder=recorder,
    )
    try:
        wd.arm()
        assert _wait_until(lambda: wd.fired == 1)
        # One dump per stall: stays disarmed until the next arm().
        time.sleep(0.25)
        assert wd.fired == 1
    finally:
        wd.stop()
        log.close()
    dump_path = tmp_path / "hang-p0-1.json"
    doc = json.loads(dump_path.read_text())
    assert doc["timeout_s"] == 0.1
    assert doc["armed_for_s"] >= 0.1
    # The dump names every thread, including the watchdog itself.
    assert "tpufw-watchdog" in doc["stacks"]
    events = events_mod.read_events(str(tmp_path / "events.jsonl"))
    hangs = [e for e in events if e["kind"] == "hang"]
    assert len(hangs) == 1
    events_mod.validate(hangs[0])
    assert hangs[0]["level"] == "error"
    assert hangs[0]["dump"] == str(dump_path)
    # The hang event itself reached the recorder's ring via the
    # listener — the bundle would carry its own diagnosis.
    assert any(e["kind"] == "hang" for e in recorder.ring_tail())


def test_watchdog_beat_suppresses_slow_but_progressing_step(tmp_path):
    """The false-positive criterion: a phase that is slower than the
    timeout in TOTAL but heartbeats within it must never fire."""
    wd = HangWatchdog(0.15, str(tmp_path))
    try:
        wd.arm()
        for _ in range(6):  # 0.3s total: 2x the timeout, but alive
            time.sleep(0.05)
            wd.beat()
        wd.disarm()
        time.sleep(0.2)
        assert wd.fired == 0
    finally:
        wd.stop()
    assert not list(tmp_path.glob("hang-*.json"))


def test_watchdog_disarm_prevents_firing(tmp_path):
    wd = HangWatchdog(0.1, str(tmp_path))
    try:
        wd.arm()
        wd.disarm()
        time.sleep(0.25)
        assert wd.fired == 0
    finally:
        wd.stop()


def test_watchdog_rearm_after_fire_reprotects(tmp_path):
    wd = HangWatchdog(0.08, str(tmp_path))
    try:
        wd.arm()
        assert _wait_until(lambda: wd.fired == 1)
        wd.arm()  # recovery: the next stall must dump again
        assert _wait_until(lambda: wd.fired == 2)
    finally:
        wd.stop()
    assert (tmp_path / "hang-p0-1.json").exists()
    assert (tmp_path / "hang-p0-2.json").exists()


def test_watchdog_beat_while_disarmed_is_noop(tmp_path):
    wd = HangWatchdog(0.05, str(tmp_path))
    try:
        wd.beat()  # must NOT arm
        time.sleep(0.15)
        assert wd.fired == 0
    finally:
        wd.stop()


def test_watchdog_rejects_nonpositive_timeout(tmp_path):
    with pytest.raises(ValueError):
        HangWatchdog(0.0, str(tmp_path))
    null = NullHangWatchdog()
    null.arm()
    null.beat()
    null.disarm()
    null.stop()
    assert null.fired == 0 and not null.enabled


# ---------------------------------------------------------------- recorder


def test_recorder_ring_is_bounded():
    rec = FlightRecorder("/tmp/unused", ring_size=4)
    for i in range(10):
        rec.on_event({"kind": "step", "step": i})
    tail = rec.ring_tail()
    assert [e["step"] for e in tail] == [6, 7, 8, 9]
    assert [e["step"] for e in rec.ring_tail(2)] == [8, 9]


def test_flush_writes_complete_bundle_manifest_last(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFW_HANG_TIMEOUT_S", "7")
    reg = Registry()
    reg.counter("tpufw_train_steps_total").inc(3)
    rec = FlightRecorder(str(tmp_path), ring_size=8, registry=reg)
    rec.on_event({"kind": "step", "step": 1})
    rec.record_config({"trainer": {"batch_size": 8}})
    bundle = rec.flush("test")
    assert bundle == str(tmp_path / "crash-bundle-p0")
    manifest = json.loads(
        (tmp_path / "crash-bundle-p0" / "manifest.json").read_text()
    )
    assert manifest["reasons"] == ["test"]
    assert manifest["pid"] == os.getpid()
    for name in ("ring.jsonl", "stacks.txt", "config.json", "env.json",
                 "metrics.prom"):
        assert name in manifest["files"]
        assert (tmp_path / "crash-bundle-p0" / name).exists()
    ring = events_mod.read_events(
        str(tmp_path / "crash-bundle-p0" / "ring.jsonl")
    )
    assert [e["step"] for e in ring] == [1]
    config = json.loads(
        (tmp_path / "crash-bundle-p0" / "config.json").read_text()
    )
    assert config["trainer"]["batch_size"] == 8
    env = json.loads(
        (tmp_path / "crash-bundle-p0" / "env.json").read_text()
    )
    assert env["TPUFW_HANG_TIMEOUT_S"] == "7"
    prom = (tmp_path / "crash-bundle-p0" / "metrics.prom").read_text()
    assert "tpufw_train_steps_total 3" in prom
    # A second trigger rewrites in place and appends the reason.
    rec.flush("again")
    manifest = json.loads(
        (tmp_path / "crash-bundle-p0" / "manifest.json").read_text()
    )
    assert manifest["reasons"] == ["test", "again"]


def test_excepthook_flushes_bundle_and_chains(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    seen = {}
    orig = sys.excepthook

    def stub(*a):
        seen.setdefault("args", a)

    sys.excepthook = stub
    try:
        rec.install()
        try:
            raise RuntimeError("boom for the recorder")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert seen["args"][0] is RuntimeError  # chained to ours
    finally:
        rec.uninstall()
        assert sys.excepthook is stub  # uninstall restored the chain
        sys.excepthook = orig
    exc = (tmp_path / "crash-bundle-p0" / "exception.txt").read_text()
    assert "boom for the recorder" in exc
    manifest = json.loads(
        (tmp_path / "crash-bundle-p0" / "manifest.json").read_text()
    )
    assert manifest["reasons"] == ["exception"]
    assert "exception.txt" in manifest["files"]


def test_sigterm_handler_flushes_then_chains_to_callable(tmp_path):
    """Trainer policy: GracefulShutdown installed a callable before the
    recorder's slot was taken over — the handler must flush the bundle
    AND hand the signal on (the grace-window checkpoint depends on it),
    never terminate."""
    rec = FlightRecorder(str(tmp_path), terminate_on_sigterm=False)
    chained = []
    rec._prev_sigterm = lambda signum, frame: chained.append(signum)
    rec._on_sigterm(signal.SIGTERM, None)
    assert chained == [signal.SIGTERM]
    manifest = json.loads(
        (tmp_path / "crash-bundle-p0" / "manifest.json").read_text()
    )
    assert manifest["reasons"] == ["sigterm"]


def test_sigterm_handler_without_terminate_policy_survives(tmp_path):
    """With no prior handler and terminate_on_sigterm=False the flush
    happens and the process lives — the caller owns the exit."""
    rec = FlightRecorder(str(tmp_path), terminate_on_sigterm=False)
    rec._prev_sigterm = signal.SIG_DFL
    rec._on_sigterm(signal.SIGTERM, None)  # must not os.kill us
    assert (tmp_path / "crash-bundle-p0" / "manifest.json").exists()


def test_install_uninstall_restores_sigterm_disposition(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    rec = FlightRecorder(str(tmp_path))
    rec.install()
    try:
        # == not is: a bound-method attribute access builds a fresh
        # object each time (the very bug this test regression-guards).
        assert signal.getsignal(signal.SIGTERM) == rec._on_sigterm
    finally:
        rec.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    # Clean uninstall leaves no empty fault log behind.
    assert not list(tmp_path.glob("fault-*.log"))


def test_format_thread_stacks_names_threads_and_open_spans(tmp_path):
    tracer = trace_mod.Tracer(str(tmp_path / "trace.json"))
    with tracer.span("step_dispatch"):
        text = format_thread_stacks(tracer)
        assert "MainThread" in text
        assert "step_dispatch" in text  # open span attributed
    tracer.close()


def test_env_snapshot_filters_to_relevant_keys(monkeypatch):
    monkeypatch.setenv("TPUFW_MODEL", "llama3_tiny")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("HOME_UNRELATED_SECRET", "nope")
    snap = env_snapshot()
    assert snap["TPUFW_MODEL"] == "llama3_tiny"
    assert snap["CUDA_VISIBLE_DEVICES"] == "0"
    assert "HOME_UNRELATED_SECRET" not in snap


def test_hang_dump_attaches_recorder_ring(tmp_path):
    rec = FlightRecorder(str(tmp_path), ring_size=4)
    for i in range(6):
        rec.on_event({"kind": "step", "step": i})
    wd = HangWatchdog(0.05, str(tmp_path), recorder=rec)
    try:
        wd.arm()
        assert _wait_until(lambda: wd.fired == 1)
    finally:
        wd.stop()
    doc = json.loads((tmp_path / "hang-p0-1.json").read_text())
    assert [e["step"] for e in doc["recent_events"]] == [2, 3, 4, 5]


# ================================================ promtext (test_promtext.py)


def _full_registry() -> Registry:
    r = Registry()
    c = r.counter("tpufw_t_requests_total", "requests in")
    c.inc(5)
    c.inc(2, tenant="alpha")
    c.inc(1, tenant="beta", route="x")
    r.counter("tpufw_t_zero_total", "pre-registered, never inc'd")
    g = r.gauge("tpufw_t_depth", "queue depth")
    g.set(3.5)
    g.set(0, tenant="alpha")
    h = r.histogram("tpufw_t_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    h.observe(0.05)
    h.observe(5.0)
    h.observe(0.5, tenant="alpha")
    return r


# ---------------------------------------------------- the round trip


def test_round_trip_is_byte_exact():
    text = _full_registry().render()
    assert promtext.render(promtext.parse(text)) == text


def test_round_trip_survives_escaping_hostile_content():
    r = Registry()
    c = r.counter("tpufw_t_total", 'help with "quotes", \\backslash\\\nand a newline')
    c.inc(1, path='C:\\dir\\"file"\nline2')
    text = r.render()
    assert promtext.render(promtext.parse(text)) == text
    # And the parsed label value is the original unescaped string.
    fams = promtext.parse(text)
    sample = next(s for f in fams for s in f.samples if s.labels)
    assert sample.labels_dict()["path"] == 'C:\\dir\\"file"\nline2'
    assert fams[0].help == 'help with "quotes", \\backslash\\\nand a newline'


def test_round_trip_preserves_float_value_text():
    # Values like 0.1 must re-render with the registry's repr-based
    # formatting, not drift through float round-tripping.
    r = Registry()
    r.gauge("tpufw_t_g", "g").set(0.1)
    r.counter("tpufw_t_c_total", "c").inc(10**15 + 1)
    text = r.render()
    assert "0.1" in text and str(10**15 + 1) in text
    assert promtext.render(promtext.parse(text)) == text


def test_histogram_family_owns_its_suffix_samples():
    text = _full_registry().render()
    fams = {f.name: f for f in promtext.parse(text)}
    hist = fams["tpufw_t_seconds"]
    assert hist.kind == "histogram"
    names = {s.name for s in hist.samples}
    assert names == {
        "tpufw_t_seconds_bucket",
        "tpufw_t_seconds_sum",
        "tpufw_t_seconds_count",
    }
    # Cumulative buckets end at +Inf and agree with _count.
    inf = [
        s for s in hist.samples
        if s.name.endswith("_bucket")
        and s.labels_dict().get("le") == "+Inf"
        and "tenant" not in s.labels_dict()
    ]
    count = next(
        s for s in hist.samples
        if s.name.endswith("_count") and not s.labels
    )
    assert inf[0].value == count.value == 2


# ---------------------------------------------------------- flatten


def test_flatten_keys_are_canonical_and_buckets_drop():
    flat = promtext.flatten(_full_registry().render())
    assert flat["tpufw_t_requests_total"] == 5
    assert flat['tpufw_t_requests_total{tenant="alpha"}'] == 2
    # Multi-label key is sorted regardless of inc() kwarg order.
    assert flat['tpufw_t_requests_total{route="x",tenant="beta"}'] == 1
    assert flat["tpufw_t_zero_total"] == 0
    assert flat["tpufw_t_seconds_sum"] == 5.05
    assert flat["tpufw_t_seconds_count"] == 2
    assert not any("_bucket" in k for k in flat)


def test_sample_key_parse_sample_key_invert():
    key = promtext.sample_key(
        "tpufw_x", {"b": 'v"2', "a": "v\\1"}
    )
    name, labels = promtext.parse_sample_key(key)
    assert name == "tpufw_x"
    assert labels == {"a": "v\\1", "b": 'v"2'}
    assert promtext.parse_sample_key("bare") == ("bare", {})


# --------------------------------------------------------- tolerance


def test_torn_and_malformed_lines_drop_not_raise():
    text = (
        "# HELP tpufw_ok help\n"
        "# TYPE tpufw_ok counter\n"
        "tpufw_ok 1\n"
        "tpufw_torn{label=\"unterminated\n"  # torn mid-label
        "tpufw_no_value\n"  # no value token
        "tpufw_bad_value not_a_float\n"
        "{\"json\": \"line\"}\n"  # foreign content
        "# EOF\n"  # OpenMetrics terminator: unknown comment
        "tpufw_ok2 2 1700000000\n"  # timestamped sample
        "tpufw_ok3 3 17 extra\n"  # >2 trailing tokens
    )
    flat = promtext.flatten(text)
    assert flat == {"tpufw_ok": 1.0, "tpufw_ok2": 2.0}


def test_untyped_samples_get_own_families():
    fams = promtext.parse("a_total 1\nb_total 2\na_total{x=\"1\"} 3\n")
    assert [f.name for f in fams] == ["a_total", "b_total", "a_total"]
    assert all(f.kind == "" and f.help is None for f in fams)


def test_non_finite_values_parse_and_render():
    text = "a NaN\nb +Inf\nc -Inf\n"
    fams = promtext.parse(text)
    values = {f.name: f.samples[0].value for f in fams}
    assert math.isnan(values["a"])
    assert values["b"] == float("inf")
    assert values["c"] == float("-inf")
    assert promtext.render(fams) == text


def test_empty_document():
    assert promtext.parse("") == []
    assert promtext.render([]) == ""
    assert promtext.flatten("") == {}


# ============================================= the port against tpufw


class _Clock:
    """One fake clock for both ledgers: monotonic and wall time move
    only when told, so two rollups of the same feed are byte-equal."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _fed_ledger(mod, events_mod_, tmp, registry, clock, monkeypatch):
    """A ledger of ``mod`` under ``clock``, fed one restart's worth of
    spans, events and direct attribution; closed into ``tmp``."""
    monkeypatch.setattr(mod, "time", clock)
    prior = os.path.join(tmp, "events.jsonl")
    log = events_mod_.EventLog(prior)
    for s in (1, 2, 9):
        log.emit("step", step=s, loss=1.0, step_time_s=0.1, data_wait_s=0.0)
    log.close()
    ledger = mod.GoodputLedger(
        registry=registry, out_path=os.path.join(tmp, "goodput.json"),
        prior_events_path=prior)
    ledger.on_event({"kind": "run_start", "start_step": 3})
    clock.t += 0.75
    ledger.on_span("data_fetch", 0.125)
    ledger.on_span("step_dispatch", 0.25)
    ledger.on_event({"kind": "step", "step": 9})
    ledger.on_span("host_sync", 0.0625)
    ledger.on_span("checkpoint_wait", 0.03125)
    ledger.add("eval", 0.0078125)
    ledger.publish()
    clock.t += 0.5
    return ledger.close(extra={"mfu": 0.25})


def test_goodput_rollup_file_and_series_equal_tpufw(tmp_path, monkeypatch):
    from tpufw.obs import events as j_events
    from tpufw.obs import goodput as j_goodput
    from tpufw.obs.registry import Registry as JRegistry

    mine_dir, theirs_dir = tmp_path / "port", tmp_path / "tpufw"
    mine_dir.mkdir()
    theirs_dir.mkdir()
    mine_reg, theirs_reg = Registry(), JRegistry()
    mine = _fed_ledger(goodput_mod, events_mod, str(mine_dir), mine_reg,
                       _Clock(), monkeypatch)
    theirs = _fed_ledger(j_goodput, j_events, str(theirs_dir), theirs_reg,
                         _Clock(), monkeypatch)
    assert mine == theirs
    assert mine["categories"]["replay"] == 0.25  # behind step 9
    assert (mine_dir / "goodput.json").read_bytes() == (
        theirs_dir / "goodput.json").read_bytes()
    assert mine_reg.render() == theirs_reg.render()


def _bundle(mod_health, reg, tmp):
    rec = mod_health.FlightRecorder(str(tmp), ring_size=3, registry=reg)
    for i in range(5):
        rec.on_event({"kind": "step", "step": i, "loss": 0.5 * i})
    rec.record_config({"trainer": {"batch_size": 8, "seq_len": 17}})
    rec.flush("test")
    rec.flush("again")
    return tmp / "crash-bundle-p0"


def test_crash_bundle_equals_tpufw(tmp_path, monkeypatch):
    """Same ring, config and registry: the manifest's reasons and files,
    the ring, the config and the metrics render are byte-equal, and the
    env snapshot agrees on every TPUFW_* knob."""
    from tpufw.obs import health as j_health
    from tpufw.obs.registry import Registry as JRegistry
    from tpufw_torch.obs import health as health_mod

    monkeypatch.setenv("TPUFW_HANG_TIMEOUT_S", "7")
    regs = []
    for R in (Registry, JRegistry):
        r = R()
        r.counter("tpufw_train_steps_total", "steps").inc(3)
        r.gauge("tpufw_train_loss", "loss").set(0.25)
        regs.append(r)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mine = _bundle(health_mod, regs[0], tmp_path / "a")
    theirs = _bundle(j_health, regs[1], tmp_path / "b")
    m = json.loads((mine / "manifest.json").read_text())
    t = json.loads((theirs / "manifest.json").read_text())
    assert (m["reasons"], m["files"], m["process"]) == (
        t["reasons"], t["files"], t["process"])
    for name in ("ring.jsonl", "config.json", "metrics.prom"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    knobs = [{k: v for k, v in json.loads((d / "env.json").read_text()
                                          ).items() if k.startswith("TPUFW_")}
             for d in (mine, theirs)]
    assert knobs[0] == knobs[1] and knobs[0]["TPUFW_HANG_TIMEOUT_S"] == "7"


def test_hang_dump_equals_tpufw(tmp_path):
    """One stall each: both dumps name the same keys, timeout and ring
    tail, and each log carries one schema-valid hang event."""
    from tpufw.obs import events as j_events
    from tpufw.obs import health as j_health
    from tpufw_torch.obs import health as health_mod

    docs, hangs = [], []
    for name, mod, ev in (("a", health_mod, events_mod),
                          ("b", j_health, j_events)):
        out = tmp_path / name
        log = ev.EventLog(str(out / "events.jsonl"))
        rec = mod.FlightRecorder(str(out), ring_size=2)
        log.listeners.append(rec.on_event)
        for i in range(4):
            log.emit("step", step=i, loss=1.0, step_time_s=0.1,
                     data_wait_s=0.0)
        wd = mod.HangWatchdog(0.05, str(out), events=log, recorder=rec)
        try:
            wd.arm()
            assert _wait_until(lambda: wd.fired == 1)
        finally:
            wd.stop()
            log.close()
        docs.append(json.loads((out / "hang-p0-1.json").read_text()))
        hangs.append([e for e in ev.read_events(str(out / "events.jsonl"))
                      if e["kind"] == "hang"])
    strip = [{k: v for k, v in d.items() if k not in ("ts", "stacks",
                                                      "armed_for_s")}
             for d in docs]
    assert strip[0]["recent_events"][0]["step"] == 2
    for d in strip:
        for e in d["recent_events"]:
            e.pop("ts")
    assert strip[0] == strip[1]
    assert [len(h) for h in hangs] == [1, 1]
    events_mod.validate(hangs[0][0])


def test_exposition_and_parse_equal_tpufw():
    """The same operations on both registries render the same bytes, and
    both parsers read that text (and a torn scrape) alike."""
    from tpufw.obs import promtext as j_promtext
    from tpufw.obs.registry import Registry as JRegistry

    texts = []
    for R in (Registry, JRegistry):
        r = R()
        c = r.counter("tpufw_t_requests_total", "requests in")
        c.inc(5)
        c.inc(2, tenant='al"pha')
        r.gauge("tpufw_t_depth", "queue\ndepth").set(0.1)
        h = r.histogram("tpufw_t_seconds", "latency", buckets=(0.1, 1.0))
        h.observe(0.05, n=3)
        h.observe(5.0, tenant="beta")
        texts.append(r.render())
    assert texts[0] == texts[1]
    torn = texts[0] + 'tpufw_torn{x="1\n'
    assert promtext.render(promtext.parse(torn)) == j_promtext.render(
        j_promtext.parse(torn))
    assert promtext.flatten(torn) == j_promtext.flatten(torn)
    assert promtext.render(promtext.parse(texts[0])) == texts[0]
