"""The port's training telemetry (``tpufw_torch.obs.Telemetry`` in
``Trainer.run`` and ``PipelineTrainer.run``, ``utils.profiling``) against
``tests/test_obs.py``'s trainer part and ``tests/test_profiling.py``.

One tiny CPU run of the port with full telemetry (metrics port, events,
trace, checkpoints and held-out evals) is held to ``tpufw``'s run of the
same config: the same event kinds in the same order, the same set of
``tpufw_*`` series (less the XLA-only ones, ``XLA_ONLY_SERIES``), and
the acceptance checks of ``tpufw``'s own test (a live scrape, schema-valid
events, the goodput rollup summing to the wall-clock, spans covering the
step loop). The run's losses equal those of a run without telemetry bit
for bit; disabled telemetry costs well under 1% of a step; the skew
monitor flags the slow rank of a 2-rank gloo gang; the ``/metrics`` and
``/debug/profile`` server answers as ``tpufw``'s; ``StepProfiler`` writes
a ``torch.profiler`` trace; ``TPUFW_COMPILE_CACHE_DIR`` moves the kernel
build per machine fingerprint, building nothing.
"""

import dataclasses
import itertools
import json
import os
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from tests.torch_gang import ROOT, finish, start_gang
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.obs import Telemetry
from tpufw_torch.obs import events as events_mod
from tpufw_torch.obs.registry import Registry, start_http_server
from tpufw_torch.obs.skew import SkewMonitor

# Series only ``tpufw``'s run publishes on the CPU: XLA's
# memory_analysis gives every compiled program a footprint, from which
# the HBM headroom gauge follows; the port reads its footprint from the
# CUDA allocator, which a CPU run does not have.
XLA_ONLY_SERIES = {"tpufw_hbm_headroom_bytes"}

# Checkpoints at every sync step: Orbax (tpufw's manager) also saves a
# run's first step off the interval, the port's manager does not, so an
# interval above 1 would part the two event logs at step 1.
TCFG = dict(batch_size=8, seq_len=17, total_steps=6, lr=1e-3, warmup_steps=2,
            sync_every=2, eval_every=2, eval_batches=1, checkpoint_every=1)


def _tiny():
    from tpufw_torch.models import LLAMA_CONFIGS

    return dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32)


def _batches(n=6):
    from tpufw_torch.train import synthetic_batches

    return list(itertools.islice(synthetic_batches(8, 17, 256, seed=0), n))


def _series(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The 2-rank gloo gang of ``tests/torch_telemetry_gang.py``, started
    at the module's first test so it runs beside the others."""
    out = tmp_path_factory.mktemp("telemetry_gang")
    procs = start_gang([os.path.join(ROOT, "tests", "torch_telemetry_gang.py"),
                        str(out)], world=2)
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _port_run(tmp, telemetry=True, scrape=None, **over):
    from tpufw_torch.train import Trainer, TrainerConfig

    cfg = _tiny()
    kw = dict(TCFG, checkpoint_dir=str(tmp / "ckpt"), **over)
    if telemetry:
        kw |= dict(telemetry_dir=str(tmp / "tel"), metrics_port=0)
    tr = Trainer(cfg, TrainerConfig(**kw), device="cpu")
    tr.init_state(seed=0)
    batches = _batches()
    history = tr.run(iter(batches),
                     model_flops_per_token=cfg.flops_per_token(16),
                     on_metrics=scrape and (lambda m: scrape(tr, m)),
                     eval_data=lambda: iter(batches[:1]),
                     on_eval=lambda ev: None)
    return tr, history


@pytest.fixture(scope="module")
def telemetry_run(tmp_path_factory, gang):
    """The port's run with full telemetry, scraping ``/metrics`` from
    ``on_metrics`` after the counted first window (between sync windows,
    as ``tpufw``'s test does)."""
    tmp = tmp_path_factory.mktemp("port")
    scraped = {}

    def scrape(tr, m):
        if m.step < 2 or "text" in scraped:
            return
        port = tr.telemetry.bound_port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            scraped["text"] = resp.read().decode()

    tr, history = _port_run(tmp, scrape=scrape)
    return tr, history, tmp / "tel", scraped


@pytest.fixture(scope="module")
def tpufw_run(tmp_path_factory):
    """``tpufw``'s Trainer on the same config (its llama3_tiny at the
    port's test precision), telemetry on: its events and final series."""
    import jax.numpy as jnp

    from tpufw.mesh import MeshConfig
    from tpufw.models import LLAMA_CONFIGS, Llama
    from tpufw.train import Trainer, TrainerConfig

    tmp = tmp_path_factory.mktemp("tpufw")
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=jnp.float32,
                              param_dtype=jnp.float32)
    tr = Trainer(Llama(cfg), TrainerConfig(
        **TCFG, checkpoint_dir=str(tmp / "ckpt"),
        telemetry_dir=str(tmp / "tel"), metrics_port=0), MeshConfig(data=8))
    tr.init_state()
    batches = _batches()
    tr.run(iter(batches), model_flops_per_token=cfg.flops_per_token(16),
           eval_data=lambda: iter(batches[:1]), on_eval=lambda ev: None)
    from tpufw.obs import events as j_events

    return (j_events.read_events(str(tmp / "tel" / "events.jsonl")),
            (tmp / "tel" / "metrics.prom").read_text())


# ------------------------------------------------- the port against tpufw


def test_event_kinds_and_order_equal_tpufw(telemetry_run, tpufw_run):
    _, _, out, _ = telemetry_run
    mine = events_mod.read_events(str(out / "events.jsonl"))
    theirs, _ = tpufw_run
    assert [e["kind"] for e in mine] == [e["kind"] for e in theirs]
    assert [e["kind"] for e in mine] == [
        "run_start", "step", "checkpoint_save", "step", "eval",
        "checkpoint_save", "step", "eval", "checkpoint_save", "step", "eval",
        "checkpoint_save", "run_end", "goodput"]
    for a, b in zip(mine, theirs):
        if a["kind"] in ("step", "eval", "checkpoint_save"):
            assert a["step"] == b["step"]
    start = [(e["workload"], e["start_step"], e["total_steps"],
              e["batch_size"], e["seq_len"], e["sync_every"])
             for e in (mine[0], theirs[0])]
    assert start[0] == start[1]


def test_series_set_equals_tpufw(telemetry_run, tpufw_run):
    _, _, out, _ = telemetry_run
    mine = _series((out / "metrics.prom").read_text())
    theirs = _series(tpufw_run[1])
    assert mine == theirs - XLA_ONLY_SERIES
    assert XLA_ONLY_SERIES <= theirs


def test_losses_equal_run_without_telemetry(telemetry_run, tmp_path):
    """The counted first step is one of the run's steps, and the count
    only looks: every loss equals the plain run's bit for bit."""
    _, history, _, _ = telemetry_run
    _, plain = _port_run(tmp_path, telemetry=False)
    assert [m.loss for m in history] == [m.loss for m in plain]
    assert [m.step for m in history] == [1, 2, 4, 6]


# ------------------------------- tpufw's trainer acceptance (test_obs.py)


def test_live_scrape_has_step_mfu_data_wait(telemetry_run):
    _, _, _, scraped = telemetry_run
    text = scraped["text"]
    assert "# TYPE tpufw_train_steps_total counter" in text
    assert "tpufw_train_mfu " in text
    info = [ln for ln in text.splitlines() if ln.startswith("tpufw_run_info{")]
    assert len(info) == 1
    assert 'backend="cpu"' in info[0] and 'model="Llama"' in info[0]
    assert "torch_version=" in info[0] and info[0].endswith(" 1")
    assert "tpufw_train_data_wait_seconds_bucket" in text
    assert "tpufw_train_step_time_seconds_count" in text
    steps = [ln for ln in text.splitlines()
             if ln.startswith("tpufw_train_steps_total ")][0]
    assert float(steps.split()[-1]) >= 2


def test_events_jsonl_schema_valid(telemetry_run):
    _, history, out, _ = telemetry_run
    events = events_mod.read_events(str(out / "events.jsonl"))
    for ev in events:
        events_mod.validate(ev)
    steps = [e for e in events if e["kind"] == "step"]
    assert len(steps) == len(history)
    assert steps[-1]["step"] == history[-1].step
    assert steps[-1]["loss"] == pytest.approx(history[-1].loss, rel=1e-4)


def test_metrics_prom_and_counted_step(telemetry_run):
    """The snapshot counts all six steps; the counted first window stays
    out of the step-time histogram (5 of 6 steps observed) and the
    programs.json entry holds its costs and MFU."""
    _, _, out, _ = telemetry_run
    text = (out / "metrics.prom").read_text()
    assert "tpufw_train_steps_total 6" in text
    assert "tpufw_train_step_time_seconds_count 5" in text
    prog = json.loads((out / "programs.json").read_text())["programs"]
    ts = prog["train_step"]
    assert ts["flops"] > 0 and ts["bytes_accessed"] > 0
    assert ts["bound"] in ("compute", "memory") and ts["calls"] == 3
    assert 'tpufw_program_mfu{program="train_step"}' in text


def test_goodput_rollup_accounts_for_wallclock(telemetry_run):
    _, _, out, _ = telemetry_run
    gp = json.loads((out / "goodput.json").read_text())
    wall = gp["wall_s"]
    assert wall > 0
    assert abs(sum(gp["categories"].values()) - wall) <= 0.02 * wall
    assert gp["categories"]["productive"] > 0
    assert gp["categories"]["checkpoint"] > 0
    assert 0 < gp["goodput_ratio"] <= 1 and gp["replay_until_step"] == 0
    text = (out / "metrics.prom").read_text()
    assert "tpufw_goodput_ratio " in text
    assert 'tpufw_badput_seconds_total{category="idle"}' in text
    events = events_mod.read_events(str(out / "events.jsonl"))
    [g] = [e for e in events if e["kind"] == "goodput"]
    assert g["goodput_ratio"] == gp["goodput_ratio"]


def test_crash_bundle_absent_on_clean_run(telemetry_run):
    _, _, out, _ = telemetry_run
    assert not list(out.glob("crash-bundle-*"))
    assert not list(out.glob("hang-*.json"))
    assert not list(out.glob("fault-*.log"))


def test_trace_spans_cover_step_loop_wallclock(telemetry_run):
    """Spans cover >= 95% of the wall-clock from the first step_dispatch
    to the last host_sync (the merged union of the complete events)."""
    _, _, out, _ = telemetry_run
    doc = json.loads((out / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {s["name"] for s in spans} >= {
        "data_fetch", "step_dispatch", "host_sync", "eval", "checkpoint",
        "checkpoint_wait", "preemption_sync"}
    t0 = min(s["ts"] for s in spans if s["name"] == "step_dispatch")
    t1 = max(s["ts"] + s["dur"] for s in spans if s["name"] == "host_sync")
    ivals = sorted((max(s["ts"], t0), min(s["ts"] + s["dur"], t1))
                   for s in spans if s["ts"] + s["dur"] > t0 and s["ts"] < t1)
    covered, cur0, cur1 = 0.0, None, None
    for a, b in ivals:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                covered += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    covered += cur1 - cur0
    assert covered / (t1 - t0) >= 0.95


def test_obs_summary_reads_the_port_files(telemetry_run, capsys):
    """``tpufw``'s digest script reads the port's telemetry dir as it
    is: events, spans, goodput, the programs' roofline and the metrics
    snapshot."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import obs_summary

    _, _, out, _ = telemetry_run
    assert obs_summary.main(["obs_summary", str(out)]) == 0
    text = capsys.readouterr().out
    for part in ("kinds: checkpoint_save=4, eval=3", "step_dispatch",
                 "productive", "train_step", "tpufw_train_steps_total 6"):
        assert part in text, part


def test_telemetry_closed_after_run(telemetry_run):
    tr, _, _, _ = telemetry_run
    port = tr.telemetry.bound_port
    with pytest.raises(Exception):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_meter_publishes_histograms_and_gauges():
    from tpufw_torch.train.metrics import Meter
    from tpufw_torch.utils.hardware import CHIP_SPECS

    reg = Registry()
    meter = Meter(tokens_per_step=1000, flops_per_token=6e9,
                  chip=CHIP_SPECS["cpu"], n_gpus=4, registry=reg)
    meter.start()
    time.sleep(0.01)
    meter.stop(4, 2.5, data_wait_s=0.08, n_steps=4)
    text = reg.render()
    assert "tpufw_train_steps_total 4" in text
    assert "tpufw_train_tokens_total 4000" in text
    assert "tpufw_train_step 4" in text and "tpufw_train_loss 2.5" in text
    assert reg.histogram("tpufw_train_data_wait_seconds").value() == 4
    assert "tpufw_train_data_wait_seconds_sum 0.08" in text
    assert reg.histogram("tpufw_train_step_time_seconds").value() == 4
    # A warm-up window counts its steps but feeds no timing series.
    meter.start()
    meter.stop(5, 2.0, n_steps=1, warmup=True)
    assert "tpufw_train_steps_total 5" in reg.render()
    assert reg.histogram("tpufw_train_step_time_seconds").value() == 4


def test_meter_without_registry_unchanged():
    from tpufw_torch.train.metrics import Meter
    from tpufw_torch.utils.hardware import CHIP_SPECS

    meter = Meter(tokens_per_step=10, flops_per_token=1.0,
                  chip=CHIP_SPECS["cpu"])
    meter.start()
    assert meter.stop(1, 1.0).step == 1 and meter.registry is None


# ------------------------------------------------- disabled-overhead budget


def test_disabled_telemetry_per_step_overhead_below_1pct():
    """One loop iteration's disabled-telemetry calls (data_fetch, the
    dispatch and sync spans, a step event, the skew guard, the watchdog
    pair, the perf probes, a goodput add, the eval and checkpoint spans)
    cost under 100 us: 1% of the smallest real step is ~250 us (tpufw's
    budget, tests/test_obs.py)."""
    from tpufw_torch.utils.profiling import StepProfiler

    tel = Telemetry.disabled()
    prof = StepProfiler(None)

    def step(x):
        return x

    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        tel.tracer.complete("data_fetch", 0.001)
        tel.watchdog.arm()
        with tel.tracer.span("step_dispatch"):
            prof.maybe_start(i)
            tel.perf.will_observe("train_step")
            with prof.step(i):
                tel.perf.observe_step("train_step", step, 1)
            prof.maybe_stop(i)
        with tel.tracer.span("host_sync"):
            tel.events.emit("step", step=1, loss=1.0, step_time_s=0.1,
                            data_wait_s=0.0)
            if tel.skew is not None:
                tel.skew.record(1, 0.1, 0.0)
            tel.perf.record_wall("train_step", 0.1)
        tel.watchdog.disarm()
        tel.goodput.add("productive", 0.001)
        with tel.tracer.span("eval"):
            pass
        with tel.tracer.span("checkpoint"):
            pass
    per_step = (time.perf_counter() - t0) / n
    assert per_step < 100e-6, f"disabled telemetry {per_step*1e6:.1f}us/step"


def test_disabled_telemetry_is_shared_and_inert(tmp_path):
    from tpufw_torch.train import Trainer, TrainerConfig

    tel = Telemetry.disabled()
    assert tel is Telemetry.disabled() and not tel.enabled
    assert tel.registry is None and tel.skew is None
    assert tel.bound_port is None and tel.snapshot_metrics() is None
    tel.close()  # must not poison later users
    assert Telemetry.create() is tel
    tr = Trainer(_tiny(), TrainerConfig(), device="cpu")
    assert tr.telemetry is tel  # before and between runs


# -------------------------------------------------------------------- skew


def _fake_gather(rows):
    return lambda local: rows


def test_straggler_detected_on_synthetic_skew(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = events_mod.EventLog(path)
    reg = Registry()
    mon = SkewMonitor(registry=reg, events=log, factor=2.0, gather=_fake_gather(
        [(1.0, 0.1), (1.1, 0.1), (2.5, 1.4), (0.9, 0.1)]))
    assert mon.record(step=8, window_time_s=1.0, data_wait_s=0.1) == [2]
    log.close()
    [ev] = events_mod.read_events(path)
    events_mod.validate(ev)
    assert (ev["kind"], ev["level"], ev["straggler_hosts"], ev["step"]) == (
        "straggler_detected", "warn", [2], 8)
    assert ev["median_s"] == pytest.approx(1.05)
    text = reg.render()
    for h in range(4):
        assert f'tpufw_train_host_window_seconds{{host="{h}"}}' in text
    assert 'tpufw_train_host_data_wait_seconds{host="2"} 1.4' in text
    assert "tpufw_train_stragglers_total 1" in text


def test_no_straggler_on_healthy_fleet_or_tiny_windows(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = events_mod.EventLog(path)
    mon = SkewMonitor(events=log, factor=2.0, gather=_fake_gather(
        [(1.0, 0.1), (1.05, 0.1), (0.98, 0.1)]))
    assert mon.record(1, 1.0, 0.1) == []
    log.close()
    assert events_mod.read_events(path) == []
    # 2x the median but only 15 ms over it: min_gap_s holds it back.
    mon = SkewMonitor(factor=2.0, min_gap_s=0.05, gather=_fake_gather(
        [(0.010, 0.0), (0.025, 0.0), (0.012, 0.0)]))
    assert mon.record(1, 0.01, 0.0) == []
    with pytest.raises(ValueError):
        SkewMonitor(factor=1.0)


def test_single_process_never_straggles():
    """Without a process group the default gather is this process's row
    alone."""
    assert SkewMonitor().record(1, 5.0, 1.0) == []


def test_skew_flags_slow_rank_in_two_rank_gang(gang):
    """A 2-rank gloo gang: each rank trains through Trainer.run with
    telemetry into one dir (its own ``-p<N>`` files), then rank 1's
    measured windows run 0.3 s longer and both ranks' monitors flag it
    at every window, the gather being a real all-gather."""
    procs, out = gang
    finish(procs, timeout=150)
    for rank in (0, 1):
        assert json.loads((out / f"skew.out{rank}.json").read_text()) == [
            [1], [1], [1]]
    train = out / "train"
    for name in ("events.jsonl", "events-p1.jsonl", "trace.json",
                 "trace-p1.json", "goodput.json", "goodput-p1.json",
                 "programs.json", "programs-p1.json", "metrics.prom",
                 "metrics-p1.prom"):
        assert (train / name).exists(), name
    for name in ("events.jsonl", "events-p1.jsonl"):
        events = events_mod.read_events(str(train / name))
        assert [e["kind"] for e in events] == [
            "run_start", "step", "step", "step", "run_end", "goodput"]
        assert events[0]["process"] == (0 if name == "events.jsonl" else 1)
    text = (out / "skew" / "metrics-p1.prom").read_text()
    assert 'tpufw_train_host_window_seconds{host="1"}' in text
    assert "tpufw_train_stragglers_total 3" in text
    [ev] = [e for e in events_mod.read_events(str(out / "skew" /
                                                  "events.jsonl"))
            if e["kind"] == "straggler_detected"][:1]
    assert ev["straggler_hosts"] == [1]


# ----------------------------------------------------------- HTTP server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_metrics_and_profile_server_answers_as_tpufw(tmp_path):
    """The same registry contents served by both packages' servers: the
    same /metrics bytes and content type; /debug/profile 404 without a
    trigger, with one 200 and the same keys, 409 while it runs; other
    paths 404."""
    from tpufw.obs.perf import ProfileTrigger as JTrigger
    from tpufw.obs.registry import Registry as JRegistry
    from tpufw.obs.registry import start_http_server as j_start
    from tpufw_torch.obs.perf import ProfileTrigger

    answers = []
    for reg, start, trig in ((Registry(), start_http_server, ProfileTrigger),
                             (JRegistry(), j_start, JTrigger)):
        reg.counter("tpufw_served_total", "served").inc(5)
        reg.gauge("tpufw_x", "x").set(0.5, tenant="a")
        plain = start(reg, 0, host="127.0.0.1")
        mounted = start(reg, 0, host="127.0.0.1",
                        profiler=trig(str(tmp_path / start.__module__)))
        try:
            base = f"http://127.0.0.1:{plain.server_address[1]}"
            base_p = f"http://127.0.0.1:{mounted.server_address[1]}"
            got = {"metrics": _get(base + "/metrics"),
                   "other": _get(base + "/other")[0],
                   "profile_404": _get(base + "/debug/profile")[0]}
            code, _, body = _get(base_p + "/debug/profile?seconds=0.2")
            got["profile"] = (code, sorted(json.loads(body)))
            code, _, body = _get(base_p + "/debug/profile?seconds=0.2")
            got["profile_busy"] = (code, json.loads(body))
        finally:
            for s in (plain, mounted):
                s.shutdown()
                s.server_close()
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[0]["metrics"][0] == 200
    assert b"tpufw_served_total 5" in answers[0]["metrics"][2]
    assert answers[0]["profile"] == (200, ["dir", "seconds", "started"])
    assert answers[0]["profile_busy"] == (
        409, {"error": "capture already in progress"})


# -------------------------------------------- profiling (test_profiling.py)


def test_compile_cache_moves_the_build_per_machine(tmp_path, monkeypatch):
    """TPUFW_COMPILE_CACHE_DIR points the kernel build at
    ``<dir>/<machine_fingerprint()>`` and builds nothing; the telemetry
    logs it as cold, and as warm once every library is there, which the
    build then reuses without running nvcc."""
    from tpufw_torch.ops import _build
    from tpufw_torch.utils import profiling

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(profiling, "_CACHE_DIR", None)
    cache = tmp_path / "kernels"
    monkeypatch.setenv("TPUFW_COMPILE_CACHE_DIR", str(cache))
    got = profiling.enable_compile_cache()
    assert got == str(cache / profiling.machine_fingerprint())
    assert len(profiling.machine_fingerprint()) == 10
    assert _build.BUILD_DIR == Path(got)
    assert _build._lib_path("flash_fwd").parent == Path(got)
    assert os.listdir(got) == []  # nothing built
    assert profiling.compile_cache_state() == (got, False)
    tel = Telemetry.create(telemetry_dir=str(tmp_path / "a"))
    tel.close()
    for name in _build.SOURCES:  # every library present: warm
        lib = _build._lib_path(name)
        lib.write_bytes(b"")
        lib.with_suffix(".log").write_text(f"ptxas {name}")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc ran"))
    assert _build.build() == {n: _build._lib_path(n) for n in _build.SOURCES}
    tel = Telemetry.create(telemetry_dir=str(tmp_path / "b"))
    tel.close()
    for d, warm in (("a", False), ("b", True)):
        [ev] = [e for e in events_mod.read_events(
            str(tmp_path / d / "events.jsonl")) if e["kind"] == "compile_cache"]
        assert (ev["dir"], ev["warm"]) == (got, warm)
    assert profiling.enable_compile_cache(
        str(tmp_path / "flat"), per_machine=False) == str(tmp_path / "flat")


def test_compile_cache_noop_without_config(monkeypatch):
    from tpufw_torch.ops import _build
    from tpufw_torch.utils.profiling import enable_compile_cache

    monkeypatch.delenv("TPUFW_COMPILE_CACHE_DIR", raising=False)
    before = _build.BUILD_DIR
    assert enable_compile_cache() is None
    assert _build.BUILD_DIR == before and before.name == "build-torch"


def test_step_profiler_inactive_is_free():
    from tpufw_torch.utils.profiling import StepProfiler

    prof = StepProfiler(None)
    steps = {id(prof.step(i)) for i in range(5)}
    assert len(steps) == 1  # one shared null context
    for i in range(5):
        prof.maybe_start(i)
        with prof.step(i):
            pass
        prof.maybe_stop(i)
    prof.close()
    assert prof.trace_path is None


def test_null_tracer_span_is_allocation_free():
    from tpufw_torch.obs import trace as trace_mod

    t = trace_mod.NullTracer()
    assert len({id(t.span("data_fetch")), id(t.span("step_dispatch",
                                                      step=3))}) == 1
    with t.span("host_sync"):
        pass
    t.complete("data_fetch", 0.01)
    t.instant("marker")
    t.close()


def test_trainer_writes_trace(tmp_path):
    """profile_dir with the window [1, 3): a torch.profiler Chrome trace
    holding steps 1 and 2 under their train_step records."""
    from tpufw_torch.train import Trainer, TrainerConfig

    trace_dir = tmp_path / "trace"
    cfg = _tiny()
    tr = Trainer(cfg, TrainerConfig(batch_size=8, seq_len=17, total_steps=4,
                                    profile_dir=str(trace_dir),
                                    profile_start=1, profile_stop=3),
                 device="cpu")
    tr.init_state()
    tr.run(iter(_batches(4)), model_flops_per_token=cfg.flops_per_token(16))
    doc = json.loads((trace_dir / "trace-steps1-3.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"train_step#1", "train_step#2"} <= names
    assert "train_step#0" not in names and "train_step#3" not in names


def test_workloads_write_telemetry_from_env(monkeypatch, capsys, tmp_path):
    """``train_llama`` and ``train_pipeline`` honour the knobs end to end:
    TPUFW_TELEMETRY_DIR, METRICS_PORT, PROFILE_STEPS and
    COMPILE_CACHE_DIR give the files, the profile window, the cache's
    event and the telemetry line; the pipeline run adds its bubble gauge,
    ``pipeline_tick`` spans and the ``pipeline_step`` program."""
    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
    from tpufw_torch.ops import _build
    from tpufw_torch.utils import profiling
    from tpufw_torch.workloads import train_llama, train_pipeline

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(profiling, "_CACHE_DIR", None)
    monkeypatch.setitem(PRESETS, "llama3_tiny", dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32))
    base = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=4, SEQ_LEN=17,
                TOTAL_STEPS=3, LOG_EVERY=1, METRICS_PORT=0,
                PROFILE_STEPS="1:2", COMPILE_CACHE_DIR=tmp_path / "cache")
    for name, mod, extra in (("llama", train_llama, {}),
                             ("pipe", train_pipeline, {"PIPE_STAGES": 2})):
        tel = tmp_path / name
        workload_env(monkeypatch, base, TELEMETRY_DIR=tel, **extra)
        assert mod.main() == 0
        out = capsys.readouterr().out
        assert "compile_cache=" in out.splitlines()[0]
        assert json.dumps({"telemetry_dir": str(tel)}) in out
        events = events_mod.read_events(str(tel / "events.jsonl"))
        assert [e["kind"] for e in events][:2] == ["compile_cache",
                                                   "run_start"]
        assert events[-1]["kind"] == "goodput"
        assert list((tel / "profile").glob("trace-steps1-2.json"))
    prog = json.loads((tmp_path / "pipe" / "programs.json").read_text())
    assert prog["programs"]["pipeline_step"]["flops"] > 0
    text = (tmp_path / "pipe" / "metrics.prom").read_text()
    assert "tpufw_pipeline_bubble_fraction 0.2" in text
    spans = json.loads((tmp_path / "pipe" / "trace.json").read_text())
    assert "pipeline_tick" in {e["name"] for e in spans["traceEvents"]}
