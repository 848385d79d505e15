"""The port's load observatory (``tpufw_torch.load``) against
``tpufw.load``.

The first part is ``tests/test_load.py`` run on the port's modules:
generator determinism, the trace schema and torn tails, rung scoring,
and the executor against stubs. The second feeds both packages the same
inputs and holds the results exactly equal (tolerance 0): the schedules
and their ``schedule_digest`` for each arrival process over several
seeds, ``MixConfig.from_env``, ``rung_stats`` and ``detect_knee`` on one
seeded trace. Then ``python -m tpufw_torch.load`` replay and sweep
against a stub router, and the closed loop on a ``llama3_tiny`` gang
(the port's engines behind a ``RouterServer``, ``scrape_once`` driven by
hand, every clock but the replay client's a fake one): burst -> burn
alert -> decision -> a spawned replica that serves -> recovery ->
scale-in, its trace, series and events read by ``tpufw``'s readers.
"""

import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw import load as j_load
from tpufw.load import sweep as j_sweep
from tpufw.obs import events as j_events
from tpufw.obs import fleet as j_fleet
from tpufw_torch.load import (
    GangExecutor,
    MixConfig,
    TraceWriter,
    parse_tenant_weights,
    read_trace,
    schedule,
    schedule_digest,
    validate_trace_record,
)
from tpufw_torch.load import __main__ as load_main
from tpufw_torch.load.sweep import SweepConfig, detect_knee, rung_stats
from tpufw_torch.obs import events as obs_events
from tpufw_torch.obs import fleet
from tpufw_torch.obs.registry import Registry
from tpufw_torch.obs.slo import SloTracker

MANIFEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "deploy",
    "manifests",
    "13-serve-disagg-v5e8-jobset.yaml",
)

MIX = MixConfig(
    seed=11,
    process="mmpp",
    rate_rps=25.0,
    duration_s=4.0,
    tenants=(("vip", 3.0), ("batch", 1.0)),
    prefix_ratio=0.6,
    session_ratio=0.3,
)


# ------------------------------------------------------ determinism


def test_same_seed_same_mix_is_byte_identical():
    a, b = schedule(MIX), schedule(MIX)
    ja = json.dumps([dataclasses.asdict(r) for r in a], sort_keys=True)
    jb = json.dumps([dataclasses.asdict(r) for r in b], sort_keys=True)
    assert ja == jb  # arrivals AND prompts AND sessions, bytewise
    assert schedule_digest(a) == schedule_digest(b)


def test_seed_change_changes_schedule():
    a = schedule(MIX)
    b = schedule(dataclasses.replace(MIX, seed=MIX.seed + 1))
    assert schedule_digest(a) != schedule_digest(b)


@pytest.mark.parametrize("process", ["poisson", "mmpp", "diurnal"])
def test_arrival_processes_stay_in_window(process):
    cfg = dataclasses.replace(MIX, process=process)
    reqs = schedule(cfg)
    assert reqs, "no arrivals generated"
    assert all(0.0 <= r.t < cfg.duration_s for r in reqs)
    assert [r.t for r in reqs] == sorted(r.t for r in reqs)
    # Loose count bound (seeded, so stable): base rate*duration is
    # 100; MMPP averages (1+burst_factor)/2 times that in the limit.
    assert 0.2 * 100 < len(reqs) < 8.0 * 100


def test_mix_shape_tenants_prefixes_sessions():
    reqs = schedule(MIX)
    by_tenant = {t: 0 for t, _ in MIX.tenants}
    for r in reqs:
        by_tenant[r.tenant] += 1
    assert by_tenant["vip"] > by_tenant["batch"]  # 3:1 weights
    # Prefix sharing: some prompts must open with an identical
    # prefix_len-token run (pool of n_prefixes shared prefixes).
    heads = [r.prompt[: MIX.prefix_len] for r in reqs
             if len(r.prompt) >= MIX.prefix_len]
    shared = len(heads) - len(set(heads))
    assert shared > 0
    sessions = [r for r in reqs if r.session]
    assert sessions
    # A continued turn reuses its session id.
    by_sid = {}
    for r in sessions:
        by_sid.setdefault(r.session, []).append(r)
    assert any(len(v) > 1 for v in by_sid.values())


def test_mix_config_validates():
    with pytest.raises(ValueError):
        MixConfig(process="lunar")
    with pytest.raises(ValueError):
        MixConfig(rate_rps=0.0)


def test_parse_tenant_weights():
    assert parse_tenant_weights("vip:3,batch:1") == (
        ("vip", 3.0), ("batch", 1.0),
    )
    assert parse_tenant_weights("solo") == (("solo", 1.0),)
    assert parse_tenant_weights("a:bad,,b:2") == (("b", 2.0),)
    assert parse_tenant_weights("") == (("default", 1.0),)


# ------------------------------------------------------ trace file


def _rec(**kw):
    base = {
        "ts_offered": 1.0, "ts_sent": 1.0, "ts_done": 1.5,
        "tenant": "vip", "status": 200, "rung": 0,
        "offered_rps": 2.0, "n_prompt": 8, "max_new": 4,
    }
    base.update(kw)
    return base


def test_trace_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "load-trace.jsonl")
    with TraceWriter(path) as w:
        w.append(_rec(ttft_s=0.1, tok_s=0.01, n_tokens=4))
        w.append(_rec(status=429, tenant="batch"))
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"ts_offered": 2.0, "tenant": "v')  # SIGKILL mid-write
    recs = read_trace(path)
    assert len(recs) == 2
    assert recs[1]["status"] == 429
    with pytest.raises(ValueError):
        validate_trace_record({"tenant": "vip"})


# --------------------------------------------------- sweep scoring


def test_rung_stats_attainment_counts_rejects_against_tenant():
    sweep = SweepConfig(ttft_target_s=0.5, tok_target_s=1.0)
    recs = [
        _rec(ttft_s=0.1, n_tokens=10),          # good
        _rec(ttft_s=0.9, n_tokens=10),          # ttft miss
        _rec(status=429),                        # rejected: counts
        _rec(tenant="batch", ttft_s=0.2, n_tokens=5),
    ]
    out = rung_stats(recs, sweep, wall_s=2.0)
    vip = out["tenants"]["vip"]
    assert vip["offered"] == 3 and vip["good"] == 1
    assert vip["rejected"] == 1
    assert vip["attainment"] == pytest.approx(1 / 3)
    assert out["tenants"]["batch"]["attainment"] == 1.0
    assert out["attainment"] == pytest.approx(2 / 4)
    assert out["goodput_tok_s"] == pytest.approx(15 / 2.0)


def test_detect_knee_is_last_goal_meeting_rung():
    rungs = [
        {"rung": 0, "offered_rps": 1.0, "attainment": 1.0},
        {"rung": 1, "offered_rps": 2.0, "attainment": 0.995},
        {"rung": 2, "offered_rps": 4.0, "attainment": 0.7},
        {"rung": 3, "offered_rps": 8.0, "attainment": 0.4},
    ]
    knee = detect_knee(rungs, goal=0.99)
    assert knee == {
        "rung": 1, "offered_rps": 2.0, "attainment": 0.995,
    }
    assert detect_knee(rungs, goal=1.1) is None


def test_rung_stats_stage_decomposition():
    sweep = SweepConfig()
    recs = [
        _rec(ttft_s=0.1, stages={"req_queue_wait": 0.2,
                                 "req_prefill": 0.1}),
        _rec(ttft_s=0.1, stages={"req_queue_wait": 0.4}),
    ]
    out = rung_stats(recs, sweep, wall_s=1.0)
    assert out["stages_mean_s"]["req_queue_wait"] == pytest.approx(0.3)
    assert out["stages_mean_s"]["req_prefill"] == pytest.approx(0.1)


# ------------------------------------------------- closed-loop exec


class _StubRouter:
    def __init__(self):
        self.added = []
        self.removed = []

    def add_replica(self, client, role):
        self.added.append((client.name, role))

    def remove_replica(self, name, *, drain=True):
        self.removed.append((name, drain))


class _StubReplica:
    def __init__(self, name):
        self.name = name
        self.closed = False
        self.drained = False

    def drain(self):
        self.drained = True
        return {"draining": True}

    def close(self):
        self.closed = True


def _decision(pool, frm, to, ts=100.0):
    return {
        "ts": ts,
        "pools": {pool: {"from": frm, "to": to}},
        "reason": ["load_tok_burn"],
    }


def test_executor_applies_scale_up_then_lifo_scale_down(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    router = _StubRouter()
    ex = GangExecutor(
        router,
        spawn={"decode": _StubReplica},
        events=log,
        wall_clock=lambda: 7.0,
    )
    ex.on_decision(_decision("decode", 1, 2))
    ex.on_decision(_decision("decode", 2, 3))
    assert router.added == [
        ("decode-auto1", "decode"), ("decode-auto2", "decode"),
    ]
    ex.on_decision(_decision("decode", 3, 2))
    assert router.removed == [("decode-auto2", True)]  # LIFO
    log.close()
    events = obs_events.read_events(str(tmp_path / "ev.jsonl"))
    actions = [
        (e["action"], e["replica"])
        for e in events if e["kind"] == "scale_action"
    ]
    assert actions == [
        ("add", "decode-auto1"),
        ("add", "decode-auto2"),
        ("remove", "decode-auto2"),
    ]
    assert all(
        e["decision_ts"] == 100.0
        for e in events if e["kind"] == "scale_action"
    )


def test_executor_never_removes_base_gang():
    router = _StubRouter()
    ex = GangExecutor(router, spawn={"decode": _StubReplica})
    ex.on_decision(_decision("decode", 2, 1))
    assert router.removed == []
    assert ex.actions[-1]["action"] == "skipped"
    ex.on_decision(_decision("prefill", 1, 2))  # no prefill factory
    assert ex.actions[-1]["action"] == "skipped"


def test_executor_recovery_links_decision_to_burn_drop():
    clock = [0.0]
    reg = Registry()
    slo = SloTracker(
        reg, ttft_ms=100.0, goal=0.99, windows=(4.0, 12.0),
        clock=lambda: clock[0],
    )
    router = _StubRouter()
    ex = GangExecutor(
        router, spawn={"decode": _StubReplica}, slo=slo,
        burn_window="4s", wall_clock=lambda: clock[0],
    )
    slo.observe("burst", ttft_s=5.0)  # violation: burn pegs high
    ex.on_decision(_decision("decode", 1, 2))
    assert ex.actions[-1]["action"] == "add"
    assert ex.actions[-1]["burn"] > 1.0  # burn-rate-at-decision
    assert ex.poll_recovery() is None  # still burning
    # Violations age out of the fast window; good traffic lands.
    clock[0] = 6.0
    for _ in range(3):
        slo.observe("burst", ttft_s=0.01)
    rec = ex.poll_recovery()
    assert rec is not None and rec["action"] == "recovered"
    assert rec["replica"] == "decode-auto1"
    assert rec["burn"] < 1.0
    assert ex.poll_recovery() is None  # one recovery per scale-up


def test_executor_close_drains_every_spawned_replica():
    router = _StubRouter()
    ex = GangExecutor(router, spawn={"decode": _StubReplica})
    ex.on_decision(_decision("decode", 1, 3))
    ex.close()
    assert [n for n, _ in router.removed] == [
        "decode-auto2", "decode-auto1",
    ]
    ex.close()  # idempotent
    assert len(router.removed) == 2


def test_recommender_listener_receives_decision(tmp_path):
    rec = fleet.ScalingRecommender(
        str(tmp_path), MANIFEST, cooldown_s=0.0,
        clock=lambda: 0.0, wall_clock=lambda: 42.0,
    )
    got = []
    rec.listeners.append(got.append)
    rec.listeners.append(lambda d: 1 / 0)  # raising subscriber: inert
    decision = rec.consider(
        [{"name": "load_tok_burn", "scale": "decode:+1"}], now=0.0
    )
    assert got == [decision]
    assert decision["pools"] == {"decode": {"from": 1, "to": 2}}


def test_slo_max_burn_and_phase_stamp(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    clock = [0.0]
    slo = SloTracker(
        Registry(), log, ttft_ms=100.0, goal=0.99,
        windows=(4.0, 12.0), clock=lambda: clock[0],
    )
    assert slo.max_burn() == 0.0
    slo.set_phase("rung-1")
    slo.observe("vip", ttft_s=5.0)
    slo.set_phase("")
    slo.observe("vip", ttft_s=6.0)
    assert slo.max_burn("4s") == pytest.approx(100.0)
    assert slo.max_burn("12s") == pytest.approx(100.0)
    log.close()
    violations = [
        e for e in obs_events.read_events(str(tmp_path / "ev.jsonl"))
        if e["kind"] == "slo_violation"
    ]
    assert violations[0]["phase"] == "rung-1"
    assert "phase" not in violations[1]


def test_trace_writer_is_thread_safe(tmp_path):
    path = str(tmp_path / "t.jsonl")
    w = TraceWriter(path)
    try:
        threads = [
            threading.Thread(
                target=lambda i=i: [
                    w.append(_rec(rung=i)) for _ in range(25)
                ],
            )
            for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        w.close()
    recs = read_trace(path)
    assert len(recs) == 100  # no torn interleaving


# ============================================== parity with tpufw.load


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("process", ["poisson", "mmpp", "diurnal"])
def test_schedule_and_digest_equal_tpufw(process, seed):
    kw = dict(seed=seed, process=process, rate_rps=9.0, duration_s=3.0,
              tenants=(("vip", 3.0), ("batch", 1.0), ("free", 0.5)),
              prefix_ratio=0.6, session_ratio=0.4, session_turns=4)
    ours = schedule(MixConfig(**kw))
    theirs = j_load.schedule(j_load.MixConfig(**kw))
    assert [dataclasses.asdict(r) for r in ours] == [
        dataclasses.asdict(r) for r in theirs]
    assert schedule_digest(ours) == j_load.schedule_digest(theirs)


LOAD_ENV = {"TPUFW_LOAD_SEED": "5", "TPUFW_LOAD_PROCESS": "diurnal",
            "TPUFW_LOAD_RATE_RPS": "6", "TPUFW_LOAD_DURATION_S": "2",
            "TPUFW_LOAD_TENANTS": "vip:3,batch:1",
            "TPUFW_LOAD_PREFIX_RATIO": "0.3",
            "TPUFW_LOAD_SESSION_RATIO": "0.5"}


def test_mix_from_env_equal_tpufw(monkeypatch):
    for k, v in LOAD_ENV.items():
        monkeypatch.setenv(k, v)
    ours, theirs = MixConfig.from_env(), j_load.MixConfig.from_env()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert schedule_digest(schedule(ours)) == j_load.schedule_digest(
        j_load.schedule(theirs))


def _seeded_trace(seed, n=80):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        status = int(rng.choice([200, 200, 200, 200, 429, 0, 502]))
        rec = _rec(tenant=str(rng.choice(["vip", "batch", "free"])),
                   status=status, rung=int(rng.integers(0, 3)),
                   ts_offered=float(i) * 0.1)
        if status == 200:
            rec["n_tokens"] = int(rng.integers(1, 30))
            if rng.random() < 0.9:
                rec["ttft_s"] = round(float(rng.exponential(0.4)), 6)
            if rng.random() < 0.8:
                rec["tok_s"] = round(float(rng.exponential(0.05)), 6)
            rec["stages"] = {s: round(float(rng.random()), 6)
                             for s in ("queue_wait", "prefill_compute",
                                       "splice") if rng.random() < 0.7}
        out.append(rec)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_rung_stats_and_knee_equal_tpufw(seed):
    kw = dict(ttft_target_s=0.5, tok_target_s=0.08, goal=0.6,
              tenant_targets=(("vip", (0.3, 0.05)),))
    ours, theirs = SweepConfig(**kw), j_sweep.SweepConfig(**kw)
    rungs_p, rungs_j = [], []
    for r in range(4):
        recs = _seeded_trace(seed * 10 + r)
        got = rung_stats(recs, ours, wall_s=3.0 + r)
        want = j_sweep.rung_stats(recs, theirs, wall_s=3.0 + r)
        assert got == want
        rungs_p.append({"rung": r, "offered_rps": 2.0 ** r, **got})
        rungs_j.append({"rung": r, "offered_rps": 2.0 ** r, **want})
    for goal in (0.3, 0.6, 0.9):
        assert detect_knee(rungs_p, goal) == j_sweep.detect_knee(
            rungs_j, goal)


# =============================================== the CLI against a stub


class _StubFrontDoor(ThreadingHTTPServer):
    """A router front door that answers every ``/generate`` with
    ``max_new`` tokens and fixed stages, and ``/metrics`` with one SLO
    gauge."""

    def __init__(self):
        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                text = b'tpufw_slo_goal{tenant="default"} 0.99\n'
                self.send_response(200)
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                body = json.dumps({
                    "tokens": list(range(req["max_new"])), "ttft_s": 0.001,
                    "replica": "decode-0",
                    "stages": {"queue_wait": 0.0, "splice": 0.001}},
                ).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        super().__init__(("127.0.0.1", 0), H)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def base(self):
        return f"http://127.0.0.1:{self.server_address[1]}"


def test_load_cli_replay_and_sweep(tmp_path, monkeypatch, capsys):
    """``python -m tpufw_torch.load replay`` sends the TPUFW_LOAD_* mix
    (the same schedule ``tpufw`` draws from those knobs) and leaves a
    trace ``tpufw``'s reader reads, one valid record a request; ``sweep``
    writes a payload whose rungs carry ``tpufw``'s schedule digests."""
    for k, v in LOAD_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TPUFW_LOAD_DIR", str(tmp_path))
    stub = _StubFrontDoor()
    try:
        assert load_main.main(["replay", "--base-url", stub.base]) == 0
        out = json.loads(capsys.readouterr().out)["load_replay"]
        want = j_load.schedule(j_load.MixConfig.from_env())
        assert out["schedule_digest"] == j_load.schedule_digest(want)
        recs = j_load.read_trace(str(tmp_path / "load-trace.jsonl"))
        assert out["offered"] == out["completed"] == len(recs) == len(want)
        for r in recs:
            j_load.validate_trace_record(r)
        assert sorted(r["n_prompt"] for r in recs) == sorted(
            len(o.prompt) for o in want)
        os.remove(tmp_path / "load-trace.jsonl")
        dst = str(tmp_path / "BENCH_load.json")
        assert load_main.main([
            "sweep", "--base-url", stub.base, "--rungs", "4,8",
            "--hold-s", "0.5", "--settle-s", "0", "--out", dst]) == 0
    finally:
        stub.shutdown()
        stub.server_close()
    knee = json.loads(capsys.readouterr().out)["knee"]
    payload = json.load(open(dst))
    assert knee == payload["knee"] == {"rung": 1, "offered_rps": 8.0,
                                       "attainment": 1.0}
    for i, rung in enumerate(payload["rungs"]):
        cfg = dataclasses.replace(j_load.MixConfig.from_env(), seed=5 + i,
                                  rate_rps=rung["offered_rps"],
                                  duration_s=0.5)
        assert rung["schedule_digest"] == j_load.schedule_digest(
            j_load.schedule(cfg))
        assert rung["slo_snapshot"] == {
            'tpufw_slo_goal{tenant="default"}': 0.99}
    assert len(j_load.read_trace(str(tmp_path / "load-trace.jsonl"))) == sum(
        r["summary"]["offered"] for r in payload["rungs"])


# ============================================ the closed loop on a gang


PAGE = 16
SEQ = 64


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def test_closed_loop_on_a_tiny_gang(tmp_path):
    """The closed autoscaling loop on the port's llama3_tiny gang
    (``PrefillEngine`` and ``DecodeEngine`` behind a ``RouterServer``),
    every clock but the replay client's a fake one and ``scrape_once``
    driven by hand: pre-traffic sweep clean; a burst of the poisoned
    tenant through the router's HTTP port fires the burn pair; one
    decision (decode +1) and a spawned replica in ``/healthz``; with the
    gang quiet and both decode replicas idle the router breaks the tie by
    name, so the spawned replica serves four prompts, with the base
    replica's tokens; relaxed targets recover; idle traffic scales in and
    the executor removes only its own replica. ``tpufw``'s readers read
    the trace, the series and the event log."""
    from tpufw_torch.infer import SamplingConfig
    from tpufw_torch.models import model_for_config
    from tpufw_torch.models.llama import LLAMA_CONFIGS
    from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine
    from tpufw_torch.load import ReplayClient
    from tpufw_torch.serve.router import LocalReplica, RouterServer

    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                              max_seq_len=SEQ).decode_config()
    model = model_for_config(cfg, device="cpu", seed=0)
    greedy = SamplingConfig()
    clock = _Clock(1000.0)
    ev_path = str(tmp_path / fleet.EVENTS_FILENAME)
    events = obs_events.EventLog(ev_path)
    reg = Registry()
    slo = SloTracker(reg, events, ttft_ms=60000.0, tok_ms=60000.0,
                     goal=0.99, windows=(4.0, 12.0),
                     tenants={"burst": (60000.0, 0.0001)}, clock=clock)
    pe = PrefillEngine(model, sampling=greedy, page=PAGE, n_slots=2)
    de = DecodeEngine(model, sampling=greedy, page=PAGE, n_slots=4, chunk=2)
    base_replica = LocalReplica("decode-base", de)
    router = RouterServer([LocalReplica("prefill-0", pe)], [base_replica],
                          port=0, page=PAGE, events=events, registry=reg,
                          slo=slo)
    url = f"http://127.0.0.1:{router.port}"
    store = fleet.SeriesStore(str(tmp_path / fleet.SERIES_FILENAME))
    recommender = fleet.ScalingRecommender(
        str(tmp_path), MANIFEST, cooldown_s=3.0, events=events,
        clock=clock, wall_clock=clock)
    rules = (
        fleet.BurnRateRule(name="load_tok_burn", metric="tok",
                           fast_window="4s", slow_window="12s",
                           scale="decode:+1"),
        fleet.AlertRule(name="load_idle_traffic",
                        series="tpufw_fleet_requests_per_s", op="<",
                        threshold=0.05, for_s=2.0, scale="decode:-1"),
    )
    collector = fleet.FleetCollector(
        [fleet.Target("router", "router", router.render_metrics),
         fleet.Target("decode-base", "decode", base_replica.signals)],
        store, events=events, rules=rules, recommender=recommender,
        health_fn=router.health, clock=clock, mono=clock)
    engines = {}

    def spawn(name):
        engines[name] = DecodeEngine(model, sampling=greedy, page=PAGE,
                                     n_slots=4, chunk=2)
        return LocalReplica(name, engines[name])

    executor = GangExecutor(router, spawn={"decode": spawn}, events=events,
                            slo=slo, burn_window="4s", wall_clock=clock)
    executor.subscribe(recommender)
    trace = TraceWriter(str(tmp_path / "load-trace.jsonl"))

    def decode_names():
        return sorted(n for n, r in router.health()["replicas"].items()
                      if r["role"] == "decode")

    def post(prompt, tenant):
        code, body, _h = router.generate(
            {"prompt": prompt, "max_new": 5, "tenant": tenant})
        assert code == 200, body
        return body

    prompts = [list(range(3, 3 + n)) for n in (5, 9, 12, 15)]  # no full page
    try:
        want = [post(p, "default")["tokens"] for p in prompts]
        d0 = collector.scrape_once()
        assert d0['tpufw_fleet_replicas{role="prefill"}'] == 1.0
        assert d0['tpufw_fleet_replicas{role="decode"}'] == 1.0
        assert d0["tpufw_fleet_replicas_unhealthy"] == 0.0

        events.emit("load_phase", phase="burst")
        slo.set_phase("burst")
        mix = MixConfig(seed=20, process="mmpp", rate_rps=5.0,
                        duration_s=1.5, tenants=(("burst", 1.0),),
                        prompt_len_base=8, prompt_len_cap=24, prefix_len=8,
                        n_prefixes=2, max_new_base=6, max_new_cap=8,
                        session_ratio=0.2, mmpp_burst_factor=4.0,
                        mmpp_dwell_s=0.8, vocab=cfg.vocab_size)
        reqs = schedule(mix)
        summary = ReplayClient(url, trace, threads=4).run(reqs)
        assert summary["completed"] == len(reqs) > 0
        clock.t = 1001.0
        d1 = collector.scrape_once()
        burn = 'tpufw_fleet_slo_burn_rate{metric="tok",tenant="burst",'
        assert d1[burn + 'window="4s"}'] > 14.4
        assert d1[burn + 'window="12s"}'] > 6.0
        assert [a["action"] for a in executor.actions] == ["add"]
        name = executor.actions[0]["replica"]
        assert decode_names() == [name, "decode-base"]
        assert executor.actions[0]["burn"] > 14.4

        slo.tenants["burst"] = (60000.0, 60000.0)
        clock.t = 1005.5  # the violations leave the 4 s window
        router._refresh_all()
        got = [None] * len(prompts)

        def run(i):
            got[i] = post(prompts[i], "burst")

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert [b["replica"] for b in got] == [name] * len(prompts)
        assert [b["tokens"] for b in got] == want
        assert engines[name].signals()["migrations"] >= len(prompts)
        rec = executor.poll_recovery()
        assert rec["action"] == "recovered" and rec["replica"] == name
        assert rec["burn"] < 1.0

        events.emit("load_phase", phase="idle")
        slo.set_phase("")
        for _ in range(8):
            clock.t += 1.0
            collector.scrape_once()
            if decode_names() == ["decode-base"]:
                break
        assert decode_names() == ["decode-base"]
        assert [(a["action"], a["replica"]) for a in executor.actions] == [
            ("add", name), ("recovered", name), ("remove", name)]
        decisions = sorted(f for f in os.listdir(tmp_path)
                           if f.startswith("fleet-rec-")
                           and f.endswith(".json"))
        assert decisions == ["fleet-rec-0001.json", "fleet-rec-0002.json"]
    finally:
        trace.close()
        executor.close()
        collector.stop()
        events.close()
        router.close()

    # tpufw's own readers read every file the loop wrote.
    recs = j_load.read_trace(str(tmp_path / "load-trace.jsonl"))
    assert len(recs) == len(reqs)
    for r in recs:
        j_load.validate_trace_record(r)
    series = j_fleet.read_series(str(tmp_path / fleet.SERIES_FILENAME))
    assert {r["replica"] for r in series} == {
        "router", "decode-base", "prefill-0", name, "fleet"}
    evs = j_events.read_events(ev_path)
    for e in evs:
        j_events.validate(e)
    chain = [(e["kind"], e.get("action") or e.get("state") or e.get("phase"))
             for e in evs if e["kind"] in (
                 "fleet_alert", "fleet_recommendation", "scale_action",
                 "load_phase")]
    want_chain = [("load_phase", "burst"), ("fleet_alert", "firing"),
                  ("fleet_recommendation", None), ("scale_action", "add"),
                  ("scale_action", "recovered"), ("load_phase", "idle"),
                  ("scale_action", "remove")]
    it = iter(chain)
    assert all(any(k == wk and (wa is None or a == wa) for k, a in it)
               for wk, wa in want_chain), chain
