"""The port's copies of ``tpufw.obs.events``, ``trace``, ``reqtrace`` and
``slo`` against ``tpufw``'s on the same inputs (mirrors
``tests/test_reqtrace.py`` and ``tests/test_slo.py``): request-trace
parse/child/format, SLO window and burn-rate math with the rendered
``tpufw_slo_*`` series, schema-checked EventLog lines and the tracer's
Chrome JSON. Host-only code: no model, no device."""

import json

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.obs import events as j_events
from tpufw.obs import registry as j_registry
from tpufw.obs import reqtrace as j_reqtrace
from tpufw.obs import slo as j_slo
from tpufw.obs import trace as j_trace
from tpufw_torch.obs import events, registry, reqtrace, slo, trace

# (events, registry, reqtrace, slo, trace) of each package.
PKGS = {
    "tpufw": (j_events, j_registry, j_reqtrace, j_slo, j_trace),
    "port": (events, registry, reqtrace, slo, trace),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _tracker(pkg, **kw):
    ev, reg_mod, _rt, slo_mod, _tr = PKGS[pkg]
    clock = _Clock()
    reg = reg_mod.Registry()
    kw.setdefault("ttft_ms", 100.0)
    kw.setdefault("tok_ms", 10.0)
    kw.setdefault("goal", 0.9)
    return slo_mod.SloTracker(reg, clock=clock, **kw), reg, clock


# ------------------------------------------------------------ reqtrace


@BOTH
def test_mint_wire_parse_child_roundtrip(pkg):
    rt = PKGS[pkg][2]
    ctx = rt.mint("vip")
    assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 8
    back = rt.parse(ctx.wire())
    assert (back.trace_id, back.span_id, back.tenant) == (
        ctx.trace_id, ctx.span_id, "vip")
    assert rt.mint().wire().count("-") == 1
    assert rt.parse(ctx.meta()).trace_id == ctx.trace_id
    kid = ctx.child()
    assert kid.trace_id == ctx.trace_id and kid.parent == ctx.span_id
    assert kid.parent not in kid.wire()
    assert kid.args(pages=3) == {**kid.args(), "pages": 3}


@pytest.mark.parametrize("value", [
    "0123456789abcdef-89abcdef-vip", "0123456789abcdef-89abcdef",
    {"id": "0123456789abcdef", "span": "89abcdef", "tenant": "t"},
    None, "", "not-a-trace", "xyz-abc", 12345, {"id": "a"}, {"span": "b"},
    "deadbeef-cafe", "e" * 16 + "-" + "f" * 8 + "-ten ant",
    "E" * 16 + "-" + "f" * 8,
])
def test_reqtrace_parse_equals_tpufw(value):
    """Both packages read the same header, meta dict or garbage alike,
    and format a context to the same wire string, meta and span args."""
    a, b = reqtrace.parse(value), j_reqtrace.parse(value)
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.trace_id, a.span_id, a.tenant, a.parent) == (
            b.trace_id, b.span_id, b.tenant, b.parent)
        assert a.wire() == b.wire() and a.meta() == b.meta()
        assert a.args(x=1) == b.args(x=1)
    assert reqtrace.HEADER == j_reqtrace.HEADER


@BOTH
def test_stage_emits_correlated_span(pkg, tmp_path):
    rt, tr_mod = PKGS[pkg][2], PKGS[pkg][4]
    tr = tr_mod.Tracer(str(tmp_path / "trace.json"), process_name="router")
    ctx = rt.mint("smoke")
    rt.stage(tr, ctx, "req_queue_wait", 0.005, depth=2)
    rt.stage(tr, None, "req_wire", 0.001)
    rt.stage(tr_mod.NULL, ctx, "req_admit", 0.001)  # disabled: a no-op
    tr.close()
    doc = json.loads((tmp_path / "trace.json").read_text())
    by_name = {e["name"]: e for e in doc["traceEvents"]
               if e.get("ph") == "X"}
    q = by_name["req_queue_wait"]
    assert q["args"] == {**ctx.args(), "depth": 2}
    assert "trace" not in by_name["req_wire"].get("args", {})
    assert "req_admit" not in by_name


def test_tracer_json_equals_tpufw(tmp_path):
    """The same spans through both tracers give the same Chrome JSON but
    for the clock."""
    docs = []
    for pkg in sorted(PKGS):
        tr_mod = PKGS[pkg][4]
        path = tmp_path / f"{pkg}.json"
        tr = tr_mod.Tracer(str(path), process_name="decode", max_events=3)
        with tr.span("serve_decode_chunk", k=4, rows=2):
            pass
        tr.complete("req_splice", 0.25, pages=3)
        for i in range(4):  # past max_events: dropped and counted
            tr.complete("extra", 0.01, i=i)
        tr.close()
        doc = json.loads(path.read_text())
        doc["otherData"].pop("wall_epoch_s")
        for e in doc["traceEvents"]:
            for k in ("ts", "dur", "pid", "tid"):
                e.pop(k, None)
        docs.append(doc)
    assert docs[0] == docs[1]


# ----------------------------------------------------------------- slo


@pytest.mark.parametrize("spec", [
    "vip:500:50, batch:10000:1000", "a:1, b:x:2, c:3:4:5, :6:7,", "",
])
def test_parse_tenant_targets_equals_tpufw(spec):
    assert slo.parse_tenant_targets(spec) == j_slo.parse_tenant_targets(spec)


@BOTH
def test_bad_config_rejected(pkg):
    reg_mod, slo_mod = PKGS[pkg][1], PKGS[pkg][3]
    with pytest.raises(ValueError, match="goal"):
        slo_mod.SloTracker(reg_mod.Registry(), goal=1.0)
    with pytest.raises(ValueError, match="windows"):
        slo_mod.SloTracker(reg_mod.Registry(), windows=())


# (tenant, ttft seconds, per-token seconds or None, seconds to advance
# the clock before the observation)
SLO_TRAFFIC = [
    ("t", 0.05, 0.005, 0.0), ("t", 0.05, 0.005, 0.0),
    ("t", 0.2, 0.05, 0.0), ("vip", 0.05, None, 1.0),
    ("vip", 0.05, 0.5, 0.0), ("", 0.01, 0.001, 0.0),
    ("t", 5.0, 0.02, 60.0), ("t", 5.0, 0.001, 0.0),
    ("t", 0.01, 0.001, 50.0), ("vip", 0.005, 0.0005, 200.0),
]


@BOTH
def test_slo_window_and_burn_math(pkg):
    tr, reg, clock = _tracker(pkg, windows=(10.0, 100.0),
                              tenants={"vip": (10.0, 1.0)})
    for tenant, ttft, tok, dt in SLO_TRAFFIC[:8]:
        clock.t += dt
        tr.observe(tenant, ttft, tok_s=tok)
    # 10s window: the two fresh 5s violations; 100s: 3 of 5 bad
    assert tr.burn_rate("t", "ttft", window=10.0) == pytest.approx(10.0)
    assert tr.attainment("t", "ttft", window=100.0) == pytest.approx(0.4)
    assert tr.attainment("vip", "ttft", window=100.0) == 0.0
    assert tr.attainment("vip", "tok", window=100.0) == 0.0
    assert tr.attainment("idle", "ttft") == 1.0
    text = reg.render()
    assert ('tpufw_slo_burn_rate{metric="ttft",tenant="t",window="10s"} 10'
            in text)
    assert 'tpufw_slo_ttft_attainment{tenant="default"} 1' in text


def test_slo_series_equal_tpufw():
    """The same traffic on the same clock renders the same series."""
    texts, numbers = [], []
    for pkg in sorted(PKGS):
        tr, reg, clock = _tracker(pkg, windows=(10.0, 100.0),
                                  tenants={"vip": (10.0, 1.0)})
        for tenant, ttft, tok, dt in SLO_TRAFFIC:
            clock.t += dt
            tr.observe(tenant, ttft, tok_s=tok)
        texts.append(reg.render())
        numbers.append([
            (tr.attainment(t, m, window=w), tr.burn_rate(t, m, window=w))
            for t in ("t", "vip", "default") for m in ("ttft", "tok")
            for w in (10.0, 100.0)
        ])
    assert texts[0] == texts[1]
    assert numbers[0] == numbers[1]


@BOTH
def test_violation_events_pass_schema_and_carry_trace(pkg, tmp_path):
    ev_mod = PKGS[pkg][0]
    path = tmp_path / "events.jsonl"
    log = ev_mod.EventLog(str(path))
    tr, _reg, _clock = _tracker(pkg, events=log)
    tr.observe("vip", 0.05)
    tr.observe("vip", 0.25, trace="deadbeefdeadbeef")
    log.close()
    evs = [e for e in ev_mod.read_events(str(path))
           if e["kind"] == "slo_violation"]
    assert len(evs) == 1
    ev = evs[0]
    assert (ev["level"], ev["tenant"], ev["metric"], ev["trace"]) == (
        "warn", "vip", "ttft", "deadbeefdeadbeef")
    assert ev["value_ms"] == pytest.approx(250.0)
    assert ev["target_ms"] == 100.0


@BOTH
def test_from_env_reads_knobs(pkg, monkeypatch):
    reg_mod, slo_mod = PKGS[pkg][1], PKGS[pkg][3]
    for k, v in {"TTFT_MS": "500", "TOK_MS": "50", "GOAL": "0.95",
                 "WINDOWS_S": "30,600", "TENANTS": "vip:100:10"}.items():
        monkeypatch.setenv(f"TPUFW_SLO_{k}", v)
    tr = slo_mod.SloTracker.from_env(reg_mod.Registry())
    assert (tr.ttft_ms, tr.tok_ms, tr.goal, tr.windows) == (
        500.0, 50.0, 0.95, (30.0, 600.0))
    assert tr.targets_for("vip") == (100.0, 10.0)
    for k in ("TTFT_MS", "TOK_MS", "GOAL", "WINDOWS_S", "TENANTS"):
        monkeypatch.delenv(f"TPUFW_SLO_{k}")
    tr = slo_mod.SloTracker.from_env(reg_mod.Registry())
    assert tr.ttft_ms == 2000.0 and tr.windows == slo_mod.DEFAULT_WINDOWS


# -------------------------------------------------------------- events


def test_event_schema_equals_tpufw():
    assert events.SCHEMA == j_events.SCHEMA
    assert events.LEVELS == j_events.LEVELS


@pytest.mark.parametrize("event", [
    {"kind": "serve_migration", "pages": 3, "bytes": 10, "wall_s": 0.1,
     "direction": "export"},
    {"kind": "router_request", "tenant": "t", "replica": "d0",
     "latency_s": 0.2},
    {"kind": "serve_migration", "pages": 3},  # missing fields
    {"kind": "no_such_kind"},
    {"kind": "step", "level": "loud", "step": 1, "loss": 1.0,
     "step_time_s": 1.0, "data_wait_s": 0.0},
])
def test_event_lines_equal_tpufw(event, tmp_path):
    """The same emit writes the same line (but for the clock) in both
    packages, or raises the same error."""
    out = []
    for pkg in sorted(PKGS):
        ev_mod = PKGS[pkg][0]
        path = tmp_path / f"{pkg}.jsonl"
        log = ev_mod.EventLog(str(path), process=0)
        fields = dict(event)
        kind = fields.pop("kind")
        try:
            log.emit(kind, **fields)
            err = None
        except (ValueError, KeyError) as e:
            err = type(e).__name__
        log.close()
        lines = ev_mod.read_events(str(path)) if path.exists() else []
        for ln in lines:
            ln.pop("ts", None)
        out.append((err, lines))
    assert out[0] == out[1]
