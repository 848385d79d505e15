"""The port's front-door router (``tpufw_torch.serve.router``), replica
discovery and framed transport against ``tpufw``'s
(``tests/test_router.py``, ``tests/test_bundle.py``'s framing tests):

- the pure parts on the same inputs in both packages: the weighted-fair
  queue's pop order, every ``RouterPolicy`` pick over seeded replica
  tables, ``_parse_weights`` and ``discover_replicas``;
- ``RouterServer`` over ``LocalReplica``s of the port's tiny engines:
  greedy tokens of ``generate_text`` through router -> prefill -> bundle
  -> decode, 429 admission, sticky and re-homed sessions, prefix
  affinity, piggyback, the reprobe of an unhealthy replica, no leaked
  inflight credit on a queue timeout, the adopted trace header, the
  stage breakdown, the drained-reply re-home from the spill store (and
  the error without one), ``/replicas`` add and remove;
- a ``TcpReplica`` path over ``serve_prefill``/``serve_decode`` and the
  router's HTTP port;
- ``import tpufw_torch.serve.router`` loads no torch.

Every socket binds port 0 and every wait has a deadline of seconds.
"""

import functools
import json
import socket
import struct
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.cluster.discovery import discover_replicas as j_discover
from tpufw.serve import router as j_router
from tpufw.serve import transport as j_transport
from tpufw_torch.cluster.discovery import discover_replicas
from tpufw_torch.infer import SamplingConfig, generate_text
from tpufw_torch.infer.spill import SpillTier
from tpufw_torch.obs import reqtrace
from tpufw_torch.obs.registry import Registry
from tpufw_torch.serve import bundle, router, transport
from tpufw_torch.serve.roles import (
    DecodeEngine,
    PrefillEngine,
    serve_decode,
    serve_prefill,
)
from tpufw_torch.serve.router import (
    LocalReplica,
    ReplicaState,
    RouterPolicy,
    RouterServer,
    TcpReplica,
)

PAGE = 16
SEQ = 64
MAX_NEW = 5
GREEDY = SamplingConfig()
BASE = list(range(3, 37))
T = 10.0  # seconds any one socket wait may take


# ---------------------------------------------- pure parts vs tpufw


@pytest.mark.parametrize("seed", range(4))
def test_wfq_pop_order_equals_tpufw(seed):
    """A seeded interleaving of pushes (tenants of weights 2, 1, 0.5 and
    an unlisted one; random costs) and pops drains both packages' queues
    in the same order with the same virtual finish times and depths."""
    rng = np.random.default_rng(seed)
    weights = {"a": 2.0, "b": 1.0, "c": 0.5}
    ours = router.WeightedFairQueue(weights)
    theirs = j_router.WeightedFairQueue(weights)
    got, want = [], []
    for i in range(60):
        if len(ours) and rng.random() < 0.4:
            got.append(ours.pop())
            want.append(theirs.pop())
        else:
            tenant = str(rng.choice(["a", "b", "c", "anon"]))
            cost = float(rng.integers(1, 40))
            got.append(ours.push(tenant, cost, (tenant, i)))
            want.append(theirs.push(tenant, cost, (tenant, i)))
        assert ours.depths() == theirs.depths()
    while len(theirs):
        got.append(ours.pop())
        want.append(theirs.pop())
    assert got == want and len(ours) == 0


def test_wfq_weighted_service_under_contention():
    q = router.WeightedFairQueue({"a": 2.0, "b": 1.0})
    for i in range(6):
        q.push("a", 10, ("a", i))
        q.push("b", 10, ("b", i))
    order = [q.pop() for _ in range(len(q))]
    assert [t for t, _ in order[:9]].count("a") == 6
    assert [i for t, i in order if t == "a"] == list(range(6))


def _tables(seed, cls):
    """Seeded (prefill, decode) replica tables of ``cls`` (either
    package's ReplicaState), with digests of BASE on some replicas."""
    rng = np.random.default_rng(seed)
    digests = bundle.chunk_digests(BASE + [1] * 20, PAGE, 3)
    out = {"prefill": [], "decode": []}
    for role, n in (("prefill", 3), ("decode", 4)):
        for i in range(n):
            total = int(rng.integers(8, 40))
            r = cls(
                f"{role[0]}{i}", role, pages_total=total,
                pages_in_use=int(rng.integers(0, total + 1)),
                slots_total=4, slots_active=int(rng.integers(0, 5)),
                prefill_inflight=int(rng.integers(0, 3)),
                healthy=bool(rng.random() > 0.15),
                draining=int(rng.random() < 0.15),
            )
            if rng.random() < 0.5:
                r.prefill_chunk_pages = 2
                r.piggyback_waterline = float(rng.choice([0.1, 0.3]))
            if rng.random() < 0.5:
                r.prefix_digests = tuple(
                    digests[: int(rng.integers(1, len(digests) + 1))])
            out[role].append(r)
    return out, digests


@pytest.mark.parametrize("seed", range(8))
def test_policy_picks_equal_tpufw(seed):
    """Every pick of both packages' RouterPolicy over the same seeded
    replica tables, with and without digests and sessions, in the same
    sequence: the same answers and the same affinity-hit counts."""
    ours = RouterPolicy(saturation=0.9, affinity_k=3)
    theirs = j_router.RouterPolicy(saturation=0.9, affinity_k=3)
    for step in range(6):
        t_ours, digests = _tables(seed * 10 + step, ReplicaState)
        t_theirs, _ = _tables(seed * 10 + step, j_router.ReplicaState)
        for n_pages in (1, 3, 9):
            for digs in ((), digests):
                for session in ("", "s1", "s2"):
                    assert ours.pick_decode(
                        session, t_ours["decode"], n_pages, digs
                    ) == theirs.pick_decode(
                        session, t_theirs["decode"], n_pages, digs)
                assert ours.pick_prefill(t_ours["prefill"], digs) == \
                    theirs.pick_prefill(t_theirs["prefill"], digs)
                for mc in (None, 1, 2):
                    assert ours.pick_piggyback(
                        t_ours["decode"], n_pages, mc, digs
                    ) == theirs.pick_piggyback(
                        t_theirs["decode"], n_pages, mc, digs)
            for a, b in zip(t_ours["decode"], t_theirs["decode"]):
                assert ours.decode_fits(a, n_pages) == \
                    theirs.decode_fits(b, n_pages)
                assert a.score() == b.score()
        if step == 3:
            ours.forget_session("s1")
            theirs.forget_session("s1")
    assert ours.affinity_hits == theirs.affinity_hits
    assert ours._affinity == theirs._affinity


@pytest.mark.parametrize("spec", [
    "a:2, b:1.5", "a:2,junk,x:,:3,", "", "vip:x,batch:0.25",
])
def test_parse_weights_equals_tpufw(spec):
    assert router._parse_weights(spec) == j_router._parse_weights(spec)


@pytest.mark.parametrize("env", [
    {"TPUFW_ROUTER_PREFILL": "p0:9001, p1:9002",
     "TPUFW_ROUTER_DECODE": "d0", "TPUFW_SERVE_PEER_PORT": "8123",
     "JOBSET_NAME": "ignored-when-explicit"},
    {"JOBSET_NAME": "tpufw-serve-disagg",
     "TPUFW_ROUTER_PREFILL_REPLICAS": "2",
     "TPUFW_ROUTER_DECODE_REPLICAS": "1"},
    {"JOBSET_NAME": "js", "TPUFW_ROUTER_PREFILL_REPLICAS": "1",
     "TPUFW_ROUTER_DECODE_REPLICAS": "2", "TPUFW_SERVE_PEER_PORT": "9"},
    {},
    {"JOBSET_NAME": "x"},
    {"TPUFW_ROUTER_PREFILL": "p0:1"},
], ids=["explicit", "jobset", "jobset_port", "none", "no_counts",
        "one_sided"])
def test_discovery_equals_tpufw(env):
    """Both packages resolve the same env to the same addresses, or
    refuse it with the same message."""
    def run(fn):
        try:
            return fn(env)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(discover_replicas) == run(j_discover)


# ------------------------------------------------------------ framing


def test_loopback_roundtrips_frames_both_ways():
    lt = transport.LoopbackTransport()
    lt.a.send(b"TPFB" + bytes(range(200)))
    assert lt.b.recv(timeout=1.0) == b"TPFB" + bytes(range(200))
    lt.b.send(b"ack")
    assert lt.a.recv(timeout=1.0) == b"ack"
    with pytest.raises(transport.TransportError, match="timeout"):
        lt.a.recv(timeout=0.01)


def test_frame_size_cap(monkeypatch):
    monkeypatch.setattr(transport, "MAX_FRAME", 8)
    with pytest.raises(transport.TransportError, match="too large"):
        transport.pack_frame(b"x" * 9)
    assert transport.pack_frame(b"abc") == j_transport.pack_frame(b"abc")


def test_tcp_transport_frames_and_error_replies():
    def handler(frame: bytes) -> bytes:
        if frame == b"boom":
            raise RuntimeError("handler exploded")
        return b"echo:" + frame

    srv, port = transport.serve_frames(0, host="127.0.0.1")
    threading.Thread(target=transport.accept_loop, args=(srv, handler),
                     daemon=True).start()
    try:
        with transport.TcpTransport("127.0.0.1", port, timeout=T) as c:
            c.send(b"hello")
            assert c.recv() == b"echo:hello"
            c.send(b"boom")
            assert "handler exploded" in json.loads(c.recv())["error"]
        # The other package's client speaks the same framing.
        reply, _rtt = j_transport.rpc("127.0.0.1", port, b"x", timeout=T)
        assert reply == b"echo:x"
    finally:
        srv.close()


def test_read_exact_detects_midframe_close():
    a, b = socket.socketpair()
    try:
        b.settimeout(T)
        a.sendall(struct.pack(">I", 100) + b"short")
        a.close()
        with pytest.raises(transport.TransportError, match="mid-frame"):
            transport.recv_frame(b)
    finally:
        b.close()


# ----------------------------------- RouterServer over tiny engines


@functools.lru_cache(maxsize=None)
def _model():
    return decode_pair(max_seq_len=SEQ)[2]


@functools.lru_cache(maxsize=None)
def _want(prompt):
    return generate_text(_model(), [list(prompt)], max_new_tokens=MAX_NEW,
                         sampling=GREEDY)[0]


def _pe(name="p0", **kw):
    return LocalReplica(name, PrefillEngine(_model(), sampling=GREEDY,
                                            page=PAGE, **kw))


def _de(name="d0", **kw):
    kw.setdefault("n_slots", 2)
    return LocalReplica(name, DecodeEngine(_model(), sampling=GREEDY,
                                           page=PAGE, chunk=2, **kw))


class _Flaky(LocalReplica):
    """A local replica whose next ``fail`` calls of ``method`` raise."""

    def __init__(self, inner, method, fail=1):
        super().__init__(inner.name, inner._engine)
        self.method, self.fail, self.traces = method, fail, []

    def _maybe_fail(self, method):
        if method == self.method and self.fail > 0:
            self.fail -= 1
            raise RuntimeError(f"{method} replica down")

    def signals(self):
        self._maybe_fail("signals")
        return super().signals()

    def prefill(self, prompt, max_new, trace=None, session=None):
        self.traces.append(trace)
        self._maybe_fail("prefill")
        return super().prefill(prompt, max_new, trace=trace,
                               session=session)

    def decode(self, data):
        self._maybe_fail("decode")
        return super().decode(data)


class _DrainsMidRequest(LocalReplica):
    """Splices the bundle, then drains before any decode chunk: the reply
    is the drained one, the session exported to the spill tier."""

    def decode(self, data):
        slot = self._engine.submit(data)
        self._engine.drain()
        return {**self._engine.collect_ex(slot), **self._engine.signals()}


@pytest.fixture
def servers():
    made = []

    def make(*a, **kw):
        kw.setdefault("port", 0)
        srv = RouterServer(*a, **kw)
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.close()


def _gen(srv, prompt, **kw):
    return srv.generate({"prompt": list(prompt), "max_new": MAX_NEW, **kw})


def test_router_serves_generate_text_tokens_with_stage_breakdown(servers):
    reg = Registry()
    srv = servers([_pe()], [_de("d0"), _de("d1")], registry=reg)
    for prompt in ([1, 5, 9], BASE, BASE[:PAGE] + [99, 98]):
        code, body, headers = _gen(srv, prompt, tenant="vip")
        assert code == 200 and body["tokens"] == _want(tuple(prompt))
        assert body["migration_pages"] == -(-(len(prompt) + MAX_NEW - 1)
                                            // PAGE)
        hdr = dict(headers)[reqtrace.HEADER]
        assert hdr.startswith(body["trace"] + "-") and hdr.endswith("-vip")
        stages = body["stages"]
        # The prefill engine's own stages ride the bundle header.
        assert {"queue_wait", "admit", "prefill_queue", "prefill_admit",
                "prefill_compute", "page_export", "wire", "splice",
                "first_decode"} <= set(stages)
        ssum = sum(v for k, v in stages.items()
                   if k not in ("first_decode", "prefill_queue",
                                "prefill_admit", "prefill_compute",
                                "page_export", "wire"))
        ssum += stages["prefill_queue"] + stages["prefill_admit"] + \
            stages["prefill_compute"] + stages["page_export"] + \
            stages["wire"]
        assert body["ttft_s"] == pytest.approx(ssum, abs=2e-3)
        assert stages["splice"] > 0.0 and stages["prefill_compute"] > 0.0
    text = srv.render_metrics()
    assert "tpufw_router_requests_total 3" in text
    assert f"tpufw_router_tokens_total {3 * MAX_NEW}" in text
    assert 'tpufw_slo_requests_total{tenant="vip"} 3' in text
    h = srv.health()
    assert h["ok"] is True and h["inflight"] == 0
    assert set(h["replicas"]) == {"p0", "d0", "d1"}
    assert h["replicas"]["d0"]["pages_total"] == 2 * SEQ // PAGE


def test_admission_rejects_with_retry_after_when_saturated(servers):
    reg = Registry()
    # Decode arena of 3 usable pages: a 5-page row never fits.
    srv = servers([_pe()], [_de(arena_pages=4)], registry=reg,
                  policy=RouterPolicy(retry_after_s=7))
    code, body, headers = srv.generate(
        {"prompt": BASE + BASE[:20], "max_new": 20, "tenant": "vip"})
    assert code == 429 and "saturated" in body["error"]
    assert dict(headers)["Retry-After"] == "7"
    c = reg.counter("tpufw_router_rejects_total")
    assert c.value(tenant="vip") == 1.0 and c.value(tenant="x") == 0.0
    code, _b, _h = _gen(srv, [1, 5, 9])  # a small request still fits
    assert code == 200


def test_sticky_session_then_rehomed_when_its_replica_leaves(servers):
    srv = servers([_pe()], [_de("d0"), _de("d1")])
    code, body, _h = _gen(srv, [4, 4, 8], session="chat")
    first = body["replica"]
    code, body, _h = _gen(srv, [4, 4, 8, 9], session="chat")
    assert code == 200 and body["replica"] == first
    assert body["tokens"] == _want((4, 4, 8, 9))
    srv.remove_replica(first)
    code, body, _h = _gen(srv, [4, 4, 8, 9, 10], session="chat")
    assert code == 200 and body["replica"] != first
    assert srv.policy._affinity["chat"] == body["replica"]


def test_prefix_affinity_steers_to_the_warm_prefill(servers):
    warm = _pe("p1", affinity_k=2)
    warm._engine.prefill(BASE, MAX_NEW)  # p1's trie holds BASE's pages
    srv = servers([_pe("p0", affinity_k=2), warm], [_de()],
                  policy=RouterPolicy(affinity_k=2))
    code, body, _h = _gen(srv, BASE[:PAGE * 2] + [7, 7])
    assert code == 200 and body["prefill_replica"] == "p1"
    assert body["tokens"] == _want(tuple(BASE[:PAGE * 2] + [7, 7]))
    assert "tpufw_router_prefix_affinity_hits_total 1" in \
        srv.render_metrics()


def test_piggyback_when_no_prefill_replica_is_healthy(servers):
    down = _Flaky(_pe(), "signals", fail=10)
    srv = servers([down], [_de(prefill_chunk_pages=1, piggyback=0.25,
                               n_slots=4)])
    code, body, _h = _gen(srv, BASE)
    assert code == 200 and body["piggyback"] is True
    assert body["tokens"] == _want(tuple(BASE))
    assert body["migration_pages"] == 0 and body["replica"] == "d0"
    assert "tpufw_router_piggyback_total 1" in srv.render_metrics()


def test_errors_blame_the_replica_that_failed_and_it_recovers(servers):
    pf = _Flaky(_pe(), "prefill")
    srv = servers([pf], [_de()])
    code, _b, _h = _gen(srv, [1, 5, 9])
    assert code == 502
    with srv._lock:
        assert not srv._states["p0"].healthy
        assert srv._states["d0"].healthy
    # No pickable prefill replica left: the forced reprobe brings it
    # back, and the request completes.
    code, body, _h = _gen(srv, [1, 5, 9])
    assert code == 200 and body["tokens"] == _want((1, 5, 9))
    srv2 = servers([_pe()], [_Flaky(_de(), "decode")])
    assert _gen(srv2, [2, 7])[0] == 502
    with srv2._lock:
        assert not srv2._states["d0"].healthy
    code, body, _h = _gen(srv2, [2, 7])
    assert code == 200 and body["tokens"] == _want((2, 7))


def test_queue_timeout_does_not_leak_inflight_credit(servers):
    srv = servers([_pe()], [_de()], max_inflight=1)
    with srv._lock:
        srv._inflight = 1  # a long request holds the credit
    assert not srv._admit("vip", 1.0, timeout=0.05)
    srv._release()
    with srv._lock:
        assert srv._inflight == 0
    assert srv._admit("t", 1.0, timeout=1.0)
    srv._release()
    text = srv.render_metrics()
    assert 'tpufw_router_deferred_total{tenant="vip"} 1' in text
    assert 'tpufw_router_queue_depth{tenant="vip"} 0' in text


def test_inbound_trace_header_is_adopted_not_reminted(servers):
    pf = _Flaky(_pe(), "none")
    srv = servers([pf], [_de()])
    ctx = reqtrace.mint("vip")
    code, body, headers = srv.generate(
        {"prompt": [1, 5, 9], "max_new": MAX_NEW, "tenant": "vip"},
        trace_header=ctx.wire())
    assert code == 200 and body["trace"] == ctx.trace_id
    assert dict(headers)[reqtrace.HEADER].startswith(ctx.trace_id)
    assert pf.traces[-1].startswith(ctx.trace_id + "-")
    code, body, _h = srv.generate({"prompt": [1], "max_new": 2},
                                  trace_header="not a trace")
    assert code == 200 and body["trace"] != ctx.trace_id


def test_drained_reply_rehomes_the_session_from_the_spill_store(
        servers, tmp_path):
    """d0 drains mid-request: the session's slot goes to the shared
    spill directory, the router reads it back and d1 finishes it with
    the undisturbed tokens."""
    d0 = _DrainsMidRequest("d0", DecodeEngine(
        _model(), sampling=GREEDY, page=PAGE, chunk=2, n_slots=2,
        spill=SpillTier(64, str(tmp_path))))
    srv = servers([_pe()], [d0, _de("d1")], spill_dir=str(tmp_path))
    code, body, _h = _gen(srv, BASE, session="mig")
    assert code == 200 and body["resumed"] is True
    assert body["replica"] == "d1" and body["tokens"] == _want(tuple(BASE))
    assert bundle.load_session(str(tmp_path), "mig") is None  # consumed
    assert srv.policy._affinity["mig"] == "d1"
    assert srv.health()["replicas"]["d0"]["draining"] is True
    assert "tpufw_router_session_rehomes_total 1" in srv.render_metrics()


def test_drained_reply_without_spill_store_is_an_error(servers):
    d0 = _DrainsMidRequest("d0", DecodeEngine(
        _model(), sampling=GREEDY, page=PAGE, chunk=2, n_slots=2))
    srv = servers([_pe()], [d0])
    code, body, _h = _gen(srv, [1, 5, 9], session="mig")
    assert code == 502 and "draining" in body["error"]


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=T) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=T) as resp:
        return resp.read().decode()


def test_tcp_replicas_behind_the_router_http_port(servers):
    """serve_prefill/serve_decode on loopback TCP, TcpReplica clients, the
    router's HTTP front end: /generate gives generate_text's tokens,
    /healthz and /metrics count what was sent, /replicas adds a TCP
    decode replica and drains it away."""
    psrv, pport = serve_prefill(PrefillEngine(_model(), sampling=GREEDY,
                                              page=PAGE), 0)
    dsrv, dport = serve_decode(DecodeEngine(_model(), sampling=GREEDY,
                                            page=PAGE, n_slots=2), 0)
    d2srv, d2port = serve_decode(DecodeEngine(_model(), sampling=GREEDY,
                                              page=PAGE, n_slots=2), 0)
    try:
        srv = servers(
            [TcpReplica("p0", "127.0.0.1", pport, "prefill", timeout=T)],
            [TcpReplica("d0", "127.0.0.1", dport, "decode", timeout=T)])
        for prompt in ([1, 5, 9], BASE):
            code, body = _post(srv.port, "/generate",
                               {"prompt": prompt, "max_new": MAX_NEW})
            assert code == 200 and body["tokens"] == _want(tuple(prompt))
            assert body["stages"]["wire"] >= 0.0
        health = json.loads(_get(srv.port, "/healthz"))
        assert health["ok"] and health["inflight"] == 0
        assert health["replicas"]["d0"]["slots_active"] == 0
        metrics = _get(srv.port, "/metrics")
        assert "tpufw_router_requests_total 2" in metrics
        assert "tpufw_router_proxy_errors_total 0" in metrics
        code, body = _post(srv.port, "/generate", {"prompt": "nope"})
        assert code == 400
        code, body = _post(srv.port, "/replicas", {"op": "add",
                                                   "name": "d9"})
        assert code == 400 and "missing fields" in body["error"]
        code, body = _post(srv.port, "/replicas", {
            "op": "add", "name": "d1", "host": "127.0.0.1",
            "port": d2port, "role": "decode"})
        assert code == 200 and body["healthy"] is True
        code, body = _post(srv.port, "/replicas",
                           {"op": "remove", "name": "d0"})
        assert code == 200 and body["drained"]["drained"] is True
        code, body = _post(srv.port, "/generate",
                           {"prompt": [2, 7], "max_new": MAX_NEW})
        assert code == 200 and body["replica"] == "d1"
        code, body = _post(srv.port, "/replicas",
                           {"op": "remove", "name": "d1"})
        assert code == 400  # the last decode replica stays
    finally:
        for s in (psrv, dsrv, d2srv):
            s.close()


def test_router_import_loads_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpufw_torch.serve.router, tpufw_torch.serve; "
         "print('torch' in sys.modules)"],
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_router_refuses_the_fleet_observatory(monkeypatch, tmp_path,
                                              capsys):
    """The knob this test once saw refused now attaches the collector:
    ``TPUFW_FLEET_SCRAPE_S`` set, ``main_router`` prints ``"fleet": true``,
    its first sweep records the router and both (unreachable, so stale)
    replicas, ``tpufw``'s reader and the port's query CLI read them, and
    the collector thread is gone once the router stops."""
    from tpufw.obs import fleet as j_fleet
    from tpufw_torch.obs import fleet

    monkeypatch.setenv("TPUFW_FLEET_SCRAPE_S", "5")
    monkeypatch.setenv("TPUFW_FLEET_DIR", str(tmp_path))
    monkeypatch.setenv("TPUFW_ROUTER_PREFILL", "127.0.0.1:1")
    monkeypatch.setenv("TPUFW_ROUTER_DECODE", "127.0.0.1:1")
    monkeypatch.setenv("TPUFW_ROUTER_PORT", "0")
    series = tmp_path / fleet.SERIES_FILENAME
    real_sleep = router.time.sleep

    def sleep(s):
        if s < 3600:
            return real_sleep(s)
        for _ in range(500):  # the collector's first sweep
            if len(fleet.read_series(str(series))) >= 4:
                break
            real_sleep(0.01)
        raise KeyboardInterrupt

    monkeypatch.setattr(router.time, "sleep", sleep)
    assert router.main_router() == 0
    banner = json.loads(capsys.readouterr().out.splitlines()[0])
    assert banner["serving_role"] == "router" and banner["fleet"] is True
    recs = j_fleet.read_series(str(series))
    by = {r["replica"]: r for r in recs}
    assert set(by) == {"router", "prefill-0", "decode-0", "fleet"}
    assert by["prefill-0"]["stale"] and by["decode-0"]["stale"]
    assert "tpufw_router_requests_total" in by["router"]["series"]
    assert by["fleet"]["series"]["tpufw_fleet_replicas_unhealthy"] == 2.0
    assert fleet.main(["query", "--dir", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["replicas"]) == {"router", "prefill-0", "decode-0"}
    assert "fleet-collector" not in [t.name for t in threading.enumerate()]
