"""The port's tick batcher (``TPUFW_SERVE_SLOTS=0``) against ``tpufw``'s
(``tests/test_serve.py``: the ``_take_tick`` policy, speculation with
the tick batcher, warmup invisible to metrics, failure isolation), on
llama3_tiny in fp32 with the Flax weights in both packages' servers:

- ``_take_tick``: compatible requests coalesce, the row budget closes
  FIFO, a sampling mismatch is diverted keeping its order, a stream runs
  solo;
- the same requests through ``tpufw``'s tick server and the port's give
  the same greedy tokens, ``batched_with`` and ``tpufw_serve_*`` counts,
  streamed or not;
- whole-batch speculation (a self-draft) gives the plain tokens, and the
  ``spec_iterations_total``/``spec_emitted_total`` counters move as
  ``tpufw``'s do;
- a request that cannot fit fails alone; warmup moves no counter and no
  seed; shutdown stops the batcher's thread.
"""

import json
import queue
import threading
import time
import urllib.request

import pytest

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.workloads import serve as j_serve
from tpufw_torch.infer import SamplingConfig
from tpufw_torch.workloads import serve

PROMPTS = [[1, 5, 9], [2, 7], list(range(3, 60))]


# ---- _Batcher._take_tick policy (no server, no device work) ----


def _bare_batcher(max_rows=64):
    """A _Batcher with no worker thread: _take_tick is pure queue policy,
    testable directly against a hand-built queue."""
    b = serve._Batcher.__new__(serve._Batcher)
    b._queue = []
    b._cv = threading.Condition()
    b._closed = False
    b.max_rows = max_rows
    b.wait_s = 0.0
    b._metrics = None
    return b


def _pending(n_rows=1, sampling=None, stream=False):
    return serve._Pending([[1]] * n_rows, 4, sampling,
                          stream_q=object() if stream else None)


def test_take_tick_coalesces_compatible_requests():
    b = _bare_batcher()
    pends = [_pending(), _pending(2), _pending()]
    b._queue = list(pends)
    assert b._take_tick() == pends
    assert b._queue == []


def test_take_tick_budget_closes_fifo():
    """Once a same-config request misses the row budget, no later
    same-config request may overtake it, even one small enough to fit."""
    b = _bare_batcher(max_rows=3)
    a, big, small = _pending(2), _pending(2), _pending(1)
    b._queue = [a, big, small]
    assert b._take_tick() == [a]
    assert b._queue == [big, small]
    assert b._take_tick() == [big, small]


def test_take_tick_diverts_sampling_mismatch_keeping_order():
    hot = SamplingConfig(temperature=1.0)
    b = _bare_batcher()
    a, m, c = _pending(), _pending(sampling=hot), _pending()
    b._queue = [a, m, c]
    assert b._take_tick() == [a, c]
    assert b._queue == [m]
    assert b._take_tick() == [m]  # the mismatch heads the next tick


def test_take_tick_stream_runs_solo():
    b = _bare_batcher()
    s, a = _pending(stream=True), _pending()
    b._queue = [s, a]
    assert b._take_tick() == [s]
    assert b._queue == [a]
    b2 = _bare_batcher()
    x, s2, y = _pending(), _pending(stream=True), _pending()
    b2._queue = [x, s2, y]
    assert b2._take_tick() == [x, y]  # a stream never joins a batch
    assert b2._queue == [s2]


def test_take_tick_returns_nothing_once_closed():
    b = _bare_batcher()
    b._queue = [_pending()]
    b._closed = True
    assert b._take_tick() == []


# ---- the tick server, against tpufw's on the same weights ----


@pytest.fixture
def servers(clear_tpufw_env):
    """``start(pkg, **env)``: a tick server of ``tpufw`` ("jax") or the
    port ("port") over llama3_tiny in fp32 with the same Flax weights
    (``build_generator`` and, with ``draft=True``, the draft replaced by
    the target itself). Every server started is shut down."""
    jmodel, params, model = decode_pair()
    clear_tpufw_env.setenv("TPUFW_SERVE_SLOTS", "0")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    clear_tpufw_env.setattr(
        j_serve, "build_generator",
        lambda: (jmodel, params, jmodel.cfg, False))
    clear_tpufw_env.setattr(
        serve, "build_generator", lambda: (model, model.cfg, False))
    started = []

    def start(pkg, draft=False, **env):
        for k, v in env.items():
            clear_tpufw_env.setenv(f"TPUFW_{k}", v)
        if draft:
            clear_tpufw_env.setenv("TPUFW_DRAFT_K", "3")
            clear_tpufw_env.setattr(
                j_serve, "build_draft_generator",
                lambda sampling: (jmodel, params, 3))
        if pkg == "jax":
            srv = j_serve._Server(port=0, max_new_tokens=6)
        else:
            srv = serve._Server(0, 6, draft_model=model if draft else None)
        started.append(srv)
        return srv

    yield start
    for srv in started:
        if isinstance(srv, serve._Server):
            srv.shutdown()
            assert not srv._batcher._thread.is_alive()


def _counts(srv):
    """The tpufw_serve_* counters of a server's exposition."""
    text = srv.metrics.render({})
    return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
            if ln.startswith("tpufw_serve_") and "seconds" not in ln}


def _drive(srv):
    """One two-row request, one 57-token prompt (the tiny model's 128-slot
    cache fits one length bucket, 64) and a stream, one after another;
    returns everything observed."""
    return [srv.generate(PROMPTS[:2], 5), srv.generate(PROMPTS[2:], 3),
            list(srv.generate_stream([[4, 4, 4], [6]], 7))]


def _together(srv, requests):
    """``requests`` [(prompts, max_new)] sent at once; their results."""
    res = [None] * len(requests)
    barrier = threading.Barrier(len(requests))

    def go(i, prompts, n):
        barrier.wait()
        res[i] = srv.generate(prompts, n)

    threads = [threading.Thread(target=go, args=(i, *r))
               for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return res


def test_tick_server_gives_jax_tokens_and_counts(servers):
    """The same traffic through both tick servers: the same greedy rows
    (sliced to each request's max_new from the power-of-two bucket),
    ``batched_with``, stream chunks and tpufw_serve_* counters."""
    jsrv = servers("jax", WARMUP="0")
    want = _drive(jsrv)
    srv = servers("port", WARMUP="0")
    assert isinstance(srv._batcher, serve._Batcher)
    got = _drive(srv)
    assert got == want
    assert got[0][1] == 1  # one request per tick, sent alone
    assert _counts(srv) == _counts(jsrv)
    assert srv._tick_index == jsrv._tick_index == 3
    assert "tpufw_serve_slots_total" not in srv.metrics.render(
        srv._gauge_values())


def test_tick_coalesces_concurrent_requests(servers):
    """Requests arriving inside the coalescing window share one tick
    (``batched_with``) and get the tokens they get alone."""
    srv = servers("port", WARMUP="0", BATCH_WAIT_MS="300")
    alone = [srv.generate([[8, 9]], 4)[0], srv.generate([[10]], 6)[0]]
    ticks = _counts(srv)["tpufw_serve_ticks_total"]
    res = _together(srv, [([[8, 9]], 4), ([[10]], 6)])
    assert [r[0] for r in res] == alone
    assert [r[1] for r in res] == [2, 2]
    assert _counts(srv)["tpufw_serve_ticks_total"] == ticks + 1


def test_tick_speculative_self_draft_matches_plain_and_jax(servers):
    """TPUFW_SERVE_SLOTS=0 with a draft: whole-batch speculative ticks.
    A self-draft accepts every proposal, so the tokens are the plain
    ones and the pass and emission counts equal ``tpufw``'s."""
    plain = servers("port", WARMUP="0").generate(PROMPTS, 6)[0]
    jsrv = servers("jax", draft=True, WARMUP="0")
    srv = servers("port", draft=True, WARMUP="0")
    assert isinstance(srv._batcher, serve._Batcher)
    want, got = jsrv.generate(PROMPTS, 6), srv.generate(PROMPTS, 6)
    assert got == want and got[0] == plain
    c, jc = _counts(srv), _counts(jsrv)
    assert c["tpufw_serve_spec_iterations_total"] > 0
    # Emitted per batch, over the tick's power-of-two bucket of 8.
    assert c["tpufw_serve_spec_emitted_total"] == 8
    assert c == jc


def test_tick_sampled_draft_and_penalty_serve_full_length(servers):
    """Non-greedy sampling composes with the tick batcher's speculation
    (rejection resampling), and so does a per-request repetition
    penalty; each tick seeds from TPUFW_SEED + its index, so a fresh
    server replays."""
    outs = []
    for _ in range(2):
        srv = servers("port", draft=True, WARMUP="0", TEMPERATURE="0.7")
        sampled = srv.generate(PROMPTS[:2], 6)[0]
        pen = srv._parse_request({"prompts": PROMPTS[:2],
                                  "repetition_penalty": 1.3})[2]
        penalized = srv.generate(PROMPTS[:2], 6, pen)[0]
        assert all(len(o) == 6 for o in sampled + penalized)
        outs.append((sampled, penalized))
        srv.shutdown()
    assert outs[0] == outs[1]


def test_tick_failure_isolation(servers):
    """A prompt that cannot fit the KV cache fails alone; a request
    coalesced with it in the same tick still succeeds."""
    srv = servers("port", WARMUP="0", BATCH_WAIT_MS="300")
    alone = srv.generate([[1, 2, 3]], 4)[0]
    barrier = threading.Barrier(2)
    res = {}

    def bad():
        barrier.wait()
        with pytest.raises(ValueError, match="KV cache"):
            srv.generate([[1] * 140], 4)
        res["bad"] = True

    def good():
        barrier.wait()
        res["good"] = srv.generate([[1, 2, 3]], 4)[0]

    threads = [threading.Thread(target=bad), threading.Thread(target=good)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert res == {"bad": True, "good": alone}


def test_tick_warmup_invisible_to_metrics_and_seed_replay(
        servers, monkeypatch):
    """Warmup (default on) runs one tick per bucket of
    TPUFW_WARMUP_BUCKETS before the listener binds and leaves the tick
    index at 0 and every tpufw_serve_* series at 0; a spy proves it
    ran."""
    calls = []
    real = serve._Server._run_tick

    def spy(self, prompts, max_new, sampling):
        calls.append((len(prompts), max_new))
        return real(self, prompts, max_new, sampling)

    monkeypatch.setattr(serve._Server, "_run_tick", spy)
    srv = servers("port", draft=True, WARMUP_BUCKETS="1,3")
    assert calls == [(1, 8), (4, 8)]
    assert srv._tick_index == 0
    for line in srv.metrics.render({}).splitlines():
        if line.startswith("tpufw_serve_") and not line.startswith("#"):
            assert line.endswith(" 0"), line


def test_tick_http_stream_equals_json_and_close_fails_queue(servers):
    """Over HTTP: an SSE stream's chunks concatenate to the JSON output.
    Closing the batcher stops its thread and fails what is still
    queued."""
    srv = servers("port", WARMUP="0")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    deadline = time.time() + 30
    while srv.httpd is None and time.time() < deadline:
        time.sleep(0.01)
    base = f"http://127.0.0.1:{srv.port}/generate"

    def post(body):
        req = urllib.request.Request(
            base, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.read()

    body = {"prompts": PROMPTS[:2], "max_new_tokens": 5}
    js = json.loads(post(body))["outputs"]
    rows = [[], []]
    for ln in post(dict(body, stream=True)).split(b"\n\n"):
        if ln.startswith(b"data: "):
            ev = json.loads(ln[len(b"data: "):])
            for acc, r in zip(rows, ev.get("outputs", [])):
                acc.extend(r)
    assert rows == js
    srv.shutdown()
    q = queue.Queue()
    with pytest.raises(RuntimeError, match="closed"):
        srv._batcher.submit_stream([[1]], 2, None, q)


def test_tick_concurrent_submits_stress(servers):
    """24 client threads (more than this machine's cores) submitting at
    once through the batcher's shared queue, with the interpreter
    switching threads every 10 µs: every request completes, with the
    tokens it gets alone, and the token counter adds up."""
    import sys

    srv = servers("port", WARMUP="0", BATCH_WAIT_MS="20", BATCH_MAX_ROWS="8")
    prompts = [[1 + i % 5, 7] for i in range(24)]
    alone = {tuple(p): srv.generate([p], 3)[0] for p in prompts[:5]}
    before = _counts(srv)["tpufw_serve_tokens_generated_total"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = _together(srv, [([p], 3) for p in prompts])
    finally:
        sys.setswitchinterval(old)
    assert all(r is not None for r in res), "a request never completed"
    assert [r[0] for r in res] == [alone[tuple(p)] for p in prompts]
    assert max(r[1] for r in res) > 1  # some requests shared a tick
    after = _counts(srv)["tpufw_serve_tokens_generated_total"]
    assert after - before == 24 * 3
