"""The port's HTTP server against ``tpufw``'s (``tests/test_serve.py``
server tests), on llama3_tiny in fp32: ``build_generator`` is replaced by
a port model holding the Flax weights, so every greedy output can be held
to ``tpufw``'s ``generate_text`` token for token.

- ``/generate`` with ids and texts, 400s for bad bodies, ``/healthz``,
  ``/debug/profile`` 404 (no telemetry);
- SSE streaming: chunk events concatenate to the JSON output;
- ``/v1/completions``;
- continuous batching: concurrent requests share the pool and get the
  tokens they get alone; ``/metrics`` counts them;
- per-request sampling, its cap, and seed replay;
- failure isolation: a request that cannot fit fails alone;
- warmup is invisible to metrics and to seed replay.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import generate_text as j_generate_text
from tpufw_torch.workloads import serve


def _want(prompts, max_new):
    jmodel, params, _ = decode_pair()
    return j_generate_text(jmodel, params, prompts, max_new_tokens=max_new)


@pytest.fixture
def server(clear_tpufw_env):
    """Start servers on free ports (``start(max_new)``); every server
    started is shut down, its scheduler thread included."""
    model = decode_pair()[2]
    clear_tpufw_env.setattr(
        serve, "build_generator", lambda: (model, model.cfg, False)
    )
    started = []

    def start(max_new=4):
        srv = serve._Server(port=0, max_new_tokens=max_new)
        started.append(srv)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        deadline = time.time() + 30
        while srv.httpd is None and time.time() < deadline:
            time.sleep(0.01)
        srv.base = f"http://127.0.0.1:{srv.port}"
        return srv

    yield start
    for srv in started:
        srv.shutdown()
        assert not srv._batcher._thread.is_alive()


def _post(base, body, path="/generate"):
    """(status, parsed JSON body)."""
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _events(base, body):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        return [json.loads(ln.strip()[len(b"data: "):]) for ln in resp
                if ln.startswith(b"data: ")]


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _metrics(base):
    code, ctype, body = _get(base, "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    return {
        ln.split()[0]: float(ln.split()[1])
        for ln in body.decode().splitlines() if ln and not ln.startswith("#")
    }


def test_http_server_generate(server):
    srv = server()
    code, _, body = _get(srv.base, "/healthz")
    assert code == 200 and json.loads(body)["ok"] is True
    prompts = [[1, 5, 9], [2, 7]]
    code, out = _post(srv.base, {"prompts": prompts, "max_new_tokens": 3})
    assert code == 200 and out["outputs"] == _want(prompts, 3)
    code, tout = _post(srv.base, {"texts": ["hi", "ok"], "max_new_tokens": 3})
    assert code == 200 and len(tout["outputs"]) == 2
    assert all(isinstance(s, str) for s in tout["texts"])
    for bad in ({"prompts": "nope"}, {"texts": [""]}, {"texts": "hello"},
                {"prompts": [[1, 2]], "max_new_tokens": 0}):
        code, err = _post(srv.base, bad)
        assert code == 400 and "error" in err
    code, _, body = _get(srv.base, "/debug/profile?seconds=1")
    assert code == 404
    assert json.loads(body) == {"error": "profiler not configured"}
    assert _get(srv.base, "/nope")[0] == 404
    assert _post(srv.base, {}, path="/nope")[0] == 404


def test_http_debug_profile_with_telemetry(server, clear_tpufw_env,
                                          tmp_path):
    """With ``TPUFW_TELEMETRY_DIR`` the server answers ``/debug/profile``
    as ``tpufw``'s does (200 with the capture's dir and seconds, 409
    while one runs), the capture lands as a Chrome trace, ``/metrics``
    carries the goodput series, and the server's trace, goodput and
    events files are written."""
    clear_tpufw_env.setenv("TPUFW_TELEMETRY_DIR", str(tmp_path))
    srv = server(max_new=3)
    code, _, body = _get(srv.base, "/debug/profile?seconds=0.5")
    got = json.loads(body)
    assert code == 200 and got["started"] is True and got["seconds"] == 0.5
    assert got["dir"].startswith(str(tmp_path / "profile" / "ondemand-"))
    code, _, body = _get(srv.base, "/debug/profile?seconds=1")
    assert code == 409
    assert json.loads(body) == {"error": "capture already in progress"}
    code, out = _post(srv.base, {"prompts": [[1, 5, 9]]})
    assert code == 200 and out["outputs"] == _want([[1, 5, 9]], 3)
    trace = os.path.join(got["dir"], "trace.json")
    deadline = time.time() + 30
    while not os.path.exists(trace) and time.time() < deadline:
        time.sleep(0.05)
    assert "traceEvents" in json.loads(open(trace).read())
    assert "tpufw_goodput_ratio" in _metrics(srv.base)
    srv.shutdown()
    for name in ("trace-serve.json", "goodput.json", "events.jsonl",
                 "metrics.prom"):
        assert (tmp_path / name).exists(), name


def test_http_server_streaming(server, monkeypatch):
    """Chunk events of per-row new tokens concatenate to the JSON output
    (chunk 2: a 6-token request streams >= 3 events), the last event is
    done (with texts for a text request), a sampled stream serves."""
    monkeypatch.setenv("TPUFW_STREAM_CHUNK", "2")
    srv = server(8)
    prompts = [[1, 5, 9], [2, 7]]
    want = _post(srv.base, {"prompts": prompts, "max_new_tokens": 6})[1]
    assert want["outputs"] == _want(prompts, 6)
    events = _events(srv.base, {"prompts": prompts, "max_new_tokens": 6})
    chunks = [e["outputs"] for e in events if "outputs" in e]
    assert len(chunks) >= 3
    got = [[t for rows in chunks for t in rows[i]] for i in range(2)]
    assert got == want["outputs"]
    assert events[-1] == {"done": True}
    tevents = _events(srv.base, {"texts": ["hi", "yo"], "max_new_tokens": 6})
    assert tevents[-1]["done"] is True and len(tevents[-1]["texts"]) == 2
    sevents = _events(srv.base, {"prompts": prompts, "max_new_tokens": 6,
                                 "temperature": 100.0})
    sgot = [[t for e in sevents if "outputs" in e for t in e["outputs"][i]]
            for i in range(2)]
    assert all(len(r) == 6 for r in sgot) and sgot != want["outputs"]


def test_http_server_openai_compat(server):
    srv = server(8)
    native = _post(srv.base, {"texts": ["hi"], "max_new_tokens": 4})[1]
    code, out = _post(srv.base, {"model": "tpufw-test", "prompt": "hi",
                                 "max_tokens": 4}, path="/v1/completions")
    assert code == 200 and out["object"] == "text_completion"
    assert out["model"] == "tpufw-test"
    assert out["choices"][0]["text"] == native["texts"][0]
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 2, "completion_tokens": 4,
                            "total_tokens": 6}
    code, tok = _post(srv.base, {"prompt": [1, 5, 9], "max_tokens": 4},
                      path="/v1/completions")
    assert code == 200 and isinstance(tok["choices"][0]["text"], str)
    for bad in ({"prompt": "hi", "stream": True}, {"prompt": "hi", "n": 2},
                {"max_tokens": 4}):
        assert _post(srv.base, bad, path="/v1/completions")[0] == 400


def test_http_server_continuous_batching(server, monkeypatch):
    """Four concurrent requests share the pool (batched_with >= 2) and get
    the tokens each gets alone, which are tpufw's; /metrics counts the
    ten requests."""
    monkeypatch.setenv("TPUFW_BATCH_WAIT_MS", "100")
    srv = server(4)
    prompts = [[1, 5, 9], [2, 7], [3], [4, 4, 4, 4]]
    _post(srv.base, {"prompts": prompts, "max_new_tokens": 16})
    _post(srv.base, {"prompts": [prompts[0]], "max_new_tokens": 16})
    seq = [_post(srv.base, {"prompts": [p], "max_new_tokens": 16})[1]
           ["outputs"][0] for p in prompts]
    assert seq == _want(prompts, 16)
    results = {}
    gate = threading.Barrier(4)

    def worker(i):
        gate.wait()
        results[i] = _post(srv.base,
                           {"prompts": [prompts[i]], "max_new_tokens": 16})[1]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert max(r["batched_with"] for r in results.values()) >= 2
    assert [results[i]["outputs"][0] for i in range(4)] == seq
    m = _metrics(srv.base)
    assert m["tpufw_serve_requests_total"] == 10
    assert m["tpufw_serve_request_errors_total"] == 0
    assert m["tpufw_serve_tokens_generated_total"] == 16 * 13
    assert m["tpufw_serve_retired_rows_total"] == 13
    assert m["tpufw_serve_request_seconds_total"] > 0
    assert m["tpufw_serve_slots_occupied"] == 0
    assert m["tpufw_serve_slots_total"] == 8
    assert m["tpufw_serve_queue_depth"] == 0


def test_http_server_per_request_sampling(server, monkeypatch):
    """Sampled output differs from greedy and from a re-post; an invalid
    value and a config past TPUFW_MAX_SAMPLING_CONFIGS 400; explicit
    defaults share the greedy pool; a second server with the same
    TPUFW_SEED replays the same sampled tokens."""
    monkeypatch.setenv("TPUFW_MAX_SAMPLING_CONFIGS", "1")
    body = {"prompts": [[1, 5, 9]], "max_new_tokens": 6}
    hot = dict(body, temperature=100.0)

    def session(srv):
        greedy = _post(srv.base, body)[1]["outputs"]
        return greedy, [_post(srv.base, hot)[1]["outputs"] for _ in range(2)]

    srv = server(6)
    greedy, sampled = session(srv)
    assert greedy == _want([[1, 5, 9]], 6)
    assert sampled[0] != greedy and sampled[1] != sampled[0]
    code, err = _post(srv.base, dict(body, temperature=-1.0))
    assert code == 400 and "temperature" in err["error"]
    code, err = _post(srv.base, dict(body, temperature=50.0))
    assert code == 400 and "sampling configs" in err["error"]
    code, out = _post(srv.base, dict(body, temperature=0.0))
    assert code == 200 and out["outputs"] == greedy
    assert session(server(6)) == (greedy, sampled)


def test_http_server_batching_failure_isolation(server, monkeypatch):
    """A 140-token prompt overflows the 128-slot cache and fails alone
    (400); the request admitted beside it succeeds."""
    monkeypatch.setenv("TPUFW_BATCH_WAIT_MS", "150")
    srv = server(4)
    results = {}

    def worker(name, prompts):
        results[name] = _post(srv.base,
                              {"prompts": prompts, "max_new_tokens": 4})

    threads = [
        threading.Thread(target=worker, args=("bad", [[1] * 140])),
        threading.Thread(target=worker, args=("good", [[1, 2, 3]])),
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert results["bad"][0] == 400 and "KV cache" in results["bad"][1]["error"]
    assert results["good"][0] == 200
    assert results["good"][1]["outputs"] == _want([[1, 2, 3]], 4)
    assert _metrics(srv.base)["tpufw_serve_request_errors_total"] == 1


@pytest.mark.parametrize("page", ["0", "16"])
def test_warmup_invisible_to_metrics_and_seed_replay(server, monkeypatch,
                                                     page):
    """The warmup request runs (a spy sees it) and leaves the stream
    indices at 0 and every tpufw_serve_ series at 0."""
    monkeypatch.setenv("TPUFW_SERVE_PAGE", page)
    calls = []
    real_admit = serve._SlotScheduler._admit_job

    def admit_spy(self, req, job, slot, grant=None):
        calls.append(slot)
        return real_admit(self, req, job, slot, grant)

    monkeypatch.setattr(serve._SlotScheduler, "_admit_job", admit_spy)
    srv = server(4)
    assert calls, "warmup never ran"
    assert srv._batcher._job_index == 0 and srv._batcher._chunk_index == 0
    for line in srv.metrics.render({}).splitlines():
        if line.startswith("tpufw_serve_"):
            assert line.endswith(" 0"), line


SPEC_SERVERS = {
    "draft_model": {"TPUFW_DRAFT_MODEL": "llama3_tiny", "TPUFW_DRAFT_K": "3",
                    "TPUFW_DEVICE": "cpu", "TPUFW_SERVE_PAGE": "16"},
    "spec_ngram": {"TPUFW_SERVE_SPEC_K": "4"},
    "prefill_chunk": {"TPUFW_SERVE_PAGE": "16",
                      "TPUFW_SERVE_PREFILL_CHUNK": "1"},
}


@pytest.mark.parametrize("mode", sorted(SPEC_SERVERS))
def test_http_server_spec_and_chunked_series(server, monkeypatch, mode):
    """The speculation and chunked-prefill servers answer with tpufw's
    greedy tokens and expose the tpufw_spec_* / tpufw_prefill_* series,
    at 0 after the warmup; TPUFW_DRAFT_MODEL builds the scheduler's draft
    pool, which shares the target's page allocator and holds no page
    once the traffic drains."""
    for k, v in SPEC_SERVERS[mode].items():
        monkeypatch.setenv(k, v)
    srv = server(6)
    spec = mode != "prefill_chunk"
    names = (("tpufw_spec_accept_rate", "tpufw_spec_fallback_slots",
              "tpufw_spec_wasted_draft_flops_total") if spec else
             ("tpufw_prefill_chunks_total", "tpufw_prefill_resumes_total",
              "tpufw_prefill_inflight"))
    before = _metrics(srv.base)
    assert all(before[n] == 0 for n in names)
    prompts = [[1, 5, 9, 1, 5, 9, 1, 5], list(range(3, 40))]
    code, out = _post(srv.base, {"prompts": prompts, "max_new_tokens": 6})
    assert code == 200 and out["outputs"] == _want(prompts, 6)
    after = _metrics(srv.base)
    b = srv._batcher
    if spec:
        assert b.spec_passes > 0
        assert 0 <= after["tpufw_spec_accept_rate"] <= 1
    else:
        assert after["tpufw_prefill_chunks_total"] >= 3
    if mode == "draft_model":
        assert b._draft_model is not None and b.spec_k == 3
        assert b._draft_model.cfg.n_layers == 2
        assert b._draft_pool.allocator is b.pool.allocator
        assert after["tpufw_spec_wasted_draft_flops_total"] >= 0
        assert "tpufw_serve_spec_iterations_total" in after
        assert b.pages_in_use == len(b.pool.prefix)
