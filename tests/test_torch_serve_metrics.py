"""What the port's server shows its clients, against ``tpufw``:

- ``tpufw_torch.obs.registry`` renders byte-identical Prometheus text to
  ``tpufw.obs.registry`` for the same sequence of operations;
- after the same request, the port's server exposes the series names and
  label sets of ``tpufw``'s server: contiguous, paged, with the latency
  breakdown histograms, with chunked prefill, with n-gram speculation and
  with a draft model;
- ``_oai_to_native`` and ``_oai_response`` give ``tpufw``'s dicts;
- ``python -m tpufw_torch.workloads.serve`` with ``TPUFW_SERVE_PORT``
  serves /generate, /v1/completions, /healthz and /metrics on the CPU.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.obs import registry as j_registry
from tpufw.workloads import serve as j_serve
from tpufw_torch.obs import registry
from tpufw_torch.workloads import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _registry_script(mod):
    reg = mod.Registry()
    reg.counter("tpufw_serve_requests_total")
    reg.counter("b_total", 'help with \\ and\nnewline "q"').inc(3)
    reg.counter("b_total").inc(0.25, tenant='a"b')
    reg.counter("b_total").inc(2, tenant="x\\y\nz")
    reg.counter("c_total").inc(12345678912345)
    reg.counter("c_total").reset()
    reg.gauge("g").set(1.5)
    reg.gauge("g").set(-2, tier="ram")
    reg.gauge("fn").set_function(lambda: 7)
    reg.gauge("broken").set_function(lambda: 1 / 0)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.0001, 0.003, 0.2, 99.0, 500.0):
        h.observe(v)
    h.observe(0.04, n=3, tenant="t")
    reg.histogram("gone_seconds").observe(1.0)
    reg.histogram("gone_seconds").reset()
    reg.histogram("small", buckets=(1, 2)).observe(1.5)
    with pytest.raises(TypeError):
        reg.gauge("b_total")
    with pytest.raises(ValueError):
        reg.counter("b_total").inc(-1)
    return reg.render(), h.value(), h.value(tenant="t"), reg.gauge("g").value()


def test_registry_exposition_is_byte_identical():
    assert _registry_script(registry) == _registry_script(j_registry)
    assert registry.CONTENT_TYPE == j_registry.CONTENT_TYPE




def _series(text):
    """{name: set of label sets} and the TYPE lines of an exposition."""
    out, types = {}, set()
    for ln in text.splitlines():
        if ln.startswith("# TYPE"):
            types.add(ln)
        elif ln and not ln.startswith("#"):
            head = ln.rsplit(" ", 1)[0]
            name, _, labels = head.partition("{")
            out.setdefault(name, set()).add(labels)
    return out, types


SERVER_ENVS = {
    "contiguous": {},
    "paged": {"TPUFW_SERVE_PAGE": "16"},
    "latency_breakdown": {"TPUFW_SERVE_LATENCY_BREAKDOWN": "1"},
    "prefill_chunk": {"TPUFW_SERVE_PAGE": "16",
                      "TPUFW_SERVE_PREFILL_CHUNK": "1"},
    "spec_ngram": {"TPUFW_SERVE_SPEC_K": "4"},
    "draft_model": {"TPUFW_DRAFT_MODEL": "llama3_tiny",
                    "TPUFW_DEVICE": "cpu"},
}


@pytest.mark.parametrize("mode", sorted(SERVER_ENVS))
def test_metrics_series_match_jax_server(clear_tpufw_env, mode):
    jmodel, params, model = decode_pair()
    for k, v in SERVER_ENVS[mode].items():
        clear_tpufw_env.setenv(k, v)
    clear_tpufw_env.setenv("TPUFW_WARMUP", "0")
    clear_tpufw_env.setattr(
        j_serve, "build_generator",
        lambda: (jmodel, params, jmodel.cfg, False))
    clear_tpufw_env.setattr(
        serve, "build_generator", lambda: (model, model.cfg, False))
    jsrv = j_serve._Server(port=0, max_new_tokens=4)
    srv = serve._Server(port=0, max_new_tokens=4)
    try:
        want, _ = jsrv.generate([[1, 5, 9], [2, 7]], 4)
        got, _ = srv.generate([[1, 5, 9], [2, 7]], 4)
        assert got == want
        jtext = jsrv.metrics.render(jsrv._gauge_values())
        text = srv.metrics.render(srv._gauge_values())
        assert _series(text) == _series(jtext)
    finally:
        srv.shutdown()


REQUESTS = {
    "text": {"prompt": "hi", "max_tokens": 4, "model": "m"},
    "texts": {"prompt": ["a", "bc"], "temperature": 0.5, "top_p": 0.9},
    "ids": {"prompt": [1, 5, 9], "n": 1, "echo": False, "stop": None},
    "id_lists": {"prompt": [[1], [2, 3]], "best_of": 1,
                 "presence_penalty": 0},
    "bad_stream": {"prompt": "hi", "stream": True},
    "bad_n": {"prompt": "hi", "n": 2},
    "bad_stop": {"prompt": "hi", "stop": ["\n"]},
    "bad_logprobs": {"prompt": "hi", "logprobs": 0},
    "no_prompt": {"max_tokens": 4},
}


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_oai_to_native_matches_jax(case):
    req = REQUESTS[case]
    try:
        want = j_serve._oai_to_native(dict(req))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            serve._oai_to_native(dict(req))
        assert str(got.value) == str(e)
        return
    assert serve._oai_to_native(dict(req)) == want


def test_oai_response_matches_jax():
    args = ([[5, 6], [7, 8, 9]], ["ab", "c"], [[1, 2, 3], [4]], 3, "m")
    want, got = j_serve._oai_response(*args), serve._oai_response(*args)
    for d in (want, got):
        assert d.pop("id").startswith("cmpl-")
        assert abs(d.pop("created") - time.time()) < 60
    assert got == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_serves_on_the_cpu(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    env.update(TPUFW_DEVICE="cpu", TPUFW_MODEL="llama3_tiny",
               TPUFW_SERVE_PORT=str(port), TPUFW_MAX_NEW_TOKENS="4",
               PYTHONPATH=ROOT)
    log = open(tmp_path / "serve.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpufw_torch.workloads.serve"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    assert json.loads(r.read())["ok"] is True
                break
            except OSError:
                assert proc.poll() is None, (tmp_path / "serve.log").read_text()
                time.sleep(0.2)
        for path, body in (("/generate", {"prompts": [[1, 5, 9]]}),
                           ("/v1/completions", {"prompt": "hi"})):
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            if path == "/generate":
                assert len(out["outputs"][0]) == 4
            else:
                assert out["usage"]["completion_tokens"] == 4
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "tpufw_serve_requests_total 2" in text
        assert "tpufw_serve_tokens_generated_total 8" in text
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    banner = json.loads((tmp_path / "serve.log").read_text().splitlines()[0])
    assert banner["serving"] is True and banner["port"] == port
    assert banner["device"] == "cpu"
