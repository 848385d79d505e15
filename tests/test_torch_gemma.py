"""tpufw_torch Gemma-2 vs the tpufw Flax Gemma on ``gemma2_tiny`` in fp32,
with the Flax weights moved into the port through ``params_from_flax``.

First the JAX package's own non-HF Gemma tests (``tests/test_gemma.py``)
on the port: odd depth refused, the analytic parameter count, the final
cap, the window on even layers only, flash (the kernels' plain versions
on the CPU) equal to the plain backend, chunked CE equal to full-logits
CE, an odd pair count, the real presets' shapes. Then parity: logits
within 2e-4 (tests/conftest.py) for a scanned and an unscanned tree,
greedy tokens through ``generate`` and through the HTTP server
(``TPUFW_MODEL=gemma2_tiny``) equal to ``tpufw``'s, and three trainer
steps with the losses of ``tpufw``'s trainer.
"""

import dataclasses
import functools
import importlib
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models.gemma import GEMMA_CONFIGS as J_CONFIGS
from tpufw.models.gemma import Gemma as JGemma
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.infer import generate_text
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import GEMMA_CONFIGS, Gemma
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.trainer import batch_loss

j_generate = importlib.import_module("tpufw.infer.generate")
TOL = dict(rtol=2e-4, atol=2e-4)
T = 48  # beyond gemma2_tiny's 32-token window
# Ragged; the 37-token prompt runs past the window, so the cached local
# layers mask something.
PROMPTS = [
    np.random.default_rng(1).integers(1, 256, n).tolist() for n in (37, 2, 11)
]
MAX_NEW = 8


def _pair(scan_layers=True, **overrides):
    """(JAX config, port config) of gemma2_tiny in fp32; ``scan_layers``
    is the JAX trunk's layout."""
    jcfg = dataclasses.replace(
        J_CONFIGS["gemma2_tiny"], dtype=jnp.float32, param_dtype=jnp.float32,
        scan_layers=scan_layers, **overrides,
    )
    tcfg = dataclasses.replace(
        GEMMA_CONFIGS["gemma2_tiny"], dtype=torch.float32,
        param_dtype=torch.float32, **overrides,
    )
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _flax_params(scan_layers=True):
    """Host Flax params of fp32 gemma2_tiny, scanned or not, from key 0.
    Random init draws the offset norms at zero; they are set to small
    random values here so that a norm read from the wrong place shows."""
    jcfg, _ = _pair(scan_layers=scan_layers)
    params = jax.jit(JGemma(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.device_get(meta.unbox(params))
    rng = np.random.default_rng(7)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (fill(v) if k != "scale" else
                        (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32))
                    for k, v in tree.items()}
        return tree

    return fill(params)


def _port(tcfg, params):
    model = Gemma(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    return model


def _tokens(seed=0, shape=(2, T)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int64)


# ----------------------------------------------------------------------
# The JAX package's Gemma tests, on the port
# ----------------------------------------------------------------------


def test_odd_layers_rejected():
    cfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"], n_layers=3)
    with pytest.raises(ValueError, match="even"):
        Gemma(cfg, device="cpu")


def test_param_count_matches_analytic():
    cfg = GEMMA_CONFIGS["gemma2_tiny"]
    model = Gemma(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    # Four offset norms per block (zeros at init) and a tied head.
    assert model.lm_head is None
    assert len([n for n in model.state_dict() if "norm" in n]) == 4 * 4 + 1
    assert all(float(p.detach().abs().max()) == 0.0
               for n, p in model.named_parameters() if "norm" in n)


def test_final_logits_capped():
    cfg = GEMMA_CONFIGS["gemma2_tiny"]
    model = Gemma(cfg, device="cpu", seed=1)
    with torch.no_grad():
        logits = model(torch.from_numpy(_tokens()))
        hidden = model(torch.from_numpy(_tokens()), return_hidden=True)
    assert torch.isfinite(logits).all()
    assert float(logits.abs().max()) <= cfg.final_logit_soft_cap
    assert hidden.shape == (2, T, cfg.d_model)


def test_sliding_window_changes_even_layers_only():
    """Even layers (0 first) attend within the window, odd ones globally;
    widening the window past the sequence changes the logits."""
    _, tcfg = _pair()
    model = _port(tcfg, _flax_params())
    assert [blk.attn.window for blk in model.layers] == [32, None, 32, None]
    wide = _port(dataclasses.replace(tcfg, sliding_window=256), _flax_params())
    tok = torch.from_numpy(_tokens(0, (1, 96)))
    with torch.no_grad():
        diff = (model(tok) - wide(tok)).abs().max()
    assert float(diff) > 1e-4


def test_flash_backend_matches_xla():
    """The whole stack (caps and windows) through the flash kernels' plain
    versions on the CPU against the plain backend."""
    _, tcfg = _pair()
    ref = _port(tcfg, _flax_params())
    flash = _port(dataclasses.replace(tcfg, attention_backend="flash"),
                  _flax_params())
    tok = torch.from_numpy(_tokens(2, (1, 64)))
    with torch.no_grad():
        np.testing.assert_allclose(flash(tok).numpy(), ref(tok).numpy(),
                                   atol=3e-5, rtol=3e-5)


def test_chunked_ce_matches_full_logits():
    """The chunked path (which applies the final cap per chunk) equals the
    model's own capped full-logits loss."""
    _, tcfg = _pair()
    model = _port(tcfg, _flax_params())
    batch = {"tokens": torch.from_numpy(_tokens(4, (2, 33)))}
    with torch.no_grad():
        full, _ = batch_loss(model, batch)
        chunked, _ = batch_loss(model, batch, loss_chunk_size=16,
                                loss_chunk_dtype="float32")
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


def test_odd_pair_count_forward():
    """26- and 42-layer presets have odd pair counts: 3 pairs build and
    run forward."""
    cfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"], n_layers=6)
    model = Gemma(cfg, device="cpu")
    assert len(model.layers) == 6
    with torch.no_grad():
        assert torch.isfinite(model(torch.zeros(1, 8, dtype=torch.long))).all()


@pytest.mark.parametrize("name, lo, hi", [("gemma2_2b", 2.5e9, 2.7e9),
                                          ("gemma2_9b", 9.1e9, 9.3e9)])
def test_real_preset_shapes(name, lo, hi):
    """The real presets build (on the meta device: shapes only) and match
    their analytic counts."""
    cfg = GEMMA_CONFIGS[name]
    model = Gemma(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.n_params()
    assert lo < n < hi
    assert model.layers[0].attn.q.weight.shape == (
        cfg.n_heads * cfg.head_dim, cfg.d_model)


# ----------------------------------------------------------------------
# Parity with tpufw's Gemma
# ----------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scanned", "unscanned"])
def test_logits_match_flax(scan_layers):
    jcfg, tcfg = _pair(scan_layers=scan_layers)
    params = _flax_params(scan_layers)
    sd = params_from_flax(params, tcfg)
    model = Gemma(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    tokens = _tokens(1)
    want = JGemma(jcfg).apply({"params": params}, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_greedy_generate_matches_jax():
    """KV-cache greedy decode, token for token, with a prompt past the
    window."""
    jcfg, tcfg = _pair()
    params = _flax_params()
    want = j_generate.generate_text(
        JGemma(jcfg.decode_config()), params, PROMPTS, max_new_tokens=MAX_NEW
    )
    got = generate_text(_port(tcfg.decode_config(), params), PROMPTS,
                        max_new_tokens=MAX_NEW)
    assert got == want


def test_three_trainer_steps_match_flax(devices8):
    """Same init, same synthetic batches, same optimizer, chunked CE with
    the final cap: every step's loss agrees to 1e-4 relative (the rule of
    test_torch_trainer.py)."""
    jcfg, tcfg = _pair()
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=1e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    jt = JTrainer(JGemma(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(meta.unbox(jt.state.params))
    j_hist = jt.run(synthetic_batches(8, 33, jcfg.vocab_size, seed=3),
                    model_flops_per_token=jcfg.flops_per_token(32))
    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    model = tt.init_state(state_dict=params_from_flax(params, tcfg))
    assert isinstance(model, Gemma)
    t_hist = tt.run(synthetic_batches(8, 33, tcfg.vocab_size, seed=3),
                    model_flops_per_token=tcfg.flops_per_token(32))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose(
        [m.loss for m in t_hist], [m.loss for m in j_hist], rtol=1e-4
    )


def test_workloads_build_gemma_for_gemma_presets(clear_tpufw_env):
    """TPUFW_MODEL=gemma2_tiny gives the train workload a GemmaConfig
    (its trainer builds a Gemma) and the serve workload a Gemma decode
    model."""
    from tpufw_torch.models import GemmaConfig
    from tpufw_torch.workloads import serve, train_llama

    clear_tpufw_env.setenv("TPUFW_MODEL", "gemma2_tiny")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    trainer, cfg = train_llama.build_trainer()
    assert isinstance(cfg, GemmaConfig)
    assert isinstance(trainer.init_state(), Gemma)
    model, cfg, restored = serve.build_generator()
    assert isinstance(model, Gemma) and model.cfg.decode and not restored
    assert isinstance(cfg, GemmaConfig) and not cfg.decode
    qmodel = serve.quantize_model(model)
    assert isinstance(qmodel, Gemma) and qmodel.cfg.quantized_weights


def test_server_gemma2_tiny_greedy_tokens_match_jax(clear_tpufw_env):
    """The HTTP server (contiguous slot pool, greedy) on the model that
    TPUFW_MODEL=gemma2_tiny selects, holding the Flax weights in fp32:
    every request's tokens equal tpufw's generate_text."""
    from tpufw_torch.workloads import serve

    clear_tpufw_env.setenv("TPUFW_MODEL", "gemma2_tiny")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    jcfg, _ = _pair()
    params = _flax_params()
    build = serve.build_generator

    def fp32_flax_generator():
        model, cfg, restored = build()
        assert isinstance(model, Gemma)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                    param_dtype=torch.float32)
        return _port(cfg32.decode_config(), params), cfg32, restored

    clear_tpufw_env.setattr(serve, "build_generator", fp32_flax_generator)
    srv = serve._Server(port=0, max_new_tokens=MAX_NEW)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        deadline = time.time() + 30
        while srv.httpd is None and time.time() < deadline:
            time.sleep(0.01)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompts": PROMPTS}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            got = json.loads(resp.read())["outputs"]
    finally:
        srv.shutdown()
    want = j_generate.generate_text(
        JGemma(jcfg.decode_config()), params, PROMPTS, max_new_tokens=MAX_NEW
    )
    assert got == want
