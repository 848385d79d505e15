"""The port's sequence-parallel backends with Gemma's features, as
``tests/test_sp_features.py`` holds ``tpufw``'s: the soft cap and a
sliding window that crosses the 64-token shards of a ring of 4, through
the einsum ring, ring-flash (the kernels' plain versions) and Ulysses,
forward and per-argument gradients against ``tpufw``'s ``xla_attention``
on the same numpy inputs; and the Gemma-2 model (caps and alternating
windows) on ``ring`` and ``ulysses`` against ``tpufw``'s xla logits.
Tolerance 2e-4 (tests/conftest.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_sp import assert_runs_close, jax_run, qkv, torch_run
from tpufw.models.gemma import GEMMA_CONFIGS as J_CONFIGS
from tpufw.models.gemma import Gemma as JGemma
from tpufw.ops.attention import xla_attention as j_xla
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import GEMMA_CONFIGS, Gemma
from tpufw_torch.parallel import (
    LocalSequenceGroup,
    ring_attention,
    ulysses_attention,
    use_mesh,
)

B, T, H, KH, D = 2, 256, 4, 2, 32
CAP = 15.0
WIN = 96  # crosses the 64-token shard boundary on a ring of 4


def _inputs():
    return qkv(0, B, T, H, KH, D, scale=3.0)


@functools.lru_cache(maxsize=None)
def _ref(window):
    """``tpufw``'s xla output and gradients on ``_inputs()``, once a
    window."""
    return jax_run(lambda q, k, v: j_xla(
        q, k, v, causal=True, logits_soft_cap=CAP, sliding_window=window),
        *_inputs())


@pytest.mark.parametrize("window", [None, WIN])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_ring_cap_window(impl, window):
    group = LocalSequenceGroup(4)

    def out(q, k, v):
        return ring_attention(q, k, v, causal=True, impl=impl, mesh=group,
                              logits_soft_cap=CAP, sliding_window=window)

    assert_runs_close(torch_run(out, *_inputs()), _ref(window))


@pytest.mark.parametrize("window", [None, WIN])
def test_ulysses_cap_window(window):
    group = LocalSequenceGroup(4)

    def out(q, k, v):
        return ulysses_attention(q, k, v, causal=True, backend="xla",
                                 mesh=group, logits_soft_cap=CAP,
                                 sliding_window=window)

    assert_runs_close(torch_run(out, *_inputs()), _ref(window))


@functools.lru_cache(maxsize=None)
def _gemma():
    """(fp32 gemma2_tiny config, its Flax params, the tokens, tpufw's
    whole-sequence xla logits)."""
    jcfg = dataclasses.replace(J_CONFIGS["gemma2_tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 64))
    ids = jnp.asarray(tokens, jnp.int32)
    params = jax.device_get(meta.unbox(jax.jit(JGemma(jcfg).init)(
        jax.random.key(3), ids)["params"]))
    logits = jax.jit(JGemma(jcfg).apply)({"params": params}, ids)
    return jcfg, params, tokens, np.asarray(logits)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_gemma_sp_backend_matches_tpufw_xla(backend):
    """Tiny Gemma-2 (caps, a window on every other layer) with a
    sequence-parallel backend over a ring of 4 equals ``tpufw``'s
    whole-sequence xla forward; Ulysses also runs the GQA repeat (2 kv
    heads over 4 shards)."""
    _, params, tokens, want = _gemma()
    tcfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"],
                               dtype=torch.float32, param_dtype=torch.float32,
                               attention_backend=backend)
    model = Gemma(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    with torch.no_grad(), use_mesh(LocalSequenceGroup(4)):
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
