"""The port's Ulysses attention (``tpufw_torch.parallel.ulysses``) as
``tests/test_ulysses.py`` holds ``tpufw``'s: over rings of 2 and 4 shards
in one process (``LocalSequenceGroup``), forward and per-argument
gradients against ``tpufw``'s Ulysses on its sequence=2 and 4 meshes on
the same numpy inputs, causal and not, the GQA repeat path (kv heads that
the ring's size does not divide), packed segment ids, the flash local
backend, the Llama model through ``attention_backend="ulysses"`` against
``tpufw``'s logits, and the errors. Tolerance 2e-4 (tests/conftest.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import flax_params, pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_sp import (
    assert_runs_close,
    jax_run,
    qkv,
    segments,
    torch_run,
)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.mesh import build_mesh as j_build_mesh
from tpufw.models.llama import Llama as JLlama
from tpufw.parallel import ulysses_attention as j_ulysses
from tpufw.parallel import use_mesh as j_use_mesh
from tpufw_torch.parallel import (
    LocalSequenceGroup,
    ulysses_attention,
    use_mesh,
)


def _tpufw(n, **kw):
    mesh = j_build_mesh(JMeshConfig(fsdp=8 // n, sequence=n))

    def fn(q, k, v):
        with j_use_mesh(mesh):
            return j_ulysses(q, k, v, **kw)

    return fn


def _port(n, **kw):
    group = LocalSequenceGroup(n)
    return lambda q, k, v: ulysses_attention(q, k, v, mesh=group, **kw)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_matches_tpufw(devices8, causal, n):
    q, k, v = qkv(n, 8, 32 * n, 4, 4, 16)
    assert_runs_close(torch_run(_port(n, causal=causal), q, k, v),
                      jax_run(_tpufw(n, causal=causal), q, k, v))


def test_gqa_repeat_path(devices8):
    """2 kv heads over a ring of 4: repeated up to the query heads."""
    q, k, v = qkv(1, 4, 64, 4, 2, 16)
    assert_runs_close(torch_run(_port(4), q, k, v),
                      jax_run(_tpufw(4), q, k, v))


def test_segment_ids_match_tpufw(devices8):
    b, t = 8, 64
    q, k, v = qkv(2, b, t, 4, 4, 16)
    seg = np.repeat(np.arange(1, 5), t // 4)[None].repeat(b, 0).astype(
        np.int32)
    assert_runs_close(
        torch_run(_port(4, segment_ids=torch.from_numpy(seg)), q, k, v),
        jax_run(_tpufw(4, segment_ids=jnp.asarray(seg)), q, k, v))


def test_flash_local_backend_matches_xla():
    """Ulysses over the flash kernels' plain versions equals Ulysses over
    plain attention (segments included)."""
    b, t = 2, 64
    q, k, v = qkv(3, b, t, 4, 2, 16)
    seg = torch.from_numpy(segments(b, t, (0, 30, 64)))
    assert_runs_close(
        torch_run(_port(2, backend="flash", segment_ids=seg), q, k, v),
        torch_run(_port(2, backend="xla", segment_ids=seg), q, k, v))


def test_model_backend_string_matches_tpufw():
    """attention_backend="ulysses" runs the Llama trunk over a ring of 4
    (2 kv heads: the repeat path) with ``tpufw``'s logits."""
    jcfg, tcfg = pair("llama3_tiny")
    params = flax_params(jcfg)
    model = torch_model(dataclasses.replace(tcfg, attention_backend="ulysses"),
                        params)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 64))
    with torch.no_grad(), use_mesh(LocalSequenceGroup(4)):
        got = model(torch.from_numpy(tokens))
    want = jax.jit(JLlama(jcfg).apply)({"params": params},
                                       jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(want)),
                               rtol=2e-4, atol=2e-4)


def test_errors_are_loud():
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="divide the local .* head"):
        ulysses_attention(q, q, q, mesh=LocalSequenceGroup(4))
    with pytest.raises(ValueError, match="needs a mesh"):
        ulysses_attention(q, q, q, mesh=None)
    with pytest.raises(ValueError, match="self-attention only"):
        ulysses_attention(q, q[:, :8], q[:, :8], mesh=LocalSequenceGroup(2))
    with pytest.raises(ValueError, match="local backend must be"):
        ulysses_attention(q, q, q, mesh=LocalSequenceGroup(2),
                          backend="ring")
