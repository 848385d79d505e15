"""The port's einsum ring (``tpufw_torch.parallel.ring``) against
``tpufw.parallel.ring_attention`` on the 8 virtual devices, as
``tests/test_ring.py`` holds the JAX ring: rings of 2, 4 and 8 shards in
one process (``LocalSequenceGroup``) against ``tpufw``'s sequence=2, 4
and 8 meshes on the same numpy inputs, causal and not, with packed
segments, outputs and per-argument gradients within 2e-4; the ring over a
world-1 gloo group's ``DeviceMesh``; and the loud "needs a mesh"."""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_gang import free_port
from tests.torch_sp import (
    assert_runs_close,
    jax_run,
    qkv,
    segments,
    torch_run,
)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.mesh import build_mesh as j_build_mesh
from tpufw.parallel import ring_attention as j_ring_attention
from tpufw.parallel import use_mesh as j_use_mesh
from tpufw_torch.ops.attention import xla_attention
from tpufw_torch.parallel import LocalSequenceGroup, ring_attention


def _tpufw_ring(n, causal, **kw):
    mesh = j_build_mesh(JMeshConfig(fsdp=8 // n, sequence=n))

    def fn(q, k, v):
        with j_use_mesh(mesh):
            return j_ring_attention(q, k, v, causal=causal, impl="einsum",
                                    **kw)

    return fn


def _port_ring(n, causal, **kw):
    group = LocalSequenceGroup(n)
    return lambda q, k, v: ring_attention(q, k, v, causal=causal,
                                          mesh=group, impl="einsum", **kw)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_tpufw(devices8, causal, n):
    q, k, v = qkv(n, 4, 16 * n, 4, 2, 16)
    assert_runs_close(torch_run(_port_ring(n, causal), q, k, v),
                      jax_run(_tpufw_ring(n, causal), q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_segments_match_tpufw(devices8, causal):
    """Packed batches: the key-side segment ids rotate with their kv
    chunk; segment 2 is absent from the first chunk, so rows of it see no
    key there and the merge must weigh that chunk 0."""
    b, t = 4, 128
    q, k, v = qkv(6, b, t, 4, 2, 16)
    seg = segments(b, t, (0, 50, 115))  # trailing pad = segment 0
    real = seg > 0
    assert_runs_close(
        torch_run(_port_ring(4, causal, segment_ids=torch.from_numpy(seg)),
                  q, k, v, real),
        jax_run(_tpufw_ring(4, causal, segment_ids=seg), q, k, v, real),
        real)


def test_ring_over_a_one_rank_gloo_mesh():
    """A gang's ``DeviceMesh`` is a ring of its ``sequence`` size: on a
    world-1 gloo group, one shard, the ring is plain attention."""
    import torch.distributed as dist

    from tpufw_torch.cluster import init_process_group
    from tpufw_torch.mesh import MeshConfig, build_mesh

    q, k, v = (torch.from_numpy(x) for x in qkv(3, 2, 32, 4, 2, 16))
    init_process_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        mesh = build_mesh(MeshConfig(), 1, "cpu")
        out = ring_attention(q, k, v, mesh=mesh)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out.numpy(), xla_attention(q, k, v).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ring_requires_mesh():
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_attention(q, q, q)
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring_attention(q, q, q, mesh=LocalSequenceGroup(2), impl="dense")
    with pytest.raises(ValueError, match="self-attention only"):
        ring_attention(q, q[:, :8], q[:, :8], mesh=LocalSequenceGroup(2),
                       impl="einsum")
    with pytest.raises(ValueError, match="sliding_window must be >= 1"):
        ring_attention(q, q, q, mesh=LocalSequenceGroup(2), sliding_window=0)
