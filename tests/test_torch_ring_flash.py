"""The port's ring-flash (``tpufw_torch.parallel.ring_flash``, the flash
kernels' plain versions on the CPU) as ``tests/test_ring_flash.py`` holds
``tpufw``'s: forward and per-argument gradients against ``tpufw``'s
``xla_attention`` on the same numpy inputs, over rings of 2 and 4 shards
in one process, with packed segments, windows that cross shard
boundaries and leave later ring steps out, the cap, and all three at
once; one case against ``tpufw``'s own ring-flash (its Pallas kernels in
interpret mode on the virtual sequence=2 mesh); ``_n_live_steps`` equal
to ``tpufw``'s on a grid; a ring of one shard bit-equal to
``flash_attention``; and the refusal of ``causal=False``. Tolerance
2e-4 (tests/conftest.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from tpufw.ops.attention import xla_attention as j_xla
from tpufw.parallel import use_mesh as j_use_mesh
from tpufw.parallel.ring_flash import _n_live_steps as j_n_live_steps
from tpufw.parallel.ring_flash import ring_flash_attention as j_ring_flash
from tpufw_torch.ops.flash import flash_attention
from tpufw_torch.parallel import LocalSequenceGroup, ring_attention
from tpufw_torch.parallel.ring_flash import _n_live_steps, ring_flash_attention


def _port(n, seg=None, **kw):
    group = LocalSequenceGroup(n)
    seg = None if seg is None else torch.from_numpy(seg)
    return lambda q, k, v: ring_flash_attention(
        q, k, v, mesh=group, segment_ids=seg, **kw)


def _xla(seg=None, **kw):
    seg = None if seg is None else jnp.asarray(seg)
    return lambda q, k, v: j_xla(q, k, v, causal=True, segment_ids=seg,
                                 **kw)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_flash_matches_xla(n):
    q, k, v = qkv(n, 4, 32 * n, 4, 2, 32)
    assert_runs_close(torch_run(_port(n), q, k, v),
                      jax_run(_xla(), q, k, v))


def test_ring_flash_segments_match_xla():
    """Packed batches: segment ids ride with their kv chunk; segment 2
    starts in the second chunk, so its rows see no key of the first, and
    that chunk's LSE ≈ -1e30 must weigh 0 in the merge."""
    b, t = 4, 128
    q, k, v = qkv(2, b, t, 4, 2, 32)
    seg = segments(b, t, (0, 70, 115))
    real = seg > 0
    assert_runs_close(torch_run(_port(2, seg), q, k, v, real),
                      jax_run(_xla(seg), q, k, v, real), real)


@pytest.mark.parametrize("window", [24, 16, 48])
def test_ring_flash_window_matches_xla(window):
    """A window across chunk boundaries (partial steps) that leaves later
    steps out (4 shards of 16 tokens: 3, 2 and 4 live steps)."""
    q, k, v = qkv(5, 2, 64, 2, 1, 32)
    assert_runs_close(torch_run(_port(4, sliding_window=window), q, k, v),
                      jax_run(_xla(sliding_window=window), q, k, v))


def test_ring_flash_segments_window_cap_match_xla():
    """Segments, a window that crosses shards and the soft cap together
    (Gemma's local layers, packed)."""
    b, t = 2, 128
    q, k, v = qkv(7, b, t, 4, 2, 32, scale=3.0)
    seg = segments(b, t, (0, 45, 100, 128))
    kw = dict(sliding_window=40, logits_soft_cap=15.0)
    assert_runs_close(torch_run(_port(4, seg, **kw), q, k, v),
                      jax_run(_xla(seg, **kw), q, k, v))


def test_ring_flash_matches_tpufw_ring_flash(devices8):
    """``tpufw``'s ring-flash itself (Pallas interpret mode, sequence=2):
    forward and gradients, with segments, a window and the cap."""
    b, t = 4, 128
    q, k, v = qkv(8, b, t, 2, 1, 32, scale=2.0)
    seg = segments(b, t, (0, 50, 128))
    kw = dict(sliding_window=80, logits_soft_cap=20.0)
    mesh = j_build_mesh(JMeshConfig(fsdp=4, sequence=2))

    def tpufw_fn(q, k, v):
        with j_use_mesh(mesh):
            return j_ring_flash(q, k, v, segment_ids=jnp.asarray(seg), **kw)

    assert_runs_close(torch_run(_port(2, seg, **kw), q, k, v),
                      jax_run(tpufw_fn, q, k, v))


def test_n_live_steps_matches_tpufw():
    for n in range(1, 9):
        for l in (1, 16, 100):
            for window in (None, 1, 2, 15, 16, 17, 24, 33, 100, 10_000):
                assert _n_live_steps(n, l, window) == j_n_live_steps(
                    n, l, window), (n, l, window)


def test_one_shard_ring_is_flash_attention_bit_for_bit():
    """A ring of one shard merges its one chunk with weight exactly 1 and
    sums dK/dV per chunk as ``flash_attention`` does: the same bits,
    forward and backward (bf16, GQA, segments, window, cap)."""
    b, t = 2, 96
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in qkv(9, b, t, 4, 2, 32))
    seg = torch.from_numpy(segments(b, t, (0, 40, 96)))
    kw = dict(segment_ids=seg, sliding_window=50, logits_soft_cap=30.0)
    runs = []
    for fn in (lambda *x: flash_attention(*x, **kw),
               lambda *x: ring_attention(*x, mesh=LocalSequenceGroup(1),
                                         **kw, impl="flash")):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*ts)
        (out.float() ** 2).sum().backward()
        runs.append([out.detach(), *(x.grad for x in ts)])
    for got, want, name in zip(runs[1], runs[0], ("o", "dq", "dk", "dv")):
        assert torch.equal(got, want), name


def test_ring_flash_rejects_noncausal_and_bad_windows():
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(NotImplementedError, match="causal-only"):
        ring_flash_attention(q, q, q, causal=False)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_flash_attention(q, q, q)
    with pytest.raises(ValueError, match="sliding_window must be >= 1"):
        ring_flash_attention(q, q, q, mesh=LocalSequenceGroup(2),
                             sliding_window=0)


def test_ring_impls_agree_with_a_window():
    """``ring_attention``'s explicit impl="flash" takes the window and
    equals the einsum impl; the default on CPU tensors is einsum."""
    q, k, v = (torch.from_numpy(x) for x in qkv(4, 2, 64, 2, 1, 32))
    group = LocalSequenceGroup(4)
    outs = {impl: ring_attention(q, k, v, mesh=group, sliding_window=24,
                                 impl=impl)
            for impl in (None, "einsum", "flash")}
    np.testing.assert_array_equal(outs[None].numpy(), outs["einsum"].numpy())
    np.testing.assert_allclose(outs["flash"].numpy(), outs["einsum"].numpy(),
                               rtol=2e-5, atol=2e-5)
