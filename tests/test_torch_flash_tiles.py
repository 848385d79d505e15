"""The CUDA flash kernels' loop bounds, checked on the CPU.

``fwd_kv_tiles``, ``dq_kv_tiles`` and ``dkv_q_tiles`` in
``tpufw_torch/ops/flash.py`` state the tile ranges that ``csrc/flash_fwd.cu``
and ``csrc/flash_dq.cu`` (kv tiles per query tile) and ``csrc/flash_dkv.cu``
(query tiles per kv tile) loop over. A kernel whose loop misses a tile
holding a visible (query, key) pair drops that pair's term, so for every
visible pair the key's tile must lie in its query tile's range, and the
query's tile in its key tile's range. Masks come from
the plain versions' ``_mask``; segments only remove pairs, so they are left
out. Each case is checked at the tiles of every head dim the kernels are
built for (``tflash.TILES``: 128, 192 for DeepSeek's MLA and 256 for
Gemma-2).
"""

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.ops import flash as tflash

# name: (t, s, offset or None for s - t, causal, window)
CASES = {
    "causal_aligned": (256, 256, None, True, None),
    "causal_unaligned_path": (2047, 2047, None, True, None),
    "noncausal_unaligned": (700, 300, None, False, None),
    "causal_offset_t100_s300": (100, 300, None, True, None),
    "causal_offset_t129_s700": (129, 700, None, True, None),
    "under_one_tile_t64": (64, 64, None, True, None),
    "under_one_tile_t5_s9": (5, 9, None, True, None),
    "window1": (300, 300, None, True, 1),
    "window127": (513, 513, None, True, 127),
    "window128": (513, 513, None, True, 128),
    "window129": (513, 513, None, True, 129),
    "window300_offset": (300, 700, None, True, 300),
    "window129_noncausal": (400, 400, None, False, 129),
    "window128_offset_t100_s300": (100, 300, None, True, 128),
    "explicit_offset_t_gt_s": (300, 200, 0, True, None),
}


def _tile_ranges(fn, n_tiles, *args):
    """[n_tiles, 2] int tensor of (lo, hi) per tile."""
    return torch.tensor([fn(i, *args) for i in range(n_tiles)]).reshape(-1, 2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_visible_pair_lies_in_both_loops(name):
    t, s, offset, causal, window = CASES[name]
    offset = s - t if offset is None else offset
    visible = tflash._mask(t, s, offset, causal, window, None, None, "cpu")[0, 0]
    assert visible.any()
    qi, ki = visible.nonzero(as_tuple=True)
    for d, tiles in tflash.TILES.items():
        args = (t, s, offset, causal, window, d)

        fq, fk = tiles["fwd"]
        fwd = _tile_ranges(tflash.fwd_kv_tiles, -(-t // fq), *args)
        lo, hi = fwd[qi // fq, 0], fwd[qi // fq, 1]
        kt = ki // fk
        assert bool(((kt >= lo) & (kt < hi)).all()), \
            f"d{d}: forward loop misses a kv tile"
        assert int(fwd[:, 1].max()) <= -(-s // fk) and int(fwd[:, 0].min()) >= 0

        dq, dk = tiles["dkv"]
        dkv = _tile_ranges(tflash.dkv_q_tiles, -(-s // dk), *args)
        lo, hi = dkv[ki // dk, 0], dkv[ki // dk, 1]
        it = qi // dq
        assert bool(((it >= lo) & (it < hi)).all()), \
            f"d{d}: dK/dV loop misses a q tile"
        assert int(dkv[:, 1].max()) <= -(-t // dq) and int(dkv[:, 0].min()) >= 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_visible_pair_lies_in_the_dq_loop(name):
    """dQ walks the forward's kv loop (one device function, ``kv_tiles``),
    at tiles of its own constants: every visible pair's kv tile lies in its
    query tile's dQ range."""
    t, s, offset, causal, window = CASES[name]
    offset = s - t if offset is None else offset
    visible = tflash._mask(t, s, offset, causal, window, None, None, "cpu")[0, 0]
    qi, ki = visible.nonzero(as_tuple=True)
    for d, tiles in tflash.TILES.items():
        bq, bkv = tiles["dq"]
        assert (bq, bkv) == tiles["fwd"]
        dq = _tile_ranges(tflash.dq_kv_tiles, -(-t // bq), t, s, offset, causal,
                          window, d)
        lo, hi = dq[qi // bq, 0], dq[qi // bq, 1]
        kt = ki // bkv
        assert bool(((kt >= lo) & (kt < hi)).all()), f"d{d}: dQ loop misses a kv tile"
        assert int(dq[:, 1].max()) <= -(-s // bkv) and int(dq[:, 0].min()) >= 0


def test_loops_skip_the_masked_tiles():
    """The bounds are not the whole grid: at the train path's shapes the
    forward and dQ each visit 136 of their 16 x 16 tile pairs (the causal
    triangle with its diagonal) and dK/dV 272 of its 16 x 32."""
    t = s = 2047
    fwd = sum(hi - max(lo, 0) for lo, hi in (
        tflash.fwd_kv_tiles(i, t, s, 0, True, None) for i in range(16)))
    dq = sum(hi - lo for lo, hi in (
        tflash.dq_kv_tiles(i, t, s, 0, True, None) for i in range(16)))
    dkv = sum(hi - lo for lo, hi in (
        tflash.dkv_q_tiles(j, t, s, 0, True, None) for j in range(16)))
    assert fwd == 136
    assert dq == 136
    assert dkv == 272


def test_head_dim_256_loops_skip_the_window():
    """At Gemma-2's train shapes (T = S = 8191, window 4096) the head-dim-256
    tiles (128 x 64 forward and dQ, 64 x 64 dK/dV) visit only the tiles
    within the window: a 128-row query tile sees keys over 4096 + 127
    positions, so at most 66 kv tiles of 64, not the causal triangle's up
    to 128; and every visited pair of tiles holds a visible pair."""
    t = s = 8191
    for window, fwd_most in ((None, 128), (4096, 66)):
        fwd = [tflash.fwd_kv_tiles(i, t, s, 0, True, window, 256)
               for i in range(64)]
        assert max(hi - lo for lo, hi in fwd) == fwd_most
        dkv = [tflash.dkv_q_tiles(j, t, s, 0, True, window, 256)
               for j in range(128)]
        visible = torch.zeros(8192, 8192, dtype=torch.bool)
        visible[:t, :s] = tflash._mask(t, s, 0, True, window, None, None, "cpu")[0, 0]
        tiles = visible.reshape(64, 128, 128, 64).any(3).any(1)  # [q128, kv64]
        for i, (lo, hi) in enumerate(fwd):
            assert bool(tiles[i, lo:hi].all()), f"window {window}: tile {i}"
        qtiles = visible.reshape(128, 64, 128, 64).any(3).any(1)  # [q64, kv64]
        for j, (lo, hi) in enumerate(dkv):
            assert bool(qtiles[lo:hi, j].all()), f"window {window}: kv tile {j}"


@pytest.mark.parametrize("window", [None, 300])
def test_head_dim_192_bounds_equal_tpufw(window):
    """At head dim 192's tiles (128 x 64 forward and dQ, 64 x 64 dK/dV) and
    the MLA train path's length (T = S = 2047), the loop bounds are the
    JAX kernels' at those tiles: the forward's start is
    ``tpufw.ops.flash._first_kv_block`` and its end the causal
    ``div((i + 1) * bq + offset + bkv - 1, bkv)`` capped at the kv tiles
    (``_fwd_kernel``); dK/dV's are ``_dkv_kernel``'s causal first and
    window last. Without a window they visit the causal triangle with its
    diagonal: 272 forward tile pairs (16 x 32) and 528 dK/dV ones (32 x
    32)."""
    from tpufw.ops.flash import _first_kv_block

    t = s = 2047
    bq, bkv = tflash.TILES[192]["fwd"]
    n_kv = -(-s // bkv)
    fwd = [tflash.fwd_kv_tiles(i, t, s, 0, True, window, 192)
           for i in range(-(-t // bq))]
    for i, (lo, hi) in enumerate(fwd):
        assert lo == int(_first_kv_block(i, bq, bkv, 0, window))
        assert hi == min(((i + 1) * bq + bkv - 1) // bkv, n_kv)
    dq, dk = tflash.TILES[192]["dkv"]
    n_q = -(-t // dq)
    dkv = [tflash.dkv_q_tiles(j, t, s, 0, True, window, 192)
           for j in range(-(-s // dk))]
    for j, (lo, hi) in enumerate(dkv):
        assert lo == max((j * dk) // dq, 0)
        want_hi = n_q if window is None else max(
            min((j * dk + dk - 1 + window - 1) // dq + 1, n_q), lo)
        assert hi == want_hi
    if window is None:
        assert sum(hi - lo for lo, hi in fwd) == 272
        assert sum(hi - lo for lo, hi in dkv) == 528
