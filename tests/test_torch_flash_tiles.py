"""The CUDA flash kernels' loop bounds, checked on the CPU.

``fwd_kv_tiles``, ``dq_kv_tiles`` and ``dkv_q_tiles`` in
``tpufw_torch/ops/flash.py`` state the tile ranges that ``csrc/flash_fwd.cu``
and ``csrc/flash_dq.cu`` (kv tiles per query tile) and ``csrc/flash_dkv.cu``
(query tiles per kv tile) loop over. A kernel whose loop misses a tile
holding a visible (query, key) pair drops that pair's term, so for every
visible pair the key's tile must lie in its query tile's range, and the
query's tile in its key tile's range. Masks come from
the plain versions' ``_mask``; segments only remove pairs, so they are left
out.
"""

import pytest
import torch

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
    args = (t, s, offset, causal, window)

    fq, fk = tflash.FWD_BLOCK_Q, tflash.FWD_BLOCK_KV
    fwd = _tile_ranges(tflash.fwd_kv_tiles, -(-t // fq), *args)
    lo, hi = fwd[qi // fq, 0], fwd[qi // fq, 1]
    kt = ki // fk
    assert bool(((kt >= lo) & (kt < hi)).all()), "forward loop misses a kv tile"
    assert int(fwd[:, 1].max()) <= -(-s // fk) and int(fwd[:, 0].min()) >= 0

    dq, dk = tflash.DKV_BLOCK_Q, tflash.DKV_BLOCK_KV
    dkv = _tile_ranges(tflash.dkv_q_tiles, -(-s // dk), *args)
    lo, hi = dkv[ki // dk, 0], dkv[ki // dk, 1]
    it = qi // dq
    assert bool(((it >= lo) & (it < hi)).all()), "dK/dV loop misses a q tile"
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
    bq, bkv = tflash.DQ_BLOCK_Q, tflash.DQ_BLOCK_KV
    assert (bq, bkv) == (tflash.FWD_BLOCK_Q, tflash.FWD_BLOCK_KV)
    dq = _tile_ranges(tflash.dq_kv_tiles, -(-t // bq), t, s, offset, causal, window)
    lo, hi = dq[qi // bq, 0], dq[qi // bq, 1]
    kt = ki // bkv
    assert bool(((kt >= lo) & (kt < hi)).all()), "dQ loop misses a kv tile"
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
