"""Ring attention with the CUDA flash kernels per chunk (port of
``tpufw.parallel.ring_flash``).

The einsum ring (``parallel.ring``) holds one [B, H, L, L] logits block
per chunk step. Here each ring step runs the flash kernels
(``ops.flash``) on the resident q shard against the visiting kv chunk, so
a shard's memory is O(L·D) whatever the total context length.

Forward: chunks merge by their log-sum-exp; for normalized partial
outputs o₁, o₂ with lse₁, lse₂: o = w₁o₁ + w₂o₂, wᵢ = exp(lseᵢ − lse₁₊₂).

Backward: the flash trick lifted to the ring. An autograd ``Function``
recomputes each chunk's probabilities from (q, k_chunk, GLOBAL lse) with
the same kernels as the one-device backward, once per visiting chunk,
while (k, v, dk_acc, dv_acc) rotate together; after the live steps one
hop sends every chunk's accumulator home.

Causality at chunk granularity is a three-way case of the shard's index:
a kv chunk wholly before the q shard is attended in full (the kernels
with ``causal=False`` at ``offset = step·L``), the diagonal chunk
causally, and a chunk after it contributes nothing and launches nothing.

Packed-batch ``segment_ids`` ride the ring with their kv chunk as in the
einsum ring; the kernels mask cross-segment pairs in-tile. A row that
sees no key of a chunk (segments, windows) leaves that chunk with LSE
≈ −1e30, and the merge gives it weight 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufw_torch.mesh.mesh import AXIS_SEQUENCE
from tpufw_torch.ops import flash as F
from tpufw_torch.parallel.context import current_mesh, sequence_group

NEG_INF = F.NEG_INF

# Chunk cases: the visiting kv chunk lies wholly before the q shard, is
# its diagonal, or lies after it.
FULL, DIAG, EMPTY = 0, 1, 2

# Kernel launches of ring-flash since the last reset, by chunk case: the
# forward's, and the backward's (one dQ and one dK/dV launch a chunk).
CHUNK_LAUNCHES = {"fwd_full": 0, "fwd_diag": 0, "bwd_full": 0, "bwd_diag": 0}


def reset_chunk_launches() -> None:
    for name in CHUNK_LAUNCHES:
        CHUNK_LAUNCHES[name] = 0


def _case(src: int, idx: int) -> int:
    return DIAG if src == idx else (EMPTY if src > idx else FULL)


def _masks(case, step, l, soft_cap, window, qseg, kseg):
    """The kernels' mask arguments for a chunk of ``case`` at ring
    ``step``: the diagonal causal at offset 0, a full chunk non-causal at
    the static chunk distance step·L, so a window sees global
    positions (with offset ≥ L every pair is causal already)."""
    causal = case == DIAG
    return dict(causal=causal, offset=0 if causal else step * l,
                soft_cap=soft_cap, window=window, qseg=qseg, kseg=kseg)


def _chunk_fwd(case, step, q, k, v, qseg, kseg, soft_cap=None, window=None):
    """One q-shard × kv-chunk flash forward: (o [B,L,H,D] in q's dtype,
    lse fp32 [B,H,L]), or None for an empty chunk (no launch)."""
    if case == EMPTY:
        return None
    CHUNK_LAUNCHES["fwd_full" if case == FULL else "fwd_diag"] += 1
    return F.flash_fwd(q, k, v, **_masks(case, step, q.shape[1], soft_cap,
                                         window, qseg, kseg))


def _chunk_bwd(case, step, q, k, v, qseg, kseg, do, lse, delta,
               soft_cap=None, window=None):
    """A chunk's (dq in q's dtype, dk and dv in k's dtype) from the flash
    backward kernels with the GLOBAL lse, the GQA sum of dk/dv done per
    chunk as ``flash_attention`` does it; None for an empty chunk."""
    if case == EMPTY:
        return None
    CHUNK_LAUNCHES["bwd_full" if case == FULL else "bwd_diag"] += 1
    masks = _masks(case, step, q.shape[1], soft_cap, window, qseg, kseg)
    dq = F.flash_dq(q, k, v, do, lse, delta, **masks)
    dk_full, dv_full = F.flash_dkv(q, k, v, do, lse, delta, **masks)
    kh = k.shape[2]
    return dq, F.gqa_sum(dk_full, kh, k.dtype), F.gqa_sum(dv_full, kh, v.dtype)


def _merge(out, lse, o_c, lse_c):
    """Merge normalized partials by log-sum-exp (the module's formula);
    out fp32 [B,L,H,D], lse fp32 [B,H,L]."""
    lse_new = torch.logaddexp(lse, lse_c)
    w1 = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(lse - lse_new))
    w2 = torch.where(lse_c <= NEG_INF / 2, 0.0, torch.exp(lse_c - lse_new))
    # [B,H,L] weights -> [B,L,H,1] to scale [B,L,H,D] outputs.
    return (w1.transpose(1, 2)[..., None] * out
            + w2.transpose(1, 2)[..., None] * o_c.float(), lse_new)


def _n_live_steps(n: int, l: int, window) -> int:
    """How many ring steps can contribute under a sliding window.

    At step s > 0 the visiting chunk sits exactly s·L positions behind
    the q shard, so the closest pair is (s−1)·L + 1 apart; once that
    reaches the window the chunk, and every later (farther) one, is
    invisible. A window spanning w shards runs about w of n steps."""
    if window is None:
        return n
    s = 1
    while s < n and (s - 1) * l + 1 < window:
        s += 1
    return s


class _RingFlash(torch.autograd.Function):
    """The ring over the held shards. Inputs after the static arguments:
    the lists q, k, v (and qseg) flattened, ``n_held`` tensors each."""

    @staticmethod
    def forward(ctx, group, soft_cap, window, n_held, *tensors):
        qs, ks, vs = (list(tensors[i * n_held:(i + 1) * n_held])
                      for i in range(3))
        qsegs = list(tensors[3 * n_held:]) or None
        n = group.size
        b, l, h, d = qs[0].shape
        steps = _n_live_steps(n, l, window)
        outs = [torch.zeros(b, l, h, d, dtype=torch.float32, device=q.device)
                for q in qs]
        lses = [torch.full((b, h, l), NEG_INF, device=q.device) for q in qs]
        k_cur, v_cur, kseg_cur = ks, vs, qsegs
        for step in range(steps):
            for i, idx in enumerate(group.indices):
                res = _chunk_fwd(
                    _case((idx - step) % n, idx), step, qs[i], k_cur[i],
                    v_cur[i], qsegs and qsegs[i], kseg_cur and kseg_cur[i],
                    soft_cap, window)
                # Merging an empty chunk (o 0, lse NEG_INF) is the identity.
                if res is not None:
                    outs[i], lses[i] = _merge(outs[i], lses[i], *res)
            if step < steps - 1:
                k_cur, v_cur = group.rotate(k_cur, v_cur)
                if qsegs:
                    (kseg_cur,) = group.rotate(kseg_cur)
        outs = [o.to(q.dtype) for o, q in zip(outs, qs)]
        ctx.group, ctx.soft_cap, ctx.window, ctx.n_held = (
            group, soft_cap, window, n_held)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses, *(qsegs or ()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        group, nh = ctx.group, ctx.n_held
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * nh:(i + 1) * nh])
                                  for i in range(5))
        qsegs = list(saved[5 * nh:]) or None
        n = group.size
        l = qs[0].shape[1]
        steps = _n_live_steps(n, l, ctx.window)
        gs = [g.contiguous() for g in grads]
        # Δ = rowsum(dO∘O) once, from the merged output.
        deltas = [F.flash_delta(o, g) for o, g in zip(outs, gs)]
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in qs]
        dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
               for k in ks]
        dvs = [torch.zeros_like(x) for x in dks]
        k_cur, v_cur, kseg_cur = ks, vs, qsegs
        for step in range(steps):
            for i, idx in enumerate(group.indices):
                res = _chunk_bwd(
                    _case((idx - step) % n, idx), step, qs[i], k_cur[i],
                    v_cur[i], qsegs and qsegs[i], kseg_cur and kseg_cur[i],
                    gs[i], lses[i], deltas[i], ctx.soft_cap, ctx.window)
                if res is not None:
                    dqs[i] += res[0].float()
                    dks[i] += res[1].float()
                    dvs[i] += res[2].float()
            # The accumulators rotate with their chunk every live step;
            # the hop home happens below, once.
            if step < steps - 1:
                k_cur, v_cur, dks, dvs = group.rotate(k_cur, v_cur, dks, dvs)
                if qsegs:
                    (kseg_cur,) = group.rotate(kseg_cur)
        # After steps − 1 rotations the chunk of shard o sits on shard
        # (o + steps − 1) % n: one rotation of n − (steps − 1) sends
        # every accumulator home.
        home = (n - (steps - 1)) % n
        if home:
            dks, dvs = group.rotate(dks, dvs, shift=home)
        return (None, None, None, None,
                *[dq.to(q.dtype) for dq, q in zip(dqs, qs)],
                *[dk.to(k.dtype) for dk, k in zip(dks, ks)],
                *[dv.to(v.dtype) for dv, v in zip(dvs, vs)],
                *([None] * len(qsegs or ())))


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    mesh=None,
    axis_name: str = AXIS_SEQUENCE,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel flash attention. q:[B,T,H,D], k/v:[B,T,K,D] as
    this process holds them (see ``parallel.ring.ring_attention``).
    Causal only (the LM path): the chunk-level case analysis assumes it.

    On CUDA tensors each live chunk launches the flash kernels; on CPU
    tensors they are the kernels' plain versions. ``sliding_window``
    runs in-kernel with global positions and cuts the ring short: chunks
    wholly beyond the window are never computed or rotated
    (``_n_live_steps``)."""
    if not causal:
        raise NotImplementedError(
            "ring_flash_attention is causal-only; use the einsum ring "
            "(impl='einsum') for non-causal sequence parallelism"
        )
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(
            "ring_flash_attention needs a mesh: pass mesh= or register one "
            "via tpufw_torch.parallel.context.use_mesh(...)"
        )
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"ring attention is self-attention only: T={q.shape[1]} != "
            f"S={k.shape[1]}"
        )
    h, kh = q.shape[2], k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kh}")
    cap = None if logits_soft_cap is None else float(logits_soft_cap)
    win = None if sliding_window is None else int(sliding_window)
    if win is not None and win < 1:
        raise ValueError(f"sliding_window must be >= 1, got {win}")
    group = sequence_group(mesh, axis_name)
    parts = [[x.contiguous() for x in group.split(t)] for t in (q, k, v)]
    if segment_ids is not None:
        parts.append([s.contiguous() for s in group.split(
            segment_ids.to(torch.int32))])
    outs = _RingFlash.apply(group, cap, win, len(parts[0]),
                            *[x for p in parts for x in p])
    return group.join(list(outs))
