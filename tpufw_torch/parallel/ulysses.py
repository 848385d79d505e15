"""Ulysses sequence parallelism: all-to-all head/sequence swap (port of
``tpufw.parallel.ulysses``).

The second long-context strategy beside the ring: two all-to-all
transposes turn sequence-split projections [B, T/P, H, D] into
head-split ones [B, T, H/P, D], each shard runs ordinary full-sequence
attention over its head group (the flash kernels unchanged), and one
reverse all-to-all restores the sequence split.

Against the ring: two collectives in all and no per-chunk merge, but P
must divide the head count left after any tensor split (each tensor
shard swaps its own heads). GQA: when the kv-head count does not divide
by P, the kv heads are repeated up to the query head count before the
swap (more bytes, the same math).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpufw_torch.mesh.mesh import AXIS_SEQUENCE
from tpufw_torch.ops.attention import _repeat_kv, local_attention
from tpufw_torch.parallel.context import current_mesh, sequence_group


def _ulysses_local(qs, ks, vs, qsegs, *, group, causal, backend, soft_cap,
                   window):
    """The body over the held shards: lists of q [B, T/P, H, D], k/v
    [B, T/P, K, D] and qseg [B, T/P] (or None)."""
    n = group.size
    h, kh = qs[0].shape[2], ks[0].shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs sequence-axis size {n} to divide the local "
            f"query head count {h}"
        )
    if kh % n:
        # GQA with too few kv heads for the swap: repeat up to H first.
        ks = [_repeat_kv(k, h // kh) for k in ks]
        vs = [_repeat_kv(v, h // kh) for v in vs]

    def swap(xs):  # [B, T/P, H, D] -> [B, T, H/P, D]
        return group.all_to_all(xs, split_dim=2, concat_dim=1)

    q_g, k_g, v_g = swap(qs), swap(ks), swap(vs)
    # Every shard needs the full-length segment ids for its heads.
    seg_full = (group.all_gather(qsegs, dim=1) if qsegs is not None
                else [None] * len(qs))
    outs = [
        local_attention(backend, q, k, v, causal=causal, segment_ids=s,
                        logits_soft_cap=soft_cap, sliding_window=window)
        for q, k, v, s in zip(q_g, k_g, v_g, seg_full)
    ]  # [B, T, H/P, D] each
    # Reverse swap: back to [B, T/P, H, D].
    return group.all_to_all(outs, split_dim=1, concat_dim=2)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    mesh=None,
    axis_name: str = AXIS_SEQUENCE,
    backend: Optional[str] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention via all-to-all. q: [B,T,H,D], k/v:
    [B,S,K,D] as this process holds them (see
    ``parallel.ring.ring_attention``); self-attention only (T == S), and
    the ring's size must divide T and H.

    ``backend`` is the local attention each shard runs on its head group
    ("xla" or "flash"); the default picks flash for causal CUDA tensors,
    xla elsewhere. ``logits_soft_cap``/``sliding_window`` pass straight
    through: each shard sees the full sequence for its heads."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(
            "ulysses_attention needs a mesh: pass mesh= or register one "
            "via tpufw_torch.parallel.context.use_mesh(...)"
        )
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"ulysses attention is self-attention only: T={q.shape[1]} "
            f"!= S={k.shape[1]}"
        )
    if backend is None:
        backend = "flash" if (causal and q.is_cuda) else "xla"
    if backend not in ("xla", "flash"):
        raise ValueError(
            f"ulysses local backend must be 'xla' or 'flash', "
            f"got {backend!r}"
        )
    group = sequence_group(mesh, axis_name)
    seg = None if segment_ids is None else group.split(
        segment_ids.to(torch.int32))
    outs = _ulysses_local(
        group.split(q), group.split(k), group.split(v), seg, group=group,
        causal=causal, backend=backend, soft_cap=logits_soft_cap,
        window=sliding_window,
    )
    return group.join(outs)
