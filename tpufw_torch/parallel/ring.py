"""Ring attention: sequence parallelism over the ``sequence`` mesh axis
(port of ``tpufw.parallel.ring``).

Activations are split along the sequence; K/V shards rotate around the
ring (``SequenceGroup.rotate``, NCCL send/receive between neighbours)
while each shard accumulates attention for its resident Q with
online-softmax merging. Shard d holds positions [d·L, (d+1)·L); masks
compare global positions, so the same code handles the full, partial and
empty chunk cases.

``impl="einsum"`` (this module) materializes each chunk's logits: the
reference implementation. ``impl="flash"`` runs the CUDA flash kernels
per chunk (``parallel.ring_flash``), O(L) memory a shard.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpufw_torch.mesh.mesh import AXIS_SEQUENCE
from tpufw_torch.ops.attention import NEG_INF, _repeat_kv, tanh_soft_cap
from tpufw_torch.parallel.context import current_mesh, sequence_group


def _chunk_attn(q, k, v, q_start, k_start, causal, scale, rep, qseg=None,
                kseg=None, soft_cap=None, window=None):
    """Attention of local q against one kv chunk: (acc, m, l) stats.

    q: [B,T,H,D], k/v: [B,S,K,D] with H = K*rep (the GQA repeat happens
    here, after the rotation, so the ring never moves repeated bytes).
    qseg [B,T] / kseg [B,S]: packed-batch segment ids; the key-side ids
    rotate with their kv chunk. m/l: [B,H,T,1] running max / normalizer
    in fp32."""
    k = _repeat_kv(k, rep)
    v = _repeat_kv(v, rep)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if soft_cap is not None:
        # Elementwise: capping each chunk before the merge equals capping
        # the full logits.
        logits = tanh_soft_cap(logits, soft_cap)
    mask = None
    if causal or window is not None:
        t, s = q.shape[1], k.shape[1]
        q_pos = q_start + torch.arange(t, device=q.device)[:, None]
        k_pos = k_start + torch.arange(s, device=q.device)[None, :]
        if causal:
            mask = (q_pos >= k_pos)[None, None]
        if window is not None:
            near = ((q_pos - k_pos) < window)[None, None]
            mask = near if mask is None else (mask & near)
    if qseg is not None:
        seg_mask = qseg[:, None, :, None] == kseg[:, None, None, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)  # [B,H,T,1]
    p = torch.exp(logits - m)
    # Fully masked chunk rows: exp(NEG_INF - NEG_INF) would be 1.
    p = torch.where(m <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhts,bshd->bhtd", p.to(q.dtype), v).float()
    return acc, m, l


def _ring_attn_local(qs, ks, vs, qsegs, *, group, causal, scale, rep,
                     soft_cap, window):
    """The ring body over the shards this process holds: lists of q
    [B,L,H,D], k/v [B,L,K,D] and qseg [B,L] (or None); the key-side
    segment ids start as the query-side ones and ride the ring with their
    kv chunk. Returns the list of outputs [B,L,H,D]."""
    n = group.size
    b, t_local, h, d = qs[0].shape
    dev = qs[0].device
    has_seg = qsegs is not None
    m = [torch.full((b, h, t_local, 1), NEG_INF, device=dev) for _ in qs]
    l = [torch.zeros(b, h, t_local, 1, device=dev) for _ in qs]
    acc = [torch.zeros(b, h, t_local, d, device=dev) for _ in qs]
    k_cur, v_cur = list(ks), list(vs)
    kseg_cur = list(qsegs) if has_seg else None
    for step in range(n):
        for i, idx in enumerate(group.indices):
            src = (idx - step) % n
            acc_c, m_c, l_c = _chunk_attn(
                qs[i], k_cur[i], v_cur[i], q_start=idx * t_local,
                k_start=src * t_local, causal=causal, scale=scale, rep=rep,
                qseg=qsegs[i] if has_seg else None,
                kseg=kseg_cur[i] if has_seg else None,
                soft_cap=soft_cap, window=window,
            )
            m_new = torch.maximum(m[i], m_c)
            alpha = torch.where(m[i] <= NEG_INF / 2, 0.0,
                                torch.exp(m[i] - m_new))
            beta = torch.where(m_c <= NEG_INF / 2, 0.0, torch.exp(m_c - m_new))
            l[i] = l[i] * alpha + l_c * beta
            acc[i] = acc[i] * alpha + acc_c * beta
            m[i] = m_new
        if step < n - 1:
            if has_seg:
                k_cur, v_cur, kseg_cur = group.rotate(k_cur, v_cur, kseg_cur)
            else:
                k_cur, v_cur = group.rotate(k_cur, v_cur)
    outs = []
    for i, q in enumerate(qs):
        l_safe = torch.where(l[i] == 0.0, 1.0, l[i])
        outs.append((acc[i] / l_safe).to(q.dtype).transpose(1, 2))
    return outs


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    mesh=None,
    axis_name: str = AXIS_SEQUENCE,
    impl: Optional[str] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention. q:[B,T,H,D], k/v:[B,S,K,D] as this
    process holds them: its shard of the sequence under a gang's
    ``DeviceMesh``, the whole sequence under a ``LocalSequenceGroup``.

    Needs a registered current mesh (``parallel.context``) or an
    explicit ``mesh``. T must equal S (self-attention) and divide evenly
    by the ring's size. ``segment_ids`` ([B, T] int) masks cross-segment
    attention for packed batches; the key-side copy rotates with its kv
    chunk.

    ``impl``: "flash" = the CUDA flash kernels per chunk
    (``parallel.ring_flash``); "einsum" = materialized per-chunk logits
    (the reference). Default (None) picks flash for causal CUDA tensors
    and einsum elsewhere. ``logits_soft_cap`` and ``sliding_window`` work
    on both impls."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError(
            "ring_attention needs a mesh: pass mesh= or register one via "
            "tpufw_torch.parallel.context.use_mesh(...)"
        )
    if sliding_window is not None and sliding_window < 1:
        # Checked here so both impls fail loudly: window=0 would mask
        # every logit (einsum would silently emit uniform-softmax means).
        raise ValueError(
            f"sliding_window must be >= 1, got {sliding_window}"
        )
    if impl is None:
        impl = "flash" if (causal and q.is_cuda) else "einsum"
    if impl == "flash":
        from tpufw_torch.parallel.ring_flash import ring_flash_attention

        return ring_flash_attention(
            q, k, v, causal=causal, segment_ids=segment_ids, mesh=mesh,
            axis_name=axis_name, logits_soft_cap=logits_soft_cap,
            sliding_window=sliding_window,
        )
    if impl != "einsum":
        raise ValueError(f"unknown ring impl {impl!r}")
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"ring attention is self-attention only: T={q.shape[1]} != "
            f"S={k.shape[1]}"
        )
    group = sequence_group(mesh, axis_name)
    rep = q.shape[2] // k.shape[2]
    seg = None if segment_ids is None else group.split(
        segment_ids.to(torch.int32))
    outs = _ring_attn_local(
        group.split(q), group.split(k), group.split(v), seg, group=group,
        causal=causal, scale=1.0 / math.sqrt(q.shape[-1]), rep=rep,
        soft_cap=logits_soft_cap, window=sliding_window,
    )
    return group.join(outs)
