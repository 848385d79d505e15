"""Attention ops with switchable backends (port of ``tpufw.ops.attention``).

- ``"xla"``   — plain softmax attention over materialized logits; runs
                anywhere and is the correctness reference (the name is
                kept from the JAX package so configs carry over).
- ``"flash"`` — the hand-written CUDA flash-attention kernels
                (``tpufw_torch.ops.flash``); on CPU tensors their plain
                PyTorch versions.
- ``"ring"``  — sequence-parallel ring attention over the ``sequence``
                mesh axis (``tpufw_torch.parallel.ring``), ring-flash on
                CUDA tensors.
- ``"ulysses"`` — sequence-parallel all-to-all attention
                (``tpufw_torch.parallel.ulysses``).

All backends take [B, T, H, D] q and [B, S, K, D] k/v with K (kv heads)
dividing H (GQA: query head h reads kv head h // (H // K)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def tanh_soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, K, D] -> [B, S, K*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return x
    b, s, k, d = x.shape
    return x[:, :, :, None, :].expand(b, s, k, n_rep, d).reshape(
        b, s, k * n_rep, d
    )


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Reference softmax attention. q:[B,T,H,D], k/v:[B,S,K,D] -> [B,T,H,D].

    Same semantics as ``tpufw.ops.attention.xla_attention``: queries sit
    at the final T of the S key positions unless ``q_positions`` gives
    them; the soft cap is applied before the mask; masked logits are
    filled with -1e30; the softmax runs in fp32 and the probabilities are
    cast to q's dtype before the product with V.
    """
    b, t, h, d = q.shape
    _, s, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kh}")
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)

    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = tanh_soft_cap(logits, logits_soft_cap)

    mask = None
    kpos = torch.arange(s, device=q.device)[None, None, None, :]
    if causal or sliding_window is not None:
        if q_positions is None:
            qpos = (torch.arange(t, device=q.device) + (s - t))[
                None, None, :, None
            ]
        else:
            qpos = q_positions[:, None, :, None]
        if causal:
            mask = qpos >= kpos
        if sliding_window is not None:
            near = (qpos - kpos) < sliding_window
            mask = near if mask is None else (mask & near)
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        seg_mask = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def local_attention(
    backend: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    offset: Optional[int] = None,
) -> torch.Tensor:
    """The ``xla`` or ``flash`` backend on the tensors as given, whatever
    mesh is registered. ``offset`` (flash) is the key position of query
    0, as ``q_positions`` gives each query's to xla."""
    if backend == "xla":
        return xla_attention(
            q,
            k,
            v,
            causal=causal,
            segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids,
            q_positions=q_positions,
            logits_soft_cap=logits_soft_cap,
            sliding_window=sliding_window,
        )
    if backend == "flash":
        from tpufw_torch.ops.flash import flash_attention

        return flash_attention(
            q, k, v, causal=causal, segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids, logits_soft_cap=logits_soft_cap,
            sliding_window=sliding_window, offset=offset,
        )
    raise ValueError(f"unknown attention backend {backend!r}")


def _gathered_attention(backend, group, q, k, v, causal, segment_ids,
                        logits_soft_cap, sliding_window):
    """``backend`` over a sequence split across processes: the ring's
    K/V (and key segment ids) gathered whole with their gradient, and
    this shard's queries at their global positions rank·L + i: what
    ``tpufw``'s GSPMD computes for a non-parallel backend under a
    sequence axis."""
    (k_all,) = group.all_gather([k], dim=1)
    (v_all,) = group.all_gather([v], dim=1)
    kseg = None
    if segment_ids is not None:
        (kseg,) = group.all_gather([segment_ids.contiguous()], dim=1)
    b, t = q.shape[:2]
    offset = group.rank * t
    q_pos = None
    if backend == "xla":
        q_pos = (offset + torch.arange(t, device=q.device)).expand(b, t)
    return local_attention(
        backend, q, k_all, v_all, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kseg, q_positions=q_pos,
        logits_soft_cap=logits_soft_cap, sliding_window=sliding_window,
        offset=offset,
    )


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    backend: str = "xla",
) -> torch.Tensor:
    """Backend dispatcher — the single attention entry point for models.

    ``ring`` and ``ulysses`` are sequence-parallel
    (``tpufw_torch.parallel``) and need a registered mesh. Under a
    registered mesh whose sequence split leaves this process one shard,
    ``xla`` and ``flash`` attend from the local queries over the gathered
    sequence."""
    if backend != "xla" and (
            kv_segment_ids is not None or q_positions is not None):
        raise NotImplementedError(
            f"KV-cache decode (kv_segment_ids/q_positions) requires "
            f"backend='xla', got {backend!r}"
        )
    if backend in ("ring", "ulysses"):
        kw = dict(causal=causal, segment_ids=segment_ids,
                  logits_soft_cap=logits_soft_cap,
                  sliding_window=sliding_window)
        if backend == "ring":
            from tpufw_torch.parallel.ring import ring_attention

            return ring_attention(q, k, v, **kw)
        from tpufw_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, **kw)
    if backend not in ("xla", "flash"):
        raise ValueError(f"unknown attention backend {backend!r}")
    if kv_segment_ids is None and q_positions is None:
        from tpufw_torch.parallel.context import partial_sequence_group

        group = partial_sequence_group()
        if group is not None:
            return _gathered_attention(
                backend, group, q, k, v, causal, segment_ids,
                logits_soft_cap, sliding_window)
    return local_attention(
        backend, q, k, v, causal=causal, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, q_positions=q_positions,
        logits_soft_cap=logits_soft_cap, sliding_window=sliding_window,
    )
