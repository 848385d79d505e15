"""Chunked-vocab cross-entropy: LM loss without the [B, T, V] fp32 tensor
(port of ``tpufw.ops.loss``).

The sequence axis is cut into chunks; each chunk's logits are computed
from the hidden states, reduced to per-token CE and dropped, and the
backward pass recomputes them (``torch.utils.checkpoint``). Peak logits
memory is B * chunk * V fp32 instead of B * T * V.

Under a tensor group (``parallel.group.TensorGroup``: the head split on
the vocabulary, Megatron's vocab-parallel cross-entropy) each chunk's
logits stay [chunk, V/tp] per held shard: the row max, the sum of exps
and the target's logit (which only the shard owning the target has) are
reduced over the group, the z-loss is taken on the combined
log-sum-exp, and the backward is each shard's softmax minus its part of
the one-hot (``vocab_parallel_token_ce``).

The post-training objectives take the same chunked head path:
``chunked_sequence_logprob`` (per-row sums, DPO) and
``chunked_token_logprob`` (per-token, GRPO) give target log-probs with
no z-loss; the final soft cap applies first, then ``logits_scale``
(1/temperature), the sampler's order. They take ``group=`` too: each
vocabulary shard contributes its part of the log-sum-exp and the
target's logit where the target falls in its range.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpufw_torch.ops.attention import tanh_soft_cap


def token_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, z_loss_weight: float = 1e-4
) -> torch.Tensor:
    """Per-token CE with z-loss, in fp32. [..., V] logits, [...] targets ->
    [...] ce."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ce = logz - label
    if z_loss_weight:
        ce = ce + z_loss_weight * logz.square()
    return ce


def vocab_parallel_logsumexp(logit_shards: list, group) -> torch.Tensor:
    """The log-sum-exp [...] over the whole vocabulary of logits split
    into the held ``logit_shards`` [..., V_i]: the row max and the sum of
    exps reduced over ``group``, the same on every shard. A loss that
    uses it must use it whole, outside the per-shard parts a ``reduce``
    sums, for its gradient to reach every shard whole."""
    m = group.max([x.amax(-1) for x in logit_shards])
    return m + torch.log(group.reduce(
        [torch.exp(x - m[..., None]).sum(-1) for x in logit_shards]))


def vocab_parallel_token_ce(
    logit_shards: list, ranges: list, targets: torch.Tensor, group,
    z_loss_weight: float = 1e-4,
) -> torch.Tensor:
    """``token_cross_entropy`` of logits split on the vocabulary:
    ``logit_shards`` [..., V_i] are the held shards' logits over the
    vocabulary ranges ``ranges`` [(lo, hi)], ``group`` the split's
    ``ShardGroup``. The max and the reductions span the whole group, so
    every shard computes the same [...] ce."""
    ls = [x.float() for x in logit_shards]
    logz = vocab_parallel_logsumexp(ls, group)
    t = targets.long()
    picked = []
    for x, (lo, hi) in zip(ls, ranges):
        inside = (t >= lo) & (t < hi)
        local = torch.where(inside, t - lo, 0)
        got = torch.gather(x, -1, local[..., None])[..., 0]
        picked.append(torch.where(inside, got, torch.zeros_like(got)))
    ce = logz - group.reduce(picked)
    if z_loss_weight:
        ce = ce + z_loss_weight * logz.square()
    return ce


class _MatmulF32Out(torch.autograd.Function):
    """[N, D] x [D, V], or batched [E, N, D] x [E, D, V], in a
    low-precision dtype with fp32 output, as ``preferred_element_type=
    float32`` gives in the JAX package: the products see the rounded
    inputs, the sums stay fp32."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if a.is_cuda:
            mm = torch.mm if a.ndim == 2 else torch.bmm
            return mm(a, w, out_dtype=torch.float32)
        return a.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.transpose(-1, -2), a.transpose(-1, -2) @ g


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with fp32 output for 2-D or batched 3-D operands of one
    dtype: ``_MatmulF32Out`` for a low-precision one, a plain product
    for fp32."""
    if a.dtype == torch.float32:
        return a @ w
    return _MatmulF32Out.apply(a, w)


def head_logits(
    h: torch.Tensor, kernel: torch.Tensor, compute_dtype: torch.dtype
) -> torch.Tensor:
    """fp32 logits [..., V] = h [..., D] @ kernel [D, V], with both inputs
    cast to ``compute_dtype`` first."""
    a = h.to(compute_dtype).reshape(-1, h.shape[-1])
    w = kernel.to(compute_dtype)
    return matmul_f32(a, w).reshape(*h.shape[:-1], w.shape[-1])


def _vocab_logits(h, kernel, compute_dtype, logits_soft_cap, logits_scale,
                  group=None) -> list:
    """fp32 logits of one [B, C, D] chunk against each held vocabulary
    shard of ``kernel`` [D, V] (the whole head at one shard): the cap,
    then the scale."""
    kernels = [kernel] if group is None or group.size == 1 \
        else group.shards(kernel, 1)
    out = []
    for w in kernels:
        logits = head_logits(h, w, compute_dtype)
        if logits_soft_cap is not None:
            logits = tanh_soft_cap(logits, logits_soft_cap)
        if logits_scale != 1.0:
            logits = logits * logits_scale
        out.append(logits)
    return out


def _vocab_ce(shards: list, kernel, targets, group,
              z_loss_weight: float) -> torch.Tensor:
    """Per-token CE of ``_vocab_logits``' shards: over the whole
    vocabulary, vocab-parallel under a ``group`` of more than one
    shard."""
    if group is None or group.size == 1:
        return token_cross_entropy(shards[0], targets, z_loss_weight)
    v = kernel.shape[1] * group.size // len(group.indices)
    return vocab_parallel_token_ce(shards, group.ranges(v), targets, group,
                                   z_loss_weight)


def _chunk_ce_sum(h, kernel, targets, mask, z_loss_weight, compute_dtype,
                  logits_soft_cap, group=None):
    """Masked CE sum of one [B, C, D] chunk (z-loss included); under a
    ``group`` of more than one shard, vocab-parallel over ``kernel``'s
    held shards."""
    shards = _vocab_logits(h, kernel, compute_dtype, logits_soft_cap, 1.0,
                           group)
    return (_vocab_ce(shards, kernel, targets, group, z_loss_weight)
            * mask).sum()


def _chunk_seq(chunk_size: int, hidden, targets, mask):
    """Pad T up to a chunk multiple and cut each array into [B, chunk, ...]
    pieces along the sequence axis (the padding of
    ``tpufw.ops.loss._chunk_seq``: zeros, which the mask drops)."""
    t = hidden.shape[1]
    pad = -(-t // chunk_size) * chunk_size - t
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    return (
        hidden.split(chunk_size, dim=1),
        targets.split(chunk_size, dim=1),
        mask.split(chunk_size, dim=1),
    )


def _enter(hidden: torch.Tensor, group) -> torch.Tensor:
    """``hidden`` entering a head split over ``group``."""
    return hidden if group is None or group.size == 1 else group.enter(hidden)


def chunked_cross_entropy(
    hidden: torch.Tensor,
    kernel: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 1e-4,
    chunk_size: int = 256,
    compute_dtype: torch.dtype = torch.bfloat16,
    logits_soft_cap: Optional[float] = None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token CE from pre-head hidden states, chunked over the sequence axis.

    hidden [B, T, D] (post final-norm), kernel [D, V] (the LM head, or the
    transposed embedding when tied), targets [B, T] ints, mask optional
    [B, T] float weights. Returns (mean loss over unmasked tokens, number
    of unmasked tokens). ``group``: a tensor group the head is split over
    (``kernel`` whole in one process, this rank's [D, V/tp] in a gang);
    the loss is then vocab-parallel.
    """
    hidden = _enter(hidden, group)
    b, t, _ = hidden.shape
    if mask is None:
        mask = torch.ones(b, t, dtype=torch.float32, device=hidden.device)
    hs, ts, ms = _chunk_seq(chunk_size, hidden, targets, mask.float())
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h_c, t_c, m_c in zip(hs, ts, ms):
        ce_sum = ce_sum + checkpoint(
            _chunk_ce_sum, h_c, kernel, t_c, m_c, z_loss_weight,
            compute_dtype, logits_soft_cap, group, use_reentrant=False,
        )
        n = n + m_c.sum()
    return ce_sum / torch.clamp(n, min=1.0), n


def _chunk_logp(h, kernel, targets, compute_dtype, logits_soft_cap,
                logits_scale, group=None):
    """Target log-probs [B, C] of one chunk: the cap, then the scale,
    then log-softmax (CE with no z-loss, negated); under a ``group`` of
    more than one shard, each vocabulary shard's part of the log-sum-exp
    and of the target's logit summed over the group."""
    shards = _vocab_logits(h, kernel, compute_dtype, logits_soft_cap,
                           logits_scale, group)
    return -_vocab_ce(shards, kernel, targets, group, 0.0)


def _chunk_row_logp(h, kernel, targets, mask, compute_dtype,
                    logits_soft_cap, group=None):
    """Masked per-row log-prob sums [B] of one chunk."""
    return (_chunk_logp(h, kernel, targets, compute_dtype, logits_soft_cap,
                        1.0, group) * mask).sum(-1)


def chunked_sequence_logprob(
    hidden: torch.Tensor,
    kernel: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    chunk_size: int = 256,
    compute_dtype: torch.dtype = torch.bfloat16,
    logits_soft_cap: Optional[float] = None,
    group=None,
) -> torch.Tensor:
    """[B] fp32 sums of the target log-probs where ``mask`` is set,
    chunked like ``chunked_cross_entropy``: hidden [B, T, D] (post
    final-norm), kernel [D, V], targets [B, T] (already shifted), mask
    [B, T] float weights. ``group``: a tensor group the head is split
    over, as in ``chunked_cross_entropy``."""
    hidden = _enter(hidden, group)
    hs, ts, ms = _chunk_seq(chunk_size, hidden, targets, mask.float())
    sums = torch.zeros(hidden.shape[0], dtype=torch.float32,
                       device=hidden.device)
    for h_c, t_c, m_c in zip(hs, ts, ms):
        sums = sums + checkpoint(
            _chunk_row_logp, h_c, kernel, t_c, m_c, compute_dtype,
            logits_soft_cap, group, use_reentrant=False,
        )
    return sums


def chunked_token_logprob(
    hidden: torch.Tensor,
    kernel: torch.Tensor,
    targets: torch.Tensor,
    chunk_size: int = 256,
    compute_dtype: torch.dtype = torch.bfloat16,
    logits_soft_cap: Optional[float] = None,
    logits_scale: float = 1.0,
    group=None,
) -> torch.Tensor:
    """Per-token target log-probs [B, T] in fp32, chunked like
    ``chunked_cross_entropy``. ``logits_scale`` (1/temperature) applies
    after the soft cap, as the decode path caps its logits and the
    sampler then divides by the temperature: these are the behaviour
    policy's log-probs. ``group``: a tensor group the head is split
    over."""
    t = hidden.shape[1]
    hidden = _enter(hidden, group)
    ones = torch.ones(targets.shape, dtype=torch.float32,
                      device=hidden.device)
    hs, ts, _ = _chunk_seq(chunk_size, hidden, targets, ones)
    chunks = [
        checkpoint(_chunk_logp, h_c, kernel, t_c, compute_dtype,
                   logits_soft_cap, logits_scale, group, use_reentrant=False)
        for h_c, t_c in zip(hs, ts)
    ]
    return torch.cat(chunks, dim=1)[:, :t]
