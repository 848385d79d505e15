"""Top-k capacity-bounded MoE routing (port of ``tpufw.ops.moe``).

Two routings with one selection, one priority order and one set of aux
statistics:

- ``route_topk_capacity``: GShard-style one-hot dispatch and combine
  tensors [G, E, C], contracted with the tokens and the expert outputs;
- ``route_topk_sorted``: the k*G (token, expert) assignments sorted by
  expert, for grouped expert matmuls.

Per routing group of G tokens each expert accepts at most C slots. The
priority is slot-major: every token's slot 0 before any token's slot 1,
earlier tokens first. Overflowing assignments are dropped (the residual
stream carries those tokens unchanged). Invalid rows (padding, idle pool
slots) take no capacity and no share of the aux statistics.

Top-k breaks ties by index, lower first, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order among equal values): a stable
descending sort, cut at k. Ties have measure zero under real routers, but
the group-limited mask makes exact zeros.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def expert_capacity(g: int, k: int, e: int, capacity_factor: float) -> int:
    """Per-expert slot count for a routing group of ``g`` tokens:
    ``capacity_factor`` x the balanced load g*k/e, never below ``k``."""
    return max(int(capacity_factor * g * k / e), k)


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, equal
    values in index order (``jax.lax.top_k``'s)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_select(
    router_logits: torch.Tensor,
    k: int,
    norm_topk: bool,
    group_limit: Optional[tuple[int, int]],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selection shared by both routings: softmax, optional DeepSeek
    group-limited masking, top-k, optional top-k renormalization. Returns
    (probs [G,E], topk_probs [G,k], topk_idx [G,k])."""
    g, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    sel_probs = probs
    if group_limit is not None:
        n_group, topk_group = group_limit
        if e % n_group:
            raise ValueError(
                f"group_limit: n_group={n_group} must divide E={e}"
            )
        per_group = e // n_group
        if k > topk_group * per_group:
            raise ValueError(
                f"group_limit: k={k} exceeds the {topk_group} surviving "
                f"groups' {topk_group * per_group} experts"
            )
        if topk_group < n_group:
            group_max = probs.reshape(g, n_group, per_group).amax(-1)
            kth = _topk(group_max, topk_group)[0][..., -1:]
            # Exact ties between group maxima keep both groups.
            keep = (group_max >= kth).repeat_interleave(per_group, dim=-1)
            # Masked experts weigh 0, survivors keep their softmax mass.
            sel_probs = torch.where(keep, probs, torch.zeros_like(probs))
    topk_probs, topk_idx = _topk(sel_probs, k)
    if norm_topk:
        topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True)
    return probs, topk_probs, topk_idx


def _router_stats(router_logits, probs, top1_mask, validf, g):
    """Switch-style load-balance statistic and router z, over valid rows:
    ONE copy for both routings."""
    lse_sq = torch.logsumexp(router_logits, dim=-1).square()
    if validf is None:
        frac_tokens = top1_mask.sum(0) / float(g)
        frac_probs = probs.mean(0)
        z = lse_sq.mean()
    else:
        n_valid = torch.clamp(validf.sum(), min=1.0)
        frac_tokens = top1_mask.sum(0) / n_valid
        frac_probs = (probs * validf[:, None]).sum(0) / n_valid
        z = (lse_sq * validf).sum() / n_valid
    aux_lb = probs.shape[-1] * (frac_tokens * frac_probs).sum()
    return aux_lb, z


def _valid_f32(valid, g):
    return None if valid is None else valid.reshape(g).float()


def route_topk_capacity(
    router_logits: torch.Tensor,
    k: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.bfloat16,
    norm_topk: bool = True,
    group_limit: Optional[tuple[int, int]] = None,
):
    """Route G tokens to top-``k`` of E experts under a per-expert
    ``capacity``.

    ``router_logits`` [G, E] fp32; ``valid`` optional [G] bool/float, False
    rows excluded from routing, capacity and the aux statistics; ``dtype``
    the dispatch/combine dtype; ``norm_topk`` renormalizes the top-k
    probabilities to sum to 1 (Mixtral; False keeps the raw softmax mass,
    DeepSeek-V2); ``group_limit`` (n_group, topk_group) runs the top-k
    over the experts of the topk_group groups with the highest max.

    Returns (dispatch [G, E, C] 0/1, combine [G, E, C] = dispatch x gate,
    aux_lb, z), the last two raw. Each (g, e, c) has at most one
    assignment, so the tensors are written slot by slot, never as the
    [G, k, E, C] product ``tpufw`` sums over k."""
    g, e = router_logits.shape
    probs, topk_probs, topk_idx = _topk_select(
        router_logits, k, norm_topk, group_limit
    )
    validf = _valid_f32(valid, g)

    # Slot-major priority: a cumsum over the [k*G, E] one-hot.
    mask = F.one_hot(topk_idx, e).float()  # [G, k, E]
    if validf is not None:
        mask = mask * validf[:, None, None]
    mask_kge = mask.transpose(0, 1).reshape(k * g, e)
    # Scanned along the last dim of [E, k*G]: an outer-dim scan over E
    # columns runs nearly serially on the GPU.
    pos_flat = torch.cumsum(mask_kge.t().contiguous(), dim=1).t() - mask_kge
    pos = pos_flat.reshape(k, g, e).transpose(0, 1)  # [G, k, E]
    keep = ((pos < capacity) & (mask > 0)).any(-1)  # [G, k]
    slot = (pos * mask).sum(-1).long().clamp(max=capacity - 1)

    dev = router_logits.device
    dispatch = torch.zeros(g, e, capacity, dtype=dtype, device=dev)
    combine = torch.zeros_like(dispatch)
    # A token's k experts are distinct, so its k (row, expert, slot)
    # targets are too: one write of all G*k, no accumulation.
    rows = torch.arange(g, device=dev)[:, None].expand(g, k)
    w = keep.to(dtype)
    dispatch[rows, topk_idx, slot] = w
    combine[rows, topk_idx, slot] = w * topk_probs.to(dtype)

    top1_mask = mask[:, 0, :]  # [G, E], zero on invalid rows
    aux_lb, z = _router_stats(router_logits, probs, top1_mask, validf, g)
    return dispatch, combine, aux_lb, z


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order; the backward hands
    each rank the sum over ranks of its rows' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.group, ctx.lo, ctx.n = group, dist.get_rank(group) * len(x), len(x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.lo:ctx.lo + ctx.n], None


def routing_order(world: int, seq: int, rows: int, length: int,
                  device=None) -> torch.Tensor:
    """The permutation that puts a gang's routing group, every rank's
    [rows, length] tokens concatenated in rank order, in the global
    batch's row-major [B, T] token order: rank r holds rows
    [(r // seq)·rows, ...) of the global batch and positions
    [(r % seq)·length, ...), as ``train.sharding.batch_shard`` and the
    sequence split lay them out. ``gathered[order]`` is that order."""
    idx = torch.arange(world * rows * length, device=device)
    return idx.reshape(world // seq, seq, rows, length).permute(
        0, 2, 1, 3).reshape(-1)


def gather_routing(router_logits: torch.Tensor, valid, group, rows: int,
                   seq: int = 1):
    """A gang's routing group: every rank's [g, E] router logits (with
    their gradient) and valid rows, in the global batch's token order, as
    the global batch ``tpufw`` routes as one group; and where this rank's
    g tokens (``rows`` rows of g / rows positions) sit in it: a slice
    when every rank holds whole rows (``seq`` 1: rank order is the global
    order), else an index tensor in this rank's token order."""
    import torch.distributed as dist

    logits = _GatherRows.apply(router_logits, group)
    if valid is not None:
        parts = [torch.empty_like(valid) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, valid.contiguous(), group=group)
        valid = torch.cat(parts)
    g, rank = router_logits.shape[0], dist.get_rank(group)
    if seq == 1:
        return logits, valid, slice(rank * g, (rank + 1) * g)
    order = routing_order(dist.get_world_size(group), seq, rows, g // rows,
                          logits.device)
    mine = torch.empty_like(order)
    mine[order] = torch.arange(order.numel(), device=order.device)
    return (logits[order], None if valid is None else valid[order],
            mine[rank * g:(rank + 1) * g])


def local_sorted(token, group_sizes, gates, mine, g: int):
    """The sorted assignments (``route_topk_sorted``'s) of this rank's g
    tokens of a gang's routing group (``mine``, ``gather_routing``'s),
    renumbered in this rank's order: (token, group_sizes, gates) of its
    tokens, in the same order."""
    gid = torch.repeat_interleave(
        torch.arange(group_sizes.numel(), device=token.device), group_sizes)
    if isinstance(mine, slice):
        keep = (token >= mine.start) & (token < mine.stop)
        local = token[keep] - mine.start
    else:
        # Global token -> its index among this rank's, or -1. Every
        # token of the group has k assignments, so the group holds
        # token.numel() // k tokens; token.numel() bounds it.
        index = torch.full((token.numel(),), -1, dtype=token.dtype,
                           device=token.device)
        index[mine] = torch.arange(g, dtype=token.dtype, device=token.device)
        local = index[token]
        keep = local >= 0
        local = local[keep]
    return (local,
            torch.bincount(gid[keep], minlength=group_sizes.numel()),
            gates[keep])


def route_topk_sorted(
    router_logits: torch.Tensor,
    k: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.bfloat16,
    norm_topk: bool = True,
    group_limit: Optional[tuple[int, int]] = None,
):
    """Sorted twin of ``route_topk_capacity``: the same selection,
    priority, drops and aux statistics, as the k*G assignments sorted by
    expert. An assignment past its expert's ``capacity`` keeps its place
    with a zero gate; an invalid row's go to a sentinel group E with zero
    gates.

    Returns (token [k*G], group_sizes [E+1], gates [k*G], aux_lb, z):
    ``token[i]`` is the source row of the i-th sorted assignment,
    ``group_sizes`` counts them per expert with the sentinel last,
    ``gates`` is each one's combine weight in ``dtype``."""
    g, e = router_logits.shape
    probs, topk_probs, topk_idx = _topk_select(
        router_logits, k, norm_topk, group_limit
    )
    validf = _valid_f32(valid, g)
    dev = router_logits.device

    # Slot-major flattening [k, G]: a stable sort by expert then keeps
    # slot 0 of every token before slot 1, earlier tokens first.
    eids = topk_idx.t().reshape(k * g)
    gates_flat = topk_probs.t().reshape(k * g)
    token = torch.arange(g, device=dev).repeat(k)
    if validf is not None:
        invalid = (validf < 0.5)[token]
        eids = torch.where(invalid, torch.full_like(eids, e), eids)
        gates_flat = torch.where(invalid, torch.zeros_like(gates_flat),
                                 gates_flat)

    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    group_sizes = torch.bincount(eids, minlength=e + 1)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    rank = torch.arange(k * g, device=dev) - starts[sorted_eids]
    kept = (rank < capacity) & (sorted_eids < e)
    gates = torch.where(kept, gates_flat[order],
                        torch.zeros_like(gates_flat)).to(dtype)

    top1_mask = F.one_hot(topk_idx[:, 0], e).float()
    if validf is not None:
        top1_mask = top1_mask * validf[:, None]
    aux_lb, z = _router_stats(router_logits, probs, top1_mask, validf, g)
    return token[order], group_sizes, gates, aux_lb, z
