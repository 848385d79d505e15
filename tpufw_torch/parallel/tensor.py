"""Tensor and expert parallelism: the Megatron split of the LM families'
weights (port of what ``tpufw``'s ``logical_axis_rules`` make GSPMD do
over the ``tensor`` and ``expert`` mesh axes).

``tpufw`` annotates each parameter with logical axis names and lets XLA
insert the collectives. The port declares the same names per module
(``LOGICAL_AXES``: a module's parameters, PyTorch layout, the router left
out: the port keeps it replicated) and computes the shard math itself,
written once over "the shards this process holds" of a
``parallel.group`` ``TensorGroup``/``ExpertGroup`` (a local group holds
every shard and slices the whole weights; a process group holds one,
and its weights ARE that shard, ``cut_model``):

- ``column``: a projection split on its output features (q, k, v, gate,
  up; a vocab-parallel head), one output per held shard;
- ``row``: a projection split on its input features (o, down), the
  shards' products summed over the axis (``ShardGroup.reduce``);
- ``vocab_embed``: each shard looks up the ids of its vocabulary range,
  the others give zeros, and the lookups are summed;
- the entry of a split block takes ``ShardGroup.enter``, whose gradient
  is the sum over the axis, so replicated parameters (norms, latent
  projections, the router) get whole gradients on every rank.

``check_divisible`` refuses a config whose split dimensions do not
divide by their axes, naming the dimension and the axis;
``refuse_unsplittable`` refuses a split of a module that carries LoRA
adapters or int8 weights, whose split is not ported. ``split_specs``
lists a model's split parameters; ``cut_tensor``/``cut_model`` give a
rank its shards of whole tensors, ``gather_split`` puts them back
together, so a checkpoint stays whole whatever the mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufw_torch.mesh.mesh import MODEL_AXES, mesh_axes_of, refuse_later_axes
from tpufw_torch.parallel.group import ShardGroup


def refuse_unsplittable(mod, *groups: ShardGroup) -> None:
    """NotImplementedError naming ROADMAP.md Queue 1 item 12g when
    ``groups`` split ``mod`` and it carries LoRA adapters (``lora_scale``
    set) or int8 weights: the shard math runs on the base weights alone
    and would compute without them."""
    sizes = {g.axis: g.size for g in groups}
    if all(n == 1 for n in sizes.values()):
        return
    if getattr(mod, "lora_scale", None) is not None:
        what = "LoRA adapters"
    elif any(p.dtype == torch.int8 for p in mod.parameters()):
        what = "int8 weights"
    else:
        return
    refuse_later_axes(sizes, f" of a {type(mod).__name__} with {what}")


def column(proj, x: torch.Tensor, group: ShardGroup) -> list:
    """``proj`` (a ``models.llama.Projection``) split on its output
    features: each held shard's ``x · W_iᵀ (+ b_i)`` in the compute
    dtype. One shard: ``[proj(x)]``."""
    if group.size == 1:
        return [proj(x)]
    refuse_unsplittable(proj, group)
    dt = proj.dtype
    x = x.to(dt)
    ws = group.shards(proj.weight, 0)
    bs = ([None] * len(ws) if proj.bias is None
          else group.shards(proj.bias, 0))
    return [F.linear(x, w.to(dt), None if b is None else b.to(dt))
            for w, b in zip(ws, bs)]


def row(proj, xs: list, group: ShardGroup) -> torch.Tensor:
    """``proj`` split on its input features: the sum over the axis of
    each held shard's ``x_i · W_iᵀ`` (the bias, if any, added once)."""
    if group.size == 1:
        (x,) = xs
        return proj(x)
    refuse_unsplittable(proj, group)
    dt = proj.dtype
    ws = group.shards(proj.weight, 1)
    y = group.reduce([F.linear(x.to(dt), w.to(dt)) for x, w in zip(xs, ws)])
    return y if proj.bias is None else y + proj.bias.to(dt)


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor,
                group: ShardGroup) -> torch.Tensor:
    """``F.embedding(tokens, table)`` with ``table`` [V, D] split on the
    vocabulary: each held shard looks up the ids in its range (zeros
    elsewhere), and the lookups are summed over the axis."""
    tokens = tokens.long()
    if group.size == 1:
        return F.embedding(tokens, table)
    parts = []
    for (lo, hi), w in zip(group.ranges(_vocab(table, group)),
                           group.shards(table, 0)):
        local = tokens - lo
        inside = (local >= 0) & (local < hi - lo)
        e = F.embedding(torch.where(inside, local, 0), w)
        parts.append(e * inside[..., None].to(e.dtype))
    return group.reduce(parts)


def _vocab(table: torch.Tensor, group: ShardGroup) -> int:
    """The whole vocabulary of a (possibly cut) table."""
    return table.shape[0] * group.size // len(group.indices)


def check_divisible(cfg, tensor: int = 1, expert: int = 1) -> None:
    """ValueError naming the dimension and the axis when a dimension of
    ``cfg`` that ``tensor`` or ``expert`` split does not divide by the
    axis's size: the heads (query and KV; MLA's heads), the MLP widths
    (dense, routed experts', shared experts'), the vocabulary, and the
    routed experts."""
    checks = []
    if tensor > 1:
        checks.append(("n_heads", cfg.n_heads))
        if hasattr(cfg, "n_kv_heads"):
            checks.append(("n_kv_heads", cfg.n_kv_heads))
        n_exp = getattr(cfg, "n_experts", 0)
        dense_ffn = not n_exp or getattr(cfg, "first_k_dense", 0) > 0 \
            or not hasattr(cfg, "moe_d_ff")
        if dense_ffn:
            checks.append(("d_ff", cfg.d_ff))
        if n_exp and hasattr(cfg, "moe_d_ff"):
            checks.append(("moe_d_ff", cfg.moe_d_ff))
        checks.append(("vocab_size", cfg.vocab_size))
        for name, v in checks:
            if v % tensor:
                raise ValueError(
                    f"mesh tensor={tensor} must divide {name}={v} for "
                    "tensor parallelism")
    if expert > 1:
        n_exp = getattr(cfg, "n_experts", 0)
        if not n_exp:
            raise ValueError(
                f"mesh expert axis has size {expert} but "
                f"{type(cfg).__name__} has no experts to shard over it")
        if n_exp % expert:
            raise ValueError(
                f"mesh expert={expert} must divide n_experts={n_exp} for "
                "expert parallelism")


def split_specs(model) -> dict:
    """{parameter name: ((mesh axis, dim), ...)} of every parameter of
    ``model`` split over ``expert`` or ``tensor``, from its modules'
    ``LOGICAL_AXES`` and ``logical_axis_rules``; the others are
    replicated over both."""
    names = dict(model.named_parameters())
    out = {}
    for prefix, mod in model.named_modules():
        for local, logical in getattr(type(mod), "LOGICAL_AXES", {}).items():
            name = f"{prefix}.{local}" if prefix else local
            if name not in names:
                continue
            split = tuple(
                (axis, dim) for dim, axes in enumerate(mesh_axes_of(logical))
                for axis in axes if axis in MODEL_AXES)
            if split:
                out[name] = split
    return out


def _groups_by_axis(groups) -> dict:
    return {g.axis: g for g in groups}


def cut_tensor(t: torch.Tensor, split: tuple, groups) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` split as ``split``
    ((axis, dim), ...) over the process ``groups`` (a group holding every
    shard keeps the whole)."""
    by_axis = _groups_by_axis(groups)
    for axis, dim in split:
        g = by_axis[axis]
        if not g.holds_all:
            (t,) = [t.chunk(g.size, dim)[i] for i in g.indices]
    return t


def cut_model(model, groups) -> dict:
    """Replace each split parameter of ``model`` (whole, on its device) by
    this rank's shard of it over the process ``groups``: what a rank of a
    tensor- or expert-parallel gang trains. Returns ``split_specs``."""
    specs = split_specs(model)
    params = dict(model.named_parameters())
    for name, split in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = params[name]
        part = cut_tensor(p.detach(), split, groups).clone()
        setattr(mod, leaf, torch.nn.Parameter(
            part, requires_grad=p.requires_grad))
    return specs


def gather_split(part: torch.Tensor, split: tuple, groups) -> torch.Tensor:
    """The whole tensor of the ranks' parts ``part`` (each rank's, split as
    ``split`` over the process ``groups``): a collective over them."""
    import torch.distributed as dist

    by_axis = _groups_by_axis(groups)
    for axis, dim in reversed(split):
        g = by_axis[axis]
        if g.size == 1:
            continue
        parts = [torch.empty_like(part) for _ in range(g.size)]
        dist.all_gather(parts, part.contiguous(), group=g.group)
        part = torch.cat(parts, dim)
    return part


def split_norm(grads: list, splits: list, groups, norm_of) -> torch.Tensor:
    """The global L2 norm of ``grads`` where ``splits[i]`` is grad i's
    split ((axis, dim), ...; () replicated) over the process ``groups``:
    a split gradient's squares summed over the ranks of its axes, a
    replicated one's counted once. ``norm_of(list)`` gives the norm of
    this rank's tensors."""
    import torch.distributed as dist

    by_axis = _groups_by_axis(groups)
    buckets: dict = {}
    for g, split in zip(grads, splits):
        buckets.setdefault(tuple(sorted({a for a, _ in split})), []).append(g)
    total = None
    for axes, gs in buckets.items():
        sq = norm_of(gs).float().square()
        for a in axes:
            if by_axis[a].size > 1:
                sq = sq.clone()
                dist.all_reduce(sq, group=by_axis[a].group)
        total = sq if total is None else total + sq
    return total.sqrt()
