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

LoRA adapters ride their weight's axes, as ``tpufw``'s ``lora_delta``
names them (A on the weight's input axes and ``lora``, B on ``lora`` and
its output axes; ``lora`` is replicated): a ``column`` weight's A is
whole and its B is cut with the output rows; a ``row`` weight's A is cut
with the input columns and its B is whole, each shard's ``B(x_i
A_iᵀ)·scale`` joining the row's one reduction. A whole adapter inside a
split enters it (``ShardGroup.enter`` on the tensor itself), so its
gradient is the sum of the shards' parts.

``check_divisible`` refuses a config whose split dimensions do not
divide by their axes, naming the dimension and the axis;
``refuse_unsplittable`` refuses a split of int8 weights, a serving form
that no mesh splits. ``split_specs`` lists a model's split parameters
(adapters included); ``cut_tensor``/``cut_model`` give a rank its shards
of whole tensors, ``gather_split`` puts them back together, so a
checkpoint stays whole whatever the mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufw_torch.mesh.mesh import MODEL_AXES, mesh_axes_of
from tpufw_torch.parallel.group import ShardGroup


def refuse_unsplittable(mod, *groups: ShardGroup) -> None:
    """NotImplementedError when ``groups`` split ``mod`` and it holds int8
    weights. By design: int8 weights are a serving form, only serving
    quantizes, and serving runs on one device's whole weights (``tpufw``'s
    serving builds its mesh with no tensor or expert knob)."""
    sizes = {g.axis: g.size for g in groups if g.size > 1}
    if sizes and any(p.dtype == torch.int8 for p in mod.parameters()):
        raise NotImplementedError(
            f"a {type(mod).__name__} with int8 weights split over "
            f"{sizes}: int8 weights are a serving form, and serving runs "
            "unsplit (tpufw's serving mesh has no tensor or expert axis); "
            "split the floating-point weights instead")


def column(proj, x: torch.Tensor, group: ShardGroup) -> list:
    """``proj`` (a ``models.llama.Projection``) split on its output
    features: each held shard's ``x · W_iᵀ (+ b_i)`` in the compute
    dtype, plus its adapter's ``(x · Aᵀ) · B_iᵀ · scale`` (A whole, B cut
    with the rows). One shard: ``[proj(x)]``."""
    if group.size == 1:
        return [proj(x)]
    refuse_unsplittable(proj, group)
    dt = proj.dtype
    x = x.to(dt)
    ws = group.shards(proj.weight, 0)
    bs = ([None] * len(ws) if proj.bias is None
          else group.shards(proj.bias, 0))
    ys = [F.linear(x, w.to(dt), None if b is None else b.to(dt))
          for w, b in zip(ws, bs)]
    scale = getattr(proj, "lora_scale", None)
    if scale is None:
        return ys
    lo = F.linear(x, group.enter(proj.weight_lora_a).to(dt))
    return [y + F.linear(lo, b.to(dt)) * scale
            for y, b in zip(ys, group.shards(proj.weight_lora_b, 0))]


def row(proj, xs: list, group: ShardGroup) -> torch.Tensor:
    """``proj`` split on its input features: the sum over the axis of
    each held shard's ``x_i · W_iᵀ`` plus its adapter's ``(x_i · A_iᵀ) ·
    Bᵀ · scale`` (A cut with the columns, B whole), one reduction (the
    bias, if any, added once)."""
    if group.size == 1:
        (x,) = xs
        return proj(x)
    refuse_unsplittable(proj, group)
    dt = proj.dtype
    xs = [x.to(dt) for x in xs]
    parts = [F.linear(x, w.to(dt))
             for x, w in zip(xs, group.shards(proj.weight, 1))]
    scale = getattr(proj, "lora_scale", None)
    if scale is not None:
        b = group.enter(proj.weight_lora_b).to(dt)
        parts = [y + F.linear(F.linear(x, a.to(dt)), b) * scale
                 for y, x, a in zip(parts, xs,
                                    group.shards(proj.weight_lora_a, 1))]
    y = group.reduce(parts)
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
    from tpufw_torch.models.lora import lora_axes

    names = dict(model.named_parameters())
    out = {}
    for prefix, mod in model.named_modules():
        for local, logical in getattr(type(mod), "LOGICAL_AXES", {}).items():
            base = f"{prefix}.{local}" if prefix else local
            for suffix, axes in (("", logical),
                                 *lora_axes(logical).items()):
                name = base + suffix
                if name not in names:
                    continue
                split = tuple(
                    (axis, dim) for dim, mesh in enumerate(mesh_axes_of(axes))
                    for axis in mesh if axis in MODEL_AXES)
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
