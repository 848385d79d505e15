"""Data and FSDP parallelism of the trainers over a ``DeviceMesh``: what
``tpufw``'s ``state_shardings`` and ``globalize_batch`` do with GSPMD
(``tpufw/train/trainer.py``), done with ``fully_shard``.

``shard_model`` wraps each block of the layer stack, then the root, in
``torch.distributed.fsdp.fully_shard`` over the mesh's ``data`` and
``fsdp`` × ``sequence`` dimensions (``fsdp_mesh``): parameters, gradients
and optimizer moments are sharded over ``fsdp`` and ``sequence`` together
(dim 0 of each tensor) and replicated over ``data``. A rank feeds the
rows of its batch shard (``batch_shard``: its ``data``, ``fsdp``
coordinate, ``data · fsdp`` shards); the ``sequence`` ranks of one
coordinate share those rows, and each takes its contiguous chunk of the
positions (``train.trainer.shift_and_mask``).

The loss is the global token-weighted mean that ``tpufw``'s jitted step
computes over the global batch: every objective backpropagates through
``backward_global_mean``, which weighs a rank's local mean by its share
of the gang's targets and scales it by the world size, which FSDP's
averaging reduction divides back out, so the gradients are those of the
global mean whatever the ranks' target counts (SFT's assistant masks,
packed segments, DPO pairs, sequence chunks). Without a process group it
is a plain ``backward``.

Under ``tensor`` or ``expert`` axes above 1 (``parallel.tensor``) the
ranks of one (``expert``, ``tensor``) coordinate hold the same split
parameters and feed different rows (or, beside a ``sequence`` axis,
different positions of them), and those of one batch shard share its
rows: ``shard_model`` then runs ``fully_shard`` over the (``data``,
``fsdp`` [× ``sequence``]) sub-mesh of each coordinate, each rank's split
parameters already cut to its shards (``parallel.tensor.cut_model``), and
the gang's token counts and means run over the batch-shard ranks of the
coordinate (``batch_group`` over ``batch_dims``, registered by the
trainer with ``batch_ranks``), so a token counts once, scaled by the size
of the mesh ``fully_shard`` averages over. ``SplitPart`` carries a split
tensor to the checkpoint, which gathers it whole.

The objectives computed over the whole batch at once (in-batch negatives,
BatchNorm's statistics) reach the other ranks' rows through
``parallel.group``'s ``gather_rows`` and ``all_sum``, collectives with
their gradient over the batch-shard ranks (``batch_process_group``: the
whole gang, or the batch-shard ranks of this rank's (``expert``,
``tensor``) coordinate). Their trainers refuse the ``sequence`` and
``pipe`` axes (``refuse_split_rows``), so those ranks are in
``batch_shard``'s order.
"""

from __future__ import annotations

import contextlib
import math

import torch

# The batch-shard ranks the gang's token counts and means run over:
# (process group, size), None = every rank.
_batch = None


def active() -> bool:
    """True when a ``torch.distributed`` process group is initialized."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if active() else 1


def batch_process_group():
    """The process group of the ranks the gang's means run over: the
    batch-shard ranks under ``batch_ranks``, else None (every rank)."""
    return None if _batch is None else _batch[0]


def batch_world() -> int:
    """The number of ranks the gang's means run over: the batch-shard
    ranks under ``batch_ranks``, else the world."""
    return _batch[1] if _batch is not None else world_size()


@contextlib.contextmanager
def batch_ranks(group, size: int):
    """Count targets and take means over ``group`` (``size`` ranks: the
    batch-shard ranks of one tensor/expert coordinate) in the block."""
    global _batch
    prev, _batch = _batch, (group, size)
    try:
        yield
    finally:
        _batch = prev


def batch_dims(mesh) -> tuple:
    """The dimensions of a ``build_mesh`` mesh whose ranks hold one
    (``expert``, ``tensor``) coordinate's parts of the global batch:
    ``data`` and ``fsdp`` (their rows), and ``sequence`` when it is above
    1 (their positions)."""
    names = mesh.mesh_dim_names
    seq = "sequence" in names and mesh.size(names.index("sequence")) > 1
    return ("data", "fsdp", "sequence") if seq else ("data", "fsdp")


def batch_group(mesh, dims=("data", "fsdp")):
    """(process group, size) of the ranks that hold this rank's
    (``expert``, ``tensor``) coordinate over every batch shard of a
    ``build_mesh`` mesh (over every coordinate of ``dims``, in their
    row-major order: ``batch_shard``'s by default; the pipeline's loss
    adds ``pipe``): one group made per coordinate (a collective)."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    lead = [names.index(d) for d in dims]
    rest = [i for i in range(len(names)) if i not in lead]
    grid = mesh.mesh.permute(*lead, *rest)
    n = math.prod(grid.shape[:len(lead)])
    cols = grid.reshape(n, -1)
    mine, me = None, dist.get_rank()
    for c in range(cols.shape[1]):
        ranks = cols[:, c].tolist()
        pg = dist.new_group(ranks)
        if me in ranks:
            mine = pg
    return mine, n


class SplitPart:
    """This rank's part ``part`` (a tensor, or its DTensor over the batch
    shards) of a tensor split as ``split`` ((axis, dim), ...) over the
    process ``groups`` of a gang; ``full_tensor`` gathers it whole (a
    collective), so a checkpoint holds the whole tensor."""

    def __init__(self, part, split: tuple, groups):
        self.part, self.split, self.groups = part, split, groups

    @property
    def is_cuda(self) -> bool:
        return self.part.is_cuda

    def full(self) -> torch.Tensor:
        from tpufw_torch.parallel.tensor import gather_split

        t = self.part.full_tensor() if is_dtensor(self.part) else self.part
        return gather_split(t, self.split, self.groups)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor or a ``SplitPart`` (a collective:
    every rank calls it), or ``t`` itself."""
    if isinstance(t, SplitPart):
        return t.full()
    return t.full_tensor() if is_dtensor(t) else t


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage), or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def full_state_dict(state: dict) -> dict:
    """``state`` with every DTensor gathered whole (on its device)."""
    return {k: full_tensor(v) for k, v in state.items()}


def local_chunk(full: torch.Tensor, ref) -> torch.Tensor:
    """This rank's part of ``full`` as ``ref`` (a DTensor) lays its
    tensor out: ``torch.chunk`` along each sharded dim, FSDP's rule (a
    rank past the last chunk holds an empty one)."""
    from torch.distributed.tensor import Shard

    mesh, local = ref.device_mesh, full
    coord = mesh.get_coordinate()
    for i, p in enumerate(ref.placements):
        if isinstance(p, Shard):
            chunks = torch.chunk(local, mesh.size(i), dim=p.dim)
            local = (chunks[coord[i]] if coord[i] < len(chunks)
                     else local.narrow(p.dim, 0, 0))
    return local


def shard_like(full: torch.Tensor, ref) -> torch.Tensor:
    """A DTensor laid out as ``ref`` holding ``full``'s values (``full``
    on any device, the same on every rank): only this rank's chunk is
    copied to ``ref``'s device."""
    from torch.distributed.tensor import DTensor

    local = local_chunk(full, ref).to(ref.device, ref.dtype).contiguous()
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def load_into(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy ``full``'s values into ``dst`` (a DTensor: its shard)."""
    if is_dtensor(dst):
        dst.to_local().copy_(local_chunk(full, dst))
    else:
        dst.copy_(full)


def fsdp_mesh(mesh):
    """The two-dimensional mesh ``fully_shard`` takes from a
    ``build_mesh`` mesh: (``data``, ``fsdp``) of this rank's (``expert``,
    ``tensor``) coordinate, or, under a ``sequence`` dimension above 1,
    (``data``, ``fsdp_sequence``) over the same ranks (a mesh of its own:
    its process groups are made here, a collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = mesh.mesh_dim_names
    if "sequence" not in names or mesh.size(names.index("sequence")) == 1:
        return mesh["data", "fsdp"]
    lead = [names.index(d) for d in ("data", "fsdp", "sequence")]
    rest = [i for i in range(len(names)) if i not in lead]
    grid = mesh.mesh.permute(*lead, *rest)
    grid = grid.reshape(grid.shape[0], -1, *grid.shape[3:])
    flat = DeviceMesh(mesh.device_type, grid.tolist(), mesh_dim_names=(
        "data", "fsdp_sequence", *(names[i] for i in rest)))
    return flat["data", "fsdp_sequence"] if rest else flat


def batch_shard(mesh) -> tuple[int, int]:
    """(this rank's batch shard, the number of shards) of a
    ``build_mesh`` mesh: its (``data``, ``fsdp``) coordinate in
    row-major order, of ``data · fsdp``."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    fsdp = mesh.size(mesh.mesh_dim_names.index("fsdp"))
    data = mesh.size(mesh.mesh_dim_names.index("data"))
    return coord["data"] * fsdp + coord["fsdp"], data * fsdp


def shard_model(model, mesh, blocks=None, route_group=None) -> None:
    """``fully_shard`` each block of ``blocks`` (default ``model.layers``),
    then the root, over ``fsdp_mesh(mesh)``. A block's ``attend`` and
    ``merge`` (called apart by the ``attn_out`` remat policy) gather and
    free its parameters as its forward does. The root keeps its
    parameters gathered from its forward to its backward (FSDP's rule for
    the root), so ``head_kernel()`` read after the forward is the whole
    head (this rank's vocabulary shard under ``tensor``). A MoE layer
    routes the global batch as one group, as ``tpufw`` does
    (``MoEMLP.route_group``: ``route_group``, default every rank;
    ``route_seq`` the ranks a row is split over)."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    names = mesh.mesh_dim_names
    seq = mesh.size(names.index("sequence")) if "sequence" in names else 1
    for m in model.modules():
        if hasattr(type(m), "route_group"):
            m.route_group = route_group or dist.group.WORLD
            m.route_seq = seq
    shard = fsdp_mesh(mesh)
    for block in model.layers if blocks is None else blocks:
        fully_shard(block, mesh=shard)
        for name in ("attend", "merge"):
            if hasattr(block, name):
                register_fsdp_forward_method(block, name)
    fully_shard(model, mesh=shard)


def gang_device():
    """The device of this rank's collectives: its GPU under NCCL, else
    the CPU (gloo)."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gang_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the batch-shard ranks (every rank unless
    ``batch_ranks`` says otherwise; a fresh tensor); ``x`` itself,
    detached, without a process group."""
    import torch.distributed as dist

    out = x.detach()
    if active():
        out = out.clone()
        dist.all_reduce(out, group=None if _batch is None else _batch[0])
    return out


def gang_count(n_local) -> torch.Tensor:
    """The gang's number of targets, at least 1 (fp32): what its
    token-weighted mean divides by."""
    return torch.clamp(gang_sum(torch.as_tensor(n_local).float()), min=1.0)


def global_mean(x: torch.Tensor, n_local) -> torch.Tensor:
    """The gang's token-weighted mean of the ranks' means ``x`` (any
    shape), each over its ``n_local`` targets; ``x`` itself, detached,
    without a process group."""
    if not active():
        return x.detach()
    n = torch.as_tensor(n_local).detach().float()
    return gang_sum(x.detach() * (n / gang_count(n)))


def backward_global_mean(loss: torch.Tensor, n_local,
                         n_global=None) -> torch.Tensor:
    """Backpropagate this rank's part of the gang's token-weighted mean
    and return that part summed over the gang (detached).

    ``loss`` is this rank's mean over its ``n_local`` targets. The gang's
    mean divides the ranks' sum of ``n_local * loss`` by ``n_global``
    (default ``gang_count(n_local)``; a step that accumulates microbatches
    passes its whole count, so that the parts add up to the step's mean).
    The rank backpropagates ``loss * n_local / n_global`` scaled by the
    number of ranks FSDP averages over (``batch_world``: the world, or the
    batch-shard ranks under ``batch_ranks``), which its averaging
    reduction divides back out, so the
    gradients are those of the global mean whatever the ranks' target
    counts. Without a process group and ``n_global`` this is
    ``loss.backward()``; at world size 1 the weight is exactly 1, so a
    world-1 gang's numbers are the unsharded ones."""
    if n_global is None and not active():
        loss.backward()
        return loss.detach()
    n = torch.as_tensor(n_local).detach().float()
    w = n / (gang_count(n) if n_global is None else n_global)
    (loss * (w * batch_world())).backward()
    return gang_sum(loss.detach() * w)


def refuse_split_rows(mesh_cfg, who: str) -> None:
    """NotImplementedError, in a gang, for a ``sequence`` or ``pipe`` axis
    of ``mesh_cfg`` above 1: ``who``'s objective needs whole rows of the
    whole batch on the batch-shard ranks (ROADMAP.md Queue 1 item 12f)."""
    if not active():
        return
    from tpufw_torch.mesh import MeshConfig

    sizes = (mesh_cfg or MeshConfig()).slice_sizes(world_size())
    for axis in ("sequence", "pipe"):
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"{who} over a {axis} mesh axis of size {sizes[axis]}: its "
                "objective is not ported to split rows in tpufw_torch yet "
                "(ROADMAP.md Queue 1 item 12f)")


def gang_agree(value: int, what: str) -> int:
    """``value`` when every rank holds the same one (a collective under a
    process group); raises ValueError, on every rank, when they differ:
    the ranks would otherwise leave one another in different states, or
    wait in a collective some never enter."""
    if not active():
        return value
    import torch.distributed as dist

    t = torch.tensor([value, -value], dtype=torch.int64,
                     device=gang_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise ValueError(
            f"the gang's ranks disagree on {what}: from {lo} to {hi} (does "
            "every rank see the same checkpoint directory?)")
    return value
