"""The collectives of a sequence ring: the port's stand-in for the
``ppermute``, ``all_to_all`` and ``all_gather`` that ``tpufw``'s
sequence-parallel bodies issue under ``shard_map``; below them, the
batch's collectives, the pipeline's neighbour exchange, and the shard
groups of the tensor and expert axes (``ShardGroup``).

A ring of n shards splits the sequence into n contiguous chunks; shard i
holds positions [i·L, (i+1)·L). The bodies of ``parallel.ring``,
``parallel.ring_flash`` and ``parallel.ulysses`` are written once over
"the shards this process holds", a list:

- ``ProcessSequenceGroup``: one shard per process, the process group of a
  ``DeviceMesh``'s ``sequence`` dimension. ``rotate`` is one
  ``batch_isend_irecv`` to the next rank with the receive from the
  previous one; ``all_to_all`` and ``all_gather`` are the autograd
  collectives of ``torch.distributed._functional_collectives``.
- ``LocalSequenceGroup(n)``: all n shards in one process (tests, and the
  card's one-process rings). ``rotate`` rolls the list; ``all_to_all``
  and ``all_gather`` are the same transposes of the list.

Every collective is differentiable: the gradient of a rotation is the
reverse rotation (the transpose of ``ppermute``), that of an all-to-all
the reverse all-to-all, that of an all-gather the sum of the gathered
gradients each shard's part receives.
"""

from __future__ import annotations

import torch


class SequenceGroup:
    """A ring of ``size`` shards; ``indices`` are the global indices of
    the shards this process holds, in the order of its lists."""

    axis = "sequence"
    size: int
    indices: tuple

    @property
    def holds_all(self) -> bool:
        """True when this process holds every shard (its tensors are the
        whole sequence)."""
        return len(self.indices) == self.size

    def split(self, x: torch.Tensor, dim: int = 1) -> list:
        """The held shards of ``x`` as this process sees it."""
        raise NotImplementedError

    def join(self, xs: list, dim: int = 1) -> torch.Tensor:
        """Inverse of ``split``."""
        raise NotImplementedError

    def rotate(self, *xss: list, shift: int = 1) -> tuple:
        """Each list of held shards rotated ``shift`` shards along the
        ring: shard i's tensor goes to shard (i + shift) % size."""
        raise NotImplementedError

    def all_to_all(self, xs: list, split_dim: int, concat_dim: int) -> list:
        """Shard i splits its tensor into ``size`` pieces along
        ``split_dim`` and sends piece j to shard j, which concatenates
        what it receives in shard order along ``concat_dim``."""
        raise NotImplementedError

    def all_gather(self, xs: list, dim: int) -> list:
        """Every shard's tensor concatenated in shard order along ``dim``,
        on every shard."""
        raise NotImplementedError


class LocalSequenceGroup(SequenceGroup):
    """All ``n`` shards of a ring in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one shard, got {n}")
        self.size = n
        self.indices = tuple(range(n))

    def split(self, x, dim=1):
        if x.shape[dim] % self.size:
            raise ValueError(
                f"the sequence axis of size {self.size} must divide the "
                f"sequence length {x.shape[dim]}")
        return list(x.chunk(self.size, dim)) if self.size > 1 else [x]

    def join(self, xs, dim=1):
        return torch.cat(xs, dim) if len(xs) > 1 else xs[0]

    def rotate(self, *xss, shift=1):
        s = shift % self.size
        return tuple(list(xs[-s:]) + list(xs[:-s]) if s else list(xs)
                     for xs in xss)

    def all_to_all(self, xs, split_dim, concat_dim):
        if self.size == 1:
            return list(xs)
        pieces = [x.chunk(self.size, split_dim) for x in xs]
        return [torch.cat([p[j] for p in pieces], concat_dim)
                for j in range(self.size)]

    def all_gather(self, xs, dim):
        full = self.join(xs, dim)
        return [full] * self.size


def _send_recv(tensors, group, size: int, rank: int, shift: int) -> list:
    """Each of ``tensors`` sent to rank (rank + shift) % size of
    ``group`` and its counterpart received from (rank - shift) % size,
    all in one ``batch_isend_irecv``."""
    import torch.distributed as dist

    dst, src = (rank + shift) % size, (rank - shift) % size
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, o in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, t, group=group, group_peer=dst))
        ops.append(dist.P2POp(dist.irecv, o, group=group, group_peer=src))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """``_send_recv`` with the reverse rotation as its gradient."""

    @staticmethod
    def forward(ctx, group, size, rank, shift, *tensors):
        ctx.args = (group, size, rank)
        ctx.shift = shift
        ctx.floating = [t.is_floating_point() for t in tensors]
        outs = _send_recv(tensors, group, size, rank, shift)
        ctx.mark_non_differentiable(
            *[o for o, f in zip(outs, ctx.floating) if not f])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        moving = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_send_recv(moving, *ctx.args, -ctx.shift))
        return (None, None, None, None,
                *[next(back) if f else None for f in ctx.floating])


class ProcessSequenceGroup(SequenceGroup):
    """This process's one shard of a ring of ``size`` ranks of
    ``group`` (a ``DeviceMesh`` dimension's process group); ``rank`` is
    its index in the ring."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.indices = (rank,)

    def split(self, x, dim=1):
        return [x]

    def join(self, xs, dim=1):
        return xs[0]

    def rotate(self, *xss, shift=1):
        if shift % self.size == 0:
            return tuple(list(xs) for xs in xss)
        outs = _Rotate.apply(self.group, self.size, self.rank, shift,
                             *[xs[0] for xs in xss])
        return tuple([o] for o in outs)

    def all_to_all(self, xs, split_dim, concat_dim):
        if self.size == 1:
            return list(xs)
        import torch.distributed._functional_collectives as fc

        stacked = torch.stack(xs[0].chunk(self.size, split_dim)).contiguous()
        out = fc.wait_tensor(fc.all_to_all_single_autograd(
            stacked, None, None, self.group))
        return [torch.cat(out.unbind(0), concat_dim)]

    def all_gather(self, xs, dim):
        if self.size == 1:
            return list(xs)
        import torch.distributed._functional_collectives as fc

        return [fc.wait_tensor(fc.all_gather_tensor_autograd(
            xs[0].contiguous(), dim, self.group))]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ring of each rank's ``x``, with its gradient
        (a rank's part of a sum over the whole sequence)."""
        if self.size == 1:
            return x
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, group=self.group)


# ---------------------------------------------------------------------------
# The batch's collectives: objectives over the whole global batch (in-batch
# negatives, BatchNorm's statistics) over the batch-shard ranks: the whole
# gang, or, under tensor or expert axes, the ranks of this rank's (expert,
# tensor) coordinate (``train.sharding.batch_ranks``), which hold the same
# rows as their coordinate's other ranks.
# ---------------------------------------------------------------------------


def _gang_size(group=None) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of ``group`` in its rank order; the gradient of
    a rank's rows is the sum over the ranks of the gradient that reaches
    them."""

    @staticmethod
    def forward(ctx, group, x):
        import torch.distributed as dist

        ctx.group = group
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return None, g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) of ``group`` (default:
    every rank; the batch-shard ranks under tensor or expert axes)
    concatenated along dim 0 in rank order, with its gradient: a
    collective. Each rank's part of the gang's objective reaches a rank's
    rows, so their gradient is the sum over the ranks (an all-reduce); a
    rank that backpropagates the whole objective weighs it through
    ``train.sharding.backward_global_mean``, whose scaling by the number
    of those ranks FSDP's averaging divides back out. ``x`` itself
    without a process group or on one rank."""
    if _gang_size(group) == 1:
        return x
    return _GatherRows.apply(group, x)


class _AllSum(torch.autograd.Function):
    """An all-reduce sum whose gradient is the all-reduce sum of the
    gradients."""

    @staticmethod
    def forward(ctx, group, x):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (default: every
    rank), with its gradient (the gradient of a rank's ``x`` is the sum
    of the ranks' gradients of the sum): a collective. ``x`` itself
    without a process group or on one rank."""
    if _gang_size(group) == 1:
        return x
    return _AllSum.apply(group, x)


# ---------------------------------------------------------------------------
# The pipeline's neighbour exchange: the port's stand-in for the
# ``ppermute`` of ``tpufw``'s pipeline schedules (s -> s+1 for
# activations, s -> s-1 for cotangents).
# ---------------------------------------------------------------------------


class PipeGroup:
    """A pipeline of ``size`` stages; ``indices`` are the stages this
    process holds, in the order of the stage axis of its stage stacks.

    ``handoff`` runs one tick's exchange: ``fwd`` maps a held stage to the
    activation it sends to the next stage, ``bwd`` one to the cotangent
    it sends to the previous one (both around the ring: the interleaved
    schedule's last stage feeds stage 0); it returns (what each held
    stage received from the previous stage, what each received from the
    next). ``fwd_expect`` and ``bwd_expect`` are the held stages that
    expect to receive in each direction, and ``like`` a tensor of the
    exchanged shape and dtype: a process holding one stage receives by
    them, one holding them all checks them against what was sent."""

    size: int
    indices: tuple

    def pos(self, stage: int) -> int:
        """Where ``stage`` sits on the stage axis of this process's
        stacks."""
        return self.indices.index(stage)

    def handoff(self, fwd: dict, bwd: dict, fwd_expect, bwd_expect,
                like: torch.Tensor) -> tuple[dict, dict]:
        raise NotImplementedError

    def handoff_autograd(self, fwd: dict, fwd_expect, like: torch.Tensor):
        """GPipe's forward exchange with its gradient: ``handoff`` of the
        activations alone; the gradient of each received tensor goes back
        to its sender (the transpose of ``ppermute``). Returns (received,
        an fp32 zero scalar tied to every exchange: added to this
        process's objective, it makes its backward run each exchange's
        reverse send)."""
        raise NotImplementedError


class LocalPipeGroup(PipeGroup):
    """All ``n`` stages of a pipeline in this process: hand-offs are moves
    between the stages' slots (differentiable as they are)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a pipeline needs at least one stage, got {n}")
        self.size = n
        self.indices = tuple(range(n))

    def _move(self, sent: dict, shift: int, expect) -> dict:
        got = {(s + shift) % self.size: x for s, x in sent.items()}
        if set(got) != set(expect):
            raise AssertionError(
                f"pipeline hand-off: stages {sorted(got)} received, "
                f"{sorted(expect)} expected (a schedule bug)")
        return got

    def handoff(self, fwd, bwd, fwd_expect, bwd_expect, like):
        return self._move(fwd, 1, fwd_expect), self._move(bwd, -1, bwd_expect)

    def handoff_autograd(self, fwd, fwd_expect, like):
        return self._move(fwd, 1, fwd_expect), like.new_zeros(
            (), dtype=torch.float32)


def _exchange(group, size: int, rank: int, sends: list, recvs: list,
              like: torch.Tensor) -> list:
    """One ``batch_isend_irecv`` of ``sends`` [(peer shift, tensor)] and
    ``recvs`` [peer shift] (tensors shaped as ``like``); returns the
    received tensors in ``recvs``' order."""
    import torch.distributed as dist

    ops, outs = [], []
    for shift, t in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), group=group,
                              group_peer=(rank + shift) % size))
    for shift in recvs:
        o = torch.empty_like(like)
        outs.append(o)
        ops.append(dist.P2POp(dist.irecv, o, group=group,
                              group_peer=(rank + shift) % size))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


class _Handoff(torch.autograd.Function):
    """One rank's forward exchange of a GPipe tick: send ``x`` (when
    ``sends``) to the next rank, receive from the previous one (when
    ``expect``); the backward sends the received tensor's gradient back
    and receives the sent one's."""

    @staticmethod
    def forward(ctx, group, size, rank, sends, expect, like, x):
        ctx.args = (group, size, rank)
        ctx.sends, ctx.expect, ctx.like = sends, expect, like
        got = _exchange(group, size, rank, [(1, x)] if sends else [],
                        [-1] if expect else [], like)
        return got[0] if expect else like.new_zeros(0)

    @staticmethod
    def backward(ctx, g):
        got = _exchange(*ctx.args, [(-1, g)] if ctx.expect else [],
                        [1] if ctx.sends else [], ctx.like)
        return (None, None, None, None, None, None,
                got[0] if ctx.sends else None)


class ProcessPipeGroup(PipeGroup):
    """This process's one stage of a pipeline of ``size`` ranks of
    ``group`` (a ``DeviceMesh``'s ``pipe`` dimension); ``rank`` is its
    stage."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.indices = (rank,)

    def connect(self, device) -> None:
        """One collective over the pipe's ranks, before any hand-off:
        NCCL needs every rank of a group in the group's first call, which
        a tick's sends and receives between two neighbours are not."""
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=device), group=self.group)

    def handoff(self, fwd, bwd, fwd_expect, bwd_expect, like):
        sends = [(1, fwd[self.rank])] if self.rank in fwd else []
        sends += [(-1, bwd[self.rank])] if self.rank in bwd else []
        recvs = ([-1] if self.rank in fwd_expect else []) + (
            [1] if self.rank in bwd_expect else [])
        got = iter(_exchange(self.group, self.size, self.rank, sends,
                             recvs, like))
        f = {self.rank: next(got)} if self.rank in fwd_expect else {}
        b = {self.rank: next(got)} if self.rank in bwd_expect else {}
        return f, b

    def handoff_autograd(self, fwd, fwd_expect, like):
        sends = self.rank in fwd
        expect = self.rank in fwd_expect
        if not (sends or expect):
            return {}, like.new_zeros((), dtype=torch.float32)
        x = fwd[self.rank] if sends else like.new_zeros(0).requires_grad_()
        out = _Handoff.apply(self.group, self.size, self.rank, sends,
                             expect, like.detach(), x)
        tie = out.float().sum() * 0.0
        return ({self.rank: out} if expect else {}), tie


# ---------------------------------------------------------------------------
# Tensor and expert parallelism: the Megatron split of a model's weights
# over the ``tensor`` mesh axis (attention heads, MLP width, vocabulary)
# and of a MoE layer's experts over ``expert``, the port's stand-in for
# the collectives GSPMD inserts for ``tpufw``'s ``logical_axis_rules``.
# ---------------------------------------------------------------------------


class ShardGroup:
    """The ``size`` shards of a model-parallel mesh axis; ``indices`` are
    the shards this process holds, in the order of its lists.

    The model code is written once over "the shards this process holds":
    a split weight's held shards (``shards``), each shard's part of a
    computation, then ``reduce`` (the sum over the axis, row-parallel
    exits) or ``gather`` (the concatenation, a vocab-parallel head's
    logits). ``enter`` marks where a replicated activation meets split
    weights: its gradient is then summed over the axis (Megatron's ``f``;
    ``reduce`` is its ``g``)."""

    axis: str
    size: int
    indices: tuple

    @property
    def holds_all(self) -> bool:
        """True when this process holds every shard."""
        return len(self.indices) == self.size

    @property
    def copies(self) -> int:
        """The processes that compute a value replicated over the axis."""
        return self.size // len(self.indices)

    def ranges(self, n: int) -> list:
        """The [lo, hi) index ranges of the held shards of an axis of
        ``n`` split evenly over the group."""
        return [(i * n // self.size, (i + 1) * n // self.size)
                for i in self.indices]

    def shards(self, w: torch.Tensor, dim: int) -> list:
        """The held shards of weight ``w`` split along ``dim``."""
        raise NotImplementedError

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``; its gradient is the sum over the axis of the gradients
        that reach it."""
        raise NotImplementedError

    def reduce(self, xs: list) -> torch.Tensor:
        """The sum over every shard of the axis of each one's ``xs``; the
        gradient reaches each shard whole."""
        raise NotImplementedError

    def gather(self, xs: list, dim: int) -> torch.Tensor:
        """Every shard's tensor concatenated in shard order along ``dim``;
        each shard's gradient is its slice."""
        raise NotImplementedError

    def max(self, xs: list) -> torch.Tensor:
        """The elementwise maximum over the axis of the held ``xs`` (no
        gradient)."""
        raise NotImplementedError


class LocalShardGroup(ShardGroup):
    """All ``n`` shards of the axis in this process, computed from the
    whole weights: a sum over the list is the reduction."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a {self.axis} axis needs at least one shard, "
                             f"got {n}")
        self.size = n
        self.indices = tuple(range(n))

    def shards(self, w, dim):
        if self.size == 1:
            return [w]
        if w.shape[dim] % self.size:
            raise ValueError(
                f"mesh {self.axis}={self.size} must divide dim {dim} of a "
                f"{tuple(w.shape)} weight")
        return list(w.chunk(self.size, dim))

    def enter(self, x):
        return x

    def reduce(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def gather(self, xs, dim):
        return torch.cat(xs, dim) if len(xs) > 1 else xs[0]

    def max(self, xs):
        out = xs[0].detach()
        for x in xs[1:]:
            out = torch.maximum(out, x.detach())
        return out


class _Enter(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return None, g


class _Reduce(torch.autograd.Function):
    """All-reduce forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, group, x):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Gather(torch.autograd.Function):
    """All-gather forward, concatenated along ``dim``; the gradient of
    this rank's part is its slice."""

    @staticmethod
    def forward(ctx, group, size, rank, dim, x):
        import torch.distributed as dist

        ctx.rank, ctx.dim, ctx.n = rank, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, None,
                g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n))


class ProcessShardGroup(ShardGroup):
    """This process's one shard of an axis of ``size`` ranks of ``group``
    (a ``DeviceMesh`` dimension's process group); ``rank`` is its index.
    A split weight here IS the rank's shard (``parallel.tensor.
    cut_model``)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.indices = (rank,)

    def shards(self, w, dim):
        return [w]

    def enter(self, x):
        return x if self.size == 1 else _Enter.apply(self.group, x)

    def reduce(self, xs):
        (x,) = xs
        return x if self.size == 1 else _Reduce.apply(self.group, x)

    def gather(self, xs, dim):
        (x,) = xs
        if self.size == 1:
            return x
        return _Gather.apply(self.group, self.size, self.rank, dim, x)

    def max(self, xs):
        import torch.distributed as dist

        (x,) = xs
        out = x.detach().clone()
        if self.size > 1:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out


class TensorGroup(ShardGroup):
    axis = "tensor"


class ExpertGroup(ShardGroup):
    axis = "expert"


class LocalTensorGroup(LocalShardGroup, TensorGroup):
    """All ``n`` tensor shards in one process (tests, and the card's
    one-process runs of the shard math)."""


class LocalExpertGroup(LocalShardGroup, ExpertGroup):
    """All ``n`` expert shards in one process."""


class ProcessTensorGroup(ProcessShardGroup, TensorGroup):
    """This rank's tensor shard of a gang."""


class ProcessExpertGroup(ProcessShardGroup, ExpertGroup):
    """This rank's expert shard of a gang."""


def enter_all(x: torch.Tensor, *groups: ShardGroup) -> torch.Tensor:
    """``x`` entering computations split over every axis of ``groups``."""
    for g in groups:
        x = g.enter(x)
    return x


def reduce_all(parts: list, *groups: ShardGroup) -> torch.Tensor:
    """The sum over the shards of every axis of ``groups`` of ``parts``,
    the held shards' parts in the nested order of ``groups`` (the first
    group's shards outermost)."""
    for g in reversed(groups):
        n = len(g.indices)
        parts = [g.reduce(parts[i:i + n]) for i in range(0, len(parts), n)]
    (out,) = parts
    return out


class _GradShare(torch.autograd.Function):
    """Identity forward; the gradient divided by ``n``."""

    @staticmethod
    def forward(ctx, n, x):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.n


def grad_share(x: torch.Tensor, *groups: ShardGroup) -> torch.Tensor:
    """``x``, a value every process of ``groups`` computes alike, whose
    gradient is then summed over them by an ``enter`` upstream: each
    process passes back its share, so the sum is the gradient once (a
    MoE layer's router losses)."""
    n = 1
    for g in groups:
        n *= g.copies
    return x if n == 1 else _GradShare.apply(n, x)
