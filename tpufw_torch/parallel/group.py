"""The collectives of a sequence ring: the port's stand-in for the
``ppermute``, ``all_to_all`` and ``all_gather`` that ``tpufw``'s
sequence-parallel bodies issue under ``shard_map``.

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
