"""Search space of the train-step autotuner: candidates and validity
(port of ``tpufw.tune.space``).

Each knob a sweep would hand-pick (remat policy, grad-accum split, CE
chunk, flash tile build, sync window, pipeline schedule) is one axis of a
small Cartesian space. Two filters keep the measurement tractable:

- validity: the rules the trainer enforces (grad_accum over the batch and
  the data x fsdp rows; a flash ``(bq, bkv)`` is valid when the model's
  head dim has that build of every kernel of the step; the pipeline
  schedule's divisibility) are checked here, so an invalid candidate never
  reaches a step;
- memory pre-pruning: ``tools.estimate_memory.estimate_train`` runs first,
  and a candidate predicted past ``HBM_FRACTION`` of the card's memory is
  dropped unmeasured.

One rule differs from ``tpufw``'s by design: the port's kernels mask the
ragged tail, so a flash block need not divide the padded sequence.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from tpufw_torch.tools.estimate_memory import estimate_train


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the search space: the knobs a winner carries.

    ``flash_bq``/``flash_bkv`` of None keep the head dim's default build
    (``ops.flash.TILES``); ``loss_chunk_size`` of None keeps full logits.
    ``pipeline_schedule`` of None keeps the trainer's own schedule;
    ``pipeline_vstages`` is the interleaved schedule's v."""

    remat_policy: str = "dots"
    grad_accum: int = 1
    loss_chunk_size: Optional[int] = None
    flash_bq: Optional[int] = None
    flash_bkv: Optional[int] = None
    sync_every: int = 1
    pipeline_schedule: Optional[str] = None
    pipeline_vstages: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axes of the Cartesian candidate space; tests and budget-tight runs
    pass smaller ones. ``flash_blocks`` of None is the head dim's own
    axis: None plus every other build the step's three kernels have
    (``ops.flash.tile_choices``)."""

    remat_policies: tuple = ("dots", "attn_out", "nothing")
    grad_accums: tuple = (1, 2)
    loss_chunk_sizes: tuple = (None, 512)
    # (bq, bkv) pairs; None = the head dim's default build.
    flash_blocks: Optional[tuple] = None
    sync_everys: tuple = (1, 4)
    # (schedule, vstages) pairs; the lone None keeps the axis inert for
    # non-pipeline trainers.
    pipeline_schedules: tuple = (None,)


DEFAULT_SPACE = SearchSpace()

# Headroom on the analytic estimate: the allocator's blocks and
# temporaries add real variance, so pruning at 100% of the card's memory
# would measure candidates that run out of it anyway.
HBM_FRACTION = 0.9


def flash_head_dim(model_cfg) -> int:
    """The head dim the flash kernels see: MLA's qk head dim (V is padded
    to it), else ``head_dim``."""
    return getattr(model_cfg, "qk_head_dim", None) or getattr(
        model_cfg, "head_dim", 0)


def candidate_order(c: Candidate) -> tuple:
    """Deterministic measurement order: baseline-like candidates first, so
    a tight budget measures something runnable before the corners."""
    return (
        c.grad_accum,
        c.sync_every,
        c.flash_bq or 0,
        c.flash_bkv or 0,
        c.remat_policy,
        c.loss_chunk_size or 0,
        c.pipeline_schedule or "",
        c.pipeline_vstages,
    )


def _bad_blocks(head_dim: int, bq, bkv) -> Optional[str]:
    """Why (bq, bkv) is no build of every kernel at ``head_dim``, or
    None."""
    from tpufw_torch.ops.flash import KERNELS, resolve_tiles

    try:
        for base in KERNELS:
            resolve_tiles(base, head_dim, (bq, bkv))
    except ValueError as e:
        return str(e)
    return None


def enumerate_candidates(
    model_cfg,
    batch_size: int,
    seq_len: int,
    space: SearchSpace | None = None,
    dp_shards: int = 1,
    n_shards: int = 1,
    hbm_bytes: Optional[float] = None,
    hbm_fraction: float = HBM_FRACTION,
    pipe_stages: int = 0,
    pipe_microbatches: int = 0,
) -> tuple[list[Candidate], list[tuple[Candidate, str]]]:
    """The space, filtered: (valid, pruned with a reason).

    ``dp_shards`` is the data x fsdp product the batch rows shard over;
    ``n_shards`` the param sharding degree fed to the memory estimate;
    ``hbm_bytes`` of None turns memory pruning off (validity only: tests
    and CPU runs). ``pipe_stages``/``pipe_microbatches`` describe a
    pipeline trainer (0: not one, and every non-None schedule prunes)."""
    space = space or DEFAULT_SPACE
    uses_flash = getattr(model_cfg, "attention_backend", "") == "flash"
    uses_remat = getattr(model_cfg, "remat", False)
    head_dim = flash_head_dim(model_cfg)
    policies = space.remat_policies if uses_remat else (
        getattr(model_cfg, "remat_policy", "dots"),
    )
    if not uses_flash:
        blocks = (None,)
    elif space.flash_blocks is None:
        from tpufw_torch.ops.flash import tile_choices

        blocks = (None, *tile_choices(head_dim))
    else:
        blocks = space.flash_blocks

    valid: list[Candidate] = []
    pruned: list[tuple[Candidate, str]] = []
    seen: set = set()
    n_layers = getattr(model_cfg, "n_layers", 0)
    for policy, accum, chunk, blk, sync, sched in itertools.product(
        policies, space.grad_accums, space.loss_chunk_sizes, blocks,
        space.sync_everys, space.pipeline_schedules,
    ):
        bq, bkv = blk if blk is not None else (None, None)
        ps, pv = sched if sched is not None else (None, 1)
        cand = Candidate(
            remat_policy=policy,
            grad_accum=accum,
            loss_chunk_size=chunk,
            flash_bq=bq,
            flash_bkv=bkv,
            sync_every=sync,
            pipeline_schedule=ps,
            pipeline_vstages=pv,
        )
        if cand in seen:
            continue
        seen.add(cand)
        if ps is not None:
            if pipe_stages < 2:
                pruned.append(
                    (cand, f"pipeline schedule {ps!r} needs a pipeline "
                     "trainer (pipe_stages >= 2)")
                )
                continue
            if ps == "interleaved":
                if pv < 2:
                    pruned.append(
                        (cand, "interleaved needs pipeline_vstages >= 2"))
                    continue
                if n_layers % (pv * pipe_stages):
                    pruned.append(
                        (cand, f"n_layers={n_layers} not divisible "
                         f"into {pv}x{pipe_stages} virtual chunks")
                    )
                    continue
                if pipe_microbatches % pipe_stages:
                    pruned.append(
                        (cand, f"microbatches {pipe_microbatches} not "
                         f"divisible by {pipe_stages} stages")
                    )
                    continue
            elif pv != 1:
                pruned.append(
                    (cand, f"pipeline_vstages={pv} only applies to "
                     "the interleaved schedule")
                )
                continue
        if accum < 1 or batch_size % accum:
            pruned.append(
                (cand, f"grad_accum {accum} does not divide batch "
                 f"{batch_size}")
            )
            continue
        if (batch_size // accum) % max(dp_shards, 1):
            pruned.append(
                (cand, f"microbatch rows {batch_size // accum} do not "
                 f"divide over data x fsdp = {dp_shards}")
            )
            continue
        if chunk is not None and chunk < 1:
            pruned.append((cand, f"loss_chunk_size {chunk} < 1"))
            continue
        if blk is not None:
            why = _bad_blocks(head_dim, bq, bkv)
            if why is not None:
                pruned.append((cand, why))
                continue
        if hbm_bytes:
            est = estimate_train(
                model_cfg,
                batch_size,
                seq_len,
                n_shards=max(n_shards, 1),
                remat_policy=policy,
                loss_chunk_size=chunk,
                grad_accum=accum,
            )
            if est.total() > hbm_bytes * hbm_fraction:
                pruned.append(
                    (cand, f"estimated {est.total() / 2**30:.2f} GiB > "
                     f"{hbm_fraction:.0%} of "
                     f"{hbm_bytes / 2**30:.2f} GiB HBM")
                )
                continue
        valid.append(cand)
    valid.sort(key=candidate_order)
    return valid, pruned
