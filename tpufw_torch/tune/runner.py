"""Measured autotuning: time real train steps per candidate (port of
``tpufw.tune.runner``).

Each candidate that ``tune.space`` lets through builds a real ``Trainer``
(or ``PipelineTrainer``), runs warm-up steps (which absorb the first use
of a kernel build, ``nvcc`` included) and a few timed steps, each ended by
``torch.cuda.synchronize``, and reports the median. The clock picks the
winner; no cost model does. Two rules keep a search from doing worse
than not searching:

- quarantine, never abort: a candidate that raises (out of memory
  included: the pre-pruning is first-order) is recorded and skipped;
- a wall-clock budget: once spent, the remaining candidates are skipped,
  but the first one always runs, so a tight budget measures the baseline.

Winners persist through ``tune.cache``; ``apply_autotune`` is the entry
``Trainer.run`` and ``PipelineTrainer.run`` call when
``TrainerConfig.autotune`` is not "off".
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Callable, Optional

from tpufw_torch.tune import cache as tune_cache
from tpufw_torch.tune.space import (
    Candidate,
    SearchSpace,
    enumerate_candidates,
)

_FLASH_ENV = ("TPUFW_FLASH_BQ", "TPUFW_FLASH_BKV")


@dataclasses.dataclass
class Trial:
    candidate: Candidate
    status: str  # "ok" | "quarantined" | "skipped_budget"
    median_step_s: Optional[float] = None
    error: Optional[str] = None


@dataclasses.dataclass
class TuneResult:
    best: Optional[Candidate]
    best_step_s: Optional[float]
    trials: list
    pruned: list
    tune_s: float
    cache_hit: bool = False
    cache_key: Optional[str] = None
    mode: str = "search"

    def summary(self) -> dict:
        """The JSON-able record the train logs echo (``tune_result``)."""
        return {
            "mode": self.mode,
            "cache_hit": self.cache_hit,
            "cache_key": self.cache_key,
            "tune_s": round(self.tune_s, 3),
            "config": self.best.as_dict() if self.best else None,
            "best_step_s": self.best_step_s,
            "n_measured": sum(1 for t in self.trials if t.status == "ok"),
            "n_quarantined": sum(
                1 for t in self.trials if t.status == "quarantined"
            ),
            "n_pruned": len(self.pruned),
        }


def search(
    candidates: list[Candidate],
    measure_fn: Callable[[Candidate], float],
    budget_s: float = 120.0,
    pruned: Optional[list] = None,
    events=None,
) -> TuneResult:
    """Measure candidates under a wall-clock budget; best = least median.

    ``measure_fn(candidate) -> median step seconds`` does the real work
    (tests pass a fake); an exception it raises quarantines that candidate
    only. The first candidate is always measured. ``events`` (an
    ``obs`` event log) gets one ``tune_trial`` line per candidate as it
    resolves."""
    if events is None:
        from tpufw_torch.obs import events as events_mod

        events = events_mod.NULL
    t0 = time.perf_counter()
    trials: list[Trial] = []
    measured_any = False

    def log_trial(t: Trial) -> None:
        trials.append(t)
        events.emit(
            "tune_trial",
            trial=len(trials) - 1,
            status=t.status,
            candidate=t.candidate.as_dict(),
            median_step_s=t.median_step_s,
            error=t.error,
        )

    for cand in candidates:
        if measured_any and time.perf_counter() - t0 > budget_s:
            log_trial(Trial(cand, "skipped_budget"))
            continue
        try:
            med = float(measure_fn(cand))
        except Exception as e:  # noqa: BLE001 — quarantine, never abort
            log_trial(
                Trial(cand, "quarantined", error=f"{type(e).__name__}: {e}")
            )
            continue
        log_trial(Trial(cand, "ok", median_step_s=med))
        measured_any = True
    ok = [t for t in trials if t.status == "ok"]
    best = min(ok, key=lambda t: t.median_step_s, default=None)
    return TuneResult(
        best=best.candidate if best else None,
        best_step_s=best.median_step_s if best else None,
        trials=trials,
        pruned=list(pruned or []),
        tune_s=time.perf_counter() - t0,
    )


def _set_flash_env(bq: Optional[int], bkv: Optional[int]) -> dict:
    """Point the kernels' tile override at the candidate's build (None
    pops: the head dim's default). Returns the previous values."""
    prev = {k: os.environ.get(k) for k in _FLASH_ENV}
    for k, v in zip(_FLASH_ENV, (bq, bkv)):
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return prev


def _restore_env(prev: dict) -> None:
    for k, v in prev.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _candidate_model_cfg(model_cfg, cand: Candidate):
    """The model config to measure or run with: ``model_cfg`` unless it
    remats under another policy than the candidate's."""
    if (
        not getattr(model_cfg, "remat", False)
        or getattr(model_cfg, "remat_policy", None) == cand.remat_policy
    ):
        return model_cfg
    return dataclasses.replace(model_cfg, remat_policy=cand.remat_policy)


def candidate_program_name(cand: Candidate) -> str:
    """The perf observatory's program name of one tune candidate: the key
    its measured trial's costs and MFU land under in ``programs.json``."""
    parts = [
        f"tune:{cand.remat_policy}",
        f"ga{cand.grad_accum}",
        f"lc{cand.loss_chunk_size}",
    ]
    if cand.flash_bq or cand.flash_bkv:
        parts.append(f"fb{cand.flash_bq}x{cand.flash_bkv}")
    if cand.pipeline_schedule:
        parts.append(f"{cand.pipeline_schedule}v{cand.pipeline_vstages}")
    return "-".join(parts)


def _measure_steps(trainer, tokens, n_steps, warmup_steps, name, perf):
    """Median seconds of ``n_steps`` train steps of ``trainer`` on
    ``tokens``, after ``warmup_steps`` (at least one: it builds every
    kernel the step launches); on CUDA each step ends in a synchronize.
    The first warm-up step is the perf observatory's counted one."""
    import torch

    cuda = trainer.device.type == "cuda"

    def step(batch):
        m = trainer.train_step(batch)
        if cuda:
            torch.cuda.synchronize(trainer.device)
        else:
            float(m["loss"])
        return m

    batch = {"tokens": tokens}
    for i in range(max(warmup_steps, 1)):
        if i == 0 and perf is not None:
            perf.observe_step(name, step, batch)
        else:
            step(batch)
    times = []
    for _ in range(max(n_steps, 1)):
        t0 = time.perf_counter()
        step(batch)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    if perf is not None:
        perf.record_wall(name, med)
    return med


def _measured(build: Callable, cand: Candidate, tokens, n_steps,
              warmup_steps, seed, perf) -> float:
    """Build a trainer for ``cand`` under its flash override, measure it,
    and free it: an out-of-memory error empties the allocator's cache
    before it quarantines the candidate."""
    import torch

    prev = _set_flash_env(cand.flash_bq, cand.flash_bkv)
    trainer = None
    try:
        trainer = build()
        trainer.init_state(seed=seed)
        return _measure_steps(trainer, tokens, n_steps, warmup_steps,
                              candidate_program_name(cand), perf)
    finally:
        _restore_env(prev)
        cuda = trainer is not None and trainer.device.type == "cuda"
        del trainer
        if cuda:
            torch.cuda.empty_cache()


def _tokens(model_cfg, trainer_cfg, n_shards: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    vocab = getattr(model_cfg, "vocab_size", 32000)
    return torch.from_numpy(rng.integers(
        0, vocab, (trainer_cfg.batch_size // max(n_shards, 1),
                   trainer_cfg.seq_len), dtype=np.int64))


def _measure_cfg(trainer_cfg, **kw):
    return dataclasses.replace(
        trainer_cfg, sync_every=1, checkpoint_dir=None, profile_dir=None,
        telemetry_dir=None, metrics_port=None, eval_every=0,
        handle_preemption=False, autotune="off", **kw)


def make_measure_fn(
    model_cfg,
    trainer_cfg,
    mesh_cfg=None,
    device=None,
    groups: tuple = (),
    n_steps: int = 3,
    warmup_steps: int = 1,
    seed: int = 0,
    perf=None,
) -> Callable[[Candidate], float]:
    """A measure_fn that builds a real ``Trainer`` per candidate (fresh
    weights and optimizer) and times its real step on seeded tokens, this
    rank's rows of the global batch."""
    from tpufw_torch.train.trainer import Trainer

    tokens = _tokens(model_cfg, trainer_cfg, _batch_shards(mesh_cfg), seed)

    def measure(cand: Candidate) -> float:
        cfg = _measure_cfg(trainer_cfg, grad_accum=cand.grad_accum,
                           loss_chunk_size=cand.loss_chunk_size)

        def build():
            return Trainer(_candidate_model_cfg(model_cfg, cand), cfg,
                           mesh_cfg, device=device, groups=groups)

        return _measured(build, cand, tokens, n_steps, warmup_steps, seed,
                         perf)

    return measure


def _batch_shards(mesh_cfg) -> int:
    """data x fsdp of ``mesh_cfg`` over the gang (1 without one)."""
    from tpufw_torch.train import sharding

    if mesh_cfg is None or not sharding.active():
        return 1
    sizes = mesh_cfg.slice_sizes(sharding.world_size())
    return sizes["data"] * sizes["fsdp"] * max(mesh_cfg.dcn_data, 1)


def make_pipeline_measure_fn(
    model_cfg,
    pipe,
    trainer_cfg,
    mesh_cfg=None,
    device=None,
    n_steps: int = 3,
    warmup_steps: int = 1,
    seed: int = 0,
    perf=None,
) -> Callable[[Candidate], float]:
    """make_measure_fn's ``PipelineTrainer`` twin: a fresh trainer per
    candidate on the candidate's schedule (the one ``apply_candidate``
    would install); grad_accum is pinned at 1 (the microbatches are the
    accumulation)."""
    from tpufw_torch.train.pipeline_trainer import PipelineTrainer

    tokens = _tokens(model_cfg, trainer_cfg, _batch_shards(mesh_cfg), seed)

    def measure(cand: Candidate) -> float:
        cfg = _measure_cfg(trainer_cfg, grad_accum=1,
                           loss_chunk_size=cand.loss_chunk_size)
        p = _candidate_pipe(pipe, cand)

        def build():
            return PipelineTrainer(_candidate_model_cfg(model_cfg, cand), p,
                                   cfg, mesh_cfg, device=device)

        return _measured(build, cand, tokens, n_steps, warmup_steps, seed,
                         perf)

    return measure


def _candidate_pipe(pipe, cand: Candidate):
    if not cand.pipeline_schedule:
        return pipe
    return dataclasses.replace(
        pipe, schedule=cand.pipeline_schedule,
        n_virtual=(cand.pipeline_vstages
                   if cand.pipeline_schedule == "interleaved" else 1))


def _mesh_shape(trainer) -> tuple:
    """The trainer's mesh as (data, pipe, fsdp, expert, sequence, tensor)
    sizes: the gang's DeviceMesh, or one process's stages and local
    groups."""
    sizes = {"data": 1, "pipe": 1, "fsdp": 1, "expert": 1, "sequence": 1,
             "tensor": 1}
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        sizes.update(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    else:
        pipe = getattr(trainer, "pipe", None)
        if pipe is not None:
            sizes["pipe"] = pipe.n_stages
        for g in getattr(trainer, "groups", ()):
            sizes[g.axis] = g.size
        ring = getattr(trainer, "local_ring", None)
        if ring is not None:
            sizes["sequence"] = ring.size
    return tuple(sizes.values())


def trainer_cache_key(trainer) -> str:
    """The tune cache's key of a trainer's (model, batch, seq, mesh)
    point; the perf observatory's ``programs.json`` is keyed by it too."""
    pipe = getattr(trainer, "pipe", None)
    return tune_cache.cache_key(
        trainer.model_cfg,
        trainer.cfg.batch_size,
        trainer.cfg.seq_len,
        _mesh_shape(trainer),
        # Stage and microbatch counts change the step being tuned; the
        # schedule is the searched dimension, so not part of the key.
        extra=(f"pp{pipe.n_stages}x{pipe.n_microbatches}"
               if pipe is not None else None),
    )


def _relayout_pipe_state(trainer, new) -> None:
    """Move a live ``PipelineTrainer``'s params and Adam moments from its
    stage layout into ``new``'s (canonical ``[S, ...]`` and interleaved
    ``[v, S, ...]`` stacks are reshapes of each other), keeping the step
    and the moments."""
    from tpufw_torch.parallel.pipeline import (
        to_canonical_stages,
        to_virtual_stages,
    )

    if new.virtual_layout:
        def conv(tree):
            return to_virtual_stages(tree, new.n_virtual, new.n_stages)
    else:
        def conv(tree):
            return to_canonical_stages(tree, new.n_stages)

    state = trainer.state_dict()
    opt = trainer._map_moments(
        state["optimizer"],
        lambda t, path: conv({"x": t})["x"] if path.startswith("stages/")
        else t)
    params = dict(state["params"], stages=conv(state["params"]["stages"]))
    trainer.pipe = new
    trainer.load_state_dict(dict(state, params=params, optimizer=opt,
                                 pipeline=dataclasses.asdict(new)))


def _apply_pipeline_candidate(trainer, cand: Candidate) -> None:
    """Install a winner on a live ``PipelineTrainer``: the CE chunk, the
    sync window, the flash override, the remat policy and the schedule
    (a layout change moves the state across in place). grad_accum is not
    a pipeline knob and is left alone."""
    from tpufw_torch.parallel.pipeline import check_group

    trainer.cfg.loss_chunk_size = cand.loss_chunk_size
    trainer.cfg.sync_every = cand.sync_every
    trainer.model_cfg = _candidate_model_cfg(trainer.model_cfg, cand)
    _set_flash_env(cand.flash_bq, cand.flash_bkv)
    old = trainer.pipe
    new = _candidate_pipe(old, cand)
    if new == old:
        return
    new.validate(trainer.model_cfg, trainer.cfg.batch_size)
    check_group(new, trainer.group)
    if new.schedule != "gpipe":
        from tpufw_torch.parallel.pipeline_1f1b import _check_1f1b

        with trainer._groups():
            _check_1f1b(trainer.model_cfg, new.schedule)
    if trainer.params is not None and new.virtual_layout != old.virtual_layout:
        _relayout_pipe_state(trainer, new)
    trainer.pipe = new


def apply_candidate(trainer, cand: Candidate) -> None:
    """Install a winner on a live trainer: the config knobs, the remat
    policy, and the flash override. The port's models read the remat
    policy from their config at each forward, so a new policy re-points
    the config of the model (and of each module holding it): the same
    weights and optimizer state, stepping under the new policy, with
    nothing compiled to drop. A ``PipelineTrainer`` takes the pipeline
    branch (schedule swap and state re-layout)."""
    if hasattr(trainer, "pipe"):
        _apply_pipeline_candidate(trainer, cand)
        return
    trainer.cfg.grad_accum = cand.grad_accum
    trainer.cfg.loss_chunk_size = cand.loss_chunk_size
    trainer.cfg.sync_every = cand.sync_every
    old = trainer.model_cfg
    new = _candidate_model_cfg(old, cand)
    if new is not old:
        trainer.model_cfg = new
        if trainer.model is not None:
            for module in trainer.model.modules():
                if getattr(module, "cfg", None) is old:
                    module.cfg = new
    _set_flash_env(cand.flash_bq, cand.flash_bkv)


def _result(trainer, events, key, mode, best=None, cache_hit=False):
    result = TuneResult(
        best=best, best_step_s=None, trials=[], pruned=[], tune_s=0.0,
        cache_hit=cache_hit, cache_key=key, mode=mode)
    trainer.last_tune = result
    events.emit("tune_result", **result.summary())
    return result


def apply_autotune(
    trainer,
    space: Optional[SearchSpace] = None,
    events=None,
    perf=None,
) -> Optional[TuneResult]:
    """Resolve ``TrainerConfig.autotune`` for a ``Trainer`` or
    ``PipelineTrainer``:

    - ``"cached"``: apply the kept winner if there is one, else nothing;
    - ``"search"``: a cache hit applies at once; a miss runs the budgeted
      search (``autotune_steps`` timed steps a candidate, memory pruning
      against ``detect_chip(...).hbm_bytes`` on CUDA, none on the CPU),
      keeps the winner and applies it.

    Returns the TuneResult (also ``trainer.last_tune``), or None when the
    mode is "off". ``events`` gets a ``tune_trial`` line per candidate and
    one ``tune_result``; ``perf`` (the perf observatory) each measured
    trial's counted cost under its ``candidate_program_name``."""
    if events is None:
        from tpufw_torch.obs import events as events_mod

        events = events_mod.NULL
    mode = getattr(trainer.cfg, "autotune", "off")
    if mode not in ("cached", "search"):
        return None
    key = trainer_cache_key(trainer)
    cached = tune_cache.load_candidate(key)
    if cached is not None:
        apply_candidate(trainer, cached)
        return _result(trainer, events, key, mode, best=cached,
                       cache_hit=True)
    if mode == "cached":
        return _result(trainer, events, key, mode)

    from tpufw_torch.utils.hardware import detect_chip

    # Memory pruning only means something against a card's memory; the
    # CPU's table entry is nominal and would mis-prune.
    hbm = (detect_chip(trainer.device).hbm_bytes
           if trainer.device.type == "cuda" else None)
    mcfg = trainer.model_cfg
    dp = trainer.batch_shard()[1]
    pipe = getattr(trainer, "pipe", None)
    if pipe is not None and space is None:
        # The pipeline's own axes: the schedule is the search, grad_accum
        # and the remat policy are pinned.
        space = SearchSpace(
            grad_accums=(1,),
            remat_policies=(getattr(mcfg, "remat_policy", "dots"),),
            pipeline_schedules=(
                None, ("1f1b", 1), ("interleaved", 2), ("zb1", 1),
            ),
        )
    candidates, pruned = enumerate_candidates(
        mcfg,
        trainer.cfg.batch_size,
        trainer.cfg.seq_len,
        space=space,
        dp_shards=dp,
        n_shards=dp,
        hbm_bytes=hbm,
        pipe_stages=pipe.n_stages if pipe is not None else 0,
        pipe_microbatches=pipe.n_microbatches if pipe is not None else 0,
    )
    perf = perf if perf is not None and perf.enabled else None
    steps = getattr(trainer.cfg, "autotune_steps", 3)
    if pipe is not None:
        measure = make_pipeline_measure_fn(
            mcfg, pipe, trainer.cfg, trainer.mesh_cfg, device=trainer.device,
            n_steps=steps, perf=perf)
    else:
        measure = make_measure_fn(
            mcfg, trainer.cfg, trainer.mesh_cfg, device=trainer.device,
            groups=_local_groups(trainer), n_steps=steps, perf=perf)
    result = search(
        candidates,
        measure,
        budget_s=getattr(trainer.cfg, "autotune_budget_s", 120.0),
        pruned=pruned,
        events=events,
    )
    result.cache_key = key
    result.mode = mode
    if result.best is not None:
        tune_cache.store(key, result.best, median_step_s=result.best_step_s,
                         tune_s=result.tune_s)
        apply_candidate(trainer, result.best)
    trainer.last_tune = result
    events.emit("tune_result", **result.summary())
    return result


def _local_groups(trainer) -> tuple:
    """The ``groups=`` a one-process trainer was built with (its local
    tensor and expert groups and its ring), () in a gang."""
    if getattr(trainer, "mesh", None) is not None:
        return ()
    out = tuple(g for g in trainer.groups if g.size > 1)
    ring = getattr(trainer, "local_ring", None)
    if ring is not None and ring.size > 1:
        out += (ring,)
    return out
