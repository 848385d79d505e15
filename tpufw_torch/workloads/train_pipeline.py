"""Pipeline-parallel LM training workload: ``python -m
tpufw_torch.workloads.train_pipeline`` (port of
``tpufw.workloads.train_pipeline``), on one GPU holding every stage or as
a gang of ``data x pipe`` processes, one per GPU.

Knobs (``tpufw``'s names):

  TPUFW_PIPE_STAGES (required, >= 2,  pipeline stages (the mesh's pipe)
  unless the YAML has a pipeline)
  TPUFW_PIPE_MICROBATCHES             default 2 x stages
  TPUFW_PIPELINE_SCHEDULE             gpipe (default) | 1f1b |
                                      interleaved | zb1
  TPUFW_PIPELINE_VSTAGES              chunks a stage for interleaved
  TPUFW_PIPE_SCHEDULE                 the older spelling of the schedule;
                                      TPUFW_PIPELINE_SCHEDULE wins
  TPUFW_MODEL (default llama3_600m_bench; any preset of
  ``configs.resolve_model_preset``), TPUFW_BATCH_SIZE
  (the global batch), TPUFW_SEQ_LEN, TPUFW_TOTAL_STEPS, TPUFW_LR,
  TPUFW_WARMUP_STEPS, TPUFW_LOG_EVERY, TPUFW_LOSS_CHUNK_SIZE (0 = full
  logits), TPUFW_LOSS_CHUNK_DTYPE, TPUFW_ADAM_MU_DTYPE, TPUFW_SYNC_EVERY,
  TPUFW_EVAL_EVERY / TPUFW_EVAL_BATCHES, TPUFW_CHECKPOINT_DIR /
  TPUFW_CHECKPOINT_EVERY, TPUFW_HANDLE_PREEMPTION /
  TPUFW_PREEMPTION_SYNC_EVERY, TPUFW_SEED, TPUFW_DATA_SEED, TPUFW_DEVICE
  (default ``cuda``; ``cpu`` for gloo); the telemetry knobs of
  ``train_llama`` (TPUFW_TELEMETRY_DIR, TPUFW_METRICS_PORT,
  TPUFW_STRAGGLER_FACTOR, TPUFW_PROFILE_DIR / _START / _STOP,
  TPUFW_PROFILE_STEPS, TPUFW_HANG_TIMEOUT_S, ...) and
  TPUFW_COMPILE_CACHE_DIR; TPUFW_CONFIG (a YAML of record: its model,
  trainer, mesh and pipeline sections are the base the knobs above
  override) and TPUFW_AUTOTUNE / _BUDGET_S / _STEPS (the schedule search
  of ``tpufw_torch.tune``), as ``train_llama`` reads them. ``tpufw``'s
  pipeline workload reads neither (it leaves them to ``train_llama``).

A gang (``tpufw``'s cluster environment, as for ``train_llama``) lays its
ranks out over ``TPUFW_MESH_DATA`` x pipe x ``TPUFW_MESH_FSDP`` (-1, the
default, fills) x ``TPUFW_MESH_EXPERT`` x ``TPUFW_MESH_TENSOR``: each rank
runs its stage, its shards of the stage's heads and ``d_ff`` over
``tensor`` and of a MoE stage's experts over ``expert``, and the ``data``
and ``fsdp`` ranks are batch shards, each loading its rows from its own
synthetic seeds (the ``tensor`` and ``expert`` ranks of a batch shard
load the same). One process without a gang holds every stage and every
tensor and expert shard (the other axes must be 1). Data: synthetic
batches from the even seeds; the held-out eval's from the odd ones. Step
metrics stream as JSON lines.

Refused with an error: TPUFW_PIPE_STAGES below 2; TPUFW_GRAD_ACCUM above
1 (microbatching is the schedule); TPUFW_MESH_TENSOR that does not divide
the heads or ``d_ff`` and TPUFW_MESH_EXPERT on a dense model or one whose
experts it does not divide (``tpufw``'s checks), and an expert axis under
the manual schedules; TPUFW_MESH_SEQUENCE above 1 (``tpufw``'s pipeline
needs sequence 1);
TPUFW_MOE_DISPATCH other than ``einsum`` (the pipelined MoE routes with
the capacity router, which ``tpufw`` falls back to silently).

Not read, as in ``tpufw``: TPUFW_ATTENTION (``train_llama``'s knob); the
preset's or the YAML's ``attention_backend`` stands.
"""

from __future__ import annotations

import json
import time

from tpufw_torch.workloads.env import (
    env_bool,
    env_float,
    env_int,
    env_opt_int,
    env_str,
    mesh_from_env,
)

_T0 = time.time()


def build_trainer(cluster=None):
    """(PipelineTrainer, model_cfg) from the TPUFW_* environment, on
    ``cluster``'s local device (default: the resolved cluster
    environment)."""
    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.configs import BENCH_CONFIG_NAME, resolve_model_preset
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer, TrainerConfig, sharding
    from tpufw_torch.workloads.train_llama import (
        autotune_knobs,
        load_config_env,
    )

    run = load_config_env()
    yaml_pipe = run.pipeline if run else None
    stages = env_int("pipe_stages", yaml_pipe.n_stages if yaml_pipe else 0)
    if stages < 2:
        raise ValueError(
            f"TPUFW_PIPE_STAGES={stages}: pipeline training needs >= 2 "
            "stages (use tpufw_torch.workloads.train_llama for pipe=1)"
        )
    dispatch = env_str("moe_dispatch", "")
    if dispatch not in ("", "einsum"):
        raise NotImplementedError(
            f"TPUFW_MOE_DISPATCH={dispatch!r}: pipelined MoE stages route "
            "with the capacity (einsum) dispatch only")
    name = env_str("model", run.model_preset if run else BENCH_CONFIG_NAME)
    # The YAML's own preset keeps its model.overrides.
    model_cfg = (run.model_cfg if run and name == run.model_preset
                 else resolve_model_preset(name))
    pipe = PipelineConfig(
        n_stages=stages,
        n_microbatches=env_int(
            "pipe_microbatches",
            yaml_pipe.n_microbatches if yaml_pipe else 2 * stages),
        # TPUFW_PIPELINE_SCHEDULE wins over the older spelling.
        schedule=env_str("pipeline_schedule", "")
        or env_str("pipe_schedule",
                   yaml_pipe.schedule if yaml_pipe else "gpipe"),
        n_virtual=env_int("pipeline_vstages",
                          yaml_pipe.n_virtual if yaml_pipe else 1),
    )
    base = run.trainer if run else TrainerConfig(
        batch_size=8, seq_len=model_cfg.max_seq_len, checkpoint_every=100)
    trainer_cfg = TrainerConfig(
        batch_size=env_int("batch_size", base.batch_size),
        seq_len=env_int("seq_len", base.seq_len),
        total_steps=env_int("total_steps", base.total_steps),
        lr=env_float("lr", base.lr),
        warmup_steps=env_int("warmup_steps", base.warmup_steps),
        log_every=env_int("log_every", base.log_every),
        loss_chunk_size=env_int("loss_chunk_size",
                                base.loss_chunk_size or 0) or None,
        loss_chunk_dtype=env_str("loss_chunk_dtype", base.loss_chunk_dtype),
        # Read so that the trainer's refusal fires on a set knob.
        grad_accum=env_int("grad_accum", base.grad_accum),
        eval_every=env_int("eval_every", base.eval_every),
        eval_batches=env_int("eval_batches", base.eval_batches),
        adam_mu_dtype=env_str("adam_mu_dtype",
                              base.adam_mu_dtype or "") or None,
        sync_every=env_int("sync_every", base.sync_every),
        checkpoint_dir=env_str("checkpoint_dir",
                               base.checkpoint_dir or "") or None,
        checkpoint_every=env_int("checkpoint_every", base.checkpoint_every),
        handle_preemption=env_bool("handle_preemption",
                                   base.handle_preemption),
        preemption_sync_every=env_int("preemption_sync_every",
                                      base.preemption_sync_every),
        profile_dir=env_str("profile_dir", base.profile_dir or "") or None,
        profile_start=env_int("profile_start", base.profile_start),
        profile_stop=env_int("profile_stop", base.profile_stop),
        telemetry_dir=env_str("telemetry_dir",
                              base.telemetry_dir or "") or None,
        metrics_port=env_opt_int("metrics_port", base.metrics_port),
        straggler_factor=env_float("straggler_factor",
                                   base.straggler_factor),
        **autotune_knobs(base),
    )
    # One process stands for the whole pipe and every tensor and expert
    # shard; a gang's ranks are devices.
    base_mesh = run.mesh if run else None
    world = (sharding.world_size() if sharding.active() else
             stages * max(env_int("mesh_tensor", getattr(
                 base_mesh, "tensor", 1)), 1)
             * max(env_int("mesh_expert", getattr(base_mesh, "expert", 1)),
                   1))
    mesh_cfg = mesh_from_env(world, pipe=stages, base=base_mesh)
    device = local_device(cluster or resolve_cluster_env(),
                          env_str("device", "cuda"))
    trainer = PipelineTrainer(model_cfg, pipe, trainer_cfg, mesh_cfg,
                              device=device)
    return trainer, model_cfg


def main() -> int:
    from tpufw_torch.cluster import initialize_cluster
    from tpufw_torch.train import synthetic_batches
    from tpufw_torch.utils.profiling import enable_compile_cache
    from tpufw_torch.workloads._common import (
        check_global_batch,
        metrics_printer,
        print_summary,
        report_preemption,
        report_telemetry,
        resume_data_seed,
    )

    cache = enable_compile_cache()
    cluster = initialize_cluster(device=env_str("device", "cuda"))
    trainer, model_cfg = build_trainer(cluster)
    mesh = (dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            if trainer.mesh is not None else
            {"pipe": trainer.pipe.n_stages,
             **{g.axis: g.size for g in trainer.groups if g.size > 1}})
    print(
        f"tpufw_torch train_pipeline: process {cluster.process_id}/"
        f"{cluster.num_processes} rank {cluster.rank}/{cluster.world_size} "
        f"device={trainer.device} mesh={mesh} "
        f"stages={trainer.pipe.n_stages} held={list(trainer.group.indices)} "
        f"microbatches={trainer.pipe.n_microbatches} "
        f"schedule={trainer.pipe.schedule} "
        f"bubble={trainer.pipe.bubble_fraction():.1%} "
        f"params={model_cfg.n_params():,}"
        + (f" compile_cache={cache}" if cache else ""),
        flush=True,
    )
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)
    else:
        trainer.init_state(seed=env_int("seed", 0))
    cfg = trainer.cfg
    shard, n_shards = trainer.batch_shard()
    local_bs = check_global_batch(cfg.batch_size, n_shards)
    # A resumed run shuffles afresh; the eval stream keeps the base seed.
    data_seed = resume_data_seed(env_int("data_seed", 0), trainer.step)
    eval_data = None
    if cfg.eval_every:
        def eval_data():
            return synthetic_batches(
                local_bs, cfg.seq_len, model_cfg.vocab_size,
                seed=env_int("data_seed", 0) * 2000 + 2 * shard + 1)

    history = trainer.run(
        synthetic_batches(local_bs, cfg.seq_len, model_cfg.vocab_size,
                          seed=data_seed * 2000 + 2 * shard),
        model_flops_per_token=model_cfg.flops_per_token(cfg.seq_len - 1),
        on_metrics=metrics_printer(_T0),
        eval_data=eval_data,
        on_eval=lambda ev: print(json.dumps(ev), flush=True),
    )
    report_preemption(trainer)
    report_telemetry(trainer)
    print_summary(history)
    if trainer.gang.active:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
