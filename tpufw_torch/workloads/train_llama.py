"""LM training workload: ``python -m tpufw_torch.workloads.train_llama``, on
one GPU or as a gang of processes, one per GPU.

Knobs (the JAX workload's names where the meaning is the same):
``TPUFW_MODEL`` (a ``LLAMA_CONFIGS``, ``MIXTRAL_CONFIGS``, ``GEMMA_CONFIGS``
or ``DEEPSEEK_CONFIGS`` preset, e.g. ``mixtral_8x7b``, ``gemma2_9b``,
``deepseek_mla_bench`` or ``deepseek_moe_tiny``, a train slice such as
``deepseek_v2_lite_train_slice`` or ``llama3_8b_lora_train_slice``, whose
trainer config gives the defaults
of the trainer knobs, or ``llama3_600m_bench``, the default),
``TPUFW_BATCH_SIZE``, ``TPUFW_SEQ_LEN`` (default: the model's
``max_seq_len``), ``TPUFW_TOTAL_STEPS``, ``TPUFW_ATTENTION`` (backend
override), ``TPUFW_MOE_DISPATCH`` (``einsum`` or ``sorted`` for a MoE
config, Mixtral's or DeepSeek's; ignored by the rest), ``TPUFW_LR``, ``TPUFW_WARMUP_STEPS``, ``TPUFW_LOSS_CHUNK_SIZE``
(0 = full logits), ``TPUFW_LOSS_CHUNK_DTYPE``, ``TPUFW_GRAD_ACCUM``,
``TPUFW_ADAM_MU_DTYPE`` (e.g. ``bfloat16``), ``TPUFW_SYNC_EVERY`` (steps
per host sync), ``TPUFW_EVAL_EVERY`` (0 = off) and ``TPUFW_EVAL_BATCHES``
(8), ``TPUFW_SEED``, ``TPUFW_DATA_SEED``, ``TPUFW_LOG_EVERY`` and
``TPUFW_DEVICE`` (default ``cuda``). ``TPUFW_LORA_RANK`` (> 0: LoRA
adapters on every projection and expert stack, the base frozen) and
``TPUFW_LORA_ALPHA`` (16); a family without adapters (DeepSeek) raises.
``llama3_8b_lora_train_slice`` is Llama-3-8B LoRA at all 32 layers.

Weights and state: ``TPUFW_CHECKPOINT_DIR`` (save every
``TPUFW_CHECKPOINT_EVERY`` steps, default 100, and resume from the latest
step at start), ``TPUFW_HANDLE_PREEMPTION`` (on: SIGTERM stops the run
with a forced checkpoint and a ``{"preempted": true, "step": N}`` line)
and ``TPUFW_PREEMPTION_SYNC_EVERY``; ``TPUFW_INIT_FROM`` (bare params to
start from at step 0, when there is no checkpoint to resume; with LoRA, a
rank-0 model's params, the adapters drawn from ``TPUFW_SEED``).

Data: ``TPUFW_DATA_PREFIX`` (a ``tools.pack_corpus`` corpus, read
shuffled by the native packer through ``prefetch_to_device``, depth
``TPUFW_PREFETCH_DEPTH``; a resumed run shuffles with
``resume_data_seed``) or synthetic batches from the even seeds;
``TPUFW_EVAL_DATA_PREFIX`` (a held-out corpus, read in order) or
synthetic eval batches from the odd seeds the train stream never uses.
Step metrics stream to stdout as one JSON line per logged step, and each
held-out evaluation as one more.

Post-training: ``TPUFW_SFT_DATA`` (JSONL conversations, rendered with
``TPUFW_SFT_TEMPLATE``, ``plain`` by default, and encoded by
``TPUFW_SFT_TOKENIZER``, ``bytes`` or a local tokenizer directory; only
assistant tokens train), ``TPUFW_DPO_DATA`` (JSONL preference pairs;
``TPUFW_DPO_BETA``, ``TPUFW_DPO_LABEL_SMOOTHING``; ``TPUFW_BATCH_SIZE``
counts rows, two a pair) or ``TPUFW_DISTILL_TEACHER`` (a preset of any
family with the student's vocab; ``TPUFW_DISTILL_TEACHER_CKPT`` a
bare-params directory of it, else its weights are drawn from
``TPUFW_SEED`` + 1 with a warning; ``TPUFW_DISTILL_TEMPERATURE``,
``TPUFW_DISTILL_ALPHA``). DPO and distillation together raise
``ValueError``. MFU credits DPO's reference forward (4/3 of the 6N count)
and the teacher's forward (a third of its own count).

A gang: ``tpufw``'s cluster environment (``TPUFW_COORDINATOR``,
``TPUFW_NUM_PROCESSES``, ``TPUFW_PROCESS_ID``; a JobSet's; the GKE
worker variables; ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` of a per-GPU
launcher, ``cluster.bootstrap``) starts the process group first: NCCL on
``cuda:<local rank>``, gloo with ``TPUFW_DEVICE=cpu``. The training state
is sharded over the mesh of ``TPUFW_MESH_DATA`` (replicas),
``TPUFW_MESH_FSDP`` (shards; -1, the default, fills),
``TPUFW_MESH_SEQUENCE`` (sequence parallelism), ``TPUFW_MESH_TENSOR``
(Megatron tensor parallelism: heads, MLP widths and the vocabulary
split), ``TPUFW_MESH_EXPERT`` (a MoE model's experts split) and
``TPUFW_MESH_DCN_DATA``; ``TPUFW_BATCH_SIZE`` is the global batch, and
each batch shard (a ``data``, ``fsdp`` coordinate: ``data · fsdp`` of
them) loads its part of it from its shard of the data (the corpus, SFT
conversations, DPO pairs) or from its own synthetic seeds. The
``sequence`` ranks of a batch shard load the same rows and each trains
its chunk of the ``seq_len - 1`` positions, which the sequence size must
divide; attention then runs as ``TPUFW_ATTENTION`` says: ``ring``
(ring-flash on CUDA) or ``ulysses`` exchange K/V along the ring, ``xla``
and ``flash`` gather it. The ``tensor`` and ``expert`` ranks of a batch
shard load the same rows too. ``TPUFW_MESH_TENSOR`` and
``TPUFW_MESH_EXPERT`` compose with ``TPUFW_MESH_SEQUENCE`` (each tensor
shard's heads run their own ring), with ``TPUFW_LORA_RANK`` (the
adapters split with their weights) and with DPO and distillation; axes
that do not fit the world raise ``ValueError``.

Telemetry (``tpufw``'s knobs and files): ``TPUFW_TELEMETRY_DIR``
(events.jsonl, trace.json, goodput.json, programs.json and metrics.prom,
``-p<N>`` names above rank 0), ``TPUFW_METRICS_PORT`` (``/metrics`` and
``/debug/profile``; 0 picks a free port; rank r binds the port plus its
``LOCAL_RANK``), ``TPUFW_STRAGGLER_FACTOR`` (2.0),
``TPUFW_PROFILE_DIR`` with ``TPUFW_PROFILE_START`` (3) and
``TPUFW_PROFILE_STOP`` (6), or ``TPUFW_PROFILE_STEPS=a:b`` (a
``torch.profiler`` trace of those steps), ``TPUFW_HANG_TIMEOUT_S``,
``TPUFW_HANG_ABORT``, ``TPUFW_CRASH_BUNDLE``, ``TPUFW_FLIGHT_RING`` and
``TPUFW_PERF_OBS``; ``TPUFW_COMPILE_CACHE_DIR`` builds (and reuses) the
CUDA kernels in a per-machine subdirectory of that directory.

Run config and tuning (``tpufw``'s knobs): ``TPUFW_CONFIG`` (a YAML of
record, ``configs.loader``, e.g. ``deploy/configs/bench-v5e1.yaml``: its
model preset and overrides, trainer and mesh sections are the base that
every ``TPUFW_*`` knob above overrides); ``TPUFW_AUTOTUNE`` (``off``,
``cached`` or ``search``: ``tpufw_torch.tune`` before the first step),
``TPUFW_AUTOTUNE_BUDGET_S`` (120) and ``TPUFW_AUTOTUNE_STEPS`` (3), the
winners kept under ``TPUFW_TUNE_CACHE_DIR``; ``TPUFW_FLASH_BQ`` /
``TPUFW_FLASH_BKV`` pick the flash kernels' tile build (``ops.flash``).
"""

from __future__ import annotations

import dataclasses
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


def load_config_env():
    """The ``RunConfig`` of ``TPUFW_CONFIG`` (None when unset), refusing a
    vision preset as ``tpufw``'s workloads do."""
    from tpufw_torch.train import TrainerConfig

    path = env_str("config", "")
    if not path:
        return None
    from tpufw_torch.configs.loader import load_run_config

    run = load_run_config(path)
    if not isinstance(run.trainer, TrainerConfig):
        raise ValueError(
            f"{path}: preset {run.model_preset!r} is not an LM config; use "
            "tpufw_torch.workloads.train_resnet for vision runs")
    return run


def autotune_knobs(base) -> dict:
    """``TPUFW_AUTOTUNE``, ``_BUDGET_S`` and ``_STEPS`` over ``base``'s
    (a TrainerConfig), the mode checked."""
    knobs = dict(
        autotune=env_str("autotune", base.autotune),
        autotune_budget_s=env_float("autotune_budget_s",
                                    base.autotune_budget_s),
        autotune_steps=env_int("autotune_steps", base.autotune_steps),
    )
    if knobs["autotune"] not in ("off", "cached", "search"):
        raise ValueError(
            f"TPUFW_AUTOTUNE={knobs['autotune']!r}: expected "
            "off | cached | search")
    return knobs


def build_trainer(cluster=None):
    """(trainer, model_cfg) from the TPUFW_* environment over the YAML of
    ``TPUFW_CONFIG`` when set, on ``cluster``'s local device (default: the
    resolved cluster environment) and sharded over the process group's
    mesh when one is initialized."""
    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.configs import BENCH_CONFIG_NAME, resolve_model_preset
    from tpufw_torch.configs.presets import TRAIN_SLICES
    from tpufw_torch.train import Trainer, TrainerConfig, sharding

    run = load_config_env()
    name = env_str("model", run.model_preset if run else BENCH_CONFIG_NAME)
    # The YAML's own preset keeps its model.overrides.
    model_cfg = (run.model_cfg if run and name == run.model_preset
                 else resolve_model_preset(name))
    backend = env_str("attention", "")
    if backend:
        model_cfg = dataclasses.replace(model_cfg, attention_backend=backend)
    # TPUFW_MOE_DISPATCH: "einsum" or "sorted" for a MoE config, ignored
    # by the rest; "sorted" is refused under an expert-sharded mesh.
    moe_dispatch = env_str("moe_dispatch", "")
    if moe_dispatch and hasattr(model_cfg, "moe_dispatch"):
        model_cfg = dataclasses.replace(model_cfg, moe_dispatch=moe_dispatch)
    mesh_cfg = mesh_from_env(sharding.world_size(),
                             getattr(model_cfg, "moe_dispatch", "einsum"),
                             base=run.mesh if run else None)
    # LoRA: TPUFW_LORA_RANK > 0 adds adapters and freezes the base (with
    # TPUFW_INIT_FROM, the base comes from bare params).
    lora_rank = env_int("lora_rank", getattr(model_cfg, "lora_rank", 0))
    lora_alpha = env_float("lora_alpha",
                           getattr(model_cfg, "lora_alpha", 16.0))
    if not hasattr(model_cfg, "lora_rank"):
        if lora_rank:
            raise NotImplementedError(
                f"TPUFW_LORA_RANK: {type(model_cfg).__name__} does not "
                "implement LoRA adapters (the MLA family is full-fine-tune "
                "only today)")
    elif (lora_rank, lora_alpha) != (model_cfg.lora_rank,
                                     model_cfg.lora_alpha):
        model_cfg = dataclasses.replace(model_cfg, lora_rank=lora_rank,
                                        lora_alpha=lora_alpha)
    if run:
        base = run.trainer
    else:
        # A train slice's own shape and schedule are the defaults.
        dflt = (TRAIN_SLICES[name]()[1] if name in TRAIN_SLICES else
                TrainerConfig(batch_size=8, seq_len=model_cfg.max_seq_len,
                              total_steps=100, warmup_steps=10,
                              loss_chunk_size=512))
        base = TrainerConfig(
            batch_size=dflt.batch_size, seq_len=dflt.seq_len,
            total_steps=dflt.total_steps, warmup_steps=dflt.warmup_steps,
            loss_chunk_size=dflt.loss_chunk_size, log_every=1,
            checkpoint_every=100)
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
    device = local_device(cluster or resolve_cluster_env(),
                          env_str("device", "cuda"))
    # Objective: TPUFW_DPO_DATA (preference pairs) or
    # TPUFW_DISTILL_TEACHER (teacher-student KL), else the LM objective;
    # each replaces the loss, so the two exclude each other.
    dpo_path = env_str("dpo_data", "")
    teacher_name = env_str("distill_teacher", "")
    if dpo_path and teacher_name:
        raise ValueError(
            "TPUFW_DPO_DATA and TPUFW_DISTILL_TEACHER are mutually "
            "exclusive objectives")
    if dpo_path:
        from tpufw_torch.train import DPOConfig, DPOTrainer

        trainer = DPOTrainer(
            model_cfg, trainer_cfg, mesh_cfg, device=device,
            dpo=DPOConfig(beta=env_float("dpo_beta", 0.1),
                          label_smoothing=env_float("dpo_label_smoothing",
                                                    0.0)))
    elif teacher_name:
        from tpufw_torch.train import DistillConfig, DistillTrainer

        trainer = DistillTrainer(
            model_cfg, trainer_cfg, mesh_cfg, device=device,
            distill=DistillConfig(
                temperature=env_float("distill_temperature", 2.0),
                alpha=env_float("distill_alpha", 0.5)))
    else:
        trainer = Trainer(model_cfg, trainer_cfg, mesh_cfg, device=device)
    return trainer, model_cfg


def install_teacher(trainer):
    """The distillation teacher of ``TPUFW_DISTILL_TEACHER`` (any preset
    name ``configs.resolve_model_preset`` takes): from the bare-params
    directory ``TPUFW_DISTILL_TEACHER_CKPT``, or, without one, drawn from
    ``TPUFW_SEED`` + 1 with a warning (good for smoke tests only).
    Returns the teacher's config."""
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.models import model_for_config

    t_name = env_str("distill_teacher", "")
    t_cfg = resolve_model_preset(t_name)
    t_ckpt = env_str("distill_teacher_ckpt", "")
    if t_ckpt:
        trainer.set_teacher_from(t_cfg, t_ckpt)
        print(f"teacher {t_name} restored from {t_ckpt}", flush=True)
    else:
        trainer.set_teacher(model_for_config(
            t_cfg, device=trainer.device, seed=env_int("seed", 0) + 1))
        print(f"WARNING: teacher {t_name} is RANDOM-INIT (no "
              "TPUFW_DISTILL_TEACHER_CKPT): smoke-test only", flush=True)
    return t_cfg


def main() -> int:
    from tpufw_torch.cluster import initialize_cluster
    from tpufw_torch.train import (
        TokenCorpus,
        prefetch_to_device,
        synthetic_batches,
    )
    from tpufw_torch.utils.profiling import enable_compile_cache
    from tpufw_torch.workloads._common import (
        check_global_batch,
        metrics_printer,
        print_summary,
        report_preemption,
        report_telemetry,
        resolve_encode,
        resume_data_seed,
    )

    # Before any kernel build: a warm per-machine cache skips nvcc.
    cache = enable_compile_cache()
    cluster = initialize_cluster(device=env_str("device", "cuda"))
    rank, world = cluster.rank, cluster.world_size
    trainer, model_cfg = build_trainer(cluster)
    mesh = (dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            if trainer.gang else {})
    print(
        f"tpufw_torch train_llama: process {cluster.process_id}/"
        f"{cluster.num_processes} rank {rank}/{world} "
        f"device={trainer.device} mesh={mesh} "
        f"params={model_cfg.n_params():,}"
        + (f" compile_cache={cache}" if cache else ""),
        flush=True,
    )
    from tpufw_torch.train import DistillTrainer, DPOTrainer

    init_from = env_str("init_from", "")
    dpo = isinstance(trainer, DPOTrainer)
    if dpo and init_from:
        # The reference anchors to the ORIGINAL base before a restore,
        # which replaces only the policy and the optimizer state.
        trainer.init_from_params(init_from, seed=env_int("seed", 0))
        print(f"initialized params from {init_from}", flush=True)
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)
    elif trainer.model is None:
        if init_from:
            trainer.init_from_params(init_from, seed=env_int("seed", 0))
            print(f"initialized params from {init_from}", flush=True)
        else:
            trainer.init_state(seed=env_int("seed", 0))
    cfg = trainer.cfg
    flops_per_token = model_cfg.flops_per_token(cfg.seq_len - 1)
    if isinstance(trainer, DistillTrainer):
        # The teacher's forward, 2N_t a token: a third of its 6N count.
        flops_per_token += install_teacher(trainer).flops_per_token(
            cfg.seq_len - 1) / 3.0
    # cfg.batch_size is GLOBAL; each batch shard loads its part of it
    # (the sequence ranks of a shard the same rows).
    shard, n_shards = trainer.batch_shard()
    local_bs = check_global_batch(cfg.batch_size, n_shards)
    # A resumed run shuffles afresh (the restored step folded into the
    # seed); the eval streams keep the base seed.
    data_seed = resume_data_seed(env_int("data_seed", 0), trainer.step)
    data_prefix = env_str("data_prefix", "")
    sft_path = env_str("sft_data", "")
    if dpo:
        from tpufw_torch.train.dpo import dpo_batches

        if local_bs % 2:
            raise ValueError(
                f"DPO local batch {local_bs} must be even (2 rows/pair)")
        # The reference forward adds 2N to the 6N train count.
        flops_per_token *= 4.0 / 3.0
        data = prefetch_to_device(
            dpo_batches(env_str("dpo_data", ""), local_bs // 2, cfg.seq_len,
                        resolve_encode(env_str("sft_tokenizer", "bytes")),
                        template=env_str("sft_template", "plain"),
                        seed=data_seed, shard_id=shard,
                        num_shards=n_shards),
            trainer.device,
        )
    elif sft_path:
        # JSONL conversations, chat-template rendered, assistant-masked.
        from tpufw_torch.train import sft_batches

        data = prefetch_to_device(
            sft_batches(sft_path, local_bs, cfg.seq_len,
                        resolve_encode(env_str("sft_tokenizer", "bytes")),
                        template=env_str("sft_template", "plain"),
                        seed=data_seed, shard_id=shard,
                        num_shards=n_shards),
            trainer.device,
        )
    elif data_prefix:
        data = prefetch_to_device(
            iter(TokenCorpus(data_prefix, local_bs, cfg.seq_len,
                             shuffle=True, seed=data_seed,
                             shard_id=shard, num_shards=n_shards)),
            trainer.device,
        )
    else:
        # Train seeds are even, the held-out stream's odd: no collision
        # for any TPUFW_DATA_SEED or shard.
        data = synthetic_batches(local_bs, cfg.seq_len, model_cfg.vocab_size,
                                 seed=data_seed * 2000 + 2 * shard)
    eval_data = None
    if cfg.eval_every:
        eval_prefix = env_str("eval_data_prefix", "")
        if eval_prefix:
            def eval_data():
                return iter(TokenCorpus(eval_prefix, local_bs, cfg.seq_len,
                                        shard_id=shard,
                                        num_shards=n_shards))
        else:
            def eval_data():
                return synthetic_batches(
                    local_bs, cfg.seq_len, model_cfg.vocab_size,
                    seed=env_int("data_seed", 0) * 2000 + 2 * shard + 1,
                )

    history = trainer.run(
        data,
        model_flops_per_token=flops_per_token,
        on_metrics=metrics_printer(_T0),
        eval_data=eval_data,
        on_eval=lambda ev: print(json.dumps(ev), flush=True),
    )
    if hasattr(data, "close"):
        data.close()  # stops the prefetch thread
    report_preemption(trainer)
    report_telemetry(trainer)
    print_summary(history)
    if trainer.gang:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
