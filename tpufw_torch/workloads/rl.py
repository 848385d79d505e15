"""GRPO RL fine-tuning workload: ``python -m tpufw_torch.workloads.rl``
(port of ``tpufw.workloads.rl``): rollout, reward, update, one JSON line
a step (reward_mean, clip_frac, kl, loss, and the rollout and update
seconds). On one GPU, or as a gang of one host's GPUs, one process per
GPU (a per-GPU launcher's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, one
process in ``tpufw``'s count): every rank rolls out the whole global
batch and trains its batch shard's rows, sharded over the mesh.

Knobs (``TPUFW_*``):
  MODEL (a ``LLAMA_CONFIGS`` preset, default ``llama3_tiny``) /
  INIT_FROM (bare params to start from) / SEED / DEVICE (default ``cuda``)
  PROMPTS_FILE   JSONL: {"prompt": <text>} or a bare token-id list a line
                 (default: two built-in demo prompts)
  SFT_TOKENIZER  "bytes" (default) or a local tokenizer directory, for
                 text prompts
  REWARD         "low_token" (the share of ids < vocab/2), "length"
                 (completion length / max_new) or "pkg.mod:fn", a custom
                 fn(prompts, completions) -> [N]
  GRPO_GROUP / GRPO_CLIP / GRPO_KL_BETA / GRPO_TEMPERATURE /
  GRPO_MAX_NEW / EOS_ID (-1: none)        the ``GRPOConfig`` knobs
  BATCH_SIZE / SEQ_LEN / TOTAL_STEPS / LR / WARMUP_STEPS /
  LOSS_CHUNK_SIZE / CHECKPOINT_DIR / CHECKPOINT_EVERY   the trainer's
  MESH_DATA / MESH_FSDP (-1: fill) / MESH_TENSOR   the mesh, as
                 ``tpufw``'s; TENSOR above 1 splits the heads, MLP widths
                 and vocabulary over that many ranks of the gang
More than one host (``num_processes`` > 1) raises, as in ``tpufw``.
"""

from __future__ import annotations

import json
import time

from tpufw_torch.workloads.env import (
    batch_mesh_from_env,
    env_float,
    env_int,
    env_str,
)

_T0 = time.time()

_DEMO_PROMPTS = [[7, 8, 9, 10], [11, 12, 13]]


def load_prompts(path: str, encode) -> list[list[int]]:
    """JSONL prompts: {"prompt": <text>} rows are encoded; bare lists
    pass through as token ids."""
    prompts: list[list[int]] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if isinstance(obj, dict) and "prompt" in obj:
                prompts.append(encode(obj["prompt"]))
            elif isinstance(obj, list) and all(isinstance(t, int)
                                               for t in obj):
                prompts.append(obj)
            else:
                raise ValueError(
                    f"{path}:{ln}: expected {{'prompt': text}} or a "
                    "token-id list")
    if not prompts:
        raise ValueError(f"{path}: no prompts")
    return prompts


def resolve_reward(spec: str, vocab_size: int, max_new: int):
    """The built-in demo rewards or an importable ``pkg.mod:fn``."""
    import numpy as np

    if spec == "low_token":
        half = vocab_size // 2

        def low_token(prompts, completions):
            return np.array([np.mean([t < half for t in c]) if c else 0.0
                             for c in completions])

        return low_token
    if spec == "length":

        def length(prompts, completions):
            return np.array([len(c) / max_new for c in completions],
                            np.float32)

        return length
    if ":" in spec:
        import importlib

        mod_name, fn_name = spec.split(":", 1)
        fn = getattr(importlib.import_module(mod_name), fn_name)
        if not callable(fn):
            raise TypeError(f"{spec} is not callable")
        return fn
    raise ValueError(
        f"TPUFW_REWARD={spec!r}: expected 'low_token', 'length', or an "
        "importable 'pkg.mod:fn'")


def build_trainer(cluster=None):
    """(trainer, model_cfg) for the RL loop from the TPUFW_* env, on
    ``cluster``'s local device (default: the resolved cluster
    environment) and sharded over the process group's mesh when one is
    initialized."""
    from tpufw_torch.cluster import local_device, resolve_cluster_env
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.train import TrainerConfig
    from tpufw_torch.train.grpo import GRPOConfig, GRPOTrainer

    mesh_cfg = batch_mesh_from_env()
    name = env_str("model", "llama3_tiny")
    if name not in LLAMA_CONFIGS:
        raise ValueError(
            f"unknown TPUFW_MODEL={name!r}; RL workload presets: "
            f"{sorted(LLAMA_CONFIGS)}")
    model_cfg = LLAMA_CONFIGS[name]
    eos = env_int("eos_id", -1)  # -1: none (0 is an EOS id in some vocabs)
    grpo = GRPOConfig(
        group_size=env_int("grpo_group", 8),
        clip_eps=env_float("grpo_clip", 0.2),
        kl_beta=env_float("grpo_kl_beta", 0.02),
        temperature=env_float("grpo_temperature", 1.0),
        max_new_tokens=env_int("grpo_max_new", 64),
        eos_id=None if eos < 0 else eos,
    )
    trainer_cfg = TrainerConfig(
        batch_size=env_int("batch_size", 16),
        seq_len=env_int("seq_len", min(512, model_cfg.max_seq_len)),
        total_steps=env_int("total_steps", 50),
        lr=env_float("lr", 1e-5),
        warmup_steps=env_int("warmup_steps", 5),
        loss_chunk_size=env_int("loss_chunk_size", 512) or None,
        checkpoint_dir=env_str("checkpoint_dir", "") or None,
        checkpoint_every=env_int("checkpoint_every", 100),
        log_every=1,
    )
    device = local_device(cluster or resolve_cluster_env(),
                          env_str("device", "cuda"))
    trainer = GRPOTrainer(model_cfg, trainer_cfg, mesh_cfg, device=device,
                          grpo=grpo)
    return trainer, model_cfg


def main() -> int:
    from tpufw_torch.cluster import initialize_cluster, resolve_cluster_env
    from tpufw_torch.utils.profiling import enable_compile_cache
    from tpufw_torch.workloads._common import report_preemption, resolve_encode

    cache = enable_compile_cache()
    cluster = resolve_cluster_env()
    if cluster.num_processes > 1:
        raise NotImplementedError(
            "the RL workload is single-process for now: rollouts are "
            "host-driven; shard prompts across independent Jobs instead"
        )
    cluster = initialize_cluster(cluster, device=env_str("device", "cuda"))
    trainer, model_cfg = build_trainer(cluster)
    mesh = (dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape))
            if trainer.gang else {})
    print(f"tpufw_torch rl: rank {cluster.rank}/{cluster.world_size} "
          f"device={trainer.device} mesh={mesh} "
          f"params={model_cfg.n_params():,}"
          + (f" compile_cache={cache}" if cache else ""), flush=True)
    seed = env_int("seed", 0)
    init_from = env_str("init_from", "")
    if init_from:
        # Base first (the step-0 KL reference), then the resume.
        trainer.init_from_params(init_from, seed=seed)
        print(f"initialized params from {init_from}", flush=True)
    else:
        trainer.init_state(seed=seed)
    if trainer.maybe_restore():
        print(f"resumed from checkpoint at step {trainer.step}", flush=True)

    prompts_file = env_str("prompts_file", "")
    if prompts_file:
        prompts = load_prompts(
            prompts_file, resolve_encode(env_str("sft_tokenizer", "bytes")))
    else:
        prompts = _DEMO_PROMPTS
        print("no TPUFW_PROMPTS_FILE: using built-in demo prompts",
              flush=True)
    per_step = trainer.cfg.batch_size // trainer.grpo.group_size
    if len(prompts) < per_step:
        raise ValueError(
            f"{len(prompts)} prompts < {per_step} needed per step "
            f"(batch_size {trainer.cfg.batch_size} / group "
            f"{trainer.grpo.group_size})")
    reward_fn = resolve_reward(env_str("reward", "low_token"),
                               model_cfg.vocab_size,
                               trainer.grpo.max_new_tokens)
    first: dict = {}

    def on_metrics(entry: dict) -> None:
        if not first:
            first["t"] = time.time()
            print(json.dumps({"cold_start_to_first_step_s":
                              round(first["t"] - _T0, 1),
                              "compile_cache": cache or None}), flush=True)
        print(json.dumps(entry), flush=True)

    # Each step takes a contiguous (wrapping) window of the prompt set.
    def window(i: int):
        return [prompts[(i * per_step + j) % len(prompts)]
                for j in range(per_step)]

    history = trainer.run_rl(window, reward_fn, seed=seed,
                             on_metrics=on_metrics)
    report_preemption(trainer)
    if history:
        last = history[-1]
        print(f"RL OK: {len(history)} steps, reward_mean "
              f"{last['reward_mean']:.4f}, kl {last['kl']:.4f}", flush=True)
    if trainer.gang:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
