"""LM training workload on one GPU: ``python -m tpufw_torch.workloads.train_llama``.

Knobs (the JAX workload's names where the meaning is the same):
``TPUFW_MODEL`` (a ``LLAMA_CONFIGS``, ``GEMMA_CONFIGS`` or
``DEEPSEEK_CONFIGS`` preset, e.g. ``gemma2_9b`` or ``deepseek_mla_bench``, or
``llama3_600m_bench``, the default), ``TPUFW_BATCH_SIZE``, ``TPUFW_SEQ_LEN`` (default: the model's
``max_seq_len``), ``TPUFW_TOTAL_STEPS``, ``TPUFW_ATTENTION`` (backend
override), ``TPUFW_LR``, ``TPUFW_WARMUP_STEPS``, ``TPUFW_LOSS_CHUNK_SIZE``
(0 = full logits), ``TPUFW_LOSS_CHUNK_DTYPE``, ``TPUFW_GRAD_ACCUM``,
``TPUFW_ADAM_MU_DTYPE`` (e.g. ``bfloat16``), ``TPUFW_SYNC_EVERY`` (steps
per host sync), ``TPUFW_EVAL_EVERY`` (0 = off) and ``TPUFW_EVAL_BATCHES``
(8), ``TPUFW_SEED``, ``TPUFW_DATA_SEED``, ``TPUFW_LOG_EVERY`` and
``TPUFW_DEVICE`` (default ``cuda``). Step metrics stream to stdout as one
JSON line per logged step, and each held-out evaluation as one more; the
eval batches are synthetic, from the odd seeds the train stream never
uses.
"""

from __future__ import annotations

import dataclasses
import json
import time

from tpufw_torch.workloads.env import env_float, env_int, env_str

_T0 = time.time()


def build_trainer():
    """(trainer, model_cfg) from the TPUFW_* environment."""
    from tpufw_torch.configs import BENCH_CONFIG_NAME, bench_model_config
    from tpufw_torch.models import PRESETS
    from tpufw_torch.train import Trainer, TrainerConfig

    name = env_str("model", BENCH_CONFIG_NAME)
    if name == BENCH_CONFIG_NAME:
        model_cfg = bench_model_config()
    elif name in PRESETS:
        model_cfg = PRESETS[name]
    else:
        raise ValueError(
            f"unknown TPUFW_MODEL={name!r}; choose from "
            f"{[BENCH_CONFIG_NAME, *PRESETS]}"
        )
    backend = env_str("attention", "")
    if backend:
        model_cfg = dataclasses.replace(model_cfg, attention_backend=backend)
    trainer_cfg = TrainerConfig(
        batch_size=env_int("batch_size", 8),
        seq_len=env_int("seq_len", model_cfg.max_seq_len),
        total_steps=env_int("total_steps", 100),
        lr=env_float("lr", 3e-4),
        warmup_steps=env_int("warmup_steps", 10),
        log_every=env_int("log_every", 1),
        loss_chunk_size=env_int("loss_chunk_size", 512) or None,
        loss_chunk_dtype=env_str("loss_chunk_dtype", "bfloat16"),
        grad_accum=env_int("grad_accum", 1),
        eval_every=env_int("eval_every", 0),
        eval_batches=env_int("eval_batches", 8),
        adam_mu_dtype=env_str("adam_mu_dtype", "") or None,
        sync_every=env_int("sync_every", 1),
    )
    device = env_str("device", "cuda")
    return Trainer(model_cfg, trainer_cfg, device=device), model_cfg


def main() -> int:
    from tpufw_torch.train import synthetic_batches

    trainer, model_cfg = build_trainer()
    trainer.init_state(seed=env_int("seed", 0))
    cfg = trainer.cfg
    print(
        f"tpufw_torch train_llama: device={trainer.device} "
        f"params={model_cfg.n_params():,}",
        flush=True,
    )
    # Train seeds are even, the held-out stream's odd: no collision for
    # any TPUFW_DATA_SEED.
    data = synthetic_batches(
        cfg.batch_size, cfg.seq_len, model_cfg.vocab_size,
        seed=env_int("data_seed", 0) * 2000,
    )

    def eval_data():
        return synthetic_batches(
            cfg.batch_size, cfg.seq_len, model_cfg.vocab_size,
            seed=env_int("data_seed", 0) * 2000 + 1,
        )
    first: dict = {}

    def on_metrics(m):
        if not first:
            first["t"] = time.time()
            print(json.dumps(
                {"cold_start_to_first_step_s": round(first["t"] - _T0, 1)}
            ), flush=True)
        print(json.dumps(m.as_dict()), flush=True)

    history = trainer.run(
        data,
        model_flops_per_token=model_cfg.flops_per_token(cfg.seq_len - 1),
        on_metrics=on_metrics,
        eval_data=eval_data if cfg.eval_every else None,
        on_eval=lambda ev: print(json.dumps(ev), flush=True),
    )
    if history:
        last = history[-1]
        print(
            f"TRAIN OK: {len(history)} steps, final loss {last.loss:.4f}, "
            f"{last.tokens_per_sec_per_gpu:.0f} tok/s/GPU, "
            f"MFU {last.mfu:.1%}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
