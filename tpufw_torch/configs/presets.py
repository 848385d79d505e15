"""Benchmark presets (port of ``tpufw.configs.presets``).

``llama3_600m_bench`` is the JAX package's single-chip bench model: the
Llama-3 architecture at d_model 1536, 14 layers, 12/6 heads of 128, vocab
32768, flash attention, remat on.

``llama3_8b_train_slice`` is the train step that ``chip_smoke.py`` and
``scripts/profile_torch_train.py`` run on one GPU.
"""

from __future__ import annotations

import dataclasses

import torch

from tpufw_torch.models.llama import LLAMA_CONFIGS, LlamaConfig
from tpufw_torch.train.trainer import TrainerConfig

BENCH_CONFIG_NAME = "llama3_600m_bench"


def bench_model_config() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32_768,
        d_model=1536,
        n_layers=14,
        n_heads=12,
        n_kv_heads=6,
        head_dim=128,
        d_ff=6144,
        max_seq_len=2048,
        dtype=torch.bfloat16,
        param_dtype=torch.float32,
        attention_backend="flash",
        remat=True,
    )


def llama3_8b_train_slice(
    n_layers: int = 4, total_steps: int = 5
) -> tuple[LlamaConfig, TrainerConfig]:
    """Llama-3-8B widths (d_model 4096, 32/8 heads of 128, d_ff 14336,
    vocab 128256, flash attention, remat) with depth cut to ``n_layers``;
    B=2, seq 2048, chunked CE at 512, warm-up 2 steps."""
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_8b"], n_layers=n_layers)
    tcfg = TrainerConfig(batch_size=2, seq_len=2048, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg
