"""Benchmark presets (port of ``tpufw.configs.presets``).

``llama3_600m_bench`` is the JAX package's single-chip bench model: the
Llama-3 architecture at d_model 1536, 14 layers, 12/6 heads of 128, vocab
32768, flash attention, remat on.

``llama3_8b_train_slice`` is the train step that ``chip_smoke.py`` and
``scripts/profile_torch_train.py`` run on one GPU;
``llama3_8b_serve_slice`` is the batch serve run of ``chip_smoke.py``, and
``llama3_8b_lora_train_slice`` Llama-3-8B LoRA at all 32 layers.
``gemma2_9b_train_slice`` and ``gemma2_9b_serve_slice`` are their Gemma-2-9B
counterparts (head dim 256, soft caps, alternating 4096-token windows), and
``deepseek_mla_train_slice`` and ``deepseek_mla_serve_slice`` the
``deepseek_mla_bench`` ones (MLA: flash at qk head dim 192 in training, the
absorbed latent cache in serving), and ``mixtral_8x7b_train_slice`` and
``mixtral_8x7b_serve_slice`` Mixtral-8x7B's (8 experts of 14336, top 2,
flash at head dim 128 in training), and ``deepseek_v2_lite_train_slice``
and ``deepseek_v2_lite_serve_slice`` DeepSeek-V2-Lite's (MLA, 64 routed
experts of 1408 top 6 plus 2 shared, one leading dense layer, yarn rope),
whose config is the port's import of ``DEEPSEEK_V2_LITE_HF``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufw_torch.models.deepseek import DEEPSEEK_CONFIGS, DeepseekConfig
from tpufw_torch.models.gemma import GEMMA_CONFIGS, GemmaConfig
from tpufw_torch.models.llama import LLAMA_CONFIGS, LlamaConfig
from tpufw_torch.models.mixtral import MIXTRAL_CONFIGS, MixtralConfig
from tpufw_torch.train.trainer import TrainerConfig

BENCH_CONFIG_NAME = "llama3_600m_bench"


def resolve_model_preset(name: str):
    """The model config a ``TPUFW_MODEL``-style name picks: the bench
    model, a preset of the four families (``models.PRESETS``), a serve
    slice's config (``SERVE_SLICES``: bf16 weights, its cache length) or a
    train slice's (``TRAIN_SLICES``)."""
    from tpufw_torch.models import PRESETS

    if name == BENCH_CONFIG_NAME:
        return bench_model_config()
    if name in PRESETS:
        return PRESETS[name]
    if name in SERVE_SLICES:
        return SERVE_SLICES[name]()[0]
    if name in TRAIN_SLICES:
        return TRAIN_SLICES[name]()[0]
    raise ValueError(
        f"unknown model {name!r}; choose from "
        f"{[BENCH_CONFIG_NAME, *PRESETS, *SERVE_SLICES, *TRAIN_SLICES]}"
    )


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


def llama3_8b_lora_train_slice(
    n_layers: int = 32, total_steps: int = 6
) -> tuple[LlamaConfig, TrainerConfig]:
    """Llama-3-8B LoRA at all ``n_layers`` = 32 layers: the full model's
    fp32 base (8.03 B parameters, 32.1 GB), frozen, with rank-16 adapters
    (alpha 16) on q/k/v/o and gate/up/down (41.9 M parameters: their
    gradients and AdamW moments are the only training state), flash
    attention, remat; B=2, seq 2048, chunked CE at 512, warm-up 2 steps.
    Full fine-tuning of the same model needs ~128 GB of fp32 weights,
    gradients and moments, hence ``llama3_8b_train_slice``'s 4 layers."""
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama3_8b"], n_layers=n_layers,
                              lora_rank=16, lora_alpha=16.0)
    tcfg = TrainerConfig(batch_size=2, seq_len=2048, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg


SERVE_PROMPT_LENS = (7, 64, 200, 511)


def llama3_8b_serve_slice(
    seed: int = 0,
) -> tuple[LlamaConfig, list[list[int]], int]:
    """(decode config, prompts, max_new_tokens) of the serve run:
    Llama-3-8B at full width and all 32 layers, bf16 weights, a KV cache
    of 2048 slots per row (a serving budget, not a width), and 4 prompts
    of 7, 64, 200 and 511 token ids drawn from a numpy ``seed``, each
    continued by 32 greedy tokens."""
    cfg = dataclasses.replace(
        LLAMA_CONFIGS["llama3_8b"], param_dtype=torch.bfloat16,
        max_seq_len=2048,
    ).decode_config()
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, n).tolist() for n in SERVE_PROMPT_LENS
    ]
    return cfg, prompts, 32


def gemma2_9b_train_slice(
    n_layers: int = 4, total_steps: int = 5
) -> tuple[GemmaConfig, TrainerConfig]:
    """Gemma-2-9B widths (d_model 3584, 16/8 heads of 256, d_ff 14336,
    vocab 256000, tied embeddings, soft caps 50/30, window 4096 on even
    layers, flash attention, remat) with depth cut to ``n_layers`` (even:
    local/global pairs); B=1, seq 8192 (Gemma-2's context, the only length
    at which the 4096 window masks anything), chunked CE at 512 with the
    final cap, warm-up 2 steps."""
    cfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_9b"], n_layers=n_layers)
    tcfg = TrainerConfig(batch_size=1, seq_len=8192, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg


def gemma2_9b_serve_slice(
    seed: int = 0,
) -> tuple[GemmaConfig, list[list[int]], int]:
    """(decode config, prompts, max_new_tokens) of the Gemma-2-9B serve
    run: full width and all 42 layers, bf16 weights drawn in bf16 (no fp32
    copy), a 2048-slot KV cache per row, and the Llama serve slice's 4
    prompts of 7, 64, 200 and 511 ids (numpy ``seed``), 32 greedy tokens
    each."""
    cfg = dataclasses.replace(
        GEMMA_CONFIGS["gemma2_9b"], param_dtype=torch.bfloat16,
        max_seq_len=2048,
    ).decode_config()
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, n).tolist() for n in SERVE_PROMPT_LENS
    ]
    return cfg, prompts, 32


def deepseek_mla_train_slice(
    n_layers: int = 10, total_steps: int = 5
) -> tuple[DeepseekConfig, TrainerConfig]:
    """``deepseek_mla_bench`` (V2-Lite's attention at full width: d_model
    2048, 16 heads, kv_lora_rank 512, head dims 128/64/128; a dense SwiGLU
    FFN of 6144, vocab 32768; flash at qk head dim 192 with V zero-padded,
    remat) at all ``n_layers`` = 10 layers; B=8, seq 2048, chunked CE at
    512, warm-up 2 steps (``scripts/mla_flash_probe.py``'s B=8 shape)."""
    cfg = dataclasses.replace(
        DEEPSEEK_CONFIGS["deepseek_mla_bench"], n_layers=n_layers
    )
    tcfg = TrainerConfig(batch_size=8, seq_len=2048, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg


def deepseek_mla_serve_slice(
    seed: int = 0,
) -> tuple[DeepseekConfig, list[list[int]], int]:
    """(decode config, prompts, max_new_tokens) of the MLA serve run:
    ``deepseek_mla_bench`` at all 10 layers, bf16 weights drawn in bf16, a
    latent cache of 256 slots per row, and 8 prompts of 128 ids drawn from
    a numpy ``seed``, each continued by 128 greedy tokens (the shapes of
    ``bench.py``'s MLA decode tier)."""
    cfg = dataclasses.replace(
        DEEPSEEK_CONFIGS["deepseek_mla_bench"], param_dtype=torch.bfloat16,
        max_seq_len=256,
    ).decode_config()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, 128).tolist() for _ in range(8)]
    return cfg, prompts, 128


def mixtral_8x7b_train_slice(
    n_layers: int = 2, total_steps: int = 5
) -> tuple[MixtralConfig, TrainerConfig]:
    """Mixtral-8x7B widths (d_model 4096, 32/8 heads of 128, 8 experts of
    d_ff 14336, top 2, capacity factor 1.25, vocab 32000, flash attention,
    remat) with depth cut to ``n_layers`` (32 layers of fp32 weights, grads
    and AdamW moments are ~750 GB; 2 are 50.6 GB); B=2, seq 2048, chunked
    CE at 512, warm-up 2 steps."""
    cfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral_8x7b"],
                              n_layers=n_layers)
    tcfg = TrainerConfig(batch_size=2, seq_len=2048, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg


def mixtral_8x7b_serve_slice(
    seed: int = 0, n_layers: int = 16,
) -> tuple[MixtralConfig, list[list[int]], int]:
    """(decode config, prompts, max_new_tokens) of the Mixtral serve run:
    full width at ``n_layers`` of 32 layers (all 32 in bf16 are 93.4 GB;
    16 are 46.96 GB), bf16 weights drawn in bf16, a 2048-slot KV cache per
    row, the Llama serve slice's 4 prompts of 7, 64, 200 and 511 ids
    (numpy ``seed``), 32 greedy tokens each, and capacity factor 8.0 = E:
    dropless, as ``tools.import_hf`` gives every imported Mixtral, so it is
    what users serve."""
    cfg = dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_8x7b"], n_layers=n_layers,
        param_dtype=torch.bfloat16, max_seq_len=2048, capacity_factor=8.0,
    ).decode_config()
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, n).tolist() for n in SERVE_PROMPT_LENS
    ]
    return cfg, prompts, 32




# DeepSeek-V2-Lite's published config.json (HF deepseek-ai/DeepSeek-V2-Lite),
# the fields an import reads. ``deepseek_v2_lite()`` is the port's
# ``config_from_hf`` of it: what importing that checkpoint gives.
DEEPSEEK_V2_LITE_HF = {
    "model_type": "deepseek_v2",
    "architectures": ["DeepseekV2ForCausalLM"],
    "vocab_size": 102_400,
    "hidden_size": 2048,
    "intermediate_size": 10_944,
    "moe_intermediate_size": 1408,
    "num_hidden_layers": 27,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "n_shared_experts": 2,
    "n_routed_experts": 64,
    "num_experts_per_tok": 6,
    "routed_scaling_factor": 1.0,
    "topk_method": "greedy",
    "n_group": 1,
    "topk_group": 1,
    "scoring_func": "softmax",
    "norm_topk_prob": False,
    "moe_layer_freq": 1,
    "first_k_dense_replace": 1,
    "q_lora_rank": None,
    "kv_lora_rank": 512,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "v_head_dim": 128,
    "hidden_act": "silu",
    "max_position_embeddings": 163_840,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10_000,
    "rope_scaling": {
        "type": "yarn",
        "factor": 40,
        "original_max_position_embeddings": 4096,
        "beta_fast": 32,
        "beta_slow": 1,
        "mscale": 0.707,
        "mscale_all_dim": 0.707,
    },
    "attention_bias": False,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}


def deepseek_v2_lite() -> DeepseekConfig:
    """DeepSeek-V2-Lite as an import of its config gives it: 27 layers
    (layer 0 dense), dropless routing (capacity factor = 64 experts),
    unscanned, max_seq_len 163840, 15,706,484,224 parameters."""
    from tpufw_torch.tools.import_hf import config_from_hf

    return config_from_hf(DEEPSEEK_V2_LITE_HF)


def deepseek_v2_lite_train_slice(
    n_layers: int = 3, total_steps: int = 5
) -> tuple[DeepseekConfig, TrainerConfig]:
    """DeepSeek-V2-Lite at full width with depth cut to ``n_layers``
    (layer 0 dense, the rest MoE; 27 layers of fp32 weights, grads and
    AdamW moments are ~251 GB, 3 are ~26.7 GB: 1,670,135,296 parameters),
    flash at qk head dim 192, capacity factor 1.25 (the training
    discipline; an import is dropless), remat; B=2, seq 2048, chunked CE
    at 512, warm-up 2 steps."""
    cfg = dataclasses.replace(
        deepseek_v2_lite(), n_layers=n_layers, attention_backend="flash",
        capacity_factor=1.25,
    )
    tcfg = TrainerConfig(batch_size=2, seq_len=2048, total_steps=total_steps,
                         warmup_steps=2, log_every=1, loss_chunk_size=512)
    return cfg, tcfg


def deepseek_v2_lite_serve_slice(
    seed: int = 0, n_layers: int = 27,
) -> tuple[DeepseekConfig, list[list[int]], int]:
    """(decode config, prompts, max_new_tokens) of the DeepSeek-V2-Lite
    serve run: all ``n_layers`` = 27 layers, bf16 weights drawn in bf16
    (31.4 GB),
    dropless as imported, the Llama serve slice's 4 prompts of 7, 64, 200
    and 511 ids (numpy ``seed``), 32 greedy tokens each. ``max_seq_len``
    is cut from the imported 163840 to 4096, yarn's original length: the
    paged pools size every row by it, and at 163840 one row's latent
    arena is 27 x 163840 x 1152 B = 5.1 GB. The rope scaling stays as
    published."""
    cfg = dataclasses.replace(
        deepseek_v2_lite(), param_dtype=torch.bfloat16, max_seq_len=4096,
        n_layers=n_layers,
    ).decode_config()
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, n).tolist() for n in SERVE_PROMPT_LENS
    ]
    return cfg, prompts, 32


# Serve slices a ``TPUFW_MODEL`` name may pick, so an entry point (a
# disaggregated replica) serves the weights the smoke test draws in
# process.
SERVE_SLICES = {"llama3_8b_serve_slice": llama3_8b_serve_slice,
                "mixtral_8x7b_serve_slice": mixtral_8x7b_serve_slice,
                "deepseek_v2_lite_serve_slice": deepseek_v2_lite_serve_slice}
# Train slices a ``TPUFW_MODEL`` name may pick: the train workload takes
# the slice's trainer config as its defaults.
TRAIN_SLICES = {"deepseek_v2_lite_train_slice": deepseek_v2_lite_train_slice,
                "llama3_8b_lora_train_slice": llama3_8b_lora_train_slice}
