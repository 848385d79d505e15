"""Gemma-2 family in PyTorch (port of ``tpufw.models.gemma``).

The trunk is ``tpufw_torch.models.llama``'s; only the block and a few
configuration knobs differ, read by the trunk with ``getattr`` as in the
JAX package:

- sandwich norms: pre AND post RMSNorm around both attention and MLP, all
  in the (1 + w) offset parameterization (zeros-init weights), the final
  norm too (``rms_offset``);
- GeGLU MLP (tanh-approximate gelu gate, ``mlp_activation``);
- tied embeddings drawn at std d^-0.5 and scaled by sqrt(d_model) at
  lookup (``embed_scale``);
- attention logit soft cap (50) in every attention path, inside the flash
  kernels when training; final logit soft cap (30) on the logits, or per
  chunk in the chunked-vocab loss (``Trainer`` passes it there);
- alternating local/global attention: even layers (layer 0 first) attend
  within ``sliding_window``, odd layers globally, so ``n_layers`` must be
  even. The JAX package scans (local, global) pairs; here the blocks are
  one ``nn.ModuleList`` in the same order, and
  ``tpufw_torch.interop.params_from_flax`` unstacks the pairs;
- q scaled by query_pre_attn_scalar**-0.5 instead of head_dim**-0.5 (the
  two agree for 2b and 9b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tpufw_torch.models.llama import MLP, Attention, Llama, RMSNorm
from tpufw_torch.ops.attention import tanh_soft_cap


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256_000
    d_model: int = 2304
    n_layers: int = 26
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 256
    d_ff: int = 9216
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    max_seq_len: int = 8192
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_backend: str = "xla"
    # Checkpoint each block in training, keeping what remat_policy names
    # (tpufw_torch.models.llama.REMAT_POLICIES).
    remat: bool = True
    remat_policy: str = "dots"
    decode: bool = False
    # Gemma-2 specifics (read by the shared trunk via getattr).
    attn_logit_soft_cap: Optional[float] = 50.0
    final_logit_soft_cap: Optional[float] = 30.0
    sliding_window: Optional[int] = 4096
    query_pre_attn_scalar: Optional[float] = 256.0
    mlp_activation: str = "gelu_tanh"
    embed_scale: bool = True
    rms_offset: bool = True
    # LoRA adapters on every projection, through the shared trunk's
    # Projection (0 = off).
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # Int8 projection weights + fp32 per-output-channel scales (serving;
    # the tied embedding stays in floating point).
    quantized_weights: bool = False

    def decode_config(self) -> "GemmaConfig":
        """Inference dress: KV cache on, remat off, plain attention."""
        return dataclasses.replace(
            self, decode=True, remat=False, attention_backend="xla"
        )

    def n_params(self, include_embed: bool = True) -> int:
        d, l = self.d_model, self.n_layers
        attn = l * (
            d * self.n_heads * self.head_dim
            + 2 * d * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * d
        )
        mlp = l * 3 * d * self.d_ff
        norms = (4 * l + 1) * d  # sandwich: 4 norms per layer + final
        total = attn + mlp + norms
        if include_embed:
            total += self.vocab_size * d  # head tied
            if not self.tie_embeddings:
                total += d * self.vocab_size
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token: 6*N_matmul plus the attention scores,
        with the local layers' keys capped at the window."""
        d, l = self.d_model, self.n_layers
        n_matmul = (
            l
            * (
                d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d
                + 3 * d * self.d_ff
            )
            + d * self.vocab_size
        )
        # Global layers see the causal triangle (~seq/2 keys per query),
        # local layers at most the window; half the layers each.
        global_keys = seq_len / 2
        local_keys = min(float(self.sliding_window or seq_len), seq_len / 2)
        attn_score = (
            6.0 * self.n_heads * self.head_dim * (l / 2) * 2.0
            * (global_keys + local_keys)
        )
        return 6.0 * n_matmul + attn_score


class GemmaBlock(nn.Module):
    """One Gemma-2 block: sandwich-normed attention + GeGLU MLP, attending
    within ``window`` keys (None: globally)."""

    def __init__(self, cfg: GemmaConfig, gen, window=None, device=None):
        super().__init__()
        d, eps = cfg.d_model, cfg.rms_eps
        self.pre_attn_norm = RMSNorm(d, eps, device, offset=True)
        self.attn = Attention(cfg, gen, window, device)
        self.post_attn_norm = RMSNorm(d, eps, device, offset=True)
        self.pre_mlp_norm = RMSNorm(d, eps, device, offset=True)
        self.mlp = MLP(cfg, gen, device)
        self.post_mlp_norm = RMSNorm(d, eps, device, offset=True)

    def attend(self, x, positions, segment_ids=None, cache=None):
        return self.attn(self.pre_attn_norm(x), positions, segment_ids,
                         cache)

    def merge(self, x, a, segment_ids=None):
        x = x + self.post_attn_norm(a)
        m = self.mlp(self.pre_mlp_norm(x))
        return x + self.post_mlp_norm(m)

    def forward(self, x, positions, segment_ids=None, cache=None):
        return self.merge(x, self.attend(x, positions, segment_ids, cache),
                          segment_ids)


class Gemma(Llama):
    """Decoder-only Gemma-2 LM: ``Llama``'s trunk (embedding, caches,
    decode, chunked-loss hidden states) over ``GemmaBlock`` layers, local
    then global, with the final soft cap on the logits (not on
    ``return_hidden``'s hidden states)."""

    def __init__(self, cfg: GemmaConfig, device=None, seed: int = 0):
        if cfg.n_layers % 2:
            raise ValueError(
                f"Gemma-2 alternates local/global layers; n_layers must be "
                f"even, got {cfg.n_layers}"
            )
        super().__init__(cfg, device=device, seed=seed)

    @staticmethod
    def _block(cfg, gen, device, index: int) -> nn.Module:
        window = cfg.sliding_window if index % 2 == 0 else None
        return GemmaBlock(cfg, gen, window, device)

    def forward(
        self, tokens, positions=None, segment_ids=None, return_hidden=False,
        cache=None,
    ):
        out = super().forward(
            tokens, positions, segment_ids, return_hidden, cache
        )
        cap = self.cfg.final_logit_soft_cap
        if cap is not None and not return_hidden:
            out = tanh_soft_cap(out, cap)
        return out


GEMMA_CONFIGS: dict[str, GemmaConfig] = {
    # 2.6B: the HF google/gemma-2-2b shape
    "gemma2_2b": GemmaConfig(attention_backend="flash"),
    # 9.2B: the HF google/gemma-2-9b shape
    "gemma2_9b": GemmaConfig(
        d_model=3584,
        n_layers=42,
        n_heads=16,
        n_kv_heads=8,
        d_ff=14_336,
        attention_backend="flash",
    ),
    "gemma2_tiny": GemmaConfig(
        vocab_size=256,
        d_model=64,
        n_layers=4,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        max_seq_len=128,
        sliding_window=32,
        query_pre_attn_scalar=16.0,
        attn_logit_soft_cap=50.0,
        final_logit_soft_cap=30.0,
        remat=False,
    ),
}
