"""Llama-3 model family in PyTorch (port of ``tpufw.models.llama``).

Same numerics as the JAX model: activations in ``cfg.dtype`` (bf16), fp32
master weights cast to ``cfg.dtype`` at every projection, RMSNorm and
RoPE in fp32, the untied LM head in fp32. Each block is recomputed in the
backward pass under ``cfg.remat`` (``torch.utils.checkpoint``).
Attention goes through ``tpufw_torch.ops.multi_head_attention``, so the
CUDA flash kernels drop in with ``attention_backend="flash"``.

Parameter layout is PyTorch's: a projection's weight is [out, in].
``tpufw_torch.interop.params_from_flax`` converts a Flax param tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpufw_torch.ops import multi_head_attention, rms_norm
from tpufw_torch.utils.hardware import resolve_device


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Rotary frequency transform, by ``rope_type``: ``"llama3"`` (HF
    ``_compute_llama3_parameters``) or ``"linear"`` (every frequency
    divided by ``factor``)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_backend: str = "xla"
    # Recompute each block in backward (the JAX "nothing" remat policy:
    # only the block inputs are kept).
    remat: bool = True
    # False = bidirectional attention.
    causal: bool = True
    # Mistral-style local attention on every layer (None = global).
    sliding_window: Optional[int] = None
    # Qwen-2 style biases on the q/k/v projections.
    attention_qkv_bias: bool = False
    # Not ported yet (ROADMAP.md Queue 1 items 7, 8, 10); must stay off.
    decode: bool = False
    quantized_weights: bool = False
    kv_page: int = 0
    lora_rank: int = 0

    def n_params(self, include_embed: bool = True) -> int:
        """Analytic parameter count (exact for this architecture)."""
        d, l = self.d_model, self.n_layers
        attn = l * (
            d * self.n_heads * self.head_dim
            + 2 * d * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * d
        )
        if self.attention_qkv_bias:
            attn += l * (
                self.n_heads * self.head_dim
                + 2 * self.n_kv_heads * self.head_dim
            )
        mlp = l * 3 * d * self.d_ff
        norms = (2 * l + 1) * d
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else d * self.vocab_size
        total = attn + mlp + norms
        if include_embed:
            total += embed + head
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token: 6*N_matmul + 6*L*d_model*T (causal)."""
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
        return 6.0 * n_matmul + self._attn_score_flops(seq_len)

    def _attn_score_flops(self, seq_len: int) -> float:
        """QK^T/AV score FLOPs per token, fwd+bwd (x3), both matmuls (x2),
        seq/2 keys per query (causal), capped at the sliding window."""
        keys = seq_len / 2
        if self.sliding_window is not None:
            keys = min(float(self.sliding_window), keys)
        return (
            6.0 * self.n_layers * self.n_heads * self.head_dim
            * 2.0 * keys
        )


LLAMA_CONFIGS: dict[str, LlamaConfig] = {
    "llama3_8b": LlamaConfig(attention_backend="flash"),
    "llama31_8b": LlamaConfig(
        max_seq_len=131_072,
        rope_scaling=RopeScaling(),
        attention_backend="flash",
    ),
    "llama3_1b_proxy": LlamaConfig(
        vocab_size=32_768,
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        max_seq_len=4096,
        attention_backend="flash",
    ),
    "llama3_tiny": LlamaConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        max_seq_len=128,
        remat=False,
    ),
    "mistral_7b": LlamaConfig(
        vocab_size=32_000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        rope_theta=10_000.0,
        max_seq_len=32_768,
        sliding_window=4096,
        attention_backend="flash",
    ),
    "mistral_tiny": LlamaConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        max_seq_len=128,
        sliding_window=32,
        remat=False,
    ),
    "qwen25_7b": LlamaConfig(
        vocab_size=152_064,
        d_model=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18_944,
        rope_theta=1_000_000.0,
        rms_eps=1e-6,
        max_seq_len=32_768,
        attention_qkv_bias=True,
        attention_backend="flash",
    ),
    "qwen25_tiny": LlamaConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        max_seq_len=128,
        remat=False,
        attention_qkv_bias=True,
    ),
}


def _scale_rope_freqs(freqs: torch.Tensor, s: RopeScaling) -> torch.Tensor:
    """HF's "linear" and "llama3" frequency transforms."""
    if s.rope_type == "linear":
        return freqs / s.factor
    if s.rope_type != "llama3":
        raise NotImplementedError(
            f"rope_type={s.rope_type!r}: RopeScaling implements "
            "'llama3' and 'linear'"
        )
    old_len = float(s.original_max_position_embeddings)
    wavelen = 2.0 * math.pi / freqs
    scaled = torch.where(
        wavelen > old_len / s.low_freq_factor, freqs / s.factor, freqs
    )
    smooth = (old_len / wavelen - s.low_freq_factor) / (
        s.high_freq_factor - s.low_freq_factor
    )
    smoothed = (1.0 - smooth) * freqs / s.factor + smooth * freqs
    is_medium = (wavelen <= old_len / s.low_freq_factor) & (
        wavelen >= old_len / s.high_freq_factor
    )
    return torch.where(is_medium, smoothed, scaled)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    scaling: Optional[RopeScaling] = None,
) -> torch.Tensor:
    """Half-split rotary embeddings in fp32. x: [B, T, H, D], positions:
    [B, T] -> same shape and dtype as x."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    if scaling is not None:
        freqs = _scale_rope_freqs(freqs, scaling)
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class Projection(nn.Module):
    """x @ W^T (+ b) with the input and the master weight cast to the
    compute dtype — ``nn.DenseGeneral(dtype=cfg.dtype)``."""

    def __init__(self, d_in, d_out, cfg, gen, bias=False, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        w = torch.empty(d_out, d_in, dtype=cfg.param_dtype, device=device)
        w.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)
        self.weight = nn.Parameter(w)
        self.bias = (
            nn.Parameter(
                torch.zeros(d_out, dtype=cfg.param_dtype, device=device)
            )
            if bias else None
        )

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, window=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        d, hd = cfg.d_model, cfg.head_dim
        bias = cfg.attention_qkv_bias
        self.q = Projection(d, cfg.n_heads * hd, cfg, gen, bias, device)
        self.k = Projection(d, cfg.n_kv_heads * hd, cfg, gen, bias, device)
        self.v = Projection(d, cfg.n_kv_heads * hd, cfg, gen, bias, device)
        self.o = Projection(cfg.n_heads * hd, d, cfg, gen, False, device)

    def forward(self, x, positions, segment_ids=None):
        cfg = self.cfg
        b, t, _ = x.shape
        q = self.q(x).view(b, t, cfg.n_heads, cfg.head_dim)
        k = self.k(x).view(b, t, cfg.n_kv_heads, cfg.head_dim)
        v = self.v(x).view(b, t, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        if not cfg.causal and self.window is not None:
            raise ValueError(
                "causal=False with sliding_window set: the window mask "
                "is causal-relative; set sliding_window=None for "
                "bidirectional embedding fine-tuning"
            )
        out = multi_head_attention(
            q, k, v,
            causal=cfg.causal,
            segment_ids=segment_ids,
            sliding_window=self.window,
            backend=cfg.attention_backend,
        )
        return self.o(out.reshape(b, t, cfg.n_heads * cfg.head_dim))


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: LlamaConfig, gen, device=None):
        super().__init__()
        self.gate = Projection(cfg.d_model, cfg.d_ff, cfg, gen, False, device)
        self.up = Projection(cfg.d_model, cfg.d_ff, cfg, gen, False, device)
        self.down = Projection(cfg.d_ff, cfg.d_model, cfg, gen, False, device)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, gen, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, gen, cfg.sliding_window, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.mlp = MLP(cfg, gen, device)

    def forward(self, x, positions, segment_ids=None):
        x = x + self.attn(self.attn_norm(x), positions, segment_ids)
        return x + self.mlp(self.mlp_norm(x))


def _reject_unported(cfg: LlamaConfig) -> None:
    for field, name in (
        ("decode", "KV-cache decode"),
        ("quantized_weights", "int8 weights"),
        ("kv_page", "the paged KV cache"),
        ("lora_rank", "LoRA adapters"),
    ):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"LlamaConfig.{field}: {name} is not ported to tpufw_torch "
                "yet (ROADMAP.md Queue 1)"
            )


class Llama(nn.Module):
    """Decoder-only Llama-3 LM. ``forward`` returns logits [B, T, vocab],
    or the post-final-norm hidden states [B, T, D] with
    ``return_hidden=True`` (the chunked-vocab loss path).

    Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        _reject_unported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        emb = torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=dev
        )
        self.embed = nn.Parameter(emb.normal_(0.0, 1.0, generator=gen))
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, gen, dev) for _ in range(cfg.n_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, dev)
        self.lm_head = None
        if not cfg.tie_embeddings:
            w = torch.empty(
                cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype,
                device=dev,
            )
            w.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
            self.lm_head = nn.Parameter(w)

    def head_kernel(self) -> torch.Tensor:
        """The [D, V] LM-head matrix (the transposed embedding if tied)."""
        w = self.embed if self.lm_head is None else self.lm_head
        return w.t()

    def forward(
        self, tokens, positions=None, segment_ids=None, return_hidden=False
    ):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device
            ).expand(tokens.shape)
        x = F.embedding(tokens.long(), self.embed).to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x = checkpoint(
                    block, x, positions, segment_ids, use_reentrant=False
                )
            else:
                x = block(x, positions, segment_ids)
        x = self.final_norm(x)
        if return_hidden:
            return x
        if self.lm_head is None:
            # Flax Embed.attend: query and table in the compute dtype.
            return x.to(cfg.dtype) @ self.embed.to(cfg.dtype).t()
        return F.linear(x.float(), self.lm_head.float())
