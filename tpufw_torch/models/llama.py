"""Llama-3 model family in PyTorch (port of ``tpufw.models.llama``).

Same numerics as the JAX model: activations in ``cfg.dtype`` (bf16), fp32
master weights cast to ``cfg.dtype`` at every projection, RMSNorm and
RoPE in fp32, the untied LM head in fp32. Under ``cfg.remat`` each block
runs under ``torch.utils.checkpoint`` with ``cfg.remat_policy`` choosing
what the forward keeps for the backward (``remat_block``), as the JAX
policies do; the policy changes memory and time, never the numbers.
Attention goes through ``tpufw_torch.ops.multi_head_attention``, so the
CUDA flash kernels drop in with ``attention_backend="flash"``.

Serving: ``cfg.decode_config()`` builds the decode twin, whose ``forward``
also takes ``cache=``, a list of per-layer ``KVCache`` (``Llama.init_cache``)
or ``PagedKVCache`` (``Llama.init_paged_cache``): each call writes its keys
and values at the cache cursor and attends over the whole cache through
the plain attention path. The cache's length and paging belong to the
cache object (``tpufw`` builds a model per cache shape instead), so one
set of weights serves every pool. With
``quantized_weights`` every projection and the untied head hold int8
codes and per-output-channel scales (``QuantProjection``; the state dict
comes from ``tpufw_torch.ops.quant.quantize_params``).

Parameter layout is PyTorch's: a projection's weight is [out, in].
``tpufw_torch.interop.params_from_flax`` converts a Flax param tree.
With ``lora_rank`` > 0 every projection also holds LoRA adapters
(``weight_lora_a``/``weight_lora_b``, ``models.lora``) and the build
freezes everything else.

The trunk also carries the knobs other families set on their configs and
read here with ``getattr``, as ``tpufw.models.llama`` reads them (Gemma-2,
``tpufw_torch.models.gemma``): ``rms_offset`` (norm weights stored as an
offset from 1), ``mlp_activation`` (``"gelu_tanh"``: GeGLU),
``query_pre_attn_scalar`` (q scaled by its inverse square root instead of
head_dim's), ``attn_logit_soft_cap`` (in every attention path) and
``embed_scale`` (embeddings drawn at std d^-0.5 and multiplied by
sqrt(d_model) at lookup).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tpufw_torch.models.lora import freeze_base, init_adapters
from tpufw_torch.ops import multi_head_attention, rms_norm
from tpufw_torch.ops.loss import head_logits
from tpufw_torch.ops.quant import dequantize_kv, quant_contract, quantize_kv
from tpufw_torch.parallel.context import tensor_group
from tpufw_torch.parallel.tensor import (
    column,
    refuse_unsplittable,
    row,
    vocab_embed,
)
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
    # Checkpoint each block in training, keeping what remat_policy names
    # (REMAT_POLICIES): "dots" (every projection output), "nothing"
    # (the block input only), "everything" (no recompute), "attn_out"
    # (the block input and the attention output).
    remat: bool = True
    remat_policy: str = "dots"
    # False = bidirectional attention.
    causal: bool = True
    # Mistral-style local attention on every layer (None = global).
    sliding_window: Optional[int] = None
    # Qwen-2 style biases on the q/k/v projections.
    attention_qkv_bias: bool = False
    # KV-cache serving model (``forward(..., cache=...)``); build with
    # decode_config().
    decode: bool = False
    # Int8 projection weights + fp32 per-output-channel scales (serving
    # only; the state dict comes from ops.quant.quantize_params).
    quantized_weights: bool = False
    # Must stay off: the paged cache is a cache object here
    # (Llama.init_paged_cache).
    kv_page: int = 0
    # LoRA adapters of this rank on every projection (0 = off); the
    # model then trains them alone (models/lora.py), and
    # lora.merge_lora folds them back into the base.
    lora_rank: int = 0
    lora_alpha: float = 16.0

    def decode_config(self) -> "LlamaConfig":
        """This architecture dressed for inference: KV cache on, remat off
        (no backward pass), plain attention (the flash kernels are the
        trainer's)."""
        return dataclasses.replace(
            self, decode=True, remat=False, attention_backend="xla"
        )

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
    """RMSNorm; with ``offset`` (Gemma) the weight is stored as an offset
    from 1, zeros at init, and applied as 1 + w in the weight's dtype, as
    HF and ``tpufw`` store it."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None,
                 offset: bool = False):
        super().__init__()
        self.eps = eps
        self.offset = offset
        init = torch.zeros if offset else torch.ones
        self.weight = nn.Parameter(
            init(dim, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        w = self.weight + 1.0 if self.offset else self.weight
        return rms_norm(x, w, self.eps)


class Projection(nn.Module):
    """x @ W^T (+ b) with the input and the master weight cast to the
    compute dtype — ``nn.DenseGeneral(dtype=cfg.dtype)`` — plus, with
    ``cfg.lora_rank`` r > 0 (and ``lora``), ``tpufw``'s ``lora_delta``:
    (x @ Aᵀ) @ Bᵀ * (lora_alpha / r) in the compute dtype, A
    ``weight_lora_a`` [r, in] and B ``weight_lora_b`` [out, r]. The model
    draws the adapters (``lora.init_adapters``: B zero, so the output is
    the base's until B trains)."""

    def __init__(self, d_in, d_out, cfg, gen, bias=False, device=None,
                 lora=True):
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
        r = getattr(cfg, "lora_rank", 0) if lora else 0
        self.lora_scale = getattr(cfg, "lora_alpha", 16.0) / r if r else None
        if r:
            self.weight_lora_a = nn.Parameter(torch.zeros(
                r, d_in, dtype=cfg.param_dtype, device=device))
            self.weight_lora_b = nn.Parameter(torch.zeros(
                d_out, r, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        y = F.linear(x, self.weight.to(self.dtype), b)
        if self.lora_scale is None:
            return y
        lo = F.linear(x, self.weight_lora_a.to(self.dtype))
        return y + F.linear(lo, self.weight_lora_b.to(self.dtype)) \
            * self.lora_scale


class QuantProjection(nn.Module):
    """The int8 serving twin of ``Projection`` (``QuantDenseGeneral``):
    int8 codes [out, in], an fp32 scale [out] and an optional fp32 bias.
    Output: x · W.to(dtype)ᵀ × scale (+ bias), all in ``dtype``. Zeros
    and ones until a quantized state dict is loaded."""

    def __init__(self, d_in, d_out, dtype, bias=False, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(d_out, d_in, dtype=torch.int8, device=device),
            requires_grad=False,
        )
        self.scale = nn.Parameter(
            torch.ones(d_out, dtype=torch.float32, device=device),
            requires_grad=False,
        )
        self.bias = (
            nn.Parameter(
                torch.zeros(d_out, dtype=torch.float32, device=device),
                requires_grad=False,
            )
            if bias else None
        )

    def forward(self, x):
        y = quant_contract(x.to(self.dtype), self.weight, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def reject_quant_lora(cfg) -> None:
    """int8 weights carry no gradient path: adapters are merged
    (``tools.merge_lora``) before quantizing. ``tpufw``'s words."""
    if getattr(cfg, "lora_rank", 0):
        raise ValueError(
            "quantized_weights with lora_rank > 0: merge the "
            "adapters (tools/merge_lora) before quantizing"
        )


def _projection(d_in, d_out, cfg, gen, bias=False, device=None):
    if cfg.quantized_weights:
        reject_quant_lora(cfg)
        return QuantProjection(d_in, d_out, cfg.dtype, bias, device)
    return Projection(d_in, d_out, cfg, gen, bias, device)


def _head_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits x · wᵀ of an untied head [V, D], as the JAX head's
    ``DenseGeneral(dtype=float32)`` computes them: both operands promoted
    to fp32. bf16 activations against bf16 or int8 weights are exact in
    bf16, so those take a bf16 product with fp32 sums instead, which
    needs no fp32 copy of the weight."""
    if x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16, torch.int8):
        return head_logits(x, w.t(), torch.bfloat16)
    return F.linear(x.float(), w.float())


@dataclasses.dataclass
class KVCache:
    """One layer's KV cache. ``key``/``value`` [B, S, K, D] in
    ``cfg.dtype``; ``seg`` [B, S] int32 segment ids, 0 for slots never
    written (and prompt padding), which the segment mask hides; ``index``
    the next slot to write: one int for every row, or a [B] tensor of
    per-row cursors (the slot pool's)."""

    key: torch.Tensor
    value: torch.Tensor
    seg: torch.Tensor
    index: Union[int, torch.Tensor]

    # The per-token feature tensors, which the pools copy and page.
    FEATS: ClassVar[tuple] = ("key", "value")


@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged KV cache (``tpufw``'s ``kv_page > 0`` cache
    leaves). ``key``/``value`` [n_pages, page, K, D] are an arena shared
    by every row, in ``cfg.dtype`` or int8 with fp32 per-token scales
    ``key_scale``/``value_scale`` [n_pages, page]; ``seg`` [n_pages, page]
    segment ids; ``table`` [B, length // page] maps row b's logical slot
    j to page ``table[b, j // page]``, offset ``j % page`` (one tensor,
    shared by every layer); ``index`` the [B] per-row cursors. Page 0 is
    the junk sink that unmapped table entries point at. Decode only: the
    prompt is prefilled through a contiguous ``KVCache`` and scattered
    into pages by ``tpufw_torch.infer.pages``."""

    key: torch.Tensor
    value: torch.Tensor
    seg: torch.Tensor
    table: torch.Tensor
    index: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    # Each feature ``f`` has its int8 scales under ``f + "_scale"``.
    FEATS: ClassVar[tuple] = ("key", "value")

    @property
    def page(self) -> int:
        return self.key.shape[1]

    @property
    def length(self) -> int:
        """Logical slots per row."""
        return self.table.shape[1] * self.page


class Attention(nn.Module):
    """GQA self-attention. Under a tensor group (``parallel.context``)
    q, k and v are column-parallel and o row-parallel: each held shard
    attends with its ``n_heads/tp`` query and ``n_kv_heads/tp`` KV heads
    (a query head's KV head lies in its own shard), so the flash kernels
    launch once per shard."""

    # Logical axes of the parameters ([out, in]), as ``tpufw`` names them.
    LOGICAL_AXES: ClassVar[dict] = {
        "q.weight": ("q_heads", "embed"), "q.bias": ("q_heads",),
        "k.weight": ("kv_heads", "embed"), "k.bias": ("kv_heads",),
        "v.weight": ("kv_heads", "embed"), "v.bias": ("kv_heads",),
        "o.weight": ("embed", "heads"),
    }

    def __init__(self, cfg: LlamaConfig, gen, window=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        d, hd = cfg.d_model, cfg.head_dim
        bias = getattr(cfg, "attention_qkv_bias", False)
        self.soft_cap = getattr(cfg, "attn_logit_soft_cap", None)
        # Non-default query scaling (Gemma's query_pre_attn_scalar): every
        # backend scales by head_dim**-0.5, so q is pre-multiplied by the
        # ratio to qpas**-0.5.
        qpas = getattr(cfg, "query_pre_attn_scalar", None)
        self.q_mult = (
            math.sqrt(hd) / math.sqrt(float(qpas))
            if qpas is not None and float(qpas) != float(hd) else None
        )
        self.q = _projection(d, cfg.n_heads * hd, cfg, gen, bias, device)
        self.k = _projection(d, cfg.n_kv_heads * hd, cfg, gen, bias, device)
        self.v = _projection(d, cfg.n_kv_heads * hd, cfg, gen, bias, device)
        self.o = _projection(cfg.n_heads * hd, d, cfg, gen, False, device)

    def forward(self, x, positions, segment_ids=None, cache=None):
        tp = tensor_group()
        x = tp.enter(x)
        outs = [self._heads(q, k, v, positions, segment_ids, cache)
                for q, k, v in zip(*(column(p, x, tp)
                                     for p in (self.q, self.k, self.v)))]
        return row(self.o, outs, tp)

    def _heads(self, q, k, v, positions, segment_ids, cache):
        """Attention of one shard's heads: q [B, T, h·D], k and v
        [B, T, kv·D] -> [B, T, h·D]."""
        cfg = self.cfg
        b, t, _ = q.shape
        hd = cfg.head_dim
        q = q.view(b, t, -1, hd)
        k = k.view(b, t, -1, hd)
        v = v.view(b, t, -1, hd)
        rope_scaling = getattr(cfg, "rope_scaling", None)
        q = apply_rope(q, positions, cfg.rope_theta, rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, rope_scaling)
        if self.q_mult is not None:
            q = q * self.q_mult
        causal = getattr(cfg, "causal", True)
        if not causal and self.window is not None:
            raise ValueError(
                "causal=False with sliding_window set: the window mask "
                "is causal-relative; set sliding_window=None for "
                "bidirectional embedding fine-tuning"
            )
        if cache is not None:
            if not causal:
                raise ValueError(
                    "causal=False with a KV cache: a KV cache is a causal "
                    "construct"
                )
            if isinstance(cache, PagedKVCache):
                out = self._paged_cached_attention(
                    q, k, v, segment_ids, cache
                )
            else:
                out = self._cached_attention(q, k, v, segment_ids, cache)
        else:
            out = multi_head_attention(
                q, k, v,
                causal=causal,
                segment_ids=segment_ids,
                logits_soft_cap=self.soft_cap,
                sliding_window=self.window,
                backend=cfg.attention_backend,
            )
        return out.reshape(b, t, -1)

    def _cached_attention(self, q, k, v, segment_ids, cache: KVCache):
        """Write this call's k/v at the cache cursor, then attend q over
        the whole cache. Causality goes by cache slot, not by RoPE
        position: under left padding a token's position lags its slot by
        the row's pad length. With per-row cursors the write window is
        clamped to ``S - t``, so a row that is done but still stepped
        writes in bounds (its output is masked by the caller)."""
        b, t = q.shape[:2]
        s = cache.key.shape[1]
        dev = q.device
        seg = (
            torch.ones(b, t, dtype=torch.int32, device=dev)
            if segment_ids is None else segment_ids.to(torch.int32)
        )
        cur = cache.index
        if isinstance(cur, int):
            if cur + t > s:
                raise ValueError(
                    f"KV cache overflow: writing {t} tokens at slot {cur} "
                    f"of {s}"
                )
            cache.key[:, cur:cur + t] = k
            cache.value[:, cur:cur + t] = v
            cache.seg[:, cur:cur + t] = seg
            slots = (cur + torch.arange(t, device=dev)).expand(b, t)
        else:
            slots = (
                torch.clamp(cur, max=s - t)[:, None]
                + torch.arange(t, device=dev)[None, :]
            )
            rows = torch.arange(b, device=dev)[:, None]
            cache.key[rows, slots] = k.to(cache.key.dtype)
            cache.value[rows, slots] = v.to(cache.value.dtype)
            cache.seg[rows, slots] = seg
        cache.index = cur + t
        return multi_head_attention(
            q,
            cache.key,
            cache.value,
            causal=True,
            segment_ids=seg,
            kv_segment_ids=cache.seg,
            q_positions=slots,
            logits_soft_cap=self.soft_cap,
            sliding_window=self.window,
            backend="xla",
        )

    def _paged_cached_attention(self, q, k, v, segment_ids,
                                cache: PagedKVCache):
        """Paged decode step: scatter this call's k/v through the page
        table, then gather every row's logical [S] view IN SLOT ORDER and
        attend over it as the contiguous branch does. Unmapped table
        entries point at page 0, whose junk only surfaces at slots beyond
        the row's cursor, where the causal mask zeroes its weight. The
        write window is clamped to ``S - t`` as in the contiguous branch:
        a done row that is still stepped writes into its own last page,
        or into page 0 once its table row is zeroed. int8 arenas quantize
        k/v per token at the append and dequantize on the gather."""
        b, t = q.shape[:2]
        s, page = cache.length, cache.page
        dev = q.device
        seg = (
            torch.ones(b, t, dtype=torch.int32, device=dev)
            if segment_ids is None else segment_ids.to(torch.int32)
        )
        cur = cache.index
        wslot = (
            torch.clamp(cur, max=s - t)[:, None]
            + torch.arange(t, device=dev)[None, :]
        )
        phys = cache.table[torch.arange(b, device=dev)[:, None],
                           wslot // page]
        off = wslot % page
        quant = cache.key_scale is not None
        if quant:
            qk, sk = quantize_kv(k, n_feat=2)
            qv, sv = quantize_kv(v, n_feat=2)
            cache.key[phys, off] = qk
            cache.value[phys, off] = qv
            cache.key_scale[phys, off] = sk
            cache.value_scale[phys, off] = sv
        else:
            cache.key[phys, off] = k.to(cache.key.dtype)
            cache.value[phys, off] = v.to(cache.value.dtype)
        cache.seg[phys, off] = seg
        cache.index = cur + t
        idx = cache.table
        feat = k.shape[2:]
        if quant:
            dtype = self.cfg.dtype
            k_all = dequantize_kv(cache.key[idx], cache.key_scale[idx], dtype)
            v_all = dequantize_kv(
                cache.value[idx], cache.value_scale[idx], dtype
            )
        else:
            k_all, v_all = cache.key[idx], cache.value[idx]
        return multi_head_attention(
            q,
            k_all.reshape(b, s, *feat),
            v_all.reshape(b, s, *feat),
            causal=True,
            segment_ids=seg,
            kv_segment_ids=cache.seg[idx].reshape(b, s),
            q_positions=wslot,
            logits_soft_cap=self.soft_cap,
            sliding_window=self.window,
            backend="xla",
        )


class MLP(nn.Module):
    """Gated feed-forward: SwiGLU, or GeGLU with ``mlp_activation=
    "gelu_tanh"`` (Gemma; the tanh-approximate gelu). ``d_ff`` overrides
    the config's width (DeepSeek's shared experts). Under a tensor group
    gate and up are column-parallel and down row-parallel."""

    LOGICAL_AXES: ClassVar[dict] = {
        "gate.weight": ("mlp", "embed"), "up.weight": ("mlp", "embed"),
        "down.weight": ("embed", "mlp"),
    }

    def __init__(self, cfg: LlamaConfig, gen, device=None, d_ff=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        act = getattr(cfg, "mlp_activation", "silu")
        if act == "silu":
            self.act = F.silu
        elif act == "gelu_tanh":
            self.act = lambda x: F.gelu(x, approximate="tanh")
        else:
            raise ValueError(f"unknown mlp_activation {act!r}")
        self.gate = _projection(d, f, cfg, gen, False, device)
        self.up = _projection(d, f, cfg, gen, False, device)
        self.down = _projection(f, d, cfg, gen, False, device)

    def forward(self, x):
        tp = tensor_group()
        x = tp.enter(x)
        hs = [self.act(g) * u for g, u in zip(column(self.gate, x, tp),
                                              column(self.up, x, tp))]
        return row(self.down, hs, tp)


class LlamaBlock(nn.Module):
    """Pre-norm attention and MLP, each with a residual. Every family's
    block splits as ``merge(x, attend(x, ...), segment_ids)``: ``attend``'s
    output is the tensor ``tpufw`` tags "attn_out" for its remat policy
    (``merge`` takes the segment ids for a MoE block's valid rows)."""

    def __init__(self, cfg: LlamaConfig, gen, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, gen, cfg.sliding_window, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.mlp = MLP(cfg, gen, device)

    def attend(self, x, positions, segment_ids=None, cache=None):
        return self.attn(self.attn_norm(x), positions, segment_ids, cache)

    def merge(self, x, a, segment_ids=None):
        x = x + a
        return x + self.mlp(self.mlp_norm(x))

    def forward(self, x, positions, segment_ids=None, cache=None):
        return self.merge(x, self.attend(x, positions, segment_ids, cache),
                          segment_ids)


# Remat policies, as ``tpufw.models.llama._REMAT_POLICIES`` names them.
REMAT_POLICIES = ("attn_out", "dots", "everything", "nothing")
# "dots" is JAX's checkpoint_dots_with_no_batch_dims: it keeps the output
# of every matmul WITHOUT batch dims, i.e. the projections' x @ W (an
# aten.mm, or addmm with a bias, at dispatch), and recomputes the rest:
# the norms, rope, the attention's batched products and the flash
# kernels, the activations.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def check_remat_policy(cfg) -> None:
    """ValueError for an unknown ``remat_policy`` of a model that remats
    (``tpufw`` raises the same when it builds the remat)."""
    name = getattr(cfg, "remat_policy", "dots")
    if cfg.remat and name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; choose from "
            f"{sorted(REMAT_POLICIES)}"
        )


def remat_block(block, policy: str, x, positions, segment_ids):
    """``block``'s training forward under ``policy``: "everything" runs
    it plainly; "nothing" checkpoints it whole, keeping its input;
    "dots" checkpoints it keeping every projection output (selective
    checkpointing); "attn_out" checkpoints ``attend`` and ``merge``
    apart, so the attention output is kept and both halves are
    recomputed from what was kept."""
    if policy == "everything":
        return block(x, positions, segment_ids)
    if policy == "attn_out":
        a = checkpoint(block.attend, x, positions, segment_ids,
                       use_reentrant=False)
        return checkpoint(block.merge, x, a, segment_ids, use_reentrant=False)
    kw = {"context_fn": _dots_context} if policy == "dots" else {}
    return checkpoint(block, x, positions, segment_ids, use_reentrant=False,
                      **kw)


def _reject_unported(cfg: LlamaConfig) -> None:
    if getattr(cfg, "kv_page", 0):
        raise NotImplementedError(
            "LlamaConfig.kv_page: in tpufw_torch the paging belongs to the "
            "cache, not the model (Llama.init_paged_cache), so one set of "
            "weights serves every pool"
        )


class Llama(nn.Module):
    """Decoder-only Llama-3 LM. ``forward`` returns logits [B, T, vocab],
    or the post-final-norm hidden states [B, T, D] with
    ``return_hidden=True`` (the chunked-vocab loss path). A decode model
    (``cfg.decode_config()``) also takes ``cache=``, the list of per-layer
    ``KVCache`` from ``Llama.init_cache``, which the call advances in place;
    without it, it runs the ordinary forward over its own tokens.

    Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``. With ``cfg.lora_rank`` > 0
    every projection carries adapters and only they need gradients.

    Under a tensor group (``parallel.context``) the embedding and the head
    are vocab-parallel (``parallel.tensor``) and the blocks Megatron's
    column/row split; ``head_kernel`` is then this rank's rows (whole in
    one process).
    """

    LOGICAL_AXES: ClassVar[dict] = {
        "embed": ("vocab", "embed"), "lm_head": ("vocab", "embed"),
    }

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        _reject_unported(cfg)
        check_remat_policy(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        # The meta device (shapes only, no memory) has no generator.
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        emb = torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=dev
        )
        # Scaled-embedding models (Gemma) store embeddings at ~1/sqrt(d)
        # and multiply by sqrt(d) at lookup, keeping the tied head's logits
        # O(1).
        std = cfg.d_model ** -0.5 if getattr(cfg, "embed_scale", False) else 1.0
        self.embed = nn.Parameter(emb.normal_(0.0, std, generator=gen))
        self.layers = nn.ModuleList(
            self._block(cfg, gen, dev, i) for i in range(cfg.n_layers)
        )
        self.final_norm = RMSNorm(
            cfg.d_model, cfg.rms_eps, dev,
            offset=getattr(cfg, "rms_offset", False),
        )
        self.lm_head = None
        if cfg.quantized_weights and not cfg.tie_embeddings:
            self.lm_head = QuantProjection(
                cfg.d_model, cfg.vocab_size, torch.float32, device=dev
            )
        elif not cfg.tie_embeddings:
            w = torch.empty(
                cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype,
                device=dev,
            )
            w.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
            self.lm_head = nn.Parameter(w)
        if getattr(cfg, "lora_rank", 0):
            # The adapters come from a stream of their own, so the base
            # is the rank-0 model's of the same seed; the freeze lives
            # in the build, so a model rebuilt on ``meta`` to resume
            # stays adapter-only.
            if dev.type != "meta":
                init_adapters(self, seed, dev)
            freeze_base(self)

    @staticmethod
    def _block(cfg, gen, device, index: int) -> nn.Module:
        """Layer ``index`` of the stack (a family's model overrides it)."""
        return LlamaBlock(cfg, gen, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(
        self, batch: int, per_row: bool = False, length: Optional[int] = None
    ) -> list[KVCache]:
        """Zeroed per-layer KV caches of ``length`` slots (default
        ``cfg.max_seq_len``) for ``batch`` rows on the model's device;
        ``per_row`` gives each row its own cursor. The cache length is
        the cache's, not the model's: one set of weights serves every
        length."""
        cfg, dev = self.cfg, self.device
        length = cfg.max_seq_len if length is None else int(length)
        if not 0 < length <= cfg.max_seq_len:
            raise ValueError(
                f"cache length {length} outside (0, max_seq_len="
                f"{cfg.max_seq_len}]"
            )
        shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
        return [
            KVCache(
                key=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                value=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                seg=torch.zeros(shape[:2], dtype=torch.int32, device=dev),
                index=(
                    torch.zeros(batch, dtype=torch.long, device=dev)
                    if per_row else 0
                ),
            )
            for _ in range(cfg.n_layers)
        ]

    def init_paged_cache(
        self, batch: int, length: int, page: int, n_pages: int,
        kv_quant: str = "",
    ) -> list[PagedKVCache]:
        """Zeroed per-layer paged caches: an arena of ``n_pages`` pages
        of ``page`` slots per layer (page 0 reserved), one page table
        [batch, length // page] shared by every layer, per-row cursors.
        ``kv_quant="int8"`` stores K/V as int8 codes with fp32 per-token
        scales. Zeros are safe initial state: segment 0 everywhere, and
        every table entry points at page 0."""
        cfg, dev = self.cfg, self.device
        if length > cfg.max_seq_len or length % page:
            raise ValueError(
                f"kv_page={page} must divide the cache length {length} "
                f"(<= max_seq_len={cfg.max_seq_len})"
            )
        if kv_quant not in ("", "int8"):
            raise ValueError(f"kv_quant={kv_quant!r}: expected '' or 'int8'")
        quant = kv_quant == "int8"
        shape = (n_pages, page, cfg.n_kv_heads, cfg.head_dim)
        kv_dtype = torch.int8 if quant else cfg.dtype
        table = torch.zeros(batch, length // page, dtype=torch.long,
                            device=dev)

        def scale():
            if not quant:
                return None
            return torch.zeros(n_pages, page, dtype=torch.float32, device=dev)

        return [
            PagedKVCache(
                key=torch.zeros(shape, dtype=kv_dtype, device=dev),
                value=torch.zeros(shape, dtype=kv_dtype, device=dev),
                seg=torch.zeros(n_pages, page, dtype=torch.int32,
                                device=dev),
                table=table,
                index=torch.zeros(batch, dtype=torch.long, device=dev),
                key_scale=scale(),
                value_scale=scale(),
            )
            for _ in range(cfg.n_layers)
        ]

    def head_kernel(self) -> torch.Tensor:
        """The [D, V] LM-head matrix (the transposed embedding if tied)."""
        w = self.embed if self.lm_head is None else self.lm_head
        return w.t()

    def forward(
        self, tokens, positions=None, segment_ids=None, return_hidden=False,
        cache=None,
    ):
        x, _ = self._trunk(tokens, positions, segment_ids, cache)
        return x if return_hidden else self._head(x)

    def _trunk(self, tokens, positions, segment_ids, cache):
        """Embedding, the blocks and the final norm: (hidden [B, T, D],
        aux), ``aux`` the sum over layers of what a block returns beside
        its output (a MoE block's router loss), else None."""
        cfg = self.cfg
        if cache is not None and not cfg.decode:
            raise ValueError(
                "a KV cache needs a decode model: build it from "
                "cfg.decode_config()"
            )
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device
            ).expand(tokens.shape)
        x = vocab_embed(tokens, self.embed, tensor_group()).to(cfg.dtype)
        if getattr(cfg, "embed_scale", False):
            # sqrt(d_model) rounded through the activation dtype, as HF and
            # tpufw do (bf16 rounding included).
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        policy = getattr(cfg, "remat_policy", "dots")
        aux = None
        for i, block in enumerate(self.layers):
            if cache is not None:
                x = block(x, positions, segment_ids, cache[i])
            elif remat:
                x = remat_block(block, policy, x, positions, segment_ids)
            else:
                x = block(x, positions, segment_ids)
            if isinstance(x, tuple):
                x, a = x
                aux = a if aux is None else aux + a
        return self.final_norm(x), aux

    def _head(self, x):
        """Logits [B, T, vocab] of the final-norm hidden states; under a
        tensor group each held shard of the vocab-parallel head (the tied
        embedding's or the untied head's rows of its vocabulary range)
        gives its logits, gathered."""
        tp = tensor_group()
        w = self.embed if self.lm_head is None else self.lm_head
        if tp.size == 1:
            return self._head_with(x, w)
        if isinstance(w, QuantProjection):
            refuse_unsplittable(w, tp)
        x = tp.enter(x)
        return tp.gather([self._head_with(x, w_i) for w_i in tp.shards(w, 0)],
                         -1)

    def _head_with(self, x, w):
        """Logits of ``x`` against head rows ``w`` [V', D], as ``tpufw``
        computes them."""
        cfg = self.cfg
        if self.lm_head is None:
            # Flax Embed.attend: query and table in the compute dtype.
            return x.to(cfg.dtype) @ w.to(cfg.dtype).t()
        if isinstance(self.lm_head, QuantProjection):
            return _head_f32(x, self.lm_head.weight) * self.lm_head.scale
        return _head_f32(x, w)
