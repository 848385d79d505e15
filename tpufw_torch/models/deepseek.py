"""DeepSeek-V2 family in PyTorch (port of ``tpufw.models.deepseek``).

Multi-head Latent Attention (MLA) on the Llama trunk
(``tpufw_torch.models.llama``: embedding, RMSNorm, SwiGLU ``MLP``,
``Projection``, remat, the untied fp32 head):

- **Latent KV.** Keys and values come from one shared latent ``c_kv``
  (``kv_a`` then ``kv_a_norm``, ``kv_lora_rank`` dims) through the raw
  ``kv_b_kernel`` [kv_lora_rank, H, nope + v], plus one decoupled-RoPE key
  of ``qk_rope_head_dim`` dims shared by every head.
- **Interleaved RoPE.** DeepSeek rotates interleaved pairs (x[2i],
  x[2i+1]), not Llama's split halves, with optional yarn scaling
  (``YarnScaling``: the frequency ramp, its truncate semantics and the
  attention factor).
- **Training** runs the expanded form: k = [k_nope | k_pe on every head],
  q = [q_nope | q_pe], scale ``qk_head_dim ** -0.5``. On the ``flash``
  backend V is zero-padded to the qk head dim and the output sliced back,
  so the CUDA kernels see one head dim (192 at V2-Lite's widths).
- **Decode** (``cfg.decode_config()`` with ``cache=``) runs the absorbed
  form over a latent cache: ``W_uk`` is folded into the query so the
  scores are taken in latent space (fp32), and ``W_uv`` is applied once to
  the attention-weighted latents. The cache holds ``c_kv`` and the roped
  ``k_pe`` per token, 576 values for V2-Lite's widths against Llama-8B's
  2048, in one of three forms: ``LatentCache`` with one cursor (batch
  generation) or per-row cursors (the slot pool), or ``PagedLatentCache``
  (an arena of pages shared by the rows, bf16 or int8 with one fp32 scale
  per token and leaf).
- **MoE FFN** (``n_routed_experts > 0``): from layer ``first_k_dense`` on,
  the block's FFN is ``DeepseekMoE``, fine-grained routed experts on
  Mixtral's ``MoEMLP`` (raw softmax top-k gates unless
  ``norm_topk_prob``, optional group-limited selection, times
  ``routed_scaling_factor``) plus the shared experts fused into one SwiGLU
  of ``n_shared_experts * moe_d_ff``. ``forward(return_aux=True)`` also
  returns the router losses summed over the MoE layers and divided by
  ``n_layers``, dense layers included, as ``tpufw`` divides them.

Differs from the JAX package: the blocks are one ``nn.ModuleList`` either
way; ``scan_layers`` names the layout of ``tpufw``'s tree for this config
(``tpufw_torch.interop.params_from_flax`` takes both), which the page
bundles follow. Not ported yet, and refused with ``NotImplementedError``:
the sequence-parallel backends.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from tpufw_torch.models.llama import (
    MLP,
    Llama,
    RMSNorm,
    _projection,
)
from tpufw_torch.models.mixtral import MoEMLP
from tpufw_torch.ops import multi_head_attention
from tpufw_torch.ops.quant import dequantize_kv, quantize_kv
from tpufw_torch.parallel.context import tensor_group
from tpufw_torch.parallel.tensor import column, row


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """Yarn long-context rope scaling (arXiv 2309.00071), as transformers'
    ``_compute_yarn_parameters`` runs it: a per-dimension ramp between
    interpolated (freq / factor) and extrapolated frequencies, and an
    ``attention_factor`` multiplied into cos/sin. With ``mscale ==
    mscale_all_dim`` (V2-Lite publishes 0.707 for both) the factor is 1."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    # 0.0 = unset: the ratio branch of the attention factor needs both.
    mscale: float = 0.0
    mscale_all_dim: float = 0.0
    attention_factor: Optional[float] = None  # None = derived
    truncate: bool = True

    def resolved_attention_factor(self) -> float:
        def get_mscale(scale, m=1.0):
            if scale <= 1:
                return 1.0
            return 0.1 * m * math.log(scale) + 1.0

        if self.attention_factor is not None:
            return float(self.attention_factor)
        if self.mscale and self.mscale_all_dim:
            return get_mscale(self.factor, self.mscale) / get_mscale(
                self.factor, self.mscale_all_dim
            )
        return get_mscale(self.factor)


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    """DeepSeek-V2 MLA decoder; field names follow the JAX package's (and
    HF's ``DeepseekV2Config`` where the concepts coincide)."""

    vocab_size: int = 32_768
    d_model: int = 2048
    n_layers: int = 12
    n_heads: int = 16
    # None = full-rank q projection (V2-Lite); an int adds the compressed
    # q path (q_a -> q_a_norm -> q_b, V2-236B).
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    d_ff: int = 8192
    rope_theta: float = 10_000.0
    rope_scaling: Optional[YarnScaling] = None
    max_seq_len: int = 4096
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "xla" (plain attention), "flash" (the CUDA kernels, V zero-padded
    # to qk_head_dim), or the sequence-parallel "ring"/"ulysses" (V padded
    # as for flash).
    attention_backend: str = "xla"
    # "einsum" (one-hot dispatch) or "sorted" (grouped matmuls); int8
    # expert stacks always run einsum.
    moe_dispatch: str = "einsum"
    # Checkpoint each block in training, keeping what remat_policy names
    # (tpufw_torch.models.llama.REMAT_POLICIES).
    remat: bool = True
    remat_policy: str = "dots"
    # The layout of tpufw's tree for this config: layers stacked (True)
    # or one subtree per layer, which a mixed dense/MoE stack needs. The
    # port's blocks are a ModuleList either way; page bundles take the
    # matching leaf paths.
    scan_layers: bool = True
    decode: bool = False
    tie_embeddings: bool = False
    # Int8 projection weights + fp32 per-output-channel scales (serving),
    # the routed and shared experts included; kv_b_kernel, the routers,
    # the norms and the embedding stay in floating point.
    quantized_weights: bool = False
    # Must stay off: the paging belongs to the cache here
    # (Deepseek.init_paged_cache), as for Llama.
    kv_page: int = 0
    kv_pages: int = 0
    kv_quant: str = ""
    # --- MoE FFN (0 routed experts = dense everywhere) ---
    n_routed_experts: int = 0
    experts_per_token: int = 6
    moe_d_ff: int = 1408
    n_shared_experts: int = 2
    first_k_dense: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    n_group: int = 0
    topk_group: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    router_z_weight: float = 1e-3

    @property
    def n_experts(self) -> int:
        """Alias: ``MoEMLP`` reads ``cfg.n_experts``."""
        return self.n_routed_experts

    @property
    def moe(self) -> bool:
        return self.n_routed_experts > 0

    def __post_init__(self):
        if self.moe and self.first_k_dense > 0 and self.scan_layers:
            raise ValueError(
                "first_k_dense > 0 mixes dense and MoE layers, which "
                "tpufw's layer scan cannot stack; set scan_layers=False "
                "(imports do)"
            )

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def decode_config(self) -> "DeepseekConfig":
        """Inference dress: latent cache on, remat off, plain attention."""
        return dataclasses.replace(
            self, decode=True, remat=False, attention_backend="xla"
        )

    def n_params(self, include_embed: bool = True) -> int:
        d, l, h = self.d_model, self.n_layers, self.n_heads
        if self.q_lora_rank is None:
            q = d * h * self.qk_head_dim
            q_norms = 0
        else:
            q = self.q_lora_rank * (d + h * self.qk_head_dim)
            q_norms = self.q_lora_rank
        kv_a = d * (self.kv_lora_rank + self.qk_rope_head_dim)
        kv_b = self.kv_lora_rank * h * (
            self.qk_nope_head_dim + self.v_head_dim
        )
        o = h * self.v_head_dim * d
        attn = l * (q + kv_a + kv_b + o)
        n_moe_layers = max(0, l - self.first_k_dense) if self.moe else 0
        n_dense_layers = l - n_moe_layers
        mlp = n_dense_layers * 3 * d * self.d_ff
        if n_moe_layers:
            per_layer = (
                3 * d * self.moe_d_ff * self.n_routed_experts
                + d * self.n_routed_experts
                + 3 * d * self.moe_d_ff * self.n_shared_experts
            )
            mlp += n_moe_layers * per_layer
        norms = (2 * l + 1) * d + l * (self.kv_lora_rank + q_norms)
        total = attn + mlp + norms
        if include_embed:
            head = 0 if self.tie_embeddings else self.vocab_size * d
            total += self.vocab_size * d + head
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token: 6 * N_matmul (the active experts only
        under MoE) plus the attention scores, causal-halved, fwd + bwd,
        QK^T over qk_head_dim and AV over v_head_dim."""
        n_matmul = (
            self.n_params(include_embed=False)
            - (2 * self.n_layers + 1) * self.d_model
            - self.n_layers * (self.kv_lora_rank + (self.q_lora_rank or 0))
            + self.d_model * self.vocab_size
        )
        if self.moe:
            n_moe_layers = max(0, self.n_layers - self.first_k_dense)
            routed = 3 * self.d_model * self.moe_d_ff
            n_matmul -= n_moe_layers * routed * (
                self.n_routed_experts - self.experts_per_token
            )
        keys = seq_len / 2
        score = (
            6.0 * self.n_layers * self.n_heads
            * (self.qk_head_dim + self.v_head_dim) * keys
        )
        return 6.0 * n_matmul + score


@functools.lru_cache(maxsize=16)
def _yarn_freqs(d: int, theta: float, s: YarnScaling,
                device=None) -> torch.Tensor:
    """[d/2] fp32 yarn inverse frequencies (transformers
    ``_compute_yarn_parameters``, truncate semantics included), computed
    once per (d, theta, scaling, device): every layer's q and k rope of
    every decode step reads them. Callers must not modify the result."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    pos_freqs = theta ** exps
    inv_extra = 1.0 / pos_freqs
    inv_inter = 1.0 / (s.factor * pos_freqs)

    def correction_dim(n_rot: float) -> float:
        return (
            d * math.log(
                s.original_max_position_embeddings / (n_rot * 2 * math.pi)
            )
        ) / (2 * math.log(theta))

    low = correction_dim(s.beta_fast)
    high = correction_dim(s.beta_slow)
    if s.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(d // 2, dtype=torch.float32, device=device) - low)
        / (high - low),
        0.0, 1.0,
    )
    extrapolation_factor = 1.0 - ramp
    return (
        inv_inter * (1.0 - extrapolation_factor)
        + inv_extra * extrapolation_factor
    )


def apply_rope_interleaved(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    scaling: Optional[YarnScaling] = None,
) -> torch.Tensor:
    """DeepSeek rotary in fp32 on INTERLEAVED pairs (x[2i], x[2i+1]), HF's
    ``view_as_complex`` layout. x: [B, T, H, D], positions: [B, T] -> x's
    shape and dtype. Under yarn the output is multiplied by the attention
    factor (the reference scales cos and sin; rotation is linear)."""
    d = x.shape[-1]
    if scaling is None:
        exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
        freqs = 1.0 / (theta ** exps)
        att = 1.0
    else:
        freqs = _yarn_freqs(d, theta, scaling, x.device)
        att = scaling.resolved_attention_factor()
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).reshape(x.shape)
    if att != 1.0:
        out = out * att
    return out.to(x.dtype)


@dataclasses.dataclass
class LatentCache:
    """One layer's latent cache (``tpufw``'s contiguous ``cached_ckv``,
    ``cached_kpe``, ``cached_segment_ids`` and ``cache_index``): ``ckv``
    [B, S, kv_lora_rank] and the roped ``kpe`` [B, S, qk_rope_head_dim] in
    ``cfg.dtype``; ``seg`` [B, S] int32, 0 for slots never written (and
    prompt padding); ``index`` the next slot to write: one int for every
    row, or a [B] tensor of per-row cursors (the slot pool's)."""

    ckv: torch.Tensor
    kpe: torch.Tensor
    seg: torch.Tensor
    index: Union[int, torch.Tensor]

    # The per-token feature tensors, which the pools copy and page.
    FEATS: ClassVar[tuple] = ("ckv", "kpe")


@dataclasses.dataclass
class PagedLatentCache:
    """One layer's paged latent cache (``tpufw``'s ``kv_page > 0`` latent
    leaves): ``ckv`` [n_pages, page, kv_lora_rank] and ``kpe`` [n_pages,
    page, qk_rope_head_dim] arenas shared by every row, in ``cfg.dtype`` or
    int8 with one fp32 scale per token and leaf (``ckv_scale``,
    ``kpe_scale`` [n_pages, page]); ``seg`` [n_pages, page]; ``table``
    [B, length // page] (one tensor, shared by every layer); ``index`` the
    [B] per-row cursors. Page 0 is the junk sink that unmapped table
    entries point at. The prompt is prefilled through a contiguous
    ``LatentCache`` and scattered into pages by ``tpufw_torch.infer.pages``."""

    ckv: torch.Tensor
    kpe: torch.Tensor
    seg: torch.Tensor
    table: torch.Tensor
    index: torch.Tensor
    ckv_scale: Optional[torch.Tensor] = None
    kpe_scale: Optional[torch.Tensor] = None

    FEATS: ClassVar[tuple] = ("ckv", "kpe")

    @property
    def page(self) -> int:
        return self.ckv.shape[1]

    @property
    def length(self) -> int:
        """Logical slots per row."""
        return self.table.shape[1] * self.page


def _reject_unported(cfg: DeepseekConfig) -> None:
    if cfg.attention_backend not in ("xla", "flash", "ring", "ulysses"):
        raise NotImplementedError(
            "MLA attention backends: 'xla', 'flash', 'ring', or 'ulysses'; "
            f"got {cfg.attention_backend!r}"
        )


class MLAttention(nn.Module):
    """Multi-head Latent Attention: the expanded form for training (and
    for a decode model called without a cache), the absorbed latent form
    over a ``LatentCache``. Under a tensor group the query up-projection
    and ``kv_b_kernel`` split on the heads and o is row-parallel; the
    latent down-projections and their norms stay replicated, entering the
    split at their outputs."""

    LOGICAL_AXES: ClassVar[dict] = {
        "q.weight": ("q_heads", "embed"),
        "q_a.weight": ("q_latent", "embed"),
        "q_b.weight": ("q_heads", "q_latent"),
        "kv_a.weight": ("kv_latent", "embed"),
        "kv_b_kernel": ("kv_latent", "q_heads", "head_dim"),
        "o.weight": ("embed", "heads"),
    }

    def __init__(self, cfg: DeepseekConfig, gen, device=None):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        q_out = h * cfg.qk_head_dim
        if cfg.q_lora_rank is None:
            self.q = _projection(d, q_out, cfg, gen, False, device)
        else:
            self.q_a = _projection(d, cfg.q_lora_rank, cfg, gen, False, device)
            self.q_a_norm = RMSNorm(cfg.q_lora_rank, cfg.rms_eps, device)
            self.q_b = _projection(cfg.q_lora_rank, q_out, cfg, gen, False,
                                   device)
        self.kv_a = _projection(d, kvr + dr, cfg, gen, False, device)
        self.kv_a_norm = RMSNorm(kvr, cfg.rms_eps, device)
        # The latent up-projection W_ukv as a RAW [kvr, H, dn + dv] kernel:
        # the absorbed decode contracts its W_uk and W_uv halves
        # separately, so both forms read this one parameter.
        w = torch.empty(kvr, h, cfg.qk_nope_head_dim + cfg.v_head_dim,
                        dtype=cfg.param_dtype, device=device)
        w.normal_(0.0, 1.0 / math.sqrt(kvr), generator=gen)
        self.kv_b_kernel = nn.Parameter(w)
        self.o = _projection(h * cfg.v_head_dim, d, cfg, gen, False, device)

    def forward(self, x, positions, segment_ids=None, cache=None):
        cfg = self.cfg
        b, t, _ = x.shape
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        kvr = cfg.kv_lora_rank
        tp = tensor_group()
        if cfg.q_lora_rank is None:
            qs = column(self.q, tp.enter(x), tp)
        else:
            qs = column(self.q_b, tp.enter(self.q_a_norm(self.q_a(x))), tp)
        ckv_kr = self.kv_a(x)
        c_kv = self.kv_a_norm(ckv_kr[..., :kvr])
        k_pe = apply_rope_interleaved(
            ckv_kr[..., kvr:][:, :, None, :], positions, cfg.rope_theta,
            cfg.rope_scaling,
        )  # [B, T, 1, dr]
        c_kv, k_pe = tp.enter(c_kv), tp.enter(k_pe)
        outs = []
        for q, kv_b in zip(qs, tp.shards(self.kv_b_kernel, 1)):
            q = q.view(b, t, -1, cfg.qk_head_dim)
            q_nope = q[..., :dn]
            q_pe = apply_rope_interleaved(
                q[..., dn:], positions, cfg.rope_theta, cfg.rope_scaling
            )
            if cache is not None:
                out = self._absorbed_cached_attention(
                    q_nope, q_pe, c_kv, k_pe[:, :, 0, :], segment_ids, cache
                )
            else:
                out = self._expanded(q_nope, q_pe, c_kv, k_pe, kv_b,
                                     segment_ids)
            outs.append(out.reshape(b, t, -1))
        return row(self.o, outs, tp)

    def _expanded(self, q_nope, q_pe, c_kv, k_pe, kv_b, segment_ids):
        """The expanded form over one shard's heads (``kv_b``: their
        columns of ``kv_b_kernel``): [B, T, h, dv]."""
        cfg = self.cfg
        b, t, h, _ = q_nope.shape
        dn, dv, dr = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.qk_rope_head_dim
        kv = torch.einsum(
            "btr,rhd->bthd", c_kv.to(cfg.dtype), kv_b.to(cfg.dtype),
        )
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_pe.expand(b, t, h, dr)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        # The scale is qk_head_dim**-0.5 on every backend: each derives
        # it from q's last dim, which is qk_head_dim here.
        if cfg.attention_backend in ("flash", "ring", "ulysses"):
            # softmax(QK^T) [v | 0] = [out | 0]: the kernels see one
            # head dim, and slicing recovers the exact result (Ulysses
            # exchanges the padded heads; the rope key is already
            # broadcast per head).
            v_pad = F.pad(v, (0, cfg.qk_head_dim - dv))
            return multi_head_attention(
                q, k, v_pad, causal=True, segment_ids=segment_ids,
                backend=cfg.attention_backend,
            )[..., :dv]
        return multi_head_attention(
            q, k, v, causal=True, segment_ids=segment_ids, backend="xla",
        )

    def _absorbed_cached_attention(self, q_nope, q_pe, c_kv, k_pe,
                                   segment_ids, cache):
        """Write this call's latents at the cache cursor, then attend in
        latent space: q_lat = q_nope · W_uk, scores (fp32) = (q_lat ·
        c_kvᵀ + q_pe · k_peᵀ) · qk_head_dim**-0.5, causal over cache slots
        (RoPE positions lag slots under left padding) and by segment, then
        ctx = probs · c_kv and one W_uv. With per-row cursors (contiguous
        or paged) the write window is clamped to ``S - t``, as Llama's
        cached attention clamps it: a done row that is still stepped
        writes in bounds, and its output is masked by the caller."""
        cfg = self.cfg
        b, t = q_nope.shape[:2]
        dev = q_nope.device
        seg = (
            torch.ones(b, t, dtype=torch.int32, device=dev)
            if segment_ids is None else segment_ids.to(torch.int32)
        )
        if isinstance(cache, PagedLatentCache):
            ckv_all, kpe_all, cseg_all, slots = self._paged_write(
                c_kv, k_pe, seg, cache)
        else:
            ckv_all, kpe_all, cseg_all, slots = self._contiguous_write(
                c_kv, k_pe, seg, cache)
        s = ckv_all.shape[1]
        dn = cfg.qk_nope_head_dim
        kv_b = self.kv_b_kernel.to(cfg.dtype)
        w_uk, w_uv = kv_b[..., :dn], kv_b[..., dn:]  # [kvr, H, dn / dv]
        q_lat = torch.einsum("bthd,rhd->bthr", q_nope.to(cfg.dtype), w_uk)
        logits = (
            torch.einsum("bthr,bsr->bhts", q_lat.float(), ckv_all.float())
            + torch.einsum("bthd,bsd->bhts", q_pe.to(cfg.dtype).float(),
                           kpe_all.float())
        ) * (float(cfg.qk_head_dim) ** -0.5)
        mask = slots[:, :, None] >= torch.arange(s, device=dev)  # [B, T, S]
        seg_mask = seg[:, :, None] == cseg_all[:, None, :]  # [B, T, S]
        logits = torch.where((mask & seg_mask)[:, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        ctx_lat = torch.einsum("bhts,bsr->bthr", probs, ckv_all)
        return torch.einsum("bthr,rhd->bthd", ctx_lat, w_uv)

    def _contiguous_write(self, c_kv, k_pe, seg, cache: LatentCache):
        """Write at the cursor(s) of a contiguous cache: (ckv, kpe, seg of
        the whole cache, the [B, t] slots written)."""
        b, t = seg.shape
        s = cache.ckv.shape[1]
        dev = seg.device
        cur = cache.index
        if isinstance(cur, int):
            if cur + t > s:
                raise ValueError(
                    f"latent cache overflow: writing {t} tokens at slot "
                    f"{cur} of {s}"
                )
            cache.ckv[:, cur:cur + t] = c_kv.to(cache.ckv.dtype)
            cache.kpe[:, cur:cur + t] = k_pe.to(cache.kpe.dtype)
            cache.seg[:, cur:cur + t] = seg
            slots = (cur + torch.arange(t, device=dev)).expand(b, t)
        else:
            slots = (torch.clamp(cur, max=s - t)[:, None]
                     + torch.arange(t, device=dev)[None, :])
            rows = torch.arange(b, device=dev)[:, None]
            cache.ckv[rows, slots] = c_kv.to(cache.ckv.dtype)
            cache.kpe[rows, slots] = k_pe.to(cache.kpe.dtype)
            cache.seg[rows, slots] = seg
        cache.index = cur + t
        return cache.ckv, cache.kpe, cache.seg, slots

    def _paged_write(self, c_kv, k_pe, seg, cache: PagedLatentCache):
        """Scatter through the page table (quantized per token for an int8
        arena), then gather every row's logical [S] view in slot order;
        unmapped entries read page 0, whose junk sits past the cursor where
        the causal mask hides it."""
        cfg = self.cfg
        b, t = seg.shape
        s, page = cache.length, cache.page
        dev = seg.device
        wslot = (torch.clamp(cache.index, max=s - t)[:, None]
                 + torch.arange(t, device=dev)[None, :])
        phys = cache.table[torch.arange(b, device=dev)[:, None],
                           wslot // page]
        off = wslot % page
        quant = cache.ckv_scale is not None
        if quant:
            qc, sc = quantize_kv(c_kv, n_feat=1)
            qp, sp = quantize_kv(k_pe, n_feat=1)
            cache.ckv[phys, off] = qc
            cache.kpe[phys, off] = qp
            cache.ckv_scale[phys, off] = sc
            cache.kpe_scale[phys, off] = sp
        else:
            cache.ckv[phys, off] = c_kv.to(cache.ckv.dtype)
            cache.kpe[phys, off] = k_pe.to(cache.kpe.dtype)
        cache.seg[phys, off] = seg
        cache.index = cache.index + t
        idx = cache.table
        if quant:
            ckv_all = dequantize_kv(cache.ckv[idx], cache.ckv_scale[idx],
                                    cfg.dtype)
            kpe_all = dequantize_kv(cache.kpe[idx], cache.kpe_scale[idx],
                                    cfg.dtype)
        else:
            ckv_all, kpe_all = cache.ckv[idx], cache.kpe[idx]
        return (ckv_all.reshape(b, s, -1), kpe_all.reshape(b, s, -1),
                cache.seg[idx].reshape(b, s), wslot)


class DeepseekMoE(nn.Module):
    """DeepSeek's MoE FFN: fine-grained routed experts (``MoEMLP`` of
    ``moe_d_ff``, the V2 gate conventions) times ``routed_scaling_factor``,
    plus the shared experts fused into one SwiGLU of ``moe_d_ff *
    n_shared_experts``. ``forward(x, valid)`` returns (y, aux)."""

    def __init__(self, cfg: DeepseekConfig, gen, device=None):
        super().__init__()
        self.cfg = cfg
        self.routed = MoEMLP(
            cfg, gen, device, d_ff=cfg.moe_d_ff, norm_topk=cfg.norm_topk_prob,
            group_limit=(cfg.n_group, cfg.topk_group) if cfg.n_group else None,
        )
        self.shared = (
            MLP(cfg, gen, device, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
            if cfg.n_shared_experts else None
        )

    def forward(self, x, valid=None):
        y, aux = self.routed(x, valid)
        y = y * self.cfg.routed_scaling_factor
        if self.shared is not None:
            y = y + self.shared(x)
        return y, aux


class DeepseekBlock(nn.Module):
    """RMSNorm -> MLA -> residual -> RMSNorm -> FFN -> residual. The FFN is
    ``DeepseekMoE`` for a MoE config from layer ``first_k_dense`` on, and
    then ``merge`` returns (x, aux) with the MoE's valid rows
    ``segment_ids > 0``; else the dense SwiGLU ``MLP``."""

    def __init__(self, cfg: DeepseekConfig, gen, device=None, index: int = 0):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = MLAttention(cfg, gen, device)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        if cfg.moe and index >= cfg.first_k_dense:
            self.moe = DeepseekMoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)

    def attend(self, x, positions, segment_ids=None, cache=None):
        return self.attn(self.attn_norm(x), positions, segment_ids, cache)

    def merge(self, x, a, segment_ids=None):
        x = x + a
        h = self.mlp_norm(x)
        if hasattr(self, "moe"):
            valid = None if segment_ids is None else segment_ids > 0
            y, aux = self.moe(h, valid)
            return x + y, aux
        return x + self.mlp(h)

    def forward(self, x, positions, segment_ids=None, cache=None):
        return self.merge(x, self.attend(x, positions, segment_ids, cache),
                          segment_ids)


class Deepseek(Llama):
    """Decoder-only DeepSeek-V2 LM: ``Llama``'s trunk (embedding, remat,
    final norm, untied fp32 head, chunked-loss hidden states) over
    ``DeepseekBlock`` layers. ``forward`` returns what ``Llama.forward``
    does, and with ``return_aux=True`` also the router losses summed over
    the layers and divided by ``n_layers`` (zero for a dense config). A
    decode model takes ``cache=``, the per-layer caches of ``init_cache``
    or ``init_paged_cache``."""

    def __init__(self, cfg: DeepseekConfig, device=None, seed: int = 0):
        _reject_unported(cfg)
        super().__init__(cfg, device=device, seed=seed)

    @staticmethod
    def _block(cfg, gen, device, index: int) -> nn.Module:
        return DeepseekBlock(cfg, gen, device, index)

    def forward(
        self, tokens, positions=None, segment_ids=None, return_hidden=False,
        cache=None, return_aux=False,
    ):
        x, aux = self._trunk(tokens, positions, segment_ids, cache)
        out = x if return_hidden else self._head(x)
        if not return_aux:
            return out
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return out, aux / self.cfg.n_layers

    def init_cache(
        self, batch: int, per_row: bool = False, length: Optional[int] = None
    ) -> list[LatentCache]:
        """Zeroed per-layer latent caches of ``length`` slots (default
        ``cfg.max_seq_len``) for ``batch`` rows; ``per_row`` gives each row
        its own cursor (the slot pool's)."""
        cfg, dev = self.cfg, self.device
        length = cfg.max_seq_len if length is None else int(length)
        if not 0 < length <= cfg.max_seq_len:
            raise ValueError(
                f"cache length {length} outside (0, max_seq_len="
                f"{cfg.max_seq_len}]"
            )
        return [
            LatentCache(
                ckv=torch.zeros(batch, length, cfg.kv_lora_rank,
                                dtype=cfg.dtype, device=dev),
                kpe=torch.zeros(batch, length, cfg.qk_rope_head_dim,
                                dtype=cfg.dtype, device=dev),
                seg=torch.zeros(batch, length, dtype=torch.int32, device=dev),
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
    ) -> list[PagedLatentCache]:
        """Zeroed per-layer paged latent caches: ckv/kpe arenas of
        ``n_pages`` pages of ``page`` slots per layer (page 0 reserved),
        one page table [batch, length // page] shared by every layer,
        per-row cursors; ``kv_quant="int8"`` stores int8 codes with fp32
        per-token scales. Zeros are safe initial state: segment 0
        everywhere, and every table entry points at page 0."""
        cfg, dev = self.cfg, self.device
        if length > cfg.max_seq_len or length % page:
            raise ValueError(
                f"kv_page={page} must divide the cache length {length} "
                f"(<= max_seq_len={cfg.max_seq_len})"
            )
        if kv_quant not in ("", "int8"):
            raise ValueError(f"kv_quant={kv_quant!r}: expected '' or 'int8'")
        quant = kv_quant == "int8"
        dtype = torch.int8 if quant else cfg.dtype
        table = torch.zeros(batch, length // page, dtype=torch.long,
                            device=dev)

        def scale():
            if not quant:
                return None
            return torch.zeros(n_pages, page, dtype=torch.float32, device=dev)

        return [
            PagedLatentCache(
                ckv=torch.zeros(n_pages, page, cfg.kv_lora_rank, dtype=dtype,
                                device=dev),
                kpe=torch.zeros(n_pages, page, cfg.qk_rope_head_dim,
                                dtype=dtype, device=dev),
                seg=torch.zeros(n_pages, page, dtype=torch.int32,
                                device=dev),
                table=table,
                index=torch.zeros(batch, dtype=torch.long, device=dev),
                ckv_scale=scale(),
                kpe_scale=scale(),
            )
            for _ in range(cfg.n_layers)
        ]


DEEPSEEK_CONFIGS: dict[str, DeepseekConfig] = {
    # Test-scale config (parity tests).
    "deepseek_tiny": DeepseekConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        d_ff=128,
        max_seq_len=128,
        remat=False,
    ),
    # The same with the compressed-q path (V2-236B style).
    "deepseek_tiny_qlora": DeepseekConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        q_lora_rank=24,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        d_ff=128,
        max_seq_len=128,
        remat=False,
    ),
    # MoE test preset: 4 routed experts top-2 + 1 shared, every layer MoE.
    "deepseek_moe_tiny": DeepseekConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        d_ff=128,
        n_routed_experts=4,
        experts_per_token=2,
        moe_d_ff=48,
        n_shared_experts=1,
        capacity_factor=4.0,
        max_seq_len=128,
        remat=False,
    ),
    # V2-Lite's attention at full width (HF deepseek-ai/DeepSeek-V2-Lite:
    # d_model 2048, 16 heads, kv_lora 512, head dims 128/64/128) with a
    # dense SwiGLU FFN of 6144: the MLA bench shape, not checkpoint
    # compatible with V2-Lite (whose FFN is MoE and rope yarn).
    "deepseek_mla_bench": DeepseekConfig(
        vocab_size=32_768,
        d_model=2048,
        n_layers=10,
        n_heads=16,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        d_ff=6144,
        max_seq_len=4096,
        attention_backend="flash",
    ),
}
