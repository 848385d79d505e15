"""Analytic per-device memory estimate for a training or decode config
(port of ``tpufw.tools.estimate_memory``, the same arithmetic on the port's
model configs).

Params + optimizer + gradient + activations (per remat policy) + logits/CE
+ KV-cache bytes, divided over the mesh the way the trainer shards them,
against the card's memory. First-order: the caching allocator's blocks,
temporaries and fragmentation add real variance, so the point is choosing
a starting batch size and remat policy (and the tuner's pre-pruning,
``tpufw_torch.tune.space``), not replacing a measured ladder.

    python -m tpufw_torch.tools.estimate_memory --model llama3_8b \\
        --batch 16 --seq 2048 --fsdp 16

``--chip`` takes ``utils.hardware.CHIP_SPECS`` (``h100_sxm``, the
default, or ``h100_pcie``) or ``auto`` (the current CUDA device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional


def _bytes(dtype) -> int:
    """Itemsize of a torch dtype or its name (``"bfloat16"``)."""
    import torch

    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _attn_geometry(cfg) -> tuple[float, float]:
    """(per-token attention projection terms, cached floats per token).

    MHA/GQA: q + o-input (H*dh each) + k + v (K*dh each); cache = 2*K*dh.
    MLA (DeepSeek): q [H*(dn+dr)], the packed latent [kvr+dr], the
    expanded k/v [H*(dn+dv)], o-input [H*dv]; cache = the latent kvr +
    dr."""
    if hasattr(cfg, "kv_lora_rank"):
        h = cfg.n_heads
        dn, dr, dv = (
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        )
        terms = (
            h * (dn + dr)            # q
            + cfg.kv_lora_rank + dr  # packed latent
            + h * (dn + dv)          # expanded k_nope + v
            + h * dv                 # o input
        )
        if getattr(cfg, "q_lora_rank", None):
            terms += cfg.q_lora_rank
        return float(terms), float(cfg.kv_lora_rank + dr)
    h_dh = cfg.n_heads * cfg.head_dim
    kv_dh = cfg.n_kv_heads * cfg.head_dim
    return float(2 * h_dh + 2 * kv_dh), float(2 * kv_dh)


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """Per-device byte totals (floats are bytes; names say what)."""

    params: float
    optimizer: float
    gradients: float
    activations: float
    logits_ce: float
    kv_cache: float

    def total(self) -> float:
        return (
            self.params + self.optimizer + self.gradients
            + self.activations + self.logits_ce + self.kv_cache
        )

    def as_dict(self) -> dict:
        d = {k: round(v / 2**30, 3)
             for k, v in dataclasses.asdict(self).items()}
        d["total_gib"] = round(self.total() / 2**30, 3)
        return d


def estimate_train(
    cfg,
    batch_size: int,
    seq_len: int,
    n_shards: int = 1,
    remat_policy: Optional[str] = None,
    loss_chunk_size: Optional[int] = None,
    adam_mu_dtype: Optional[str] = None,
    grad_accum: int = 1,
) -> MemoryEstimate:
    """Training-step footprint per device (the tuner's pruning oracle).

    ``n_shards`` is the param/optimizer sharding degree (``fsdp``); batch
    rows shard over the same data x fsdp product, and ``grad_accum`` > 1
    divides them further (one microbatch's activations live at a time) at
    the cost of an fp32 gradient accumulator. Params in
    ``cfg.param_dtype``; Adam mu (``adam_mu_dtype`` or fp32) + nu (fp32);
    one gradient tree; activations: each layer's saved block input, plus
    by policy ("dots": every projection output; "attn_out": one saved
    [rows, T, D] a layer beside one recomputed block; "nothing": one
    block; "everything": "dots" plus the [H, T, T] scores); logits/CE:
    [B, chunk, V] fp32 chunks, or [B, T-1, V]."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    p_bytes = _bytes(cfg.param_dtype)
    a_bytes = _bytes(cfg.dtype)
    n_params = cfg.n_params()
    params = n_params * p_bytes / n_shards
    mu_bytes = _bytes(adam_mu_dtype or "float32")
    optimizer = n_params * (mu_bytes + 4) / n_shards
    gradients = n_params * p_bytes / n_shards
    if grad_accum > 1:
        gradients += n_params * 4 / n_shards

    rows = batch_size / max(n_shards, 1) / grad_accum
    t = seq_len
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    attn_terms, _ = _attn_geometry(cfg)
    policy = remat_policy or getattr(cfg, "remat_policy", "dots")

    boundary = l * rows * t * d * a_bytes  # saved block inputs
    g_tokens = rows * t
    mlp_terms = 3 * f  # gate, up, down-input (dense MLP)
    moe_terms = 0.0
    if getattr(cfg, "n_experts", 0):
        # Capacity dispatch: the expert buffers replace the dense MLP, and
        # the dispatch/combine tensors are [G, E, C] = cf * k * G^2
        # elements each.
        k = cfg.experts_per_token
        cf = cfg.capacity_factor
        f_e = getattr(cfg, "moe_d_ff", f)
        mlp_terms = cf * k * (d + 2 * f_e)
        n_shared = getattr(cfg, "n_shared_experts", 0)
        if n_shared:
            mlp_terms += 3 * n_shared * f_e
        moe_terms = 2 * cf * k * g_tokens
    per_layer_dots = g_tokens * (
        attn_terms + mlp_terms + moe_terms + 2 * d  # + two norm outputs
    ) * a_bytes
    if policy == "nothing":
        live = per_layer_dots
    elif policy == "attn_out":
        live = per_layer_dots + l * g_tokens * d * a_bytes
    elif policy == "dots":
        live = l * per_layer_dots
    elif policy == "everything":
        live = l * (per_layer_dots + rows * cfg.n_heads * t * t * a_bytes)
    else:
        raise ValueError(
            f"unknown remat_policy {policy!r}; choose from "
            "dots|nothing|attn_out|everything"
        )
    activations = boundary + live

    v = cfg.vocab_size
    if loss_chunk_size:
        logits_ce = 2 * rows * min(loss_chunk_size, t) * v * 4
    else:
        logits_ce = 2 * rows * (t - 1) * v * 4

    return MemoryEstimate(
        params=params, optimizer=optimizer, gradients=gradients,
        activations=activations, logits_ce=logits_ce, kv_cache=0.0,
    )


def estimate_decode(
    cfg,
    batch_size: int,
    cache_len: Optional[int] = None,
    weights_dtype: Optional[str] = None,
    n_shards: int = 1,
) -> MemoryEstimate:
    """Serving footprint per device: weights (cast per ``weights_dtype``,
    the ``TPUFW_DECODE_DTYPE`` lever) + the KV cache [B, cache_len] in
    ``cfg.dtype`` over every layer (MLA: the latent), both divided by
    ``n_shards``."""
    w_bytes = _bytes(weights_dtype or cfg.param_dtype)
    a_bytes = _bytes(cfg.dtype)
    s = cache_len or cfg.max_seq_len
    _, kv_per_token = _attn_geometry(cfg)
    kv = cfg.n_layers * batch_size * s * kv_per_token * a_bytes
    return MemoryEstimate(
        params=cfg.n_params() * w_bytes / n_shards,
        optimizer=0.0,
        gradients=0.0,
        activations=0.0,
        logits_ce=batch_size * cfg.vocab_size * 4 / n_shards,
        kv_cache=kv / n_shards,
    )


def main(argv=None) -> int:
    from tpufw_torch.configs import BENCH_CONFIG_NAME, bench_model_config
    from tpufw_torch.models import PRESETS
    from tpufw_torch.utils.hardware import CHIP_SPECS

    presets = {**PRESETS, BENCH_CONFIG_NAME: bench_model_config()}
    chips = sorted(k for k in CHIP_SPECS if k != "cpu")
    ap = argparse.ArgumentParser(
        prog="tpufw_torch.tools.estimate_memory",
        description="Analytic per-device memory estimate (training or "
        "decode)",
    )
    ap.add_argument("--model", required=True,
                    help=f"one of {sorted(presets)}")
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq", type=int, default=None, help="train seq len")
    ap.add_argument("--fsdp", type=int, default=1, help="param shards")
    ap.add_argument("--remat", default=None,
                    choices=["dots", "nothing", "attn_out", "everything"])
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--adam-mu-dtype", default=None)
    ap.add_argument("--decode", action="store_true",
                    help="serving estimate instead of training")
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--decode-dtype", default=None,
                    help="weights dtype at decode (TPUFW_DECODE_DTYPE)")
    ap.add_argument("--chip", default="h100_sxm",
                    help=f"card to compare against: one of {chips}, or "
                    "'auto' (the current CUDA device)")
    args = ap.parse_args(argv)
    if args.model not in presets:
        ap.error(f"unknown --model {args.model!r}")
    if args.chip != "auto" and args.chip not in chips:
        ap.error(f"unknown --chip {args.chip!r}; choose from {chips} or "
                 "'auto'")
    cfg = presets[args.model]
    if args.decode:
        est = estimate_decode(cfg, args.batch, args.cache_len,
                              args.decode_dtype, n_shards=args.fsdp)
    else:
        est = estimate_train(
            cfg, args.batch, args.seq or cfg.max_seq_len,
            n_shards=args.fsdp, remat_policy=args.remat,
            loss_chunk_size=args.ce_chunk,
            adam_mu_dtype=args.adam_mu_dtype, grad_accum=args.grad_accum,
        )
    if args.chip == "auto":
        from tpufw_torch.utils.hardware import detect_chip

        chip = detect_chip("cuda")
    else:
        chip = CHIP_SPECS[args.chip]
    print(json.dumps({
        "model": args.model,
        "mode": "decode" if args.decode else "train",
        **est.as_dict(),
        "chip": chip.name,
        "chip_hbm_gib": round(chip.hbm_bytes / 2**30, 1),
        "fits": est.total() < chip.hbm_bytes,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
