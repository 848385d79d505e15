"""Weight-only int8 quantization for serving (port of ``tpufw.ops.quant``).

Decode streams every weight once per generated token, so storing the
projection weights as int8 plus one fp32 scale per output channel halves
the bytes a step must read against bf16. The product itself runs in the
activation dtype: the int8 codes are cast, multiplied, and the scale is
applied to the product (exact for per-output-channel scales).

Scope, as in the JAX package: the attention q/k/v/o (MLA's q or q_a/q_b,
kv_a and o) and MLP gate/up/down weights of every block, the expert stacks
(Mixtral's, DeepSeek's routed ones) and DeepSeek's shared-expert MLP, and
the untied LM head. Embeddings and norms stay in floating point, and so do
the Qwen q/k/v biases, the routers and MLA's raw ``kv_b_kernel`` (small,
and the absorbed decode contracts its halves separately).

Layout is PyTorch's: a weight is [out, in], so its scale is [out] and is
reduced over dim 1; an expert stack is [E, out, in], its scale [E, out]. The rounding rule is ``jnp.round``'s, half to even,
which ``torch.round`` shares, so the codes equal the JAX package's.
"""

from __future__ import annotations

import re

import torch

#: State-dict keys of the projection weights that are quantized.
_PROJ_KEY = re.compile(
    r"^layers\.\d+\.(attn\.(q|k|v|o|q_a|q_b|kv_a)"
    r"|(mlp|moe\.shared)\.(gate|up|down))\.weight$"
)
#: State-dict keys of the expert stacks ([E, out, in]: Mixtral's
#: ``moe.w_*``, DeepSeek's routed ``moe.routed.w_*``).
_EXPERT_KEY = re.compile(
    r"^layers\.\d+\.moe\.(routed\.)?(w_gate|w_up|w_down)$")


def quantize_kernel(w: torch.Tensor, in_axes: tuple) -> dict:
    """fp weight -> {"q_kernel" int8, "scale" fp32}: symmetric scales per
    output channel, reduced over ``in_axes`` (the scale keeps the other
    dims), amax / 127 + 1e-12 in the weight's dtype, then fp32, as
    ``tpufw.ops.quant`` computes it."""
    amax = w.abs().amax(dim=in_axes)
    scale = (amax / 127.0 + 1e-12).float()
    bshape = list(w.shape)
    for ax in in_axes:
        bshape[ax] = 1
    q = torch.clamp(torch.round(w / scale.reshape(bshape)), -127, 127)
    return {"q_kernel": q.to(torch.int8), "scale": scale}


def quantize_entry(key: str, val: torch.Tensor):
    """The int8 twin's entries for state-dict entry ``key``: {``<p>.weight``
    codes, ``<p>.scale``} for a projection weight (``<p>`` its module), an
    expert stack (``<p>`` the stack's name) or the untied ``lm_head``;
    None for a tensor that stays as it is."""
    if _PROJ_KEY.match(key):
        prefix = key[: -len(".weight")]
    elif _EXPERT_KEY.match(key) or key == "lm_head":
        prefix = key
    else:
        return None
    q = quantize_kernel(val, (val.ndim - 1,))
    return {f"{prefix}.weight": q["q_kernel"], f"{prefix}.scale": q["scale"]}


def quantize_params(state_dict: dict) -> dict:
    """A ``Llama`` (``Mixtral``, ``Gemma``, ``Deepseek``) state dict -> the
    state dict of its int8 twin (``quantized_weights=True``): each
    projection's ``weight`` becomes int8 codes [out, in] with a ``scale``
    [out] beside it, each expert stack ``w`` becomes ``w.weight`` [E, out,
    in] and ``w.scale`` [E, out], and the untied ``lm_head`` becomes
    ``lm_head.weight`` / ``lm_head.scale``. Other tensors are passed
    through, not copied. A state dict with LoRA adapters raises: merge
    them first (``models.lora.merge_lora``)."""
    from tpufw_torch.models.lora import has_lora

    if has_lora(state_dict):
        raise ValueError(
            "quantize_params on a LoRA tree: run merge_lora first "
            "(adapters must fold into the kernels they modify)"
        )
    out = {}
    hit = 0
    for key, val in state_dict.items():
        q = quantize_entry(key, val)
        if q is None:
            out[key] = val
        else:
            out.update(q)
            hit += 1
    if not hit:
        raise ValueError(
            "quantize_params: no projection weights found (expected "
            "layers.N.attn.{q,k,v,o,q_a,q_b,kv_a}.weight, "
            "layers.N.{mlp,moe.shared}.{gate,up,down}.weight, "
            "layers.N.moe[.routed].{w_gate,w_up,w_down} or lm_head)"
        )
    return out


def quantize_kv(kv: torch.Tensor, n_feat: int = 1) -> tuple:
    """Per-token symmetric int8 quantization for KV-cache appends: the
    trailing ``n_feat`` dims are quantized together, every leading dim
    keeps its own fp32 scale. Returns (q int8, scale)."""
    dims = tuple(range(kv.ndim - n_feat, kv.ndim))
    x = kv.float()
    scale = x.abs().amax(dim=dims) / 127.0 + 1e-12
    bshape = scale.shape + (1,) * n_feat
    q = torch.clamp(torch.round(x / scale.reshape(bshape)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Inverse of ``quantize_kv``: codes times broadcast scales in fp32,
    cast to ``dtype`` at the end."""
    n_feat = q.ndim - scale.ndim
    bshape = scale.shape + (1,) * n_feat
    return (q.float() * scale.reshape(bshape)).to(dtype)


def quant_contract(
    x: torch.Tensor, q_weight: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """x · dequant(W)ᵀ for an int8 [out, in] weight: the codes are cast to
    x's dtype, contracted with x's last dim, and the product is scaled per
    output channel in x's dtype."""
    y = torch.nn.functional.linear(x, q_weight.to(x.dtype))
    return y * scale.to(x.dtype)
