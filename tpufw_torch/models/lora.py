"""LoRA utilities (port of ``tpufw.models.lora``): adapter names, the
adapters' initial draw, and the merge of trained adapters into the base.

An adapter pair of a weight ``w`` lives beside it in the state dict as
``w_lora_a`` and ``w_lora_b``: a projection's (``llama.Projection``) are
``<module>.weight_lora_a`` [r, in] and ``<module>.weight_lora_b`` [out,
r], an expert stack's (``mixtral.MoEMLP``) are ``<moe>.w_gate_lora_a``
[E, r, in] and ``<moe>.w_gate_lora_b`` [E, out, r]. The weight's delta is
``(B @ A) * alpha / rank`` in either layout, ``[out, in]`` or ``[E, out,
in]``. A model built with ``lora_rank > 0`` freezes every other parameter
(``requires_grad=False``), so the optimizer, which takes the parameters
that need gradients, updates the adapters alone.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

_A, _B = "_lora_a", "_lora_b"
# Xored into the model's seed: the adapters' stream is apart from the
# base's, so a LoRA model's base is the rank-0 model's of the same seed.
_ADAPTER_STREAM = 0x4C6F5241


def is_lora_name(name: str) -> bool:
    """True for a state-dict key (or parameter name) of an adapter: its
    last component ends in ``_lora_a`` or ``_lora_b``."""
    last = name.rsplit(".", 1)[-1]
    return last.endswith(_A) or last.endswith(_B)


def lora_axes(logical: tuple) -> dict:
    """{suffix: logical axes} of the adapters of a weight whose logical
    axes are ``logical`` (``(*lead, out, in)``, PyTorch's layout): A
    ``(*lead, "lora", in)``, B ``(*lead, out, "lora")``, as ``tpufw``'s
    ``lora_delta`` names them in its transposed layout."""
    if len(logical) < 2:
        return {}
    *lead, out, inp = logical
    return {_A: (*lead, "lora", inp), _B: (*lead, out, "lora")}


def has_lora(state_dict) -> bool:
    """True when a state dict (or any iterable of keys) holds an adapter."""
    return any(is_lora_name(k) for k in state_dict)


def adapter_pairs(state_dict) -> dict[str, tuple[str, str]]:
    """{base key: (A key, B key)} of every adapter pair in ``state_dict``;
    ValueError for half a pair or a pair without its weight."""
    pairs = {}
    for k in state_dict:
        if k.endswith(_A):
            base = k[: -len(_A)]
            if base + _B not in state_dict or base not in state_dict:
                raise ValueError(
                    f"adapter {k} has no {base + _B} or no weight {base}")
            pairs[base] = (k, base + _B)
        elif k.endswith(_B) and k[: -len(_B)] + _A not in state_dict:
            raise ValueError(f"adapter {k} has no {k[: -len(_B)] + _A}")
    return pairs


@torch.no_grad()
def init_adapters(model: nn.Module, seed: int, device=None) -> None:
    """Draw every adapter of ``model`` afresh on ``device`` (default: the
    model's): each A from N(0, 1/fan_in) (fan_in its last dim, the
    projection's input width) with a generator seeded ``seed`` xor
    ``_ADAPTER_STREAM``, in module order, and every B zero, so the model's
    output equals its base's. A parameter still on the meta device is
    replaced by a real one."""
    dev = torch.device(device) if device is not None else model.device
    gen = torch.Generator(device=dev).manual_seed(seed ^ _ADAPTER_STREAM)
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not is_lora_name(name):
                continue
            t = torch.empty(p.shape, dtype=p.dtype, device=dev)
            if name.endswith(_A):
                t.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
            else:
                t.zero_()
            setattr(mod, name, nn.Parameter(t))


def freeze_base(model: nn.Module) -> None:
    """``requires_grad=False`` on every parameter that is not an
    adapter."""
    for name, p in model.named_parameters():
        if not is_lora_name(name):
            p.requires_grad_(False)


@contextlib.contextmanager
def adapters_bypassed(model: nn.Module):
    """Within the block, ``model`` computes its base alone: every module
    with adapters (``lora_scale`` set) skips their product. The frozen
    base of a LoRA model is the reference policy of DPO and GRPO; at
    step 0 (B zero) it equals the adapted model bit for bit."""
    mods = [m for m in model.modules()
            if getattr(m, "lora_scale", None) is not None]
    scales = [m.lora_scale for m in mods]
    for m in mods:
        m.lora_scale = None
    try:
        yield model
    finally:
        for m, s in zip(mods, scales):
            m.lora_scale = s


@torch.no_grad()
def merge_lora(
    state_dict: dict, rank: Optional[int] = None, *, alpha: float
) -> dict:
    """Fold every adapter pair into its weight, ``w += (B @ A) * alpha /
    rank`` computed in fp32 and cast to ``w``'s dtype, and drop the
    adapters: the state dict of the rank-0 model (``lora_rank=0``), which
    serving, ``quantize_params`` and ``export_hf`` take. Other tensors are
    passed through, not copied.

    ``rank`` is read from the adapters (A's rank dim); one that is passed
    must equal it. ``alpha`` is required: it is not recoverable from the
    shapes, and a wrong one mis-scales every merged weight. A state dict
    with no adapters raises ValueError."""
    pairs = adapter_pairs(state_dict)
    if not pairs:
        raise ValueError("merge_lora: no *_lora_a/_lora_b adapters found")
    ranks = {state_dict[a].shape[-2] for a, _ in pairs.values()}
    if len(ranks) != 1:
        raise ValueError(
            f"merge_lora: adapters of several ranks {sorted(ranks)}")
    actual = ranks.pop()
    if rank is not None and rank != actual:
        raise ValueError(
            f"merge_lora: rank={rank} but the adapters were trained at "
            f"rank {actual}; merging would mis-scale every weight")
    scale = alpha / actual
    out = {}
    for k, v in state_dict.items():
        if is_lora_name(k):
            continue
        if k in pairs:
            a, b = (state_dict[n].float() for n in pairs[k])
            # B @ A: [out, r] @ [r, in], or per expert [E, out, r] @ [E, r, in].
            v = v + (torch.matmul(b, a) * scale).to(v.dtype)
        out[k] = v
    return out
