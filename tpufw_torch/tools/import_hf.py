"""HuggingFace checkpoints in and out of the port (port of
``tpufw.tools.import_hf``) for its four families: Llama (with Mistral's
window, Qwen-2's q/k/v biases and ``llama3``/``linear`` rope scaling),
Mixtral, Gemma-2 and DeepSeek-V2 (MLA with and without ``q_lora_rank``,
yarn rope, the dense FFN or the MoE FFN with leading dense layers).

HF ``nn.Linear`` weights and the port's are both [out, in], so the mapping
is a renaming; the one reshape is DeepSeek's ``kv_b_proj`` [H·(nope+v),
kv_lora_rank], which the port keeps raw as ``kv_b_kernel`` [kv_lora_rank,
H, nope+v] (``tpufw_torch.interop``). A Mixtral expert stack [E, out, in]
is E HF experts (``block_sparse_moe.experts.e.w1``/``w3``/``w2`` for the
gate, up and down stacks), copied one by one into their slices; the
router is ``block_sparse_moe.gate``. DeepSeek's routed stacks are
``mlp.experts.e.{gate,up,down}_proj``, its router ``mlp.gate`` and its
shared experts ``mlp.shared_experts.*``. An imported Mixtral or DeepSeek
MoE routes dropless (capacity factor = E), as HF's dense top-k gather
does. Gemma's norms are offsets from 1 on
both sides. The target shape and dtype of every tensor come from the model
built on the meta device, so norms stay fp32 as the port keeps them.

A checkpoint directory is read through ``tpufw_torch.io.safetensors``:
mapped views, each tensor moved to the device in its stored dtype and cast
there, so an 8B bf16 import never holds an fp32 copy on the host.

    python -m tpufw_torch.tools.import_hf HF_DIR --out PARAMS_DIR
    python -m tpufw_torch.tools.import_hf SRC --out HF_DIR --export MODEL

The first writes bare params (``train.checkpoint.save_params``: the port's
state dict as safetensors plus its config), which ``TPUFW_INIT_FROM`` and
``TPUFW_PARAMS_CHECKPOINT`` read; the second writes an HF directory from
bare params or a training checkpoint of the preset MODEL.

Refused, as ``tpufw`` refuses them: an unmerged LoRA tree (ValueError:
``tools.merge_lora`` folds the adapters in first), rope
``dynamic``/``longrope``, and DeepSeek
routing other than greedy or group-limited greedy softmax over every
layer from ``first_k_dense_replace`` on, which neither package
implements.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from tpufw_torch.io.safetensors import MAX_SHARD_BYTES, open_dir, save_sharded
from tpufw_torch.models import (
    DeepseekConfig,
    GemmaConfig,
    LlamaConfig,
    MixtralConfig,
    RopeScaling,
    model_for_config,
)
from tpufw_torch.models.deepseek import YarnScaling
from tpufw_torch.models.lora import has_lora


def _getter(obj):
    if isinstance(obj, Mapping):
        return obj.get
    return lambda k, d=None: getattr(obj, k, d)


def _rope_scaling_from_hf(rs: Any) -> Optional[RopeScaling]:
    """HF ``rope_scaling`` -> RopeScaling: ``llama3`` and ``linear``.
    ``dynamic`` (NTK, a function of the runtime length) and ``longrope``
    (learned per-dimension factors) are refused: dropping them would
    import a model whose logits drift with position."""
    if not rs:
        return None
    get = _getter(rs)
    rtype = get("rope_type") or get("type")
    if rtype == "linear":
        return RopeScaling(factor=float(get("factor")), rope_type="linear")
    if rtype != "llama3":
        raise NotImplementedError(
            f"rope_scaling rope_type={rtype!r} is not implemented in "
            "tpufw or tpufw_torch ('llama3' and 'linear' are; 'dynamic' "
            "scales with the runtime sequence length, 'longrope' needs "
            "learned per-dim vectors); importing would silently change "
            "rotary frequencies"
        )
    return RopeScaling(
        factor=float(get("factor")),
        low_freq_factor=float(get("low_freq_factor")),
        high_freq_factor=float(get("high_freq_factor")),
        original_max_position_embeddings=int(
            get("original_max_position_embeddings")),
    )


def config_from_hf(hf_config: Any):
    """The port's config of a transformers config (object or dict):
    ``LlamaConfig`` for llama/mistral/qwen2, ``MixtralConfig`` for mixtral
    (dropless: capacity factor = the expert count), ``GemmaConfig`` for
    gemma2, ``DeepseekConfig`` for deepseek_v2 (a MoE one dropless and,
    with leading dense layers, unscanned, as ``tpufw`` imports it)."""
    get = _getter(hf_config)
    mtype = get("model_type")
    if mtype == "gemma2":
        return _gemma_config_from_hf(get)
    if mtype == "deepseek_v2":
        return _deepseek_config_from_hf(get)
    is_qwen2 = mtype == "qwen2"
    # Mistral and Mixtral: one window on every layer (None when the
    # checkpoint disables it, as Mistral v0.2+ and Mixtral do).
    is_mistral = mtype in ("mistral", "mixtral")
    if is_qwen2 and get("use_sliding_window"):
        raise NotImplementedError(
            "Qwen2 import: use_sliding_window=True (layer-windowed "
            "attention) is not implemented")
    unsupported = {
        "attention_bias": lambda v: bool(v) and not is_qwen2,
        "mlp_bias": bool,
        "hidden_act": lambda v: v not in (None, "silu"),
        "sliding_window": lambda v: bool(v) and not (is_qwen2 or is_mistral),
    }
    bad = {k: get(k) for k, is_bad in unsupported.items() if is_bad(get(k))}
    if bad:
        raise NotImplementedError(
            f"HF config uses features the port's Llama doesn't implement: "
            f"{bad}; importing would silently change the model's math")
    d_model = get("hidden_size")
    n_heads = get("num_attention_heads")
    moe = {}
    cls = LlamaConfig
    if mtype == "mixtral":
        cls = MixtralConfig
        moe = dict(n_experts=get("num_local_experts"),
                   experts_per_token=get("num_experts_per_tok"),
                   capacity_factor=float(get("num_local_experts")))
    return cls(
        **moe,
        rope_scaling=_rope_scaling_from_hf(get("rope_scaling")),
        vocab_size=get("vocab_size"),
        d_model=d_model,
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=get("num_key_value_heads") or n_heads,
        head_dim=get("head_dim") or d_model // n_heads,
        d_ff=get("intermediate_size"),
        rope_theta=float(get("rope_theta") or 10_000.0),
        rms_eps=float(get("rms_norm_eps") or 1e-5),
        max_seq_len=get("max_position_embeddings") or 8192,
        tie_embeddings=bool(get("tie_word_embeddings") or False),
        attention_qkv_bias=is_qwen2,
        sliding_window=get("sliding_window") if is_mistral else None,
    )


def _gemma_config_from_hf(get) -> GemmaConfig:
    act = get("hidden_activation") or get("hidden_act")
    if act not in (None, "gelu_pytorch_tanh"):
        raise NotImplementedError(
            f"Gemma2 import supports gelu_pytorch_tanh only, got {act!r}")
    if bool(get("attention_bias")):
        raise NotImplementedError(
            "Gemma2 import does not implement attention_bias=True")
    if not (get("tie_word_embeddings") is None
            or bool(get("tie_word_embeddings"))):
        raise NotImplementedError(
            "Gemma2 import assumes tied embeddings (all released Gemma-2 "
            "checkpoints tie them)")
    d_model = get("hidden_size")
    n_heads = get("num_attention_heads")
    head_dim = get("head_dim") or d_model // n_heads
    return GemmaConfig(
        vocab_size=get("vocab_size"),
        d_model=d_model,
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=get("num_key_value_heads") or n_heads,
        head_dim=head_dim,
        d_ff=get("intermediate_size"),
        rope_theta=float(get("rope_theta") or 10_000.0),
        rms_eps=float(get("rms_norm_eps") or 1e-6),
        max_seq_len=get("max_position_embeddings") or 8192,
        tie_embeddings=True,
        attn_logit_soft_cap=get("attn_logit_softcapping"),
        final_logit_soft_cap=get("final_logit_softcapping"),
        sliding_window=get("sliding_window"),
        query_pre_attn_scalar=float(
            get("query_pre_attn_scalar") or head_dim),
    )


def _deepseek_moe_from_hf(get, n_layers: int, bad: dict) -> dict:
    """The MoE fields of a DeepseekConfig (empty for a dense FFN), as
    ``tpufw`` imports them; unsupported routing goes into ``bad``."""
    # Layers >= first_k_dense_replace run the MoE FFN; an all-dense
    # checkpoint sets it past the last layer.
    first_moe = get("first_k_dense_replace") or 0
    if not get("n_routed_experts") or first_moe >= n_layers:
        return {}
    e, k = get("n_routed_experts"), get("num_experts_per_tok")
    group = {}
    topk_method = get("topk_method") or "greedy"
    if topk_method == "group_limited_greedy":
        ng, tg = get("n_group"), get("topk_group")
        if ng and tg and e % ng == 0 and (tg >= ng or k <= tg * (e // ng)):
            group = dict(n_group=int(ng), topk_group=int(tg))
        else:
            bad["group_limited_greedy"] = {
                "n_group": ng, "topk_group": tg, "n_routed_experts": e,
                "num_experts_per_tok": k}
    elif topk_method != "greedy":
        bad["topk_method"] = topk_method
    if (get("scoring_func") or "softmax") != "softmax":
        bad["scoring_func"] = get("scoring_func")
    if (get("moe_layer_freq") or 1) != 1:
        bad["moe_layer_freq"] = get("moe_layer_freq")
    return dict(
        n_routed_experts=e,
        experts_per_token=k,
        moe_d_ff=get("moe_intermediate_size"),
        n_shared_experts=get("n_shared_experts") or 0,
        first_k_dense=first_moe,
        routed_scaling_factor=float(get("routed_scaling_factor") or 1.0),
        # HF stores norm_topk_prob but its DeepseekV2 gate never applies
        # it: the raw softmax mass is what runs.
        norm_topk_prob=False,
        # Dropless, as HF routes.
        capacity_factor=float(e),
        # tpufw cannot scan a mixed dense/MoE stack.
        scan_layers=first_moe == 0,
        **group,
    )


def _deepseek_config_from_hf(get) -> DeepseekConfig:
    n_layers = get("num_hidden_layers")
    bad = {}
    moe = _deepseek_moe_from_hf(get, n_layers, bad)
    yarn = None
    rs = get("rope_scaling")
    if rs:
        rs_get = _getter(rs)
        if (rs_get("rope_type") or rs_get("type")) != "yarn":
            bad["rope_scaling"] = rs
        else:
            yarn = YarnScaling(
                factor=float(rs_get("factor")),
                original_max_position_embeddings=int(
                    rs_get("original_max_position_embeddings")
                    or get("max_position_embeddings") or 4096),
                beta_fast=float(rs_get("beta_fast") or 32),
                beta_slow=float(rs_get("beta_slow") or 1),
                # Unset stays falsy: the attention factor's ratio branch
                # needs both mscales.
                mscale=float(rs_get("mscale") or 0.0),
                mscale_all_dim=float(rs_get("mscale_all_dim") or 0.0),
                attention_factor=rs_get("attention_factor"),
                truncate=bool(True if rs_get("truncate") is None
                              else rs_get("truncate")),
            )
    if get("attention_bias"):
        bad["attention_bias"] = get("attention_bias")
    if get("hidden_act") not in (None, "silu"):
        bad["hidden_act"] = get("hidden_act")
    if bad:
        raise NotImplementedError(
            f"DeepseekV2 import: unsupported features {bad}; the port's MLA "
            "implements default and yarn rope, no attention bias, silu, and "
            "greedy or group-limited greedy softmax routing on every layer "
            "from first_k_dense_replace on")
    return DeepseekConfig(
        vocab_size=get("vocab_size"),
        d_model=get("hidden_size"),
        n_layers=n_layers,
        n_heads=get("num_attention_heads"),
        q_lora_rank=get("q_lora_rank"),
        kv_lora_rank=get("kv_lora_rank"),
        qk_nope_head_dim=get("qk_nope_head_dim"),
        qk_rope_head_dim=get("qk_rope_head_dim"),
        v_head_dim=get("v_head_dim"),
        d_ff=get("intermediate_size"),
        rope_theta=float(get("rope_theta") or 10_000.0),
        rms_eps=float(get("rms_norm_eps") or 1e-6),
        max_seq_len=get("max_position_embeddings") or 4096,
        tie_embeddings=bool(get("tie_word_embeddings") or False),
        rope_scaling=yarn,
        **moe,
    )


# Port key -> HF key (without the "model." prefix), by pattern.
_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj",
         "q_a": "q_a_proj", "q_b": "q_b_proj", "kv_a": "kv_a_proj_with_mqa"}
_NORMS = {"attn_norm": "input_layernorm",
          "mlp_norm": "post_attention_layernorm",
          "moe_norm": "post_attention_layernorm",
          "pre_attn_norm": "input_layernorm",
          "post_attn_norm": "post_attention_layernorm",
          "pre_mlp_norm": "pre_feedforward_layernorm",
          "post_mlp_norm": "post_feedforward_layernorm"}
_TOP = {"embed": "embed_tokens.weight", "final_norm.weight": "norm.weight",
        "lm_head": "lm_head.weight"}
_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")
# Mixtral expert stack -> the HF name of each expert's weight.
_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}
_EXPERT_KEY = re.compile(r"^layers\.(\d+)\.moe\.(w_gate|w_up|w_down)$")
# DeepSeek's routed stacks: expert e's weights are
# ``mlp.experts.e.{gate,up,down}_proj``.
_ROUTED_KEY = re.compile(
    r"^layers\.(\d+)\.moe\.routed\.w_(gate|up|down)$")


def hf_key(port_key: str) -> str:
    """The HF name (no ``model.`` prefix) of a port state-dict key."""
    if port_key in _TOP:
        return _TOP[port_key]
    m = _LAYER.match(port_key)
    if m is None:
        raise KeyError(f"no HF name for {port_key!r}")
    i, rest = m.groups()
    parts = rest.split(".")
    if parts[0] in _NORMS and parts[1:] == ["weight"]:
        return f"layers.{i}.{_NORMS[parts[0]]}.weight"
    if parts[0] == "attn":
        if parts[1] in _PROJ and parts[2] in ("weight", "bias"):
            return f"layers.{i}.self_attn.{_PROJ[parts[1]]}.{parts[2]}"
        if parts[1] in ("q_a_norm", "kv_a_norm"):
            return f"layers.{i}.self_attn.{parts[1][:-5]}_layernorm.weight"
        if parts[1] == "kv_b_kernel":
            return f"layers.{i}.self_attn.kv_b_proj.weight"
    if parts[0] == "mlp" and parts[2:] == ["weight"]:
        return f"layers.{i}.mlp.{parts[1]}_proj.weight"
    if parts == ["moe", "router", "weight"]:
        return f"layers.{i}.block_sparse_moe.gate.weight"
    if parts == ["moe", "routed", "router", "weight"]:
        return f"layers.{i}.mlp.gate.weight"
    if parts[:2] == ["moe", "shared"] and parts[3:] == ["weight"]:
        return f"layers.{i}.mlp.shared_experts.{parts[2]}_proj.weight"
    raise KeyError(f"no HF name for {port_key!r}")


def expert_keys(port_key: str, n_experts: int) -> Optional[list[str]]:
    """The HF names (no ``model.`` prefix) of the experts of a Mixtral or
    DeepSeek expert-stack key, in stack order; None for any other key."""
    m = _ROUTED_KEY.match(port_key)
    if m is not None:
        i, proj = m.groups()
        return [f"layers.{i}.mlp.experts.{e}.{proj}_proj.weight"
                for e in range(n_experts)]
    m = _EXPERT_KEY.match(port_key)
    if m is None:
        return None
    i, name = m.groups()
    return [f"layers.{i}.block_sparse_moe.experts.{e}.{_EXPERTS[name]}.weight"
            for e in range(n_experts)]


def _is_kv_b(port_key: str) -> bool:
    return port_key.endswith(".attn.kv_b_kernel")


def _meta_state(cfg, dtype=None) -> dict[str, torch.Tensor]:
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return model_for_config(cfg, device="meta").state_dict()


def _source_tensors(source) -> Mapping[str, Any]:
    """{HF key without "model.": tensor, array or a lazy getter}."""
    if isinstance(source, (str, os.PathLike)):
        files = open_dir(source)
        return {k.removeprefix("model."): (lambda k=k, f=f: f.get(k))
                for k, f in files.items()}
    sd = source.state_dict() if hasattr(source, "state_dict") else source
    return {k.removeprefix("model."): v for k, v in dict(sd).items()}


def from_hf(source: Any, cfg, dtype: Optional[torch.dtype] = None,
            device=None) -> dict[str, torch.Tensor]:
    """The port's state dict of ``cfg`` from HF weights: a checkpoint
    directory (``*.safetensors``), a transformers model or a state dict
    (tensors or numpy arrays). ``dtype`` (default ``cfg.param_dtype``) is
    the projections' and embeddings'; norms stay as the model keeps them.
    Each tensor goes to ``device`` (default CPU) in its stored dtype and
    is cast there."""
    src = _source_tensors(source)
    dev = torch.device("cpu" if device is None else device)

    def fetch(name, key):
        if name not in src:
            raise KeyError(
                f"HF checkpoint is missing {name!r} (for {key!r}; have "
                f"{sorted(src)[:6]}...); not a {type(cfg).__name__} "
                "state dict?")
        t = src[name]
        t = t() if callable(t) else t
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.detach()

    out = {}
    for key, want in _meta_state(cfg, dtype).items():
        experts = expert_keys(key, getattr(cfg, "n_experts", 0))
        if experts is not None:
            # One expert at a time into its slice of the stack.
            stack = torch.empty(want.shape, dtype=want.dtype, device=dev)
            for e, name in enumerate(experts):
                t = fetch(name, key)
                if tuple(t.shape) != tuple(want.shape[1:]):
                    raise ValueError(
                        f"{name}: shape {tuple(t.shape)}, the config wants "
                        f"{tuple(want.shape[1:])} for {key}[{e}]")
                stack[e].copy_(t)
            out[key] = stack
            continue
        name = hf_key(key)
        t = fetch(name, key).to(dev)
        if _is_kv_b(key):
            t = t.t().reshape(want.shape)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, the config wants "
                f"{tuple(want.shape)} for {key}")
        # A tensor that came through to the CPU unchanged shares the
        # source's memory (an HF model's parameter, a mapped file): own it.
        shared = dev.type == "cpu" and t.dtype == want.dtype
        t = t.to(want.dtype)
        out[key] = t.clone() if shared else t.contiguous()
    return out


def to_hf(state_dict: Mapping[str, torch.Tensor], cfg
          ) -> dict[str, torch.Tensor]:
    """Inverse of ``from_hf``: HF-keyed tensors (``model.`` prefix, dtype
    and device kept) of the port's state dict."""
    if has_lora(state_dict):
        # The emitters read only base weights: an unmerged LoRA tree
        # would ship the frozen base and drop the whole fine-tune.
        raise ValueError(
            "to_hf/export_hf on a LoRA tree: run "
            "tpufw_torch.tools.merge_lora first (adapters must fold into "
            "the kernels they modify)")
    if isinstance(cfg, GemmaConfig) and not cfg.tie_embeddings:
        raise NotImplementedError(
            "Gemma export assumes tied embeddings (every released Gemma-2 "
            "checkpoint ties them)")
    want = _meta_state(cfg)
    extra = sorted(state_dict.keys() - want.keys())
    missing = sorted(want.keys() - state_dict.keys())
    if extra or missing:
        raise ValueError(
            f"to_hf: not a {type(cfg).__name__} state dict (unexpected "
            f"{extra[:4]}, missing {missing[:4]}); quantized state dicts "
            "do not export")
    out = {}
    for key in want:
        t = state_dict[key].detach()
        experts = expert_keys(key, getattr(cfg, "n_experts", 0))
        if experts is not None:
            out.update({"model." + name: t[e]
                        for e, name in enumerate(experts)})
            continue
        if _is_kv_b(key):
            t = t.reshape(t.shape[0], -1).t()
        name = hf_key(key)
        out[name if name == "lm_head.weight" else "model." + name] = t
    return out


def hf_config_dict(cfg, torch_dtype: str = "float32") -> dict:
    """The transformers config.json of a port config."""
    if isinstance(cfg, DeepseekConfig):
        out = {
            "model_type": "deepseek_v2",
            "architectures": ["DeepseekV2ForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.d_model,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_heads,
            "q_lora_rank": cfg.q_lora_rank,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            # transformers sizes its rotary from head_dim: MLA's rope slice.
            "head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim,
            "intermediate_size": cfg.d_ff,
            "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "attention_bias": False,
            "hidden_act": "silu",
            "torch_dtype": torch_dtype,
            # Layers below first_k_dense_replace are dense: past the last
            # layer for a dense FFN everywhere.
            "first_k_dense_replace": (
                cfg.first_k_dense if cfg.moe else cfg.n_layers),
        }
        if cfg.moe:
            out.update(
                n_routed_experts=cfg.n_routed_experts,
                num_experts_per_tok=cfg.experts_per_token,
                moe_intermediate_size=cfg.moe_d_ff,
                n_shared_experts=cfg.n_shared_experts or None,
                routed_scaling_factor=cfg.routed_scaling_factor,
                norm_topk_prob=False,
                scoring_func="softmax",
                moe_layer_freq=1,
                **({"topk_method": "group_limited_greedy",
                    "n_group": cfg.n_group, "topk_group": cfg.topk_group}
                   if cfg.n_group else {"topk_method": "greedy"}),
            )
        ys = cfg.rope_scaling
        if ys is not None:
            out["rope_scaling"] = {
                "rope_type": "yarn",
                "factor": ys.factor,
                "original_max_position_embeddings":
                    ys.original_max_position_embeddings,
                "beta_fast": ys.beta_fast,
                "beta_slow": ys.beta_slow,
                **({"mscale": ys.mscale} if ys.mscale else {}),
                **({"mscale_all_dim": ys.mscale_all_dim}
                   if ys.mscale_all_dim else {}),
                **({"attention_factor": ys.attention_factor}
                   if ys.attention_factor is not None else {}),
                **({} if ys.truncate else {"truncate": False}),
            }
        return out
    out = {
        "model_type": "llama",
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.d_ff,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": False,
        "mlp_bias": False,
        "hidden_act": "silu",
        "torch_dtype": torch_dtype,
    }
    rs = getattr(cfg, "rope_scaling", None)
    if rs is not None:
        out["rope_scaling"] = (
            {"rope_type": "linear", "factor": rs.factor}
            if rs.rope_type == "linear" else
            {"rope_type": "llama3", "factor": rs.factor,
             "low_freq_factor": rs.low_freq_factor,
             "high_freq_factor": rs.high_freq_factor,
             "original_max_position_embeddings":
                 rs.original_max_position_embeddings})
    if isinstance(cfg, MixtralConfig):
        if cfg.attention_qkv_bias:
            raise NotImplementedError(
                "export of a Mixtral config with attention_qkv_bias: no HF "
                "architecture has MoE with q/k/v biases")
        out.update(model_type="mixtral", architectures=["MixtralForCausalLM"],
                   num_local_experts=cfg.n_experts,
                   num_experts_per_tok=cfg.experts_per_token,
                   sliding_window=cfg.sliding_window)
        out.pop("mlp_bias")
        return out
    if isinstance(cfg, GemmaConfig):
        out.update(
            model_type="gemma2",
            architectures=["Gemma2ForCausalLM"],
            hidden_activation="gelu_pytorch_tanh",
            attn_logit_softcapping=cfg.attn_logit_soft_cap,
            final_logit_softcapping=cfg.final_logit_soft_cap,
            sliding_window=cfg.sliding_window,
            query_pre_attn_scalar=cfg.query_pre_attn_scalar,
            tie_word_embeddings=True,
        )
        out.pop("mlp_bias")
        out.pop("hidden_act")
        return out
    if cfg.attention_qkv_bias:
        if cfg.sliding_window:
            raise NotImplementedError(
                "export of qkv-bias + sliding_window is not implemented (the "
                "qwen2 config would say use_sliding_window=False)")
        if cfg.head_dim != cfg.d_model // cfg.n_heads:
            raise NotImplementedError(
                f"Qwen2 export requires head_dim == d_model//n_heads "
                f"({cfg.d_model // cfg.n_heads}), got {cfg.head_dim}")
        out.update(model_type="qwen2", architectures=["Qwen2ForCausalLM"],
                   use_sliding_window=False)
        for k in ("attention_bias", "mlp_bias", "head_dim"):
            out.pop(k)
    elif cfg.sliding_window:
        out.update(model_type="mistral", architectures=["MistralForCausalLM"],
                   sliding_window=cfg.sliding_window)
        out.pop("mlp_bias")
    return out


def export_hf(state_dict: Mapping[str, torch.Tensor], cfg, out_dir: str,
              max_shard_bytes: int = MAX_SHARD_BYTES) -> dict:
    """Write an HF checkpoint directory (config.json and safetensors,
    sharded past ``max_shard_bytes``) that ``from_pretrained`` loads;
    tensors keep their dtype and are copied off the device one by one."""
    # Map before touching the filesystem: a refusal leaves no directory.
    sd = to_hf(state_dict, cfg)
    dtype = str(sd["model.embed_tokens.weight"].dtype).removeprefix("torch.")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg, dtype), f, indent=2)
    files = save_sharded(sd, out_dir, max_shard_bytes)
    return {"out": out_dir, "files": files, "n_tensors": len(sd),
            "n_params": int(sum(t.numel() for t in sd.values())),
            "bytes": int(sum(t.numel() * t.element_size()
                             for t in sd.values()))}


def _params_of(src: str, cfg) -> dict[str, torch.Tensor]:
    """The model state dict at ``src``: bare params, or a training
    checkpoint (a step directory or its directory's latest step)."""
    from tpufw_torch.train.checkpoint import (
        PARAMS_CONFIG,
        checkpoint_model_state,
        load_params,
    )

    if os.path.isfile(os.path.join(src, PARAMS_CONFIG)):
        return load_params(src, cfg)[1]
    return checkpoint_model_state(src, cfg)


def main(argv=None) -> int:
    """HF directory -> bare params; with ``--export MODEL``, bare params
    or a training checkpoint of the preset MODEL -> HF directory."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpufw_torch.tools.import_hf",
        description="HF checkpoint <-> tpufw_torch bare params",
    )
    ap.add_argument("src", help="HF checkpoint dir (config.json + "
                    "*.safetensors); with --export, bare params or a "
                    "training checkpoint dir")
    ap.add_argument("--out", required=True, help="output dir")
    ap.add_argument("--export", metavar="MODEL", default=None,
                    help="reverse direction; MODEL names the preset")
    args = ap.parse_args(argv)

    if args.export:
        from tpufw_torch.configs import resolve_model_preset

        cfg = resolve_model_preset(args.export)
        info = export_hf(_params_of(os.path.abspath(args.src), cfg), cfg,
                         args.out)
        print(json.dumps(info))
        return 0

    from tpufw_torch.train.checkpoint import save_params

    with open(os.path.join(args.src, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    sd = from_hf(args.src, cfg)
    save_params(args.out, sd, cfg)
    print(json.dumps({"out": args.out,
                      "n_params": int(sum(t.numel() for t in sd.values()))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
