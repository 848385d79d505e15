"""Weight bridge: a Flax ``decoder_lm`` param tree -> a ``Llama``,
``Mixtral``, ``Gemma`` or ``Deepseek`` state dict (``params_from_flax``),
and a Flax ViT or ResNet tree -> a ``ViT`` or ``ResNet`` state dict
(``vision_params_from_flax``).

Layout facts of the JAX package it handles:

- the scanned trunk keeps its blocks under ``layers`` with a leading [L]
  axis on every leaf (``nn.scan``); an unscanned trunk uses ``layer_{i}``;
- ``DenseGeneral`` kernels are [in, *out] (q is [D, H, hd], o is
  [H, hd, D]); PyTorch weights are [out, in];
- ``lm_head`` is [D, V] and absent when the embedding is tied (Gemma);
- RMSNorm weights are stored under ``scale`` (Gemma's as offsets from 1,
  which the port's offset norms store the same way);
- Gemma scans (local, global) PAIRS: ``layers`` holds ``local`` and
  ``global`` blocks stacked over the L/2 pairs, ``layer_{p}`` holds pair
  p unscanned; pair p is the port's layers 2p and 2p + 1. Its blocks have
  four norms (``pre_attn_norm``, ``post_attn_norm``, ``pre_mlp_norm``,
  ``post_mlp_norm``) where Llama's have two;
- DeepSeek's MLA block holds ``q`` [D, H, qk] (or ``q_a`` [D, r],
  ``q_a_norm`` and ``q_b`` [r, H, qk]), ``kv_a`` [D, kvr + rope],
  ``kv_a_norm``, ``o`` [H, v, D] and the RAW ``kv_b_kernel`` [kvr, H,
  nope + v], a plain array that is copied as it is (not a
  ``DenseGeneral``, so not transposed);
- Mixtral's block holds ``moe_norm`` and ``moe``: ``router`` (a
  ``DenseGeneral`` [D, E]) and the RAW expert stacks ``w_gate``/``w_up``
  [E, D, F] and ``w_down`` [E, F, D], which become the port's [E, out, in]
  (each expert transposed);
- DeepSeek's MoE block holds ``mlp_norm`` and ``moe``: ``routed`` (a
  Mixtral ``moe``: router and expert stacks) and ``shared`` (a SwiGLU
  ``gate``/``up``/``down``), the port's ``moe.routed`` and ``moe.shared``;
  a tree with leading dense layers is unscanned;
- a tree from ``tpufw.ops.quant.quantize_params`` holds, for each
  projection and the untied ``lm_head``, ``{"q_kernel" [in, *out] int8,
  "scale" [*out]}`` (plus the Qwen ``bias``); it becomes the port's int8
  [out, in] ``weight`` and [out] ``scale`` (``quantized_weights=True``).
  An int8 expert stack is ``{"q_kernel" [E, in, out], "scale" [E, out]}``
  and becomes ``weight`` [E, out, in] and ``scale`` [E, out].

- LoRA adapters: a projection's ``{name}_lora_a`` kernel [*in, r] and
  ``{name}_lora_b`` kernel [r, *out] beside it become the port's
  ``weight_lora_a`` [r, in] and ``weight_lora_b`` [out, r] (the in and
  out dims flattened as the base kernel's are); a Mixtral stack's raw
  ``{w}_lora_a`` [E, in, r] and ``{w}_lora_b`` [E, r, out] become
  ``{w}_lora_a`` [E, r, in] and ``{w}_lora_b`` [E, out, r].

A tensor- or expert-parallel gang starts from ``tpufw``'s weights the
same way: each rank loads the whole state dict (``params_from_flax``'s)
and keeps its (``expert``, ``tensor``) coordinate's shards of it
(``Trainer.init_state``, ``parallel.tensor.cut_model``).

Pipeline trees (``tpufw.parallel.pipeline``'s functional params):
``pipeline_params_from_jax`` takes one as it is (the port keeps its
layout: stage stacks ``[S, lps, ...]`` or, interleaved, ``[v, S, lpc,
...]``, kernels ``[in, *out]``); ``pipeline_params_from_flax`` restacks a
scanned Llama-family or DeepSeek tree into one (the mapping of
``tests/test_pipeline_mla.py``'s ``_flax_to_pipeline``).

The input is a nested dict of numpy arrays (``jax.device_get`` of the
params, or of a gradient tree of the same shape). Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# Projections a block may hold (Llama/Gemma: q, k, v, o; MLA: q or q_a and
# q_b, kv_a, o).
_PROJ = {
    "attn": ("q", "k", "v", "o", "q_a", "q_b", "kv_a"),
    "mlp": ("gate", "up", "down"),
}


def _t(x) -> torch.Tensor:
    """int8 stays int8; every float leaf becomes fp32."""
    x = np.asarray(x)
    dtype = np.int8 if x.dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def _kernel(kernel: np.ndarray, name: str) -> torch.Tensor:
    """[in, *out] (or [*in, out] for o) -> [out, in]."""
    k = np.asarray(kernel)
    if name == "o":  # [H, hd, D]
        k = k.reshape(-1, k.shape[-1])
    else:  # [D, ...out]
        k = k.reshape(k.shape[0], -1)
    return _t(k.T)


_NORMS = ("attn_norm", "mlp_norm", "moe_norm", "pre_attn_norm",
          "post_attn_norm", "pre_mlp_norm", "post_mlp_norm")
_EXPERTS = ("w_gate", "w_up", "w_down")
_ATTN_NORMS = ("q_a_norm", "kv_a_norm")  # MLA's latent norms


def _block(tree: dict, prefix: str, out: dict) -> None:
    for norm in _NORMS:
        if norm in tree:
            out[f"{prefix}.{norm}.weight"] = _t(tree[norm]["scale"])
    attn = tree["attn"]
    for norm in _ATTN_NORMS:
        if norm in attn:
            out[f"{prefix}.attn.{norm}.weight"] = _t(attn[norm]["scale"])
    if "kv_b_kernel" in attn:
        out[f"{prefix}.attn.kv_b_kernel"] = _t(attn["kv_b_kernel"])
    if "moe" in tree and "routed" in tree["moe"]:
        _moe(tree["moe"]["routed"], f"{prefix}.moe.routed", out)
        if "shared" in tree["moe"]:
            _block_projs(tree["moe"], f"{prefix}.moe",
                         {"shared": _PROJ["mlp"]}, out)
    elif "moe" in tree:
        _moe(tree["moe"], f"{prefix}.moe", out)
    _block_projs(tree, prefix, _PROJ, out)


def _block_projs(tree: dict, prefix: str, projs: dict, out: dict) -> None:
    """The projections ``projs`` ({module: names}) of ``tree``."""
    for mod, names in projs.items():
        for name in names:
            if name not in tree.get(mod, {}):
                continue
            leaf = tree[mod][name]
            key = f"{prefix}.{mod}.{name}"
            if "q_kernel" in leaf:
                out[f"{key}.weight"] = _kernel(leaf["q_kernel"], name)
                out[f"{key}.scale"] = _t(np.asarray(leaf["scale"]).reshape(-1))
            else:
                out[f"{key}.weight"] = _kernel(leaf["kernel"], name)
            if "bias" in leaf:
                out[f"{key}.bias"] = _t(
                    np.asarray(leaf["bias"]).reshape(-1)
                )
            a, b = tree[mod].get(name + "_lora_a"), tree[mod].get(
                name + "_lora_b")
            if a is not None:
                # A [*in, r] -> [r, in]; B [r, *out] -> [out, r].
                a, b = np.asarray(a["kernel"]), np.asarray(b["kernel"])
                out[f"{key}.weight_lora_a"] = _t(a.reshape(-1, a.shape[-1]).T)
                out[f"{key}.weight_lora_b"] = _t(b.reshape(b.shape[0], -1).T)


def _moe(tree: dict, prefix: str, out: dict) -> None:
    """Mixtral's router and expert stacks ([E, in, out] -> [E, out, in])."""
    out[f"{prefix}.router.weight"] = _kernel(tree["router"]["kernel"], "router")
    for name in _EXPERTS:
        leaf = tree[name]
        if isinstance(leaf, dict):
            out[f"{prefix}.{name}.weight"] = _t(
                np.swapaxes(np.asarray(leaf["q_kernel"]), -1, -2))
            out[f"{prefix}.{name}.scale"] = _t(leaf["scale"])
        else:
            out[f"{prefix}.{name}"] = _t(np.swapaxes(np.asarray(leaf), -1, -2))
        for suffix in ("_lora_a", "_lora_b"):
            if name + suffix in tree:  # [E, in, r] / [E, r, out], swapped
                out[f"{prefix}.{name}{suffix}"] = _t(
                    np.swapaxes(np.asarray(tree[name + suffix]), -1, -2))


def _blocks(tree: dict, cfg):
    """(port layer index, Flax block tree) for every layer: a scanned or
    unscanned trunk of blocks, or of Gemma's (local, global) pairs."""
    scanned = "layers" in tree
    first = tree["layers"] if scanned else tree.get("layer_0", {})
    if "local" in first:
        for p in range(cfg.n_layers // 2):
            pair = _slice(tree["layers"], p) if scanned else tree[f"layer_{p}"]
            yield 2 * p, pair["local"]
            yield 2 * p + 1, pair["global"]
        return
    for i in range(cfg.n_layers):
        yield i, _slice(tree["layers"], i) if scanned else tree[f"layer_{i}"]


def params_from_flax(tree: dict, cfg) -> dict[str, torch.Tensor]:
    """State dict for ``tpufw_torch.models.Llama(cfg)`` (or ``Mixtral``,
    ``Gemma`` or ``Deepseek``) from a Flax tree."""
    out = {"embed": _t(tree["embed"]["embedding"])}
    for i, block in _blocks(tree, cfg):
        _block(block, f"layers.{i}", out)
    out["final_norm.weight"] = _t(tree["final_norm"]["scale"])
    head = tree.get("lm_head")
    if head is not None and "q_kernel" in head:
        out["lm_head.weight"] = _t(np.asarray(head["q_kernel"]).T)
        out["lm_head.scale"] = _t(head["scale"])
    elif head is not None:
        out["lm_head"] = _t(np.asarray(head["kernel"]).T)
    elif not cfg.tie_embeddings:
        raise KeyError("untied config but the Flax tree has no lm_head")
    return out


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _vision_leaves(tree: dict, prefix: str, out: dict) -> None:
    """A Flax vision module tree: a kernel [in, out] becomes a [out, in]
    weight (HWIO convs OIHW), a norm's ``scale`` its ``weight``; biases,
    ``cls_token`` and ``pos_embed`` as they are."""
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if not isinstance(node, dict):
            out[key] = _t(node)
        elif "kernel" in node:
            k = np.asarray(node["kernel"])
            out[f"{key}.weight"] = _t(
                k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
            if "bias" in node:
                out[f"{key}.bias"] = _t(node["bias"])
        elif "scale" in node:
            out[f"{key}.weight"] = _t(node["scale"])
            out[f"{key}.bias"] = _t(node["bias"])
        else:
            _vision_leaves(node, f"{key}.", out)


def vision_params_from_flax(params: dict, cfg,
                            batch_stats: dict | None = None
                            ) -> dict[str, torch.Tensor]:
    """State dict for ``tpufw_torch.models.ViT(cfg)`` or ``ResNet(cfg)``
    from a Flax ``params`` tree (ViT's blocks scanned under ``blocks``
    with a leading [L] axis, or unscanned as ``block{i}``) and, for a
    ResNet, its ``batch_stats`` (each BN's ``mean``/``var`` become its
    ``running_mean``/``running_var``)."""
    tree = dict(params)
    if "blocks" in tree:  # the scanned ViT stack
        stack = tree.pop("blocks")
        for i in range(cfg.n_layers):
            tree[f"block{i}"] = _slice(stack, i)
    blocks = {k: tree.pop(k) for k in list(tree)
              if k.startswith("block") and k[5:].isdigit()}
    out = {}
    _vision_leaves(tree, "", out)
    for name, block in blocks.items():
        _vision_leaves(block, f"blocks.{name[5:]}.", out)

    def stats(node, prefix):
        for name, v in node.items():
            if "mean" in v:
                out[f"{prefix}{name}.running_mean"] = _t(v["mean"])
                out[f"{prefix}{name}.running_var"] = _t(v["var"])
            else:
                stats(v, f"{prefix}{name}.")

    stats(batch_stats or {}, "")
    return out


def pipeline_params_from_jax(tree: dict, device=None) -> dict:
    """``tpufw``'s pipeline param (or gradient) tree, canonical or
    interleaved, as the port's: the same nested dict and layout, each
    leaf an fp32 tensor on ``device`` (default the CPU)."""
    if isinstance(tree, dict):
        return {k: pipeline_params_from_jax(v, device) for k, v in tree.items()}
    t = _t(tree)
    return t if device is None else t.to(device)


def pipeline_params_from_flax(tree: dict, cfg, n_stages: int) -> dict:
    """A scanned Flax ``decoder_lm`` tree of a Llama-family or DeepSeek
    (MLA, dense or uniform-MoE) config restacked into pipeline params:
    each ``[L, ...]`` leaf split into ``[n_stages, L / n_stages, ...]``,
    kernels kept ``[in, *out]``; exact, so a parity test pins the
    pipeline's block math to the model of record."""
    lps = cfg.n_layers // n_stages
    layers = tree["layers"]

    def stack(leaf):
        a = np.asarray(leaf)
        return _t(a.reshape(n_stages, lps, *a.shape[1:]))

    attn = layers["attn"]
    stages = {"attn_norm": stack(layers["attn_norm"]["scale"]),
              "mlp_norm": stack(layers["mlp_norm"]["scale"]),
              "wo": stack(attn["o"]["kernel"])}
    if "kv_b_kernel" in attn:
        stages |= {"kv_a_norm": stack(attn["kv_a_norm"]["scale"]),
                   "wkv_a": stack(attn["kv_a"]["kernel"]),
                   "wkv_b": stack(attn["kv_b_kernel"])}
        if "q" in attn:
            stages["wq"] = stack(attn["q"]["kernel"])
        else:
            stages |= {"wq_a": stack(attn["q_a"]["kernel"]),
                       "q_a_norm": stack(attn["q_a_norm"]["scale"]),
                       "wq_b": stack(attn["q_b"]["kernel"])}
    else:
        for name in ("q", "k", "v"):
            stages[f"w{name}"] = stack(attn[name]["kernel"])
            if "bias" in attn[name]:
                stages[f"b{name}"] = stack(attn[name]["bias"])
    if "moe" in layers:
        moe = layers["moe"]
        routed = moe["routed"]
        stages |= {"router": stack(routed["router"]["kernel"]),
                   **{w: stack(routed[w]) for w in _EXPERTS}}
        if "shared" in moe:
            stages |= {f"w_shared_{n}": stack(moe["shared"][n]["kernel"])
                       for n in ("gate", "up", "down")}
    else:
        stages |= {f"w_{n}": stack(layers["mlp"][n]["kernel"])
                   for n in ("gate", "up", "down")}
    out = {"embed": _t(tree["embed"]["embedding"]), "stages": stages,
           "final_norm": _t(tree["final_norm"]["scale"])}
    if "lm_head" in tree:
        out["head"] = _t(tree["lm_head"]["kernel"])
    return out
