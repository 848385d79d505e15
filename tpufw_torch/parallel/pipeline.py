"""Pipeline parallelism: the GPipe schedule over a pipe of stages (port of
``tpufw.parallel.pipeline``).

The layer stack is split into S stages; microbatches stream through them,
activations handed from stage s to s + 1 by the pipe group
(``parallel.group``): a ``LocalPipeGroup`` holds every stage in one
process (the tests, one card), a ``ProcessPipeGroup`` one stage per rank
of a ``DeviceMesh``'s ``pipe`` dimension (``batch_isend_irecv`` to the
neighbours). GPipe runs the ticks of every microbatch's forward and
differentiates through them with autograd, the hand-off's gradient being
the reverse send. Bubble fraction (S - 1) / (M + S - 1). The 1F1B,
zero-bubble and interleaved schedules (``pipeline_1f1b``,
``pipeline_zb1``, ``pipeline_interleaved``) run the same stage math with
a manual backward.

Parameters are ``tpufw``'s functional pipeline tree, its leaves torch
tensors: ``embed`` [V, D], ``stages`` (stacks [S, layers_per_stage, ...],
or [v, S, layers_per_chunk, ...] for the interleaved schedule; Gemma's
``local``/``global`` pairs), ``final_norm`` and, untied, ``head`` [D, V].
A process holds the stage axis of the stages it holds (all S on a
``LocalPipeGroup``, its own on a ``ProcessPipeGroup``: ``stage_slice``);
``embed``, ``final_norm`` and ``head`` are whole on every rank, their
gradients summed over the gang. Stage stacks are not sharded over
``data`` or ``fsdp``, as in ``tpufw``: those ranks are batch shards.

Tensor and expert parallelism inside a stage (``tpufw``'s pp x tp x ep):
the registered ``TensorGroup``/``ExpertGroup`` (``parallel.context``)
split each stage leaf as ``leaf_split`` says (Megatron's heads and
``d_ff`` over ``tensor``, the routed experts over ``expert``). The block
math is written once over the shards a process holds, as the models'
is: a replicated activation ``enter``s the split projections, each held
shard computes its heads or columns, and the row-parallel exits
``reduce`` (two reductions a block; a MoE layer's routed experts one
over both axes, its router replicated). Replicated leaves (norms, MLA's
latent projections, the router) thus get whole gradients on every rank,
in GPipe's autograd and in the manual schedules' per-stage
``autograd.grad`` alike, since the collectives sit inside the stage's
graph. A process group's rank holds its shards (``stage_slice``); a
local group holds the whole stacks and slices them per shard. The
embedding and the head are never split (``tpufw`` keeps them outside
its pipeline region).

The block math is ``tpufw``'s (``_block``, ``_mla_block``,
``_mla_moe_block``, ``_mixtral_block``, ``_gemma_block``) on the port's
ops: ``ops.multi_head_attention`` (the flash kernels with
``attention_backend="flash"``), ``ops.rms_norm``, ``models.llama.
apply_rope``, ``models.deepseek.apply_rope_interleaved``,
``ops.moe.route_topk_capacity`` and ``ops.loss``.

A divergence by design: ``tpufw`` runs every stage on every tick, bubble
ticks on clipped copies of a real microbatch whose results it masks out;
the port runs a stage only on its real ticks. Outputs, gradients and the
MoE router loss (which ``tpufw`` counts on real ticks only) are the same,
and the flash kernels launch once per layer per real tick.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpufw_torch.models.deepseek import DeepseekConfig, apply_rope_interleaved
from tpufw_torch.models.gemma import GemmaConfig
from tpufw_torch.models.llama import LlamaConfig, apply_rope
from tpufw_torch.models.mixtral import MixtralConfig
from tpufw_torch.ops import multi_head_attention, rms_norm
from tpufw_torch.ops.attention import tanh_soft_cap
from tpufw_torch.ops.moe import expert_capacity, route_topk_capacity
from tpufw_torch.parallel.context import expert_group, tensor_group
from tpufw_torch.parallel.group import (
    LocalPipeGroup,
    PipeGroup,
    enter_all,
    grad_share,
    reduce_all,
)

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb1")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline schedule hyperparameters on top of a model config.

    ``schedule``: "gpipe" (autograd through the microbatch stream; Llama,
    Gemma, Mixtral, dense and MoE MLA), "1f1b" (one forward one backward,
    activations O(n_stages), ``pipeline_1f1b``), "interleaved" (1F1B over
    ``n_virtual`` chunks a stage, ``pipeline_interleaved``) or "zb1" (the
    backward split into input- and weight-gradient phases,
    ``pipeline_zb1``); the last three implement the Llama family and
    dense MLA. ``n_virtual`` is the interleaved schedule's chunks per
    stage; its stacks are ``[v, S, layers_per_chunk, ...]``."""

    n_stages: int
    n_microbatches: int
    schedule: str = "gpipe"
    n_virtual: int = 1

    @property
    def virtual_layout(self) -> bool:
        """True when stage stacks carry the leading [n_virtual] axis."""
        return self.schedule == "interleaved"

    def validate(self, model, batch_size: int) -> None:
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown pipeline schedule {self.schedule!r}; "
                "expected 'gpipe', '1f1b', 'interleaved', or 'zb1'"
            )
        _check_model_split(model, self.n_stages)
        if batch_size % self.n_microbatches:
            raise ValueError(
                f"batch {batch_size} not divisible by "
                f"{self.n_microbatches} microbatches"
            )
        if self.schedule == "interleaved":
            v, s = self.n_virtual, self.n_stages
            if v < 2:
                raise ValueError(
                    "schedule='interleaved' needs n_virtual >= 2 "
                    "(v == 1 is exactly the '1f1b' schedule)"
                )
            if model.n_layers % (v * s):
                raise ValueError(
                    f"n_layers={model.n_layers} not divisible by "
                    f"n_virtual*n_stages={v * s} model chunks"
                )
            if self.n_microbatches % s:
                raise ValueError(
                    f"interleaved schedule groups microbatches by "
                    f"stage count: n_microbatches="
                    f"{self.n_microbatches} % n_stages={s} != 0"
                )
        elif self.n_virtual != 1:
            raise ValueError(
                f"n_virtual={self.n_virtual} only applies to "
                "schedule='interleaved'"
            )

    def bubble_fraction(self) -> float:
        """Analytic bubble fraction: GPipe/1F1B (S-1)/(M+S-1);
        interleaved (S-1)/(vM+S-1); ZB-H1 (S-1)/(3M+S-1)."""
        s, m = self.n_stages, self.n_microbatches
        if self.schedule == "interleaved":
            return (s - 1) / (self.n_virtual * m + s - 1)
        if self.schedule == "zb1":
            return (s - 1) / (3 * m + s - 1)
        return (s - 1) / (m + s - 1)

    def n_ticks(self) -> int:
        """Ticks per train step: GPipe's forward and backward sweeps of
        M+S-1 each; 1F1B's M+2(S-1); interleaved vM+(v+1)S-2; ZB-H1's
        M+3(S-1)."""
        s, m = self.n_stages, self.n_microbatches
        if self.schedule == "gpipe":
            return 2 * (m + s - 1)
        if self.schedule == "interleaved":
            v = self.n_virtual
            return v * m + (v + 1) * s - 2
        if self.schedule == "zb1":
            return m + 3 * (s - 1)
        return m + 2 * (s - 1)


# ----------------------------------------------------------------------
# Families and checks
# ----------------------------------------------------------------------


def _is_moe(cfg) -> bool:
    return isinstance(cfg, MixtralConfig)


def _is_gemma(cfg) -> bool:
    return isinstance(cfg, GemmaConfig)


def _is_mla(cfg) -> bool:
    return isinstance(cfg, DeepseekConfig)


def _returns_aux(cfg) -> bool:
    """Mixtral and MoE-FFN DeepSeek: the forward returns a router loss."""
    return _is_moe(cfg) or (_is_mla(cfg) and cfg.moe)


def _check_model_split(cfg, n_stages: int) -> None:
    """``tpufw``'s model-side checks, shared by ``PipelineConfig.validate``
    and ``init_pipeline_params``; and the MoE dispatch, which a pipeline
    runs only one way."""
    if not (isinstance(cfg, LlamaConfig) or _is_gemma(cfg) or _is_mla(cfg)):
        raise NotImplementedError(
            f"pipeline schedules implement Llama-family, Gemma, and "
            f"DeepSeek-MLA blocks; got {type(cfg).__name__}"
        )
    if _is_mla(cfg) and cfg.moe and cfg.first_k_dense > 0:
        raise NotImplementedError(
            "pipelined MLA-MoE stages need UNIFORM layers "
            f"(first_k_dense == 0, got {cfg.first_k_dense}); mixed "
            "dense/MoE stacks use the plain Trainer"
        )
    if not getattr(cfg, "causal", True):
        raise NotImplementedError(
            "pipeline schedules implement causal attention only; "
            "bidirectional (causal=False) embedding fine-tuning uses "
            "the plain Trainer (tpufw_torch.train.contrastive)"
        )
    if _is_moe(cfg) and getattr(cfg, "attention_qkv_bias", False):
        raise NotImplementedError(
            "pipelined MoE blocks do not implement attention_qkv_bias"
        )
    if _returns_aux(cfg) and getattr(cfg, "moe_dispatch", "einsum") != "einsum":
        # tpufw's pipeline runs the capacity router whatever the config
        # says; the port refuses instead of training another dispatch.
        raise NotImplementedError(
            f"moe_dispatch={cfg.moe_dispatch!r}: pipelined MoE stages route "
            "with the capacity (einsum) dispatch only; unset "
            "TPUFW_MOE_DISPATCH or set it to 'einsum'"
        )
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by {n_stages} stages"
        )
    if _is_gemma(cfg) and (cfg.n_layers // n_stages) % 2:
        raise ValueError(
            f"Gemma pipelines scan local/global PAIRS: layers per "
            f"stage ({cfg.n_layers}/{n_stages}) must be even"
        )


def check_group(pipe: PipelineConfig, group: PipeGroup) -> None:
    """The pipe group must have ``pipe.n_stages`` stages (``tpufw``'s
    mesh check: a differently sized pipe drops or duplicates stages)."""
    if group.size != pipe.n_stages:
        raise ValueError(
            f"PipelineConfig.n_stages={pipe.n_stages} but mesh pipe axis "
            f"has size {group.size}"
        )


def check_split(cfg) -> None:
    """``tpufw``'s checks of the registered tensor and expert groups
    (``parallel.context``) against ``cfg``, with its messages: ``tensor``
    must divide the heads (and, but for MLA, the KV heads) and the MLP
    width (``moe_d_ff`` for MLA-MoE, which also covers the shared
    experts'); an ``expert`` axis needs a MoE model whose experts it
    divides."""
    tp, ep = tensor_group().size, expert_group().size
    if ep > 1:
        if not _returns_aux(cfg):
            raise NotImplementedError(
                f"mesh expert axis has size {ep} but {type(cfg).__name__}"
                " has no experts to shard over it")
        if cfg.n_experts % ep:
            raise ValueError(
                f"mesh expert={ep} must divide n_experts="
                f"{cfg.n_experts} for pipelined expert parallelism")
    if tp > 1:
        checks = [("n_heads", cfg.n_heads)]
        if _is_mla(cfg) and cfg.moe:
            checks.append(("moe_d_ff", cfg.moe_d_ff))
        else:
            checks.append(("d_ff", cfg.d_ff))
        if not _is_mla(cfg):
            checks.append(("n_kv_heads", cfg.n_kv_heads))
        for name, v in checks:
            if v % tp:
                raise ValueError(
                    f"mesh tensor={tp} must divide {name}={v} "
                    "for pipelined tensor parallelism")


# ----------------------------------------------------------------------
# Parameter trees
# ----------------------------------------------------------------------

#: The Megatron split of each stage-stack leaf over ``tensor`` (``tpufw``'s
#: ``_TENSOR_LEAF_AXIS``), its axis counted from the end so one table
#: covers every layout: q/k/v (and Qwen's biases, MLA's ``wq_b`` and
#: ``wkv_b``) on their head axis, o on its input heads, gate/up (the
#: dense, routed and shared experts') on their ``d_ff`` columns, down on
#: its ``d_ff`` rows. MLA's latent down-projections (``wq_a``, ``wkv_a``)
#: and every norm stay replicated: the latents are shared by the heads.
_TENSOR_LEAF_AXIS = {
    "wq": -2, "wk": -2, "wv": -2, "wo": -3,
    "bq": -2, "bk": -2, "bv": -2,
    "w_gate": -1, "w_up": -1, "w_down": -2,
    "wq_b": -2, "wkv_b": -2,
    "w_shared_gate": -1, "w_shared_up": -1, "w_shared_down": -2,
}

#: The routed expert stacks (rank 5, [S, lps, E, in, out]; never in the
#: interleaved layout) split their [E] axis over ``expert``.
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def leaf_split(path: str, ndim: int, virtual: bool = False) -> tuple:
    """((mesh axis, dim), ...) of a stage-stack leaf at ``path`` (its
    name is the last part) of rank ``ndim``: the expert split of a routed
    expert stack, then the tensor split of ``_TENSOR_LEAF_AXIS``."""
    name = path.rpartition("/")[2]
    out = []
    if not virtual and name in _EXPERT_LEAVES and ndim == 5:
        out.append(("expert", 2))
    t = _TENSOR_LEAF_AXIS.get(name)
    if t is not None:
        out.append(("tensor", ndim + t))
    return tuple(out)


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, f"{prefix}{k}/" if isinstance(v, dict)
                               else f"{prefix}{k}")
        return out
    return [(prefix, tree)]


def to_virtual_stages(stages: dict, n_virtual: int, n_stages: int):
    """Canonical ``[S, lps, ...]`` stacks regrouped into the interleaved
    ``[v, S, lpc, ...]`` layout: chunk c = k*S + d lands at [k, d], so
    stage d holds chunks d, S + d, 2S + d, ... (a reshape)."""

    def conv(a):
        lpc = a.shape[0] * a.shape[1] // (n_virtual * n_stages)
        return a.reshape(n_virtual, n_stages, lpc, *a.shape[2:])

    return tree_map(conv, stages)


def to_canonical_stages(stages: dict, n_stages: int):
    """Inverse of ``to_virtual_stages``."""
    return tree_map(lambda a: a.reshape(n_stages, -1, *a.shape[3:]), stages)


def stage_axis(virtual: bool) -> int:
    """The stage axis of a stage stack: 0, or 1 in the interleaved
    layout (``tpufw``'s ``stage_partition_specs``: that axis over
    ``pipe``, every other replicated)."""
    return 1 if virtual else 0


def stage_slice(stages: dict, group: PipeGroup, virtual: bool = False,
                groups: tuple = ()):
    """The part of whole stage stacks that ``group``'s process holds:
    its stages along the stage axis (all of them on a
    ``LocalPipeGroup``), then its shards over ``groups`` (``cut_stages``)."""
    if group.indices != tuple(range(group.size)):
        ax = stage_axis(virtual)
        idx = list(group.indices)
        stages = tree_map(
            lambda a: a[(slice(None),) * ax + (idx,)].contiguous(), stages)
    return cut_stages(stages, groups, virtual)


def cut_stages(stages: dict, groups: tuple = (), virtual: bool = False):
    """This process's shards of each split leaf (``leaf_split``) of stage
    stacks over the tensor and expert ``groups`` (a ``TensorGroup`` and an
    ``ExpertGroup``; a group holding every shard keeps the whole)."""
    from tpufw_torch.parallel.tensor import cut_tensor

    if all(g.holds_all for g in groups):
        return stages
    return map_paths(lambda path, a: cut_tensor(
        a, leaf_split(path, a.ndim, virtual), groups).contiguous(), stages)


def map_paths(fn, tree, prefix: str = ""):
    """``fn(path, tensor)`` on every tensor of a nested dict (paths as
    ``tree_leaves`` gives them)."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}{k}/" if isinstance(v, dict)
                             else f"{prefix}{k}") for k, v in tree.items()}
    return fn(prefix, tree)


def _stage_layers(cfg, lps: int) -> dict:
    """{leaf name: (shape after [lps], fan-in or None for a norm, init)}
    of one stage's stacks; init "ones" or "zeros" for norms."""
    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    if _is_mla(cfg):
        kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        out = {
            "attn_norm": ((d,), None, "ones"),
            "kv_a_norm": ((kvr,), None, "ones"),
            "wkv_a": ((d, kvr + dr), d, None),
            "wkv_b": ((kvr, h, cfg.qk_nope_head_dim + cfg.v_head_dim),
                      kvr, None),
            "wo": ((h, cfg.v_head_dim, d), h * cfg.v_head_dim, None),
            "mlp_norm": ((d,), None, "ones"),
        }
        if cfg.moe:
            e, mf = cfg.n_routed_experts, cfg.moe_d_ff
            out |= {"router": ((d, e), d, None),
                    "w_gate": ((e, d, mf), d, None),
                    "w_up": ((e, d, mf), d, None),
                    "w_down": ((e, mf, d), mf, None)}
            if cfg.n_shared_experts:
                sf = cfg.n_shared_experts * mf
                out |= {"w_shared_gate": ((d, sf), d, None),
                        "w_shared_up": ((d, sf), d, None),
                        "w_shared_down": ((sf, d), sf, None)}
        else:
            out |= {"w_gate": ((d, f), d, None), "w_up": ((d, f), d, None),
                    "w_down": ((f, d), f, None)}
        if cfg.q_lora_rank is None:
            out["wq"] = ((d, h, cfg.qk_head_dim), d, None)
        else:
            qr = cfg.q_lora_rank
            out |= {"wq_a": ((d, qr), d, None),
                    "q_a_norm": ((qr,), None, "ones"),
                    "wq_b": ((qr, h, cfg.qk_head_dim), qr, None)}
        return out
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": ((d, h, dh), d, None), "wk": ((d, kh, dh), d, None),
            "wv": ((d, kh, dh), d, None), "wo": ((h, dh, d), h * dh, None)}
    if _is_gemma(cfg):
        return {"pre_attn_norm": ((d,), None, "zeros"),
                "post_attn_norm": ((d,), None, "zeros"),
                "pre_mlp_norm": ((d,), None, "zeros"),
                "post_mlp_norm": ((d,), None, "zeros"),
                **attn, "w_gate": ((d, f), d, None),
                "w_up": ((d, f), d, None), "w_down": ((f, d), f, None)}
    if _is_moe(cfg):
        e = cfg.n_experts
        return {"attn_norm": ((d,), None, "ones"), **attn,
                "moe_norm": ((d,), None, "ones"), "router": ((d, e), d, None),
                "w_gate": ((e, d, f), d, None), "w_up": ((e, d, f), d, None),
                "w_down": ((e, f, d), f, None)}
    out = {"attn_norm": ((d,), None, "ones"), **attn,
           "mlp_norm": ((d,), None, "ones"), "w_gate": ((d, f), d, None),
           "w_up": ((d, f), d, None), "w_down": ((f, d), f, None)}
    if getattr(cfg, "attention_qkv_bias", False):
        out |= {"bq": ((h, dh), None, "zeros"), "bk": ((kh, dh), None, "zeros"),
                "bv": ((kh, dh), None, "zeros")}
    return out


def _draw(seed, key: tuple, shape, scale: float, dtype, device):
    """A normal draw times ``scale`` from the generator of ``key`` (a
    numpy ``SeedSequence`` of the seed and the key), fp32 then ``dtype``."""
    state = np.random.SeedSequence([seed, *key]).generate_state(2)
    gen = torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]) >> 1)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_pipeline_params(
    cfg, pipe: PipelineConfig, seed: int = 0, device=None,
    group: Optional[PipeGroup] = None,
) -> dict:
    """The pipeline tree of ``cfg`` with weights drawn from ``seed`` (the
    flax trunk's initializers: a normal embedding, fan-in scaled kernels,
    unit norms; Gemma's zero norm offsets and 1/sqrt(d) tied embedding),
    in ``cfg.param_dtype`` on ``device`` (default ``cuda``). Every layer's
    leaves come from a generator of their own (``SeedSequence`` of the
    seed, the leaf and the layer), so a process draws only the stages of
    ``group`` (default: all of them), and the interleaved layout holds
    the same layers as the canonical one."""
    from tpufw_torch.utils.hardware import resolve_device

    device = resolve_device(device)
    s = pipe.n_stages
    _check_model_split(cfg, s)
    group = group or LocalPipeGroup(s)
    v = pipe.n_virtual if pipe.virtual_layout else 1
    n_chunks = v * s
    per_chunk = cfg.n_layers // n_chunks
    pd = cfg.param_dtype
    d = cfg.d_model
    # The chunks this process holds, [v][held stages], chunk c = k*S + d.
    held = [[k * s + st for st in group.indices] for k in range(v)]

    def stack(name_key: int, layer_shape, fan_in, init, unit: int):
        """[v?, held, layers per chunk / unit, *layer_shape]."""
        n = per_chunk // unit

        def chunk(c):
            if init is not None:
                fill = torch.ones if init == "ones" else torch.zeros
                return fill((n, *layer_shape), dtype=torch.float32,
                            device=device)
            return torch.stack([
                _draw(seed, (name_key, c * n + i), layer_shape,
                      1.0 / math.sqrt(fan_in), pd, device)
                for i in range(n)])

        out = torch.stack([torch.stack([chunk(c) for c in row])
                           for row in held])
        return out if pipe.virtual_layout else out[0]

    def block(layers: dict, offset: int, unit: int) -> dict:
        return {name: stack(offset + i, shape, fan_in, init, unit)
                for i, (name, (shape, fan_in, init)) in
                enumerate(sorted(layers.items()))}

    layers = _stage_layers(cfg, per_chunk)
    if _is_gemma(cfg):
        stages = {"local": block(layers, 100, 2),
                  "global": block(layers, 200, 2)}
        embed = _draw(seed, (0,), (cfg.vocab_size, d), 1.0 / math.sqrt(d),
                      pd, device)
        return {"embed": embed, "stages": stages,
                "final_norm": torch.zeros(d, device=device)}
    return {
        "embed": _draw(seed, (0,), (cfg.vocab_size, d), 1.0, pd, device),
        "stages": block(layers, 100, 1),
        "final_norm": torch.ones(d, device=device),
        "head": _draw(seed, (1,), (d, cfg.vocab_size), 1.0 / math.sqrt(d),
                      pd, device),
    }


# ----------------------------------------------------------------------
# Block / stage math (numerically the tpufw pipeline block)
# ----------------------------------------------------------------------


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    return torch.arange(t, device=x.device).expand(b, t)


def _proj(x: torch.Tensor, w: torch.Tensor, spec: str, dt) -> torch.Tensor:
    return torch.einsum(spec, x, w.to(dt))


def _mlp(p, h, dt, act, prefix="w_"):
    """The gated MLP ``down(act(gate h) * up h)``, each held tensor
    shard's ``d_ff`` columns (``h`` entering them), summed over the axis
    at the row-parallel exit."""
    tp = tensor_group()
    h = tp.enter(h)
    outs = []
    for wg, wu, wd in zip(tp.shards(p[prefix + "gate"], -1),
                          tp.shards(p[prefix + "up"], -1),
                          tp.shards(p[prefix + "down"], -2)):
        g = _proj(h, wg, "btd,df->btf", dt)
        u = _proj(h, wu, "btd,df->btf", dt)
        outs.append(_proj(act(g) * u, wd, "btf,fd->btd", dt))
    return tp.reduce(outs)


def _head_shards(p, names, tp) -> list:
    """Per held tensor shard, the dict of ``names``' head slices (each
    leaf's split axis from ``_TENSOR_LEAF_AXIS``)."""
    cols = [tp.shards(p[n], _TENSOR_LEAF_AXIS[n]) for n in names]
    return [dict(zip(names, ws)) for ws in zip(*cols)]


def _gqa(p: dict, h, cfg, backend: str, seg, window, soft_cap=None,
         q_scale=None):
    """GQA attention of the normed ``h`` with RoPE through o: each held
    tensor shard's heads (``h`` entering them; Qwen's qkv biases before
    RoPE; Gemma's query scale after it), summed over the axis after o."""
    dt = cfg.dtype
    tp = tensor_group()
    positions = _positions(h)
    h = tp.enter(h)
    rs = getattr(cfg, "rope_scaling", None)
    names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if "bq" in p
                                        else [])
    outs = []
    for w in _head_shards(p, names, tp):
        q = _proj(h, w["wq"], "btd,dhk->bthk", dt)
        k = _proj(h, w["wk"], "btd,dhk->bthk", dt)
        v = _proj(h, w["wv"], "btd,dhk->bthk", dt)
        if "bq" in w:
            q = q + w["bq"].to(dt)
            k = k + w["bk"].to(dt)
            v = v + w["bv"].to(dt)
        q = apply_rope(q, positions, cfg.rope_theta, rs)
        k = apply_rope(k, positions, cfg.rope_theta, rs)
        if q_scale is not None:
            q = q * q_scale
        att = multi_head_attention(
            q, k, v, causal=True, segment_ids=seg, logits_soft_cap=soft_cap,
            sliding_window=window, backend=backend,
        )
        outs.append(_proj(att, w["wo"], "bthk,hkd->btd", dt))
    return tp.reduce(outs)


def _attn_sublayer(p: dict, x, cfg, backend: str, seg=None):
    """Pre-norm GQA attention with RoPE and its residual (Qwen's qkv
    biases before RoPE, Mistral's uniform window)."""
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    return x + _gqa(p, h, cfg, backend, seg,
                    getattr(cfg, "sliding_window", None))


def _block(p: dict, x, cfg, backend: str, seg=None):
    """One Llama-family decoder block; p's leaves have no layer axis."""
    x = _attn_sublayer(p, x, cfg, backend, seg)
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    return x + _mlp(p, h, cfg.dtype, F.silu)


def _mla_attn_sublayer(p: dict, x, cfg, backend: str, seg=None):
    """MLA attention and its residual, the expanded training form of
    ``models.deepseek.MLAttention``; flash gets V zero-padded to the qk
    head dim and its output sliced back. The latent projections and
    their norms are replicated and enter the held tensor shards' heads
    at their outputs; the heads are summed over the axis after o."""
    dt = cfg.dtype
    tp = tensor_group()
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, kvr = cfg.v_head_dim, cfg.kv_lora_rank
    positions = _positions(x)
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    if "wq" in p:
        q_in, q_name, q_spec = tp.enter(h), "wq", "btd,dhk->bthk"
    else:
        cq = _proj(h, p["wq_a"], "btd,dr->btr", dt)
        q_in = tp.enter(rms_norm(cq, p["q_a_norm"], cfg.rms_eps))
        q_name, q_spec = "wq_b", "btr,rhk->bthk"
    ckv_kr = _proj(h, p["wkv_a"], "btd,dr->btr", dt)
    c_kv = rms_norm(ckv_kr[..., :kvr], p["kv_a_norm"], cfg.rms_eps)
    k_pe = apply_rope_interleaved(ckv_kr[..., kvr:][:, :, None, :],
                                  positions, cfg.rope_theta, cfg.rope_scaling)
    c_kv, k_pe = tp.enter(c_kv), tp.enter(k_pe)
    padded = backend in ("flash", "ring")
    outs = []
    for w in _head_shards(p, [q_name, "wkv_b", "wo"], tp):
        q = _proj(q_in, w[q_name], q_spec, dt)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        q_pe = apply_rope_interleaved(q_pe, positions, cfg.rope_theta,
                                      cfg.rope_scaling)
        kv = _proj(c_kv.to(dt), w["wkv_b"], "btr,rhd->bthd", dt)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:3], dr)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        v_in = F.pad(v, (0, cfg.qk_head_dim - dv)) if padded else v
        att = multi_head_attention(q, k, v_in, causal=True, segment_ids=seg,
                                   backend=backend)
        if padded:
            att = att[..., :dv]
        outs.append(_proj(att, w["wo"], "bthd,hdD->btD", dt))
    return x + tp.reduce(outs)


def _mla_block(p: dict, x, cfg, backend: str, seg=None):
    """One dense-FFN DeepSeek-MLA block."""
    x = _mla_attn_sublayer(p, x, cfg, backend, seg)
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    return x + _mlp(p, h, cfg.dtype, F.silu)


def _moe_mlp(p: dict, h, cfg, valid, group_rows: Optional[int]):
    """Top-k capacity MoE MLP: (output, the summed router loss of its
    routing groups). Each group of ``group_rows`` rows (default: all of
    ``h``'s) routes alone, as ``tpufw`` routes each (microbatch x
    data-shard) group; the router runs in fp32, replicated. Each held
    expert shard runs its experts' slots through each held tensor
    shard's ``d_ff`` columns, the parts summed over both axes (one
    reduction), as ``models.mixtral.MoEMLP`` does; the router's logits
    enter both axes and its losses pass back a share a shard."""
    b, t, d = h.shape
    gr = group_rows or b
    if b % gr:
        raise ValueError(f"{b} rows not divisible by group_rows {gr}")
    e, k = cfg.n_experts, cfg.experts_per_token
    dt = cfg.dtype
    ep, tp = expert_group(), tensor_group()
    stacks = [ep.shards(p[n], -3) for n in ("w_gate", "w_up", "w_down")]
    ys, aux = [], 0.0
    for i in range(b // gr):
        hg = h[i * gr:(i + 1) * gr]
        g = gr * t
        logits = torch.einsum("btd,de->bte", hg.float(),
                              p["router"].float()).reshape(g, e)
        vg = None if valid is None else valid[i * gr:(i + 1) * gr].reshape(g)
        dispatch, combine, a, z = route_topk_capacity(
            enter_all(logits, ep, tp), k,
            expert_capacity(g, k, e, cfg.capacity_factor),
            valid=vg, dtype=dt, norm_topk=getattr(cfg, "norm_topk_prob", True),
            group_limit=((cfg.n_group, cfg.topk_group)
                         if getattr(cfg, "n_group", 0) else None),
        )
        xf = enter_all(hg.reshape(g, d).to(dt), ep, tp)
        parts = []
        for (lo, hi), wg, wu, wd in zip(ep.ranges(e), *stacks):
            xe = torch.einsum("gec,gd->ecd", dispatch[:, lo:hi], xf)
            for wg_t, wu_t, wd_t in zip(tp.shards(wg, -1), tp.shards(wu, -1),
                                        tp.shards(wd, -2)):
                gate = torch.einsum("ecd,edf->ecf", xe, wg_t.to(dt))
                up = torch.einsum("ecd,edf->ecf", xe, wu_t.to(dt))
                down = torch.einsum("ecf,efd->ecd", F.silu(gate) * up,
                                    wd_t.to(dt))
                parts.append(torch.einsum("gec,ecd->gd", combine[:, lo:hi],
                                          down))
        ys.append(reduce_all(parts, ep, tp).reshape(gr, t, d))
        aux = aux + grad_share(
            cfg.router_aux_weight * a + cfg.router_z_weight * z, ep, tp)
    return torch.cat(ys), aux


def _mixtral_block(p: dict, x, cfg, backend: str, seg=None, group_rows=None):
    """One Mixtral block: (x, router loss); padding (segment 0) rows
    take no routing."""
    x = _attn_sublayer(p, x, cfg, backend, seg)
    h = rms_norm(x, p["moe_norm"], cfg.rms_eps)
    y, aux = _moe_mlp(p, h, cfg, None if seg is None else seg > 0, group_rows)
    return x + y, aux


def _mla_moe_block(p: dict, x, cfg, backend: str, seg=None, group_rows=None):
    """One MoE-FFN DeepSeek-MLA block (uniform stacks): routed experts
    times ``routed_scaling_factor`` plus the shared-expert SwiGLU."""
    x = _mla_attn_sublayer(p, x, cfg, backend, seg)
    h = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    y, aux = _moe_mlp(p, h, cfg, None if seg is None else seg > 0, group_rows)
    y = y * cfg.routed_scaling_factor
    if "w_shared_gate" in p:
        y = y + _mlp(p, h, cfg.dtype, F.silu, prefix="w_shared_")
    return x + y, aux


def _gemma_block(p: dict, x, cfg, backend: str, seg, window):
    """One Gemma-2 block: sandwich (1 + w) norms, GeGLU, the attention
    soft cap and query_pre_attn_scalar scaling. Under a tensor split each
    sublayer's shards are summed before its post-norm (an RMSNorm of a
    partial sum would be another function)."""
    dt = cfg.dtype

    def norm(which, h):
        return rms_norm(h, p[which] + 1.0, cfg.rms_eps)

    qpas = cfg.query_pre_attn_scalar
    q_scale = None
    if qpas is not None and float(qpas) != float(cfg.head_dim):
        q_scale = math.sqrt(cfg.head_dim) / math.sqrt(float(qpas))
    x = x + norm("post_attn_norm", _gqa(
        p, norm("pre_attn_norm", x), cfg, backend, seg, window,
        cfg.attn_logit_soft_cap, q_scale))
    m = _mlp(p, norm("pre_mlp_norm", x), dt,
             lambda g: F.gelu(g, approximate="tanh"))
    return x + norm("post_mlp_norm", m)


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _stage(stage_params: dict, x, cfg, backend: str, seg=None,
           group_rows=None):
    """This stage's blocks in order (Gemma's in local/global pairs):
    (out, the summed router loss of its MoE layers, 0.0 for the dense
    families)."""
    if _is_gemma(cfg):
        for i in range(stage_params["local"]["wq"].shape[0]):
            x = _gemma_block(_layer(stage_params["local"], i), x, cfg,
                             backend, seg, cfg.sliding_window)
            x = _gemma_block(_layer(stage_params["global"], i), x, cfg,
                             backend, seg, None)
        return x, 0.0
    n = stage_params["wo"].shape[0]
    if _returns_aux(cfg):
        blk = _mla_moe_block if _is_mla(cfg) else _mixtral_block
        aux = 0.0
        for i in range(n):
            x, a = blk(_layer(stage_params, i), x, cfg, backend, seg,
                       group_rows)
            aux = aux + a
        return x, aux
    blk = _mla_block if _is_mla(cfg) else _block
    for i in range(n):
        x = blk(_layer(stage_params, i), x, cfg, backend, seg)
    return x, 0.0


def chunk_params(stages: dict, group: PipeGroup, stage: int, chunk: int = 0,
                 virtual: bool = False) -> dict:
    """The stacks of ``chunk`` of ``stage`` (a stage this process holds):
    [layers, ...] views of its stage stacks."""
    pos = group.pos(stage)
    return tree_map(lambda a: a[chunk][pos] if virtual else a[pos], stages)


# ----------------------------------------------------------------------
# Embedding and head
# ----------------------------------------------------------------------


def head_kernel(params: dict) -> torch.Tensor:
    """[D, V] LM head: dedicated, or the transposed tied embedding."""
    return params["head"] if "head" in params else params["embed"].t()


def _embed(params: dict, tokens, cfg):
    """Token embedding lookup incl. Gemma's sqrt(d) scaling. The rows are
    gathered, then cast: the same values as ``tpufw``'s cast-then-gather,
    and the backward sums a token's rows in fp32 (as the manual schedules'
    scatter-add does), not in the compute dtype."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if _is_gemma(cfg):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def _final_norm(params: dict, hidden, cfg):
    fnorm = params["final_norm"]
    if _is_gemma(cfg):
        fnorm = fnorm + 1.0
    return rms_norm(hidden, fnorm, cfg.rms_eps)


def _logits_epilogue(params: dict, hidden, cfg):
    """final norm -> head (fp32) -> the final soft cap."""
    h = _final_norm(params, hidden, cfg)
    logits = h.float() @ head_kernel(params).float()
    cap = getattr(cfg, "final_logit_soft_cap", None)
    return logits if cap is None else tanh_soft_cap(logits, cap)


def ce_sum(params: dict, hidden, targets, mask, cfg,
           loss_chunk_size: Optional[int] = None,
           loss_chunk_dtype="bfloat16"):
    """The token CE (with z-loss) of ``hidden``'s logits summed over
    ``mask``: full logits, or with ``loss_chunk_size`` the chunked-vocab
    CE in ``loss_chunk_dtype`` (the final cap a chunk). ``params`` needs
    only the final norm and the head (or the tied embedding)."""
    from tpufw_torch.ops.loss import chunked_cross_entropy, token_cross_entropy

    if loss_chunk_size:
        if isinstance(loss_chunk_dtype, str):
            loss_chunk_dtype = getattr(torch, loss_chunk_dtype)
        mean, n = chunked_cross_entropy(
            _final_norm(params, hidden, cfg), head_kernel(params), targets,
            mask, chunk_size=loss_chunk_size, compute_dtype=loss_chunk_dtype,
            logits_soft_cap=getattr(cfg, "final_logit_soft_cap", None))
        return mean * n
    ce = token_cross_entropy(_logits_epilogue(params, hidden, cfg), targets)
    return (ce * mask).sum()


# ----------------------------------------------------------------------
# GPipe schedule
# ----------------------------------------------------------------------


def _microbatches(x, m: int):
    return None if x is None else list(x.chunk(m, dim=0))


def _gpipe(params, inputs, seg, cfg, pipe, group, backend, group_rows):
    """Stream the M microbatches of ``inputs`` [B, T] through the held
    stages: (the last stage's outputs per microbatch, or None where this
    process does not hold it; the held stages' summed router loss; the
    zero scalar that ties a process group's hand-offs to the
    objective). Only real ticks run."""
    s_n, m = pipe.n_stages, pipe.n_microbatches
    tok = _microbatches(inputs, m)
    segs = _microbatches(seg, m) or [None] * m
    held = group.indices
    outs = [None] * m if s_n - 1 in held else None
    aux = 0.0
    ties = 0.0
    recv: dict = {}
    like = torch.empty(tok[0].shape + (cfg.d_model,), dtype=cfg.dtype,
                       device=inputs.device)
    for t in range(m + s_n - 1):
        send = {}
        for s in held:
            j = t - s
            if not 0 <= j < m:
                continue
            x_in = _embed(params, tok[j], cfg) if s == 0 else recv[s]
            y, a = _stage(chunk_params(params["stages"], group, s), x_in,
                          cfg, backend, segs[j], group_rows)
            aux = aux + a
            if s == s_n - 1:
                outs[j] = y
            else:
                send[s] = y
        expect = {s for s in held if s > 0 and 0 <= t + 1 - s < m}
        recv, tie = group.handoff_autograd(send, expect, like)
        ties = ties + tie
    return outs, aux, ties


def _aux_groups(pipe: PipelineConfig, rows: int, group_rows) -> int:
    """Routing groups per microbatch of this process's ``rows``."""
    mb = rows // pipe.n_microbatches
    return mb // (group_rows or mb)


def pipeline_forward(
    params: dict,
    tokens: torch.Tensor,
    cfg,
    pipe: PipelineConfig,
    group: Optional[PipeGroup] = None,
    backend: Optional[str] = None,
    segment_ids: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    group_rows: Optional[int] = None,
):
    """Full LM forward with the block stack pipelined: logits [B, T, V]
    (or, with ``return_hidden``, the post-final-norm hidden states), and
    for MoE configs the tuple (that, the mean router loss, /n_layers as
    ``tpufw`` gives it). ``group`` defaults to a ``LocalPipeGroup`` of
    every stage. Under a ``ProcessPipeGroup`` only the last stage has
    outputs (None elsewhere) and the router loss is this process's part
    of the gang's sum. ``group_rows``: MoE routing groups of that many
    rows of each microbatch (default: the microbatch)."""
    group = group or LocalPipeGroup(pipe.n_stages)
    check_group(pipe, group)
    check_split(cfg)
    pipe.validate(cfg, tokens.shape[0])
    if pipe.virtual_layout:
        raise ValueError(
            "pipeline_forward runs the canonical [S, lps] stacks; regroup "
            "interleaved ones with to_canonical_stages")
    backend = backend or cfg.attention_backend
    b, t = tokens.shape
    outs, aux, _ = _gpipe(params, tokens, segment_ids, cfg, pipe, group,
                          backend, group_rows)
    out = None
    if outs is not None:
        hidden = torch.cat(outs)
        out = (_final_norm(params, hidden, cfg) if return_hidden
               else _logits_epilogue(params, hidden, cfg))
    if _returns_aux(cfg):
        n = pipe.n_microbatches * _aux_groups(pipe, b, group_rows)
        return out, aux / n / cfg.n_layers
    return out


def reference_forward(params: dict, tokens, cfg, backend: str = "xla",
                      segment_ids=None, group_rows: Optional[int] = None):
    """Sequential evaluation of the same (canonical, whole) params with no
    pipe: the schedule's parity oracle. MoE configs route each group of
    ``group_rows`` rows alone and return (logits, the router loss meaned
    over groups, /n_layers)."""
    b, t = tokens.shape
    x = _embed(params, tokens, cfg)
    flat = tree_map(lambda a: a.reshape(-1, *a.shape[2:]), params["stages"])
    if _returns_aux(cfg):
        gr = group_rows or b
        if b % gr:
            raise ValueError(f"batch {b} not divisible by group_rows {gr}")
        x, aux = _stage(flat, x, cfg, backend, segment_ids, gr)
        return (_logits_epilogue(params, x, cfg),
                aux / (b // gr) / cfg.n_layers)
    x, _ = _stage(flat, x, cfg, backend, segment_ids)
    return _logits_epilogue(params, x, cfg)


# ----------------------------------------------------------------------
# Objectives
# ----------------------------------------------------------------------


def _gang_sum_(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed in place over each process group of ``groups``."""
    import torch.distributed as dist

    for g in groups:
        dist.all_reduce(x, group=g)
    return x


@dataclasses.dataclass
class Gang:
    """The collectives a pipeline step needs beyond its pipe group: the
    process groups of the batch shards (``data``, ``fsdp``: the ranks
    holding this process's stages and shards, other rows), the process
    group of the ranks of this rank's (``expert``, ``tensor``) coordinate
    (None: every rank), over which the loss and the replicated leaves'
    gradients are summed, and whether there is a process group at all.
    ``Gang()`` is one process."""

    batch_groups: tuple = ()
    active: bool = False
    coord_group: Any = None

    def batch_sum(self, x):
        return _gang_sum_(x, self.batch_groups) if self.active else x

    def world_sum(self, x):
        """``x`` summed in place over the ranks of this coordinate."""
        import torch.distributed as dist

        if self.active:
            dist.all_reduce(x, group=self.coord_group)
        return x


def objective_parts(params, batch, cfg, pipe, group, backend=None,
                    loss_chunk_size=None, loss_chunk_dtype="bfloat16",
                    group_rows=None, gang: Optional[Gang] = None):
    """(this process's differentiable part of the step's objective, the
    gang's number of targets): the CE sum over the targets whose last
    stage it holds over the global target count, plus its stages' part of
    the mean router loss, plus the hand-off tie. Summed over the gang it
    is ``tpufw``'s ``pipeline_loss``."""
    from tpufw_torch.train.trainer import shift_and_mask

    gang = gang or Gang()
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    check_split(cfg)
    pipe.validate(cfg, inputs.shape[0])
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    n = gang.batch_sum(mask.sum().detach().clone())
    n = torch.clamp(n, min=1.0)
    outs, aux, ties = _gpipe(params, inputs, seg_in, cfg, pipe, group,
                             backend or cfg.attention_backend, group_rows)
    obj = ties
    if outs is not None:
        obj = obj + ce_sum(params, torch.cat(outs), targets, mask, cfg,
                           loss_chunk_size, loss_chunk_dtype) / n
    if _returns_aux(cfg):
        groups = pipe.n_microbatches * _aux_groups(
            pipe, inputs.shape[0], group_rows) * _n_batch_shards(gang)
        obj = obj + aux / groups / cfg.n_layers
    return obj, n


def _n_batch_shards(gang: Gang) -> int:
    """The gang's batch shards (1 without a process group)."""
    import torch.distributed as dist

    return math.prod(dist.get_world_size(g) for g in gang.batch_groups)


def pipeline_loss(params, batch, cfg, pipe, group=None, backend=None,
                  loss_chunk_size=None, loss_chunk_dtype="bfloat16",
                  group_rows=None):
    """The LM objective through the GPipe schedule (the same shift and
    packed-batch masking as the Trainer, the router loss joined), on one
    process: differentiable. ``batch`` is {tokens [+ segment_ids,
    loss_mask]} of tensors, or a token tensor."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    group = group or LocalPipeGroup(pipe.n_stages)
    check_group(pipe, group)
    return objective_parts(params, batch, cfg, pipe, group, backend,
                           loss_chunk_size, loss_chunk_dtype, group_rows)[0]


def _zero_none(grads, leaves):
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


def unflatten_like(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def reduce_grads(grads: dict, gang: Gang) -> dict:
    """Sum a step's gradients over the gang: stage stacks over the batch
    shards (their pipe ranks hold other stages; their tensor and expert
    ranks other shards, or, for a replicated leaf, the whole gradient:
    the stage's ``enter`` summed its parts), the rest over the ranks of
    this coordinate (only the first and last stages produce them, whole
    on each tensor and expert rank)."""
    if not gang.active:
        return grads
    for path, g in tree_leaves(grads):
        if path.startswith("stages"):
            gang.batch_sum(g)
        else:
            gang.world_sum(g)
    return grads


def gpipe_value_and_grad(params, batch, cfg, pipe, group=None, backend=None,
                         loss_chunk_size=None, loss_chunk_dtype="bfloat16",
                         group_rows=None, gang: Optional[Gang] = None):
    """(the step's loss, its gradients, a tree like ``params``) through
    the GPipe schedule, autograd through the ticks; under a gang both
    are the global batch's on every rank."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    group = group or LocalPipeGroup(pipe.n_stages)
    gang = gang or Gang()
    check_group(pipe, group)
    # Leaves of their own (the same storage): the gradients are returned,
    # never accumulated into the caller's ``.grad``.
    params = tree_map(lambda a: a.detach().requires_grad_(), params)
    leaves = [p for _, p in tree_leaves(params)]
    obj, _ = objective_parts(params, batch, cfg, pipe, group, backend,
                             loss_chunk_size, loss_chunk_dtype, group_rows,
                             gang)
    # ``backward`` runs every node of the graph (``autograd.grad`` would
    # prune a receiving rank's hand-offs, which lead to no parameter of
    # its own, and the sender would wait for their reverse sends).
    obj.backward()
    grads = unflatten_like(params, _zero_none([p.grad for p in leaves],
                                              leaves))
    loss = gang.world_sum(obj.detach().clone())
    return loss, reduce_grads(grads, gang)


@torch.no_grad()
def pipeline_eval(params, batch, cfg, pipe, group=None, backend=None,
                  loss_chunk_size=None, loss_chunk_dtype="bfloat16",
                  group_rows=None, gang: Optional[Gang] = None) -> dict:
    """Forward-only objective: {loss, n_tokens} of the global batch on
    every rank, with the train objective's shift and masks (the router
    loss joined). Interleaved stacks run the interleaved schedule's
    forward sub-ticks."""
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    group = group or LocalPipeGroup(pipe.n_stages)
    gang = gang or Gang()
    check_group(pipe, group)
    if pipe.virtual_layout:
        from tpufw_torch.parallel.pipeline_1f1b import manual_value_and_grad

        loss, n = manual_value_and_grad(
            params, batch, cfg, pipe, group, backend, loss_chunk_size,
            loss_chunk_dtype, gang=gang, train=False)
        return {"loss": loss, "n_tokens": n}
    obj, n = objective_parts(params, batch, cfg, pipe, group, backend,
                             loss_chunk_size, loss_chunk_dtype, group_rows,
                             gang)
    return {"loss": gang.world_sum(obj.detach().clone()), "n_tokens": n}


def pipeline_train_step(params, optimizer, batch, cfg, pipe, group=None,
                        loss_chunk_size=None, loss_chunk_dtype="bfloat16"):
    """One optimizer update over the pipelined model through
    ``pipe.schedule``: the gradients land in the leaves' ``.grad`` and
    ``optimizer`` (a ``LlamaAdamW`` over the leaves) steps. Returns
    {loss, grad_norm}."""
    loss, grads = value_and_grad(params, batch, cfg, pipe, group,
                                 loss_chunk_size=loss_chunk_size,
                                 loss_chunk_dtype=loss_chunk_dtype)
    by_path = dict(tree_leaves(grads))
    for path, p in tree_leaves(params):
        p.grad = by_path[path].to(p.dtype)
    return {"loss": loss, "grad_norm": optimizer.step()}


def value_and_grad(params, batch, cfg, pipe, group=None, backend=None,
                   loss_chunk_size=None, loss_chunk_dtype="bfloat16",
                   gang: Optional[Gang] = None) -> tuple[Any, dict]:
    """(loss, gradients) of one step through ``pipe.schedule``."""
    if pipe.schedule == "gpipe":
        return gpipe_value_and_grad(params, batch, cfg, pipe, group, backend,
                                    loss_chunk_size, loss_chunk_dtype,
                                    gang=gang)
    from tpufw_torch.parallel.pipeline_1f1b import manual_value_and_grad

    return manual_value_and_grad(params, batch, cfg, pipe, group, backend,
                                 loss_chunk_size, loss_chunk_dtype, gang=gang)
