"""Mixtral sparse-MoE family in PyTorch (port of ``tpufw.models.mixtral``).

``Llama``'s trunk (embedding, caches, remat, final norm, untied fp32 head)
over ``MixtralBlock`` layers, whose feed-forward is ``MoEMLP``: a router
computed in fp32 on an fp32 input, top-k of E SwiGLU experts, routed by
``tpufw_torch.ops.moe`` under a per-expert capacity. Two dispatch modes,
as in the JAX package (``cfg.moe_dispatch``):

- ``"einsum"``: one-hot dispatch/combine tensors [G, E, C] contracted
  with the tokens and the expert outputs, every expert run over its C
  slots as one batched matmul;
- ``"sorted"``: the k*G assignments sorted by expert and run as grouped
  matmuls, one ``F.linear`` per expert over its rows. ``tpufw`` calls
  ``jax.lax.ragged_dot``; here the group sizes are read to the host
  (one device-to-host sync per layer) to split the rows.

Int8 serving (``quantized_weights``) holds each expert stack as int8
codes with a per-(expert, out-channel) scale (``QuantExperts``) and runs
the einsum mode, as ``tpufw`` does; the router stays in floating point.

Layout: an expert stack is [E, out, in], so expert e is an HF
``nn.Linear`` weight; ``tpufw_torch.interop`` transposes the Flax
[E, in, out] stacks. With ``lora_rank`` r > 0 each stack ``w`` has its
adapters beside it, ``w_lora_a`` [E, r, in] and ``w_lora_b`` [E, out, r]
(``tpufw``'s [E, in, r] and [E, r, out], transposed), in both dispatch
modes; the router has none.

Under an expert group (``parallel.context``) each held expert shard runs
its experts' slots of the global routing, each through the held width
shards of a tensor group, and the parts are summed over both axes; the
router stays replicated. Adapters are cut with their stacks (``_parts``).
A split of int8 stacks raises NotImplementedError (a serving form, which
runs unsplit).

``forward`` returns logits (or hidden states), and ``(out, aux)`` with
``return_aux=True``: aux is the layer mean of ``router_aux_weight *
load_balance + router_z_weight * z``, which the trainer adds to the loss.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpufw_torch.models.llama import (
    Attention,
    Llama,
    LlamaConfig,
    Projection,
    RMSNorm,
    reject_quant_lora,
)
from tpufw_torch.ops.moe import (
    expert_capacity,
    gather_routing,
    local_sorted,
    route_topk_capacity,
    route_topk_sorted,
)
from tpufw_torch.parallel.context import expert_group, tensor_group
from tpufw_torch.parallel.group import (
    LocalExpertGroup,
    enter_all,
    grad_share,
    reduce_all,
)
from tpufw_torch.parallel.tensor import refuse_unsplittable

_DISPATCH_MODES = ("einsum", "sorted")
_ONE_EXPERT = LocalExpertGroup(1)


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # Per-expert slots = capacity_factor * (tokens * k / n_experts).
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    router_z_weight: float = 1e-3
    # "einsum" (one-hot dispatch) or "sorted" (grouped matmuls).
    moe_dispatch: str = "einsum"

    def n_params(self, include_embed: bool = True) -> int:
        d, l = self.d_model, self.n_layers
        attn = l * (
            d * self.n_heads * self.head_dim
            + 2 * d * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * d
        )
        moe = l * (3 * d * self.d_ff * self.n_experts + d * self.n_experts)
        norms = (2 * l + 1) * d
        total = attn + moe + norms
        if include_embed:
            total += self.vocab_size * d
            if not self.tie_embeddings:
                total += d * self.vocab_size
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token on the ACTIVE parameters (k experts of
        E, and the router) plus the attention scores."""
        d, l, k = self.d_model, self.n_layers, self.experts_per_token
        n_active = (
            l
            * (
                d * self.n_heads * self.head_dim
                + 2 * d * self.n_kv_heads * self.head_dim
                + self.n_heads * self.head_dim * d
                + 3 * d * self.d_ff * k
                + d * self.n_experts
            )
            + d * self.vocab_size
        )
        return 6.0 * n_active + self._attn_score_flops(seq_len)


MIXTRAL_CONFIGS: dict[str, MixtralConfig] = {
    "mixtral_8x7b": MixtralConfig(
        vocab_size=32_000,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        rope_theta=1e6,
        max_seq_len=32_768,
        n_experts=8,
        experts_per_token=2,
        attention_backend="flash",
    ),
    "mixtral_tiny": MixtralConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        max_seq_len=128,
        n_experts=4,
        experts_per_token=2,
        remat=False,
    ),
}


def _dispatch_mode(cfg) -> str:
    """The dispatch a MoE layer of ``cfg`` runs: ``cfg.moe_dispatch``,
    except einsum for int8 expert stacks; ValueError for an unknown one."""
    mode = getattr(cfg, "moe_dispatch", "einsum")
    if mode not in _DISPATCH_MODES:
        raise ValueError(
            f"moe_dispatch={mode!r}: choose 'einsum' (one-hot dispatch "
            "tensors) or 'sorted' (grouped matmuls over expert-sorted rows)"
        )
    if getattr(cfg, "quantized_weights", False):
        return "einsum"
    return mode


class QuantExperts(nn.Module):
    """The int8 serving twin of an expert stack (``QuantExpertKernel``):
    codes [E, out, in] and an fp32 scale [E, out]. Output: xe [E, C, in]
    against each expert's codes cast to xe's dtype, scaled per (expert,
    out-channel) in that dtype."""

    def __init__(self, e, d_in, d_out, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(e, d_out, d_in, dtype=torch.int8, device=device),
            requires_grad=False,
        )
        self.scale = nn.Parameter(
            torch.ones(e, d_out, dtype=torch.float32, device=device),
            requires_grad=False,
        )

    def forward(self, xe):
        y = torch.bmm(xe, self.weight.to(xe.dtype).transpose(1, 2))
        return y * self.scale[:, None, :].to(y.dtype)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts; ``forward(x, valid)`` returns (y,
    aux), aux pre-weighted by the config. ``d_ff`` overrides the expert
    width, ``norm_topk=False`` keeps the raw softmax gates and
    ``group_limit`` is DeepSeek's (n_group, topk_group), passed to the
    routing as ``tpufw`` passes them."""

    # A gang's process group (set by ``train.sharding.shard_model``): the
    # routing group is then the global batch, every rank's tokens in its
    # row-major order, as ``tpufw`` routes it, and each rank computes its
    # own tokens. ``route_seq``: the sequence ranks a row is split over.
    route_group = None
    route_seq = 1

    # Logical axes of the expert stacks ([E, out, in]); the router, which
    # ``tpufw`` shards over ``expert``, stays replicated here.
    LOGICAL_AXES = {
        "w_gate": ("expert", "expert_mlp", "embed"),
        "w_up": ("expert", "expert_mlp", "embed"),
        "w_down": ("expert", "embed", "expert_mlp"),
    }

    def __init__(self, cfg, gen, device=None, d_ff=None, norm_topk=True,
                 group_limit=None):
        super().__init__()
        self.cfg = cfg
        self.mode = _dispatch_mode(cfg)
        self.norm_topk = norm_topk
        self.group_limit = group_limit
        d, f, e = cfg.d_model, d_ff or cfg.d_ff, cfg.n_experts
        self.router = Projection(d, e, cfg, gen, device=device, lora=False)
        self.router.dtype = torch.float32
        r = getattr(cfg, "lora_rank", 0)
        if cfg.quantized_weights:
            reject_quant_lora(cfg)
        self.lora_scale = getattr(cfg, "lora_alpha", 16.0) / r if r else None
        shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        for name, (d_in, d_out) in shapes.items():
            if cfg.quantized_weights:
                setattr(self, name, QuantExperts(e, d_in, d_out, device))
                continue
            w = torch.empty(e, d_out, d_in, dtype=cfg.param_dtype,
                            device=device)
            w.normal_(0.0, 1.0 / math.sqrt(d_in), generator=gen)
            setattr(self, name, nn.Parameter(w))
            if r:
                # Drawn by the model (lora.init_adapters): B zero.
                for suffix, shape in (("_lora_a", (e, r, d_in)),
                                      ("_lora_b", (e, d_out, r))):
                    setattr(self, name + suffix, nn.Parameter(torch.zeros(
                        shape, dtype=cfg.param_dtype, device=device)))

    def _parts(self, name, ep, tp) -> list:
        """The held parts of expert stack ``name``: for each held expert
        shard, for each held width shard of it, (w, (A, B) or None
        without LoRA). ``tensor`` splits the width (gate and up on their
        output, dim 1; down on its input, dim 2); an adapter rides its
        stack's axes: cut with its experts, and with the width where it
        carries it (gate/up's B, down's A), else whole, entering the
        width split (its gradient summed over the width shards)."""
        dim = 2 if name == "w_down" else 1
        stacks = ep.shards(getattr(self, name), 0)
        if self.lora_scale is None:
            return [[(w, None) for w in tp.shards(we, dim)] for we in stacks]
        a_s, b_s = (ep.shards(getattr(self, name + s), 0)
                    for s in ("_lora_a", "_lora_b"))
        out = []
        for we, a, b in zip(stacks, a_s, b_s):
            if dim == 1:
                a = tp.enter(a)
                pairs = [(a, bt) for bt in tp.shards(b, 1)]
            else:
                b = tp.enter(b)
                pairs = [(at, b) for at in tp.shards(a, 2)]
            out.append(list(zip(tp.shards(we, dim), pairs)))
        return out

    def _experts(self, xe, w, ab):
        """[E', C, in] -> [E', C, out] through ``w`` (an expert stack or
        a part of it), plus its adapters' ``ab`` = (A, B) part ``(xe @
        Aᵀ) @ Bᵀ * (lora_alpha / r)`` when not None."""
        if isinstance(w, QuantExperts):
            return w(xe)
        dt = self.cfg.dtype
        y = torch.bmm(xe, w.to(dt).transpose(1, 2))
        if ab is None:
            return y
        a, b = (t.to(dt).transpose(1, 2) for t in ab)
        return y + torch.bmm(torch.bmm(xe, a), b) * self.lora_scale

    def forward(self, x, valid=None):
        cfg = self.cfg
        b, t, d = x.shape
        e, k = cfg.n_experts, cfg.experts_per_token
        g = b * t
        ep, tp = expert_group(), tensor_group()
        refuse_unsplittable(self, ep, tp)
        router_logits = self.router(x.float()).reshape(g, e)
        valid = None if valid is None else valid.reshape(g)
        mine = slice(0, g)
        if self.route_group is not None:
            router_logits, valid, mine = gather_routing(
                router_logits, valid, self.route_group, b, self.route_seq)
        # Each expert or tensor shard's combine reaches only its part of
        # the gates: their gradients are summed over both axes; the router
        # losses, alike on every rank, pass back a share each.
        router_logits = enter_all(router_logits, ep, tp)
        capacity = expert_capacity(router_logits.shape[0], k, e,
                                   cfg.capacity_factor)
        kw = dict(valid=valid, dtype=x.dtype, norm_topk=self.norm_topk,
                  group_limit=self.group_limit)
        if self.mode == "sorted":
            token, sizes, gates, aux, z = route_topk_sorted(
                router_logits, k, capacity, **kw)
            if self.route_group is not None:
                token, sizes, gates = local_sorted(token, sizes, gates, mine,
                                                   g)
            y = self._sorted(x.reshape(g, d), token, sizes, gates)
        else:
            # In a gang every expert runs over the global capacity's
            # slots, those of other ranks' rows empty.
            dispatch, combine, aux, z = route_topk_capacity(
                router_logits, k, capacity, **kw)
            y = self._einsum(x.reshape(g, d), dispatch[mine], combine[mine])
        return y.reshape(b, t, d), grad_share(
            cfg.router_aux_weight * aux + cfg.router_z_weight * z, ep, tp)

    def _einsum(self, xf, dispatch, combine):
        """Dispatch [G, E, C] -> per-expert slots, the experts, combine
        back: both contractions one matmul over (e, c). Each held expert
        shard (one, whole, unsplit) runs its experts' slots through each
        held width shard of the tensor group, and the parts are summed
        over both axes."""
        g, e, c = dispatch.shape
        ep, tp = expert_group(), tensor_group()
        xf = enter_all(xf, ep, tp)
        parts = []
        for (lo, hi), gates, ups, downs in zip(
                ep.ranges(e), *(self._parts(n, ep, tp)
                                for n in ("w_gate", "w_up", "w_down"))):
            n = hi - lo
            xe = (dispatch[:, lo:hi].reshape(g, n * c).t() @ xf).reshape(
                n, c, -1).to(self.cfg.dtype)
            comb = combine[:, lo:hi].reshape(g, n * c)
            for wg, wu, wd in zip(gates, ups, downs):
                h = F.silu(self._experts(xe, *wg)) * self._experts(xe, *wu)
                out = self._experts(h, *wd)
                parts.append(comb.to(out.dtype) @ out.reshape(n * c, -1))
        return reduce_all(parts, ep, tp)

    def _sorted(self, xf, token, group_sizes, gates):
        """Grouped expert matmuls over the expert-sorted rows; the
        sentinel group (invalid rows, zero gates) gives zeros, as
        ``tpufw``'s zero pad expert does. Under a tensor group each held
        width shard runs the groups, and the gated parts are summed."""
        cfg = self.cfg
        e = cfg.n_experts
        sizes = group_sizes.tolist()  # one device-to-host read per layer
        tp = tensor_group()
        xs = tp.enter(xf).to(cfg.dtype)[token]

        def grouped(inp, w, ab):
            # unbind, not w[i]: each index's backward would write a zeroed
            # copy of the whole stack, E of them summed.
            w = w.to(cfg.dtype).unbind(0)
            parts = inp.split(sizes)
            outs = [F.linear(parts[i], w[i]) for i in range(e)]
            if ab is not None:
                # The adapters over the same splits: no further host read.
                a, b = (t.to(cfg.dtype).unbind(0) for t in ab)
                outs = [y + F.linear(F.linear(parts[i], a[i]), b[i])
                        * self.lora_scale for i, y in enumerate(outs)]
            outs.append(inp.new_zeros(sizes[e], w[0].shape[0]))
            return torch.cat(outs)

        parts = []
        # The sorted dispatch keeps the expert stacks whole.
        for wg, wu, wd in zip(*(self._parts(n, _ONE_EXPERT, tp)[0]
                                for n in ("w_gate", "w_up", "w_down"))):
            h = F.silu(grouped(xs, *wg)) * grouped(xs, *wu)
            yw = grouped(h, *wd) * gates[:, None].to(cfg.dtype)
            parts.append(torch.zeros_like(xf, dtype=cfg.dtype).index_add(
                0, token, yw))
        return tp.reduce(parts)


class MixtralBlock(nn.Module):
    """RMSNorm -> attention -> residual -> RMSNorm -> MoE -> residual;
    ``merge`` returns (x, aux), the MoE's valid rows being
    ``segment_ids > 0``."""

    def __init__(self, cfg: MixtralConfig, gen, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, gen, cfg.sliding_window, device)
        self.moe_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.moe = MoEMLP(cfg, gen, device)

    def attend(self, x, positions, segment_ids=None, cache=None):
        return self.attn(self.attn_norm(x), positions, segment_ids, cache)

    def merge(self, x, a, segment_ids=None):
        x = x + a
        valid = None if segment_ids is None else segment_ids > 0
        y, aux = self.moe(self.moe_norm(x), valid)
        return x + y, aux

    def forward(self, x, positions, segment_ids=None, cache=None):
        return self.merge(x, self.attend(x, positions, segment_ids, cache),
                          segment_ids)


class Mixtral(Llama):
    """Decoder-only MoE LM: ``Llama``'s trunk over ``MixtralBlock`` layers.
    ``forward`` returns what ``Llama.forward`` does, and with
    ``return_aux=True`` also the layer mean of the router losses."""

    @staticmethod
    def _block(cfg, gen, device, index: int) -> nn.Module:
        return MixtralBlock(cfg, gen, device)

    def forward(
        self, tokens, positions=None, segment_ids=None, return_hidden=False,
        cache=None, return_aux=False,
    ):
        x, aux = self._trunk(tokens, positions, segment_ids, cache)
        out = x if return_hidden else self._head(x)
        if return_aux:
            return out, aux / self.cfg.n_layers
        return out
