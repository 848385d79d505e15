"""Vision Transformer in PyTorch (port of ``tpufw.models.vit``).

Numerics of the JAX model, trap by trap:

- images come in NHWC (float, any dtype); patchify is a reshape to
  [B, g, p, g, p, C], a transpose to (p, p, C) per patch and one matmul
  with the [D, p*p*C] patch kernel, not a convolution;
- activations in ``cfg.dtype`` (bf16), fp32 master weights cast at every
  dense layer (``Dense``: ``nn.Dense(dtype=cfg.dtype)``, bias included);
- LayerNorm as flax's: fp32 arithmetic and output, epsilon **1e-6** (torch's
  default is 1e-5);
- attention is two matmuls and a softmax, bidirectional, outside any
  kernel: the scores QKᵀ come out in fp32 (``preferred_element_type``),
  scaled by head_dim^-0.5, the softmax is fp32 and the probabilities are
  cast to ``cfg.dtype`` before the product with V;
- the MLP's GELU is the tanh approximation (``nn.gelu(approximate=True)``);
- ``pool`` "cls" classifies from a zero-initialised [CLS] token, "mean"
  from the mean of the patch tokens; the head is fp32 and starts at zero;
- ``remat`` checkpoints each block whole in training (flax's
  ``nothing_saveable``: the block input is kept, the rest recomputed).

Parameter layout is PyTorch's: a dense weight is [out, in];
``tpufw_torch.interop.vision_params_from_flax`` converts a Flax tree.

Under a tensor group (``parallel.context``) the blocks split as
``tpufw``'s logical axes name them (``LOGICAL_AXES``): q and up are
column-parallel, o and down row-parallel, and each held shard attends
with its ``n_heads/tp`` heads; the class head is vocab-parallel
(``forward(images, logit_shards=True)`` gives each held shard's logits).
k and v split with q (Megatron). ``tpufw`` names them ``"kv"``, which no
rule maps, so GSPMD keeps them whole there: the same numbers, a
divergence by design.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpufw_torch.ops.loss import matmul_f32
from tpufw_torch.parallel.context import tensor_group
from tpufw_torch.parallel.tensor import column, row
from tpufw_torch.utils.hardware import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "cls": classify from the [CLS] token; "mean": mean-pool the patches.
    pool: str = "cls"
    remat: bool = False

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide into n_heads")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls'|'mean', got {self.pool!r}")

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.pool == "cls" else 0)

    def n_params(self) -> int:
        d, l, f = self.d_model, self.n_layers, self.d_ff
        patch = (self.patch_size**2 * 3) * d + d
        pos = self.seq_len * d + (d if self.pool == "cls" else 0)
        attn = l * (4 * d * d + 4 * d)  # qkvo weights + biases
        mlp = l * (2 * d * f + f + d)
        norms = l * 2 * 2 * d + 2 * d  # 2 LN/block + final, scale+bias
        head = d * self.num_classes + self.num_classes
        return patch + pos + attn + mlp + norms + head

    def flops_per_image(self, image_size: Optional[int] = None) -> float:
        """Training FLOPs per image: 3x (forward + backward at 2x) the
        forward matmul FLOPs, 2 per MAC: patchify, the blocks' per-token
        matmuls, the bidirectional QKᵀ and AV (t keys per query) and the
        head on the pooled token."""
        del image_size  # the signature of ResNetConfig's
        d, l, t, f = self.d_model, self.n_layers, self.seq_len, self.d_ff
        macs = (
            self.n_patches * (self.patch_size**2 * 3 * d)
            + l * t * (4 * d * d + 2 * d * f)
            + 2 * l * t * t * d
            + d * self.num_classes
        )
        return 3.0 * 2.0 * macs


# ViT-B/16 (86.6 M parameters), L/16 and S/16, remat on: without it every
# block keeps its fp32 [B, H, T, T] scores for the backward.
VIT_CONFIGS: dict[str, ViTConfig] = {
    "vit_b16": ViTConfig(remat=True),
    "vit_l16": ViTConfig(
        d_model=1024, n_layers=24, n_heads=16, d_ff=4096, remat=True
    ),
    "vit_s16": ViTConfig(
        d_model=384, n_layers=12, n_heads=6, d_ff=1536, remat=True
    ),
}


class Dense(nn.Module):
    """``nn.Dense(dtype=dtype)``: x @ Wᵀ + b with the input, the fp32
    weight [out, in] and the bias cast to ``dtype``. ``init`` draws the
    weight: "xavier_uniform", "lecun_normal" or "zeros"; the bias starts
    at zero."""

    def __init__(self, d_in, d_out, dtype, param_dtype, gen, init,
                 device=None):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(d_out, d_in, dtype=param_dtype, device=device)
        if init == "xavier_uniform":
            bound = math.sqrt(6.0 / (d_in + d_out))
            w.uniform_(-bound, bound, generator=gen)
        elif init == "lecun_normal":
            w.normal_(0.0, d_in ** -0.5, generator=gen)
        else:
            w.zero_()
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(
            torch.zeros(d_out, dtype=param_dtype, device=device))

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics, arithmetic
    and output, epsilon 1e-6, fp32 scale and bias."""

    def __init__(self, dim, param_dtype=torch.float32, device=None,
                 eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=param_dtype, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


class ViTBlock(nn.Module):
    """Pre-norm bidirectional self-attention and GELU MLP, each with a
    residual."""

    # Logical axes of the parameters ([out, in]), ``tpufw``'s names but
    # k and v's (see the module doc).
    LOGICAL_AXES = {
        "q.weight": ("q_heads", "embed"), "q.bias": ("q_heads",),
        "k.weight": ("kv_heads", "embed"), "k.bias": ("kv_heads",),
        "v.weight": ("kv_heads", "embed"), "v.bias": ("kv_heads",),
        "o.weight": ("embed", "q_heads"),
        "up.weight": ("mlp", "embed"), "up.bias": ("mlp",),
        "down.weight": ("embed", "mlp"),
    }

    def __init__(self, cfg: ViTConfig, gen, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model

        def dense(d_in, d_out):
            return Dense(d_in, d_out, cfg.dtype, cfg.param_dtype, gen,
                         "xavier_uniform", device)

        self.attn_norm = LayerNorm(d, cfg.param_dtype, device)
        self.q, self.k, self.v, self.o = (dense(d, d) for _ in range(4))
        self.mlp_norm = LayerNorm(d, cfg.param_dtype, device)
        self.up = dense(d, cfg.d_ff)
        self.down = dense(cfg.d_ff, d)

    def forward(self, x):
        cfg = self.cfg
        tp = tensor_group()
        y = tp.enter(self.attn_norm(x).to(cfg.dtype))
        outs = [self._heads(q, k, v) for q, k, v in zip(
            *(column(p, y, tp) for p in (self.q, self.k, self.v)))]
        x = x + row(self.o, outs, tp)
        y = tp.enter(self.mlp_norm(x).to(cfg.dtype))
        hs = [F.gelu(u, approximate="tanh") for u in column(self.up, y, tp)]
        return x + row(self.down, hs, tp)

    def _heads(self, q, k, v):
        """Attention of one shard's heads: q, k, v [B, T, h·hd] -> [B, T,
        h·hd]."""
        b, t, _ = q.shape
        hd = self.cfg.d_model // self.cfg.n_heads
        q, k, v = (p.reshape(b, t, -1, hd).transpose(1, 2)
                   for p in (q, k, v))
        h = q.shape[1]
        # QKᵀ with fp32 output (preferred_element_type), one batch of
        # b * h products.
        scores = matmul_f32(q.reshape(b * h, t, hd),
                            k.reshape(b * h, t, hd).transpose(1, 2))
        scores = scores.reshape(b, h, t, t) * (hd ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(self.cfg.dtype)
        return (probs @ v).transpose(1, 2).reshape(b, t, h * hd)


class ViT(nn.Module):
    """ViT classifier: NHWC images -> fp32 logits [B, num_classes] (with
    ``logit_shards``, the list of the held class shards' logits, see
    ``class_logits``). No batch statistics: train and eval mode compute
    the same function. Weights are drawn on ``device`` (default ``cuda``)
    from a ``torch.Generator`` seeded with ``seed``."""

    LOGICAL_AXES = {"head.weight": ("vocab", "embed"), "head.bias": ("vocab",)}

    def __init__(self, cfg: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        p, d = cfg.patch_size, cfg.d_model
        self.patch_embed = Dense(p * p * 3, d, cfg.dtype, cfg.param_dtype,
                                 gen, "xavier_uniform", dev)
        self.cls_token = (
            nn.Parameter(torch.zeros(1, 1, d, dtype=cfg.param_dtype,
                                     device=dev))
            if cfg.pool == "cls" else None)
        pos = torch.empty(1, cfg.seq_len, d, dtype=cfg.param_dtype,
                          device=dev)
        self.pos_embed = nn.Parameter(pos.normal_(0.0, 0.02, generator=gen))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, gen, dev) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(d, cfg.param_dtype, dev)
        self.head = Dense(d, cfg.num_classes, torch.float32, cfg.param_dtype,
                          gen, "zeros", dev)

    def forward(self, images, logit_shards: bool = False):
        cfg = self.cfg
        b = images.shape[0]
        p, g = cfg.patch_size, cfg.image_size // cfg.patch_size
        x = images.to(cfg.dtype).reshape(b, g, p, g, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
        x = self.patch_embed(x)
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(b, 1, cfg.d_model)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
        x = self.final_norm(x)
        pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
        return class_logits(self.head, pooled, logit_shards)


def class_logits(head: Dense, pooled: torch.Tensor, shards: bool):
    """The class head on ``pooled`` [B, D], vocab-parallel under a tensor
    group: the held class shards' logits (``shards``), or them gathered
    whole [B, num_classes]."""
    tp = tensor_group()
    parts = column(head, tp.enter(pooled), tp)
    return parts if shards else tp.gather(parts, -1)
