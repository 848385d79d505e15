"""ResNet-50 in PyTorch (port of ``tpufw.models.resnet``).

ResNet-v1.5 bottleneck network: the stride sits on the 3x3 conv. Images
are NHWC at the API, as in the JAX model; inside, the NCHW view of that
memory is ``channels_last``, the layout cuDNN runs fastest. Numerics of
the JAX model, trap by trap:

- convs in ``cfg.dtype`` (bf16) on fp32 master weights, no bias, drawn
  with variance scaling 2.0 over fan_out (normal);
- flax ``Conv``'s default ``SAME`` padding is computed from the input:
  a stride-2 3x3 conv on an even input pads (0, 1), not torch's (1, 1),
  so every conv pads explicitly (``same_padding``); the stem pads (3, 3);
- ``BatchNorm`` is flax's with momentum 0.9 and epsilon 1e-5: in training
  the batch statistics are reduced in fp32 and the running variance
  takes the **biased** batch variance (``nn.BatchNorm2d`` would take the
  unbiased one); in eval the running statistics normalize. The
  normalization is computed in fp32 and its output cast to
  ``cfg.norm_dtype``. In a gang (``BatchNorm.stat_group`` set, the
  vision trainer's sharding) the training statistics are the global
  batch's, as in ``tpufw``'s one program over the sharded batch;
- ``bn3`` (each block's last BN) starts with its scale at zero, so a
  residual branch starts as the identity;
- the head is fp32 (lecun-normal weights, zero bias) on the spatial mean;
  under a tensor group it is vocab-parallel (``tpufw``'s ``("embed",
  "vocab")``), the convolutions replicated.

State-dict names follow the Flax tree (``conv_init``, ``bn_init``,
``stage{s}_block{b}.conv1`` ... ``bn_proj``, ``head``);
``tpufw_torch.interop.vision_params_from_flax`` converts it, batch
statistics into the BN buffers ``running_mean``/``running_var``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpufw_torch.models.vit import Dense, class_logits
from tpufw_torch.utils.hardware import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # The dtype BatchNorm's output is cast to (statistics are fp32 either
    # way); bf16 halves the bytes the bandwidth-bound early stages move.
    norm_dtype: torch.dtype = torch.float32

    def flops_per_image(self, image_size: int = 224) -> float:
        """~4.1 GFLOP forward for 224x224 ResNet-50, quadratic in the
        resolution; x3 for forward and backward."""
        return 3.0 * 4.1e9 * (image_size / 224) ** 2


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high), the odd
    pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=dtype)``: an OIHW fp32 weight
    cast to ``dtype``; ``padding`` None is ``SAME``, else (low, high) on
    both spatial dims."""

    def __init__(self, c_in, c_out, kernel, stride, cfg, gen, padding=None,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, cfg.dtype
        w = torch.empty(c_out, c_in, kernel, kernel, dtype=cfg.param_dtype,
                        device=device)
        w.normal_(0.0, math.sqrt(2.0 / (c_out * kernel * kernel)),
                  generator=gen)
        self.weight = nn.Parameter(w)

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.padding is None:
            ph = same_padding(x.shape[2], k, self.stride)
            pw = same_padding(x.shape[3], k, self.stride)
        else:
            ph = pw = self.padding
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        x = x.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=norm_dtype)``
    over the channel dim of an NCHW tensor. Training normalizes with the
    batch statistics and updates ``running_mean``/``running_var`` with
    the fp32 mean and the biased variance; eval normalizes with the
    running ones.

    ``stat_group`` (a process group, None on one rank) makes the training
    statistics the gang's over every rank's rows, each rank holding an
    equal share: the global mean first, then the global mean of
    (x − mean)², both in fp32 through ``parallel.group.all_sum``, whose
    gradient is the global batch's; the running statistics take the
    global mean and biased variance. ``nn.SyncBatchNorm`` would update
    ``running_var`` with the unbiased variance."""

    stat_group = None

    def __init__(self, c, norm_dtype, zero_scale=False, device=None,
                 momentum=0.9, eps=1e-5):
        super().__init__()
        self.norm_dtype, self.momentum, self.eps = norm_dtype, momentum, eps
        self.weight = nn.Parameter(
            (torch.zeros if zero_scale else torch.ones)(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        # fp32 arithmetic inside F.batch_norm, output in the input's dtype:
        # a bf16 input gives the fp32 result rounded to bf16.
        x = x.to(self.norm_dtype) if self.norm_dtype == torch.float32 else x
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.norm_dtype)
        if self.stat_group is not None:
            return self._global_batch_norm(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.to(self.norm_dtype)

    @torch.no_grad()
    def _update_running(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _global_batch_norm(self, x):
        """Training mode over the gang's rows (see the class doc), the
        fp32 result rounded once to ``norm_dtype``."""
        from tpufw_torch.parallel.group import all_sum

        xf = x.float()
        count = xf.numel() // xf.shape[1] * self.stat_group.size()
        mean = all_sum(xf.sum(dim=(0, 2, 3)), self.stat_group) / count
        centered = xf - mean[:, None, None]
        var = all_sum((centered * centered).sum(dim=(0, 2, 3)),
                      self.stat_group) / count
        self._update_running(mean.detach(), var.detach())
        y = centered * torch.rsqrt(var + self.eps)[:, None, None]
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(self.norm_dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x filters), BN after each, ReLU; the
    first block of a stage projects the residual (1x1, stride, BN)."""

    def __init__(self, c_in, filters, stride, cfg, gen, device=None):
        super().__init__()
        nd = cfg.norm_dtype
        self.conv1 = Conv(c_in, filters, 1, 1, cfg, gen, device=device)
        self.bn1 = BatchNorm(filters, nd, device=device)
        self.conv2 = Conv(filters, filters, 3, stride, cfg, gen,
                          device=device)
        self.bn2 = BatchNorm(filters, nd, device=device)
        self.conv3 = Conv(filters, filters * 4, 1, 1, cfg, gen,
                          device=device)
        self.bn3 = BatchNorm(filters * 4, nd, zero_scale=True, device=device)
        self.proj = self.bn_proj = None
        if c_in != filters * 4 or stride != 1:
            self.proj = Conv(c_in, filters * 4, 1, stride, cfg, gen,
                             device=device)
            self.bn_proj = BatchNorm(filters * 4, nd, device=device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """ResNet-v1.5: NHWC images -> fp32 logits [B, num_classes]. Weights
    are drawn on ``device`` (default ``cuda``) from a ``torch.Generator``
    seeded with ``seed``; ``train()``/``eval()`` pick batch or running
    statistics. ``logit_shards`` as ``ViT``'s."""

    LOGICAL_AXES = {"head.weight": ("vocab", "embed"), "head.bias": ("vocab",)}

    def __init__(self, cfg: ResNetConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        self.conv_init = Conv(3, cfg.width, 7, 2, cfg, gen, padding=(3, 3),
                              device=dev)
        self.bn_init = BatchNorm(cfg.width, cfg.norm_dtype, device=dev)
        self.block_names = []
        c = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * 2**stage
            for block in range(n_blocks):
                name = f"stage{stage}_block{block}"
                stride = 2 if block == 0 and stage > 0 else 1
                self.add_module(name, BottleneckBlock(c, filters, stride, cfg,
                                                      gen, dev))
                self.block_names.append(name)
                c = filters * 4
        self.head = Dense(c, cfg.num_classes, torch.float32, cfg.param_dtype,
                          gen, "lecun_normal", dev)

    def forward(self, images, logit_shards: bool = False):
        # NHWC memory seen as NCHW: channels_last, no copy.
        x = images.permute(0, 3, 1, 2).to(self.cfg.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return class_logits(self.head, x.mean(dim=(2, 3)), logit_shards)


def resnet50(num_classes: int = 1000, device=None, seed: int = 0,
             **kw) -> ResNet:
    return ResNet(ResNetConfig(num_classes=num_classes, **kw), device=device,
                  seed=seed)
