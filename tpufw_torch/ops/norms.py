"""Normalization ops. RMSNorm is the Llama norm; computed in fp32."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, output cast back to x.dtype."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)
