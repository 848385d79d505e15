"""Token sampling transforms: temperature, top-k, top-p, min-p, repetition
penalty, greedy (port of ``tpufw.infer.sampling``).

Pure [B, V] logits -> [B] token functions. The draw takes an explicit
``torch.Generator`` in place of a jax key: Gumbel-max over one uniform
per logit, so every sampled call consumes exactly B·V uniforms from the
generator, in call order, whatever the logits. Greedy decoding consumes
none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    # 0.0 = greedy (argmax); otherwise logits are divided by temperature.
    temperature: float = 0.0
    # Keep only the k most likely tokens (0/None disables).
    top_k: Optional[int] = None
    # Nucleus sampling: keep the smallest set of tokens whose cumulative
    # probability reaches top_p (1.0/None disables).
    top_p: Optional[float] = None
    # Drop tokens whose probability is below min_p * max probability
    # (None disables).
    min_p: Optional[float] = None
    # HF-style repetition penalty (> 1.0 discourages): logits of tokens
    # already seen (prompt + generated so far) are divided by the penalty
    # when positive, multiplied when negative. 1.0/None disables. Applied
    # before temperature, as transformers does.
    repetition_penalty: Optional[float] = None


def track_seen(cfg: SamplingConfig) -> bool:
    """Whether decoding must keep the [B, V] seen-token mask."""
    return cfg.repetition_penalty is not None and cfg.repetition_penalty != 1.0


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits. [B, V] -> [B, V]."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus mask: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p (the top token always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Token i is kept while the mass before it is < p; p <= 0 degrades to
    # the top token, never to masking everything.
    keep = (cum - probs) < p
    keep[..., 0] = True
    threshold = torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < threshold, _NEG, logits)


def apply_min_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Mask tokens with probability < p * max probability."""
    logprobs = torch.log_softmax(logits, dim=-1)
    threshold = logprobs.amax(dim=-1, keepdim=True) + torch.log(
        torch.tensor(p, dtype=logprobs.dtype)
    )
    return torch.where(logprobs < threshold, _NEG, logits)


def apply_repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """HF rule: for tokens in ``seen`` ([B, V] bool), positive logits
    divide by the penalty, negative ones multiply."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def transform_logits(
    logits: torch.Tensor,
    cfg: SamplingConfig,
    seen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply cfg's transforms to [..., V] logits in fp32: the exact
    distribution ``sample_token`` draws from. Greedy (temperature 0)
    returns after the penalty."""
    logits = logits.float()
    if track_seen(cfg) and seen is not None:
        logits = apply_repetition_penalty(
            logits, seen, cfg.repetition_penalty
        )
    if cfg.temperature == 0.0:
        return logits
    logits = logits / cfg.temperature
    if cfg.top_k:
        logits = apply_top_k(logits, cfg.top_k)
    if cfg.top_p is not None and cfg.top_p < 1.0:
        logits = apply_top_p(logits, cfg.top_p)
    if cfg.min_p is not None and cfg.min_p > 0.0:
        logits = apply_min_p(logits, cfg.min_p)
    return logits


def sample_token(
    logits: torch.Tensor,
    cfg: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    seen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, V] float logits -> [B] int64 tokens. ``generator`` (on the
    logits' device) drives the draw; ``seen`` is the [B, V] bool mask the
    repetition penalty applies to (None skips the penalty)."""
    logits = transform_logits(logits, cfg, seen)
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return gumbel_argmax(logits, draw_uniforms(logits.shape, generator,
                                               logits.device))


def draw_uniforms(shape, generator, device) -> torch.Tensor:
    """The uniforms one sampled draw of ``shape`` takes from
    ``generator``, kept off 0 so their double log stays finite."""
    return torch.rand(shape, generator=generator, device=device).clamp_min(
        torch.finfo(torch.float32).tiny
    )


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gumbel-max over transformed ``logits`` with the uniforms ``u`` of
    one draw: a sample of softmax(logits) along the last axis."""
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
