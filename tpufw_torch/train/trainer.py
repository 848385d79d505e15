"""Single-GPU training: loss, optimizer, step and the Trainer loop
(port of ``tpufw.train.trainer``).

The optimizer is optax's Llama recipe, built so the two packages take the
same steps: ``clip_by_global_norm(1.0)``, then AdamW
(b1 .9, b2 .95, eps 1e-8 outside the square root, weight decay .1 on every
parameter) under ``warmup_cosine_decay_schedule(0, lr, warmup, total,
0.1 * lr)``, evaluated at the pre-increment step count as optax does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tpufw_torch.models import model_for_config
from tpufw_torch.models.llama import Llama, LlamaConfig
from tpufw_torch.ops.loss import chunked_cross_entropy, token_cross_entropy
from tpufw_torch.train.metrics import Meter, StepMetrics, timed_batches
from tpufw_torch.utils.hardware import detect_chip, resolve_device


def cross_entropy_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 1e-4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token CE with z-loss over full logits. Returns (loss, n_tokens)."""
    ce = token_cross_entropy(logits, targets, z_loss_weight)
    if mask is None:
        return ce.mean(), torch.tensor(float(ce.numel()), device=ce.device)
    n = torch.clamp(mask.sum(), min=1.0)
    return (ce * mask).sum() / n, n


def shift_and_mask(batch: dict):
    """LM target shift + packed-batch masking. Returns (inputs, targets,
    input_segment_ids, loss_mask): boundary positions never predict the
    next document's first token, and padding targets (segment 0) never
    train."""
    tokens = batch["tokens"]
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    seg = batch.get("segment_ids")
    seg_in = None if seg is None else seg[:, :-1]
    mask = batch.get("loss_mask")
    mask = None if mask is None else mask[:, 1:].float()
    if seg is not None:
        same_seg = (seg[:, :-1] == seg[:, 1:]).float()
        nonpad = (seg[:, 1:] > 0).float()
        seg_mask = same_seg * nonpad
        mask = seg_mask if mask is None else mask * seg_mask
    return inputs, targets, seg_in, mask


def batch_loss(
    model: Llama,
    batch: dict,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM objective for one batch of device tensors: (loss, n_targets).
    ``loss_chunk_size`` switches to the chunked-vocab CE, which never
    materializes [B, T, V] logits; the model then skips its head, and the
    config's ``final_logit_soft_cap`` (Gemma) is applied per chunk."""
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    if loss_chunk_size:
        hidden = model(inputs, segment_ids=seg_in, return_hidden=True)
        return chunked_cross_entropy(
            hidden, model.head_kernel(), targets, mask,
            chunk_size=loss_chunk_size,
            compute_dtype=getattr(torch, loss_chunk_dtype),
            logits_soft_cap=getattr(model.cfg, "final_logit_soft_cap", None),
        )
    return cross_entropy_loss(model(inputs, segment_ids=seg_in), targets, mask)


def warmup_cosine_decay(
    step: int, peak: float, warmup: int, decay_steps: int, end: float
) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, end)."""
    if step < warmup:
        return peak * step / warmup
    span = decay_steps - warmup
    count = min(step - warmup, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
    alpha = 0.0 if peak == 0.0 else end / peak
    return peak * ((1.0 - alpha) * cosine + alpha)


class LlamaAdamW:
    """clip_by_global_norm -> AdamW -> schedule, with optax's arithmetic.

    The update is ``torch.optim.AdamW(fused=True)``, which matches optax's
    ``adamw``: decay on the pre-update parameter, eps outside the square
    root, the same bias correction. The clip and the learning rate at the
    pre-increment count are applied around it."""

    def __init__(
        self,
        params,
        lr: float = 3e-4,
        warmup_steps: int = 100,
        total_steps: int = 10_000,
        weight_decay: float = 0.1,
        grad_clip: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.95,
        eps: float = 1e-8,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.warmup = lr, warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.grad_clip = grad_clip
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay, fused=True,
        )

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(
            count, self.lr, self.warmup, self.decay_steps, 0.1 * self.lr
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping."""
        grads = [p.grad for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: where(norm < max, g, g / norm * max).
        torch._foreach_mul_(grads, torch.where(
            g_norm < self.grad_clip, 1.0, self.grad_clip / g_norm
        ))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        self.adamw.step()
        return g_norm


def default_optimizer(params, lr=3e-4, warmup_steps=100, total_steps=10_000):
    return LlamaAdamW(
        params, lr=lr, warmup_steps=warmup_steps, total_steps=total_steps
    )


def train_step(
    model: Llama,
    optimizer: LlamaAdamW,
    batch: dict,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype: str = "bfloat16",
    grad_accum: int = 1,
) -> dict:
    """One optimizer update; returns device tensors {loss, grad_norm}.

    ``grad_accum`` > 1 splits the batch into that many microbatches of
    strided rows (row m, m+A, ...) and accumulates token-weighted
    gradients, ``backward(loss * n)``, before the single update — the
    one-shot step's numbers up to summation order.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    optimizer.zero_grad()
    if grad_accum == 1:
        loss, _ = batch_loss(model, batch, loss_chunk_size, loss_chunk_dtype)
        loss.backward()
    else:
        l_sum = n_sum = 0.0
        for m in range(grad_accum):
            mb = {k: v[m::grad_accum] for k, v in batch.items()}
            loss, n = batch_loss(model, mb, loss_chunk_size, loss_chunk_dtype)
            n = n.detach()
            (loss * n).backward()
            l_sum = l_sum + loss.detach() * n
            n_sum = n_sum + n
        n_safe = torch.clamp(n_sum, min=1.0)
        loss = l_sum / n_safe
        for p in optimizer.params:
            p.grad.div_(n_safe)
    grad_norm = optimizer.step()
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def batch_to_device(batch: dict, device: torch.device) -> dict:
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
    }


@dataclasses.dataclass
class TrainerConfig:
    batch_size: int = 8
    seq_len: int = 2048
    total_steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    log_every: int = 10
    # Sequence positions per chunked-CE step; None = full logits.
    loss_chunk_size: Optional[int] = None
    # Head-matmul input dtype on the chunked path (fp32 accumulation).
    loss_chunk_dtype: str = "bfloat16"
    # Microbatches per optimizer step (1 = off).
    grad_accum: int = 1


class Trainer:
    """Builds the model and optimizer on one device and runs the step
    loop with tokens/s/GPU and MFU metrics."""

    def __init__(
        self,
        model_cfg: LlamaConfig,
        trainer_cfg: TrainerConfig,
        device=None,
    ):
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.device = resolve_device(device)
        self.model: Optional[Llama] = None
        self.optimizer: Optional[LlamaAdamW] = None
        self.step = 0

    def init_state(self, seed: int = 0, state_dict=None) -> Llama:
        """Random weights from ``seed``, or ``state_dict`` when given
        (e.g. ``tpufw_torch.interop.params_from_flax``); fresh optimizer
        state at step 0. A ``GemmaConfig`` builds a ``Gemma``, a
        ``DeepseekConfig`` a ``Deepseek``."""
        self.model = model_for_config(
            self.model_cfg, device=self.device, seed=seed
        )
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.optimizer = default_optimizer(
            self.model.parameters(),
            lr=self.cfg.lr,
            warmup_steps=self.cfg.warmup_steps,
            total_steps=self.cfg.total_steps,
        )
        self.step = 0
        return self.model

    def train_step(self, batch: dict) -> dict:
        accum = self.cfg.grad_accum
        if accum > 1 and self.cfg.batch_size % accum:
            raise ValueError(
                f"grad_accum={accum} must divide batch {self.cfg.batch_size}"
            )
        out = train_step(
            self.model, self.optimizer, batch_to_device(batch, self.device),
            self.cfg.loss_chunk_size, self.cfg.loss_chunk_dtype, accum,
        )
        self.step += 1
        return out

    def run(
        self,
        data: Iterator[dict],
        model_flops_per_token: float,
        on_metrics: Callable[[StepMetrics], None] | None = None,
    ) -> list[StepMetrics]:
        if self.model is None:
            self.init_state()
        meter = Meter(
            tokens_per_step=self.cfg.batch_size * (self.cfg.seq_len - 1),
            flops_per_token=model_flops_per_token,
            chip=detect_chip(self.device),
        )
        remaining = max(0, self.cfg.total_steps - self.step)
        history: list[StepMetrics] = []
        for i, (wait, batch) in enumerate(timed_batches(data)):
            if i >= remaining:
                break
            meter.start()
            m = self.train_step(batch)
            sm = meter.stop(self.step, m["loss"], data_wait_s=wait)
            history.append(sm)
            if on_metrics and i % self.cfg.log_every == 0:
                on_metrics(sm)
        return history
