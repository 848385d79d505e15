"""Knowledge distillation (port of ``tpufw.train.distill``): a student
trained against a frozen teacher.

Objective (Hinton et al. 2015, softened softmax):

  loss = alpha * T^2 * KL(softmax(teacher/T) || softmax(student/T))
       + (1 - alpha) * CE(student, hard labels)

The T^2 factor keeps the gradient's size comparable across temperatures.
Student and teacher logits are computed chunk by chunk from their hidden
states and reduced at once (``chunked_distill_loss``), so neither model's
[B, T, V] logits are ever held. The teacher may be another architecture
of any ported family (only the vocab must match); it is a frozen copy in
``teacher_dtype`` and its forward runs under ``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from tpufw_torch.ops.loss import (
    _chunk_seq,
    _enter,
    _vocab_ce,
    _vocab_logits,
    vocab_parallel_logsumexp,
)
from tpufw_torch.parallel.context import tensor_group
from tpufw_torch.parallel.tensor import check_divisible
from tpufw_torch.train import sharding
from tpufw_torch.train.checkpoint import load_params
from tpufw_torch.train.trainer import (
    LlamaAdamW,
    Trainer,
    batch_to_device,
    final_soft_cap,
    forward_with_aux,
    frozen_copy,
    frozen_model,
    on_mesh,
    shift_and_mask,
)


def _chunk_distill(h_s, h_t, t_c, m_c, student_kernel, teacher_kernel,
                   inv_t, compute_dtype, student_soft_cap, teacher_soft_cap,
                   group=None):
    """Masked (KL sum, CE sum) of one [B, C] chunk; under a ``group`` of
    more than one shard, both heads vocab-parallel: each softmax's max
    and log-sum-exp reduced over the group, and the KL a position
    ``sum_v p_t (log p_t - s_v / T) + lse_s sum_v p_t``, its sums over
    the vocabulary taken shard by shard and reduced."""
    s_logits = _vocab_logits(h_s, student_kernel, compute_dtype,
                             student_soft_cap, 1.0, group)
    t_logits = _vocab_logits(h_t, teacher_kernel, compute_dtype,
                             teacher_soft_cap, 1.0, group)
    if group is None or group.size == 1:
        s_logp = torch.log_softmax(s_logits[0] * inv_t, dim=-1)
        t_logp = torch.log_softmax(t_logits[0] * inv_t, dim=-1)
        # KL(t || s) per position; the teacher's entropy term is constant
        # in the student but kept, so the metric reads as a KL (0 at
        # equality).
        kl_tok = (t_logp.exp() * (t_logp - s_logp)).sum(-1)
        ce_tok = -torch.gather(torch.log_softmax(s_logits[0], dim=-1), -1,
                               t_c[..., None].long())[..., 0]
        return (kl_tok * m_c).sum(), (ce_tok * m_c).sum()
    s_scaled = [x * inv_t for x in s_logits]
    t_scaled = [x * inv_t for x in t_logits]
    lse_t = vocab_parallel_logsumexp(t_scaled, group)[..., None]
    t_logp = [x - lse_t for x in t_scaled]
    p_t = [x.exp() for x in t_logp]
    # log p_s = s / T - lse_s: the replicated lse_s enters once, whole.
    kl_tok = group.reduce([(p * (t - s)).sum(-1) for p, t, s in
                           zip(p_t, t_logp, s_scaled)]) \
        + vocab_parallel_logsumexp(s_scaled, group) * group.reduce(
            [p.sum(-1) for p in p_t])
    ce_tok = _vocab_ce(s_logits, student_kernel, t_c, group, 0.0)
    return (kl_tok * m_c).sum(), (ce_tok * m_c).sum()


def chunked_distill_loss(
    student_hidden: torch.Tensor,
    student_kernel: torch.Tensor,
    teacher_hidden: torch.Tensor,
    teacher_kernel: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    temperature: float = 1.0,
    alpha: float = 0.5,
    chunk_size: int = 256,
    compute_dtype: torch.dtype = torch.bfloat16,
    student_soft_cap: Optional[float] = None,
    teacher_soft_cap: Optional[float] = None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, kl, ce) masked means, chunked over the sequence axis; each
    chunk is checkpointed, so its logits are recomputed in the backward.

    kl is the temperature-softened KL(teacher || student) times T^2; ce
    the hard-label cross entropy (no z-loss). Each model's final soft cap
    (Gemma) applies to its own logits before the temperature; the two may
    differ. The vocab sizes must match. ``group``: a tensor group both
    heads are split over on the vocabulary (the kernels whole in one
    process, this rank's [D, V/tp] in a gang)."""
    if student_kernel.shape[-1] != teacher_kernel.shape[-1]:
        raise ValueError(
            f"student vocab {student_kernel.shape[-1]} != teacher vocab "
            f"{teacher_kernel.shape[-1]}: distillation KL needs one vocab")
    mask = mask.float()
    student_hidden = _enter(student_hidden, group)
    hs, ts, ms = _chunk_seq(chunk_size, student_hidden, targets, mask)
    ht, _, _ = _chunk_seq(chunk_size, teacher_hidden, targets, mask)
    zero = torch.zeros((), dtype=torch.float32, device=student_hidden.device)
    kl_sum, ce_sum, n = zero, zero, zero
    for h_s, h_t, t_c, m_c in zip(hs, ht, ts, ms):
        kl_c, ce_c = checkpoint(
            _chunk_distill, h_s, h_t, t_c, m_c, student_kernel,
            teacher_kernel, 1.0 / temperature, compute_dtype,
            student_soft_cap, teacher_soft_cap, group, use_reentrant=False,
        )
        kl_sum, ce_sum, n = kl_sum + kl_c, ce_sum + ce_c, n + m_c.sum()
    n_safe = torch.clamp(n, min=1.0)
    kl = temperature ** 2 * kl_sum / n_safe
    ce = ce_sum / n_safe
    return alpha * kl + (1.0 - alpha) * ce, kl, ce


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    # Softmax temperature of both distributions (the KL term).
    temperature: float = 2.0
    # KL weight; (1 - alpha) goes to the hard-label CE. 1.0 = pure KL.
    alpha: float = 0.5
    # Storage dtype of the frozen teacher.
    teacher_dtype: str = "bfloat16"


def distill_train_step(
    model,
    optimizer: LlamaAdamW,
    teacher,
    batch: dict,
    temperature: float = 2.0,
    alpha: float = 0.5,
    loss_chunk_size: int = 256,
    loss_chunk_dtype: str = "bfloat16",
    norm_fn=None,
) -> dict:
    """One distillation update on a packed LM batch of device tensors;
    returns device tensors {loss, kl_loss, ce_loss, grad_norm}. The
    teacher's hidden states come from a forward under ``torch.no_grad``;
    a MoE student's router loss joins the objective. Under a process
    group ``batch`` is this rank's rows of the global batch (sharded
    models): the losses and the gradients are the global batch's token
    means. ``norm_fn``: the clip's global norm where parameters are split
    (``LlamaAdamW.step``)."""
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    with torch.no_grad():
        t_hidden, _ = forward_with_aux(teacher, inputs, seg_in)
    optimizer.zero_grad()
    s_hidden, aux = forward_with_aux(model, inputs, seg_in)
    total, kl, ce = chunked_distill_loss(
        s_hidden, model.head_kernel(), t_hidden, teacher.head_kernel(),
        targets, mask, temperature=temperature, alpha=alpha,
        chunk_size=loss_chunk_size,
        compute_dtype=getattr(torch, loss_chunk_dtype),
        student_soft_cap=final_soft_cap(model),
        teacher_soft_cap=final_soft_cap(teacher),
        group=tensor_group(),
    )
    loss = total + aux
    loss = sharding.backward_global_mean(loss, mask.sum())
    kl, ce = sharding.global_mean(torch.stack([kl, ce]), mask.sum())
    grad_norm = optimizer.step(norm_fn)
    return {"loss": loss.detach(), "kl_loss": kl.detach(),
            "ce_loss": ce.detach(), "grad_norm": grad_norm}


class DistillTrainer(Trainer):
    """``Trainer`` whose objective distills a frozen teacher into the
    student; ``run``, checkpoints, SIGTERM and the ``Meter`` are
    inherited, and ``set_teacher`` (or ``set_teacher_from``) must come
    before the first step. The teacher's forward (2N_t a token, a third
    of its own 6N count) is credited when ``run`` is given it, as the
    train workload does. Under tensor and expert axes the teacher is cut
    by the student's groups and its forward runs under them."""

    def __init__(self, model_cfg, trainer_cfg, mesh_cfg=None, device=None,
                 distill: DistillConfig = DistillConfig(), groups=()):
        super().__init__(model_cfg, trainer_cfg, mesh_cfg, device, groups)
        if trainer_cfg.grad_accum != 1:
            raise NotImplementedError(
                "DistillTrainer does not implement grad_accum; silently "
                "ignoring it would change optimization semantics vs the "
                "base Trainer")
        self.distill = distill
        self.teacher = None

    def _check_vocab(self, teacher_cfg) -> None:
        """The vocabularies must match; under a split the teacher's
        dimensions must divide by the student's axes, as the student's
        do (a teacher with no experts takes no expert split)."""
        if teacher_cfg.vocab_size != self.model_cfg.vocab_size:
            raise ValueError(
                f"teacher vocab {teacher_cfg.vocab_size} != student vocab "
                f"{self.model_cfg.vocab_size}")
        if self.split:
            tp, ep = self.groups
            check_divisible(teacher_cfg, tp.size,
                            ep.size if getattr(teacher_cfg, "n_experts", 0)
                            else 1)

    def set_teacher(self, teacher_model) -> None:
        """Install a frozen copy of ``teacher_model`` (any ported family
        with the student's vocab) in ``teacher_dtype`` on this trainer's
        device: fresh storage, never the caller's tensors."""
        self._check_vocab(teacher_model.cfg)
        self.teacher = frozen_copy(
            teacher_model, getattr(torch, self.distill.teacher_dtype)
        ).to(self.device)
        self._shard(self.teacher)

    def set_teacher_from(self, teacher_cfg, path: str) -> None:
        """Install the teacher from a bare-params directory of
        ``teacher_cfg``'s model (``checkpoint.save_params``, the
        ``tools.import_hf`` output), read onto this trainer's device and
        cast to ``teacher_dtype``."""
        self._check_vocab(teacher_cfg)
        _, state = load_params(path, teacher_cfg, self.device)
        self.teacher = frozen_model(
            teacher_cfg, state, getattr(torch, self.distill.teacher_dtype))
        self._shard(self.teacher)

    @on_mesh
    def train_step(self, batch: dict) -> dict:
        if self.teacher is None:
            raise RuntimeError(
                "distillation step before set_teacher(): install the "
                "frozen teacher first")
        out = distill_train_step(
            self.model, self.optimizer, self.teacher,
            batch_to_device(batch, self.device),
            temperature=self.distill.temperature, alpha=self.distill.alpha,
            loss_chunk_size=self.cfg.loss_chunk_size or 256,
            loss_chunk_dtype=self.cfg.loss_chunk_dtype,
            norm_fn=self._norm_fn(),
        )
        self.step += 1
        return out
