"""Single-GPU training: loss, optimizer, step and the Trainer loop
(port of ``tpufw.train.trainer``).

The optimizer is optax's Llama recipe, built so the two packages take the
same steps: ``clip_by_global_norm(1.0)``, then AdamW
(b1 .9, b2 .95, eps 1e-8 outside the square root, weight decay .1 on every
parameter) under ``warmup_cosine_decay_schedule(0, lr, warmup, total,
0.1 * lr)``, evaluated at the pre-increment step count as optax does.
``adam_mu_dtype`` stores the first moment in another dtype (optax's
``adamw(mu_dtype=)``).

``Trainer.run`` syncs the host on the loss every ``sync_every`` steps
(after the first and the last too), metering each window of steps as one
``StepMetrics``, and runs the held-out evaluation (``Trainer.evaluate``)
every ``eval_every`` steps at those sync points. At the same points it
checkpoints (``train.checkpoint``, every ``checkpoint_every`` steps) and
stops on SIGTERM with a forced save (``train.preemption``);
``maybe_restore`` resumes from the latest checkpoint, ``init_from_params``
starts from bare params. ``cfg.telemetry_dir``, ``metrics_port`` and
``profile_dir`` turn on ``tpufw``'s telemetry (``run_steps``: events,
spans, goodput, skew, the counted first step's costs, a ``torch.profiler``
window, the ``/metrics`` server).

Data and FSDP parallelism: when a ``torch.distributed`` process group is
initialized, ``Trainer`` builds the model whole on its rank's device (from
the seed, from params or from a checkpoint: every rank holds the same
full tensors, the seed and the files being the same on every rank), then
shards it over the mesh of ``mesh_cfg`` (``train.sharding.shard_model``);
the optimizer's moments are made, or restored, sharded. Each rank feeds
the ``batch_size / (data · fsdp)`` rows of its batch shard
(``batch_shard``); the loss, ``grad_norm`` and the held-out evaluation
are the global batch's, as ``tpufw``'s jitted step computes them.
Without a process group nothing of this runs.

Sequence parallelism: under a ``sequence`` axis above 1 the ranks of one
batch shard feed the same rows, and each trains its contiguous chunk of
the ``seq_len - 1`` shifted positions (``shift_and_mask``) at its global
RoPE positions (``forward_with_aux``); the ``ring`` and ``ulysses``
attention backends exchange K/V along the ring, and ``xla`` and
``flash`` attend over the gathered sequence. The trainer registers its
mesh (``parallel.context``) for its steps and evaluations; without a
process group that mesh is a ring of one shard, so ``ring`` and
``ulysses`` train in one process with the numbers of ``flash``, unless
``groups=`` holds a ``LocalSequenceGroup``: every shard of that ring in
the one process.

Tensor and expert parallelism: under ``tensor`` or ``expert`` axes above
1 every rank builds the model whole, then keeps its shards of the split
parameters (``parallel.tensor.cut_model``: Megatron's heads, MLP widths
and vocabulary over ``tensor``, a MoE layer's experts over ``expert``)
before ``fully_shard`` shards them over the batch-shard ranks of its
(``expert``, ``tensor``) coordinate. The ranks of one coordinate feed
different rows; the loss, its token count and the means run over them
(``sharding.batch_ranks``), the global-norm clip counts a split
gradient's shards once each and a replicated one once
(``parallel.tensor.split_norm``), and a checkpoint gathers the split
tensors whole (``sharding.SplitPart``), so it resumes at any world size.
One process runs the same shard math over several shards with
``groups=(LocalTensorGroup(n), LocalExpertGroup(m))``, and a
``LocalSequenceGroup(s)`` among them runs every shard's attention over a
ring of s in that process. The post-trainers (DPO, distillation,
embeddings, GRPO) take both axes too: their heads go through the
vocab-parallel log-probs and KL, their frozen side models are cut as the
policy is. Both axes compose with a ``sequence`` axis (each tensor
shard's heads run their own ring; the means and the MoE routing group
then span the coordinate's data x fsdp x sequence ranks) and with LoRA
(the adapters split with their weights, ``parallel.tensor``).

LoRA: a model with ``lora_rank`` > 0 is built with its base frozen
(``requires_grad=False``), and ``LlamaAdamW`` takes the parameters that
need gradients, so the global-norm clip and AdamW see the adapters alone
(``tpufw``'s ``multi_transform`` of the adapters' chain and
``set_to_zero`` for the base). The reported ``grad_norm`` is then the
adapters' (``tpufw``'s counts the base's gradients as well).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tpufw_torch.mesh import MeshConfig, build_mesh, mesh_shape
from tpufw_torch.models import model_for_config
from tpufw_torch.models.llama import Llama, LlamaConfig
from tpufw_torch.models.lora import init_adapters, is_lora_name
from tpufw_torch.ops.loss import chunked_cross_entropy, token_cross_entropy
from tpufw_torch.parallel.context import (
    model_groups,
    partial_sequence_group,
    tensor_group,
    use_groups,
    use_mesh,
)
from tpufw_torch.parallel.group import (
    LocalExpertGroup,
    LocalShardGroup,
    LocalSequenceGroup,
    LocalTensorGroup,
)
from tpufw_torch.parallel.tensor import (
    check_divisible,
    cut_model,
    cut_tensor,
    split_norm,
)
from tpufw_torch.train import sharding
from tpufw_torch.train.checkpoint import (
    CheckpointManager,
    check_identity,
    config_identity,
    config_to_dict,
    load_params,
)
from tpufw_torch.obs import Telemetry
from tpufw_torch.obs.perf import resolve_profile_window
from tpufw_torch.train.metrics import Meter, StepMetrics, timed_batches
from tpufw_torch.train.preemption import checkpoint_stop, owned_shutdown
from tpufw_torch.utils.hardware import detect_chip, resolve_device
from tpufw_torch.utils.profiling import StepProfiler


def frozen_copy(model, dtype: torch.dtype):
    """A model of ``model``'s config whose floating tensors are fresh
    storage in ``dtype`` (integer ones fresh copies too), with
    ``requires_grad`` off and in eval mode: the frozen side model of
    post-training (the DPO or GRPO reference, the distillation teacher),
    never aliasing the policy that the optimizer updates in place. A
    sharded model is gathered whole first (a collective)."""
    return frozen_model(model.cfg, sharding.full_state_dict(model.state_dict()),
                        dtype)


def frozen_model(cfg, state_dict: dict, dtype: torch.dtype):
    """A frozen model of ``cfg`` (built on ``meta``) holding a fresh copy
    of each tensor of ``state_dict``, floating ones cast to ``dtype``;
    see ``frozen_copy``."""
    model = model_for_config(cfg, device="meta")
    fresh = {k: (v.to(dtype, copy=True) if v.is_floating_point()
                 else v.clone()) for k, v in state_dict.items()}
    model.load_state_dict(fresh, assign=True)
    model.requires_grad_(False)
    return model.eval()


def final_soft_cap(model) -> Optional[float]:
    """The model's final-logit soft cap (Gemma), which the chunked head
    path applies since ``return_hidden`` skips the model's own."""
    return getattr(model.cfg, "final_logit_soft_cap", None)


def forward_with_aux(model, inputs: torch.Tensor,
                     segment_ids: Optional[torch.Tensor] = None,
                     return_hidden: bool = True):
    """(post-final-norm hidden states [B, T, D], or logits without
    ``return_hidden``; the MoE router loss or 0.0) of ``model`` on
    ``inputs``: the one forward of every objective. Under a sequence split
    (``shift_and_mask``) the positions are the chunk's global ones."""
    kw = {"segment_ids": segment_ids, "return_hidden": return_hidden,
          "positions": sequence_positions(inputs)}
    if getattr(model.cfg, "n_experts", 0) > 0:
        return model(inputs, return_aux=True, **kw)
    return model(inputs, **kw), 0.0


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


def sequence_positions(inputs: torch.Tensor) -> Optional[torch.Tensor]:
    """The global positions [B, L] of this rank's chunk of the sequence
    under a sequence split (rank·L + arange(L)), else None (the model's
    default, arange)."""
    group = partial_sequence_group()
    if group is None:
        return None
    b, l = inputs.shape[:2]
    return (group.rank * l + torch.arange(l, device=inputs.device)).expand(
        b, l)


def sequence_chunk(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's contiguous chunk of ``x`` [B, T', ...] along the
    positions under a sequence split (ValueError when the ring's size
    does not divide T'), else ``x``."""
    group = partial_sequence_group()
    if group is None or x is None:
        return x
    t = x.shape[1]
    if t % group.size:
        raise ValueError(
            f"the sequence axis of size {group.size} must divide the "
            f"{t} trained positions (seq_len - 1)")
    l = t // group.size
    return x[:, group.rank * l:(group.rank + 1) * l]


def shift_and_mask(batch: dict):
    """LM target shift + packed-batch masking. Returns (inputs, targets,
    input_segment_ids, loss_mask): boundary positions never predict the
    next document's first token, and padding targets (segment 0) never
    train. The shift runs on whole rows; under a sequence split each of
    the four is then this rank's chunk of the positions."""
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
    return tuple(map(sequence_chunk, (inputs, targets, seg_in, mask)))


def target_count(batch: dict) -> torch.Tensor:
    """The number of trained target positions of ``batch`` (fp32, not
    clamped), without its forward: what an accumulating step counts
    before its first microbatch."""
    _, targets, _, mask = shift_and_mask(batch)
    if mask is None:
        return torch.tensor(float(targets.numel()), device=targets.device)
    return mask.sum()


def batch_loss(
    model: Llama,
    batch: dict,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype: str = "bfloat16",
) -> tuple[torch.Tensor, torch.Tensor]:
    """LM objective for one batch of device tensors: (loss, n_targets).
    ``loss_chunk_size`` switches to the chunked-vocab CE, which never
    materializes [B, T, V] logits; the model then skips its head, and the
    config's ``final_logit_soft_cap`` (Gemma) is applied per chunk. A MoE
    model's router loss (``return_aux`` of a config with experts: Mixtral,
    DeepSeek MoE) joins the objective on both paths, as in ``tpufw``.
    Under a tensor group the head is vocab-parallel and its logits stay
    split: the loss takes the chunked path, a whole sequence a chunk when
    ``loss_chunk_size`` is unset, its head product in the dtypes of the
    model's own head."""
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    tp = tensor_group()
    chunk = loss_chunk_size or (inputs.shape[1] if tp.size > 1 else None)
    out, aux = forward_with_aux(model, inputs, seg_in,
                                return_hidden=bool(chunk))
    if chunk:
        if loss_chunk_size:
            dtype = getattr(torch, loss_chunk_dtype)
        elif model.lm_head is None:
            dtype = model.cfg.dtype
        else:
            dtype = torch.promote_types(out.dtype, model.lm_head.dtype)
        loss, n = chunked_cross_entropy(
            out, model.head_kernel(), targets, mask, chunk_size=chunk,
            compute_dtype=dtype, logits_soft_cap=final_soft_cap(model),
            group=tp,
        )
    else:
        loss, n = cross_entropy_loss(out, targets, mask)
    return loss + aux, n


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
    pre-increment count are applied around it.

    ``mu_dtype`` (e.g. ``"bfloat16"``; None: the parameters' dtype) stores
    the first moment in that dtype, the second staying in the
    parameters'. The fused AdamW keeps both in the parameters' dtype, so
    this takes an update of its own with optax's ``adamw(mu_dtype=)``
    arithmetic, op for op as optax runs it eagerly: the new moment
    ``(1 - b1) * g + b1 * mu`` (the decayed term rounded in ``mu_dtype``)
    is bias-corrected and applied at the gradients' precision, and only
    then rounded into storage. Compiled, XLA may fuse the bf16 product
    without its rounding, so the two differ by an ulp of the moment."""

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
        mu_dtype: Optional[str] = None,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.warmup = lr, warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.grad_clip = grad_clip
        self.count = 0
        self.adamw = None
        self.mu = self.nu = None
        if mu_dtype is None:
            self.adamw = torch.optim.AdamW(
                self.params, lr=0.0, betas=(b1, b2), eps=eps,
                weight_decay=weight_decay, fused=True,
            )
            return
        dtype = getattr(torch, mu_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"adam_mu_dtype={mu_dtype!r} is not a torch dtype")
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p, dtype=dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(
            count, self.lr, self.warmup, self.decay_steps, 0.1 * self.lr
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, norm_fn: Optional[Callable] = None) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping. A parameter the loss did not reach
        (an embedding objective's LM head) takes a zero gradient, as
        optax's update of a gradient tree does: weight decay still
        applies to it. ``norm_fn(grads)`` gives the global norm where the
        parameters are held apart across ranks (pipeline stages)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        # Over sharded gradients (DTensors) the norm is the global one.
        g_norm = norm_fn(grads) if norm_fn is not None else \
            sharding.full_tensor(torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads))))
        # optax: where(norm < max, g, g / norm * max), on each shard.
        torch._foreach_mul_([sharding.local_tensor(g) for g in grads],
                            torch.where(g_norm < self.grad_clip, 1.0,
                                        self.grad_clip / g_norm))
        lr = self.schedule(self.count)
        self.count += 1
        if self.adamw is None:
            self._mu_dtype_step(grads, lr)
            return g_norm
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return g_norm

    def state_dict(self) -> dict:
        """``count`` and the moments: the fused AdamW's own state dict, or
        the ``mu``/``nu`` lists of the ``mu_dtype`` form."""
        if self.adamw is not None:
            return {"count": self.count, "adamw": self.adamw.state_dict()}
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Inverse of ``state_dict``; the form (fused or ``mu_dtype``)
        and every moment's dtype must match this optimizer's. Moments
        saved whole (a checkpoint's, any world size) are sharded as their
        parameters are."""
        if (self.adamw is None) != ("adamw" not in state):
            raise ValueError(
                "optimizer state of the other form: fused AdamW vs "
                "adam_mu_dtype moments")
        if self.adamw is not None:
            saved = state["adamw"]
            if any(sharding.is_dtensor(p) for p in self.params):
                saved = dict(saved, state={
                    i: {k: (sharding.shard_like(v, self.params[i])
                            if k != "step" else v) for k, v in st.items()}
                    for i, st in saved["state"].items()})
            self.adamw.load_state_dict(saved)
        else:
            for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
                if [t.dtype for t in mine] != [t.dtype for t in theirs]:
                    raise ValueError("adam_mu_dtype differs from the saved one")
                for a, b in zip(mine, theirs):
                    sharding.load_into(a, b)
        self.count = int(state["count"])

    def _mu_dtype_step(self, grads, lr: float) -> None:
        """optax ``scale_by_adam(mu_dtype=)``, ``add_decayed_weights`` and
        the learning rate, per parameter."""
        b1, b2 = self.b1, self.b2
        # 1 - decay**count in fp32, as optax computes it.
        f32 = dict(dtype=torch.float32, device=self.params[0].device)
        count = torch.tensor(float(self.count), **f32)
        bc1 = 1.0 - torch.tensor(b1, **f32) ** count
        bc2 = 1.0 - torch.tensor(b2, **f32) ** count
        b1_mu = torch.tensor(b1, dtype=self.mu[0].dtype, device=f32["device"])
        # Elementwise: each rank updates its shards.
        loc = sharding.local_tensor
        for p, g, mu, nu in zip(map(loc, self.params), map(loc, grads),
                                map(loc, self.mu), map(loc, self.nu)):
            # optax's ``(1 - b1) * g + b1 * mu``: JAX's weak-typed b1
            # takes mu's dtype, so the decayed moment is a product of two
            # values in mu's dtype; the sum is in the gradients'.
            m = (1.0 - b1) * g + (mu * b1_mu).to(g.dtype)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            upd = (m / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(upd + self.weight_decay * p, alpha=-lr)
            mu.copy_(m)


def default_optimizer(params, lr=3e-4, warmup_steps=100, total_steps=10_000,
                      mu_dtype=None):
    return LlamaAdamW(
        params, lr=lr, warmup_steps=warmup_steps, total_steps=total_steps,
        mu_dtype=mu_dtype,
    )


def train_step(
    model: Llama,
    optimizer: LlamaAdamW,
    batch: dict,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype: str = "bfloat16",
    grad_accum: int = 1,
    norm_fn: Optional[Callable] = None,
) -> dict:
    """One optimizer update; returns device tensors {loss, grad_norm}
    (``norm_fn``: the optimizer's global norm where parameters are split
    across ranks, ``LlamaAdamW.step``).

    ``grad_accum`` > 1 splits the batch into that many microbatches of
    strided rows (row m, m+A, ...) and accumulates the gradients of each
    one's part of the step's token-weighted mean, ``loss * n / N``,
    before the single update: the one-shot step's numbers up to
    summation order.

    Under a process group ``model`` is sharded (``sharding.shard_model``)
    and ``batch`` is this rank's rows of the global batch: the loss and
    the gradients are the global batch's (``sharding.backward_global_mean``),
    and a rank's strided microbatch m is its part of the global
    microbatch m.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    optimizer.zero_grad()
    if grad_accum == 1:
        loss, n = batch_loss(model, batch, loss_chunk_size, loss_chunk_dtype)
        loss = sharding.backward_global_mean(loss, n)
    else:
        mbs = [{k: v[m::grad_accum] for k, v in batch.items()}
               for m in range(grad_accum)]
        n_step = sharding.gang_count(
            sum(target_count(mb) for mb in mbs))
        loss = 0.0
        for mb in mbs:
            mb_loss, n = batch_loss(model, mb, loss_chunk_size,
                                    loss_chunk_dtype)
            loss = loss + sharding.backward_global_mean(mb_loss, n, n_step)
    grad_norm = optimizer.step(norm_fn)
    return {"loss": loss.detach(), "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(
    model: Llama,
    batch: dict,
    loss_chunk_size: Optional[int] = None,
    loss_chunk_dtype: str = "bfloat16",
) -> dict:
    """Forward-only objective on one held-out batch: {loss, n_tokens};
    under a process group, the global batch's, of every rank's rows."""
    loss, n = batch_loss(model, batch, loss_chunk_size, loss_chunk_dtype)
    return {"loss": sharding.global_mean(loss, n),
            "n_tokens": sharding.gang_sum(n)}


def run_evaluation(data, n_batches, eval_batch_fn) -> dict:
    """The token-weighted held-out eval loop: accumulate the {loss,
    n_tokens} of ``eval_batch_fn(batch)`` over up to ``n_batches`` batches
    (None: until the iterator ends) and report {eval_loss, eval_ppl,
    eval_tokens, eval_batches}."""
    total_loss = total_n = 0.0
    n_seen = 0
    for i, batch in enumerate(data):
        if n_batches is not None and i >= n_batches:
            break
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        out = eval_batch_fn(batch)
        n = float(out["n_tokens"])
        total_loss += float(out["loss"]) * n
        total_n += n
        n_seen += 1
    if n_seen == 0:
        raise ValueError("evaluate(): empty eval iterator")
    loss = total_loss / max(total_n, 1.0)
    return {
        "eval_loss": loss,
        "eval_ppl": math.exp(min(loss, 50.0)),
        "eval_tokens": int(total_n),
        "eval_batches": n_seen,
    }


def emit_eval(tel: Telemetry, ev: dict) -> None:
    """The ``eval`` event of one held-out evaluation (its numbers, as
    ``tpufw``'s ``maybe_inloop_eval`` logs them)."""
    tel.events.emit("eval", **{
        k: v if isinstance(v, int) else round(float(v), 6)
        for k, v in ev.items() if isinstance(v, (int, float))})


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Numpy arrays or tensors (e.g. from ``prefetch_to_device``, then
    already there) on ``device``."""
    return {
        k: (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v))).to(device)
        for k, v in batch.items()
    }


def mesh_label(trainer) -> str:
    """Compact mesh label for the ``tpufw_run_info`` gauge, ``tpufw``'s
    form: ``fsdp=4`` / ``data=2,fsdp=2`` (size-1 axes left out), the
    local groups and pipeline stages one process holds likewise;
    ``single`` for one unsplit device."""
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    else:
        sizes = {g.axis: g.size for g in getattr(trainer, "groups", ())}
        pipe = getattr(trainer, "pipe", None)
        if pipe is not None:
            sizes = {"pipe": pipe.n_stages, **sizes}
    return ",".join(f"{k}={v}" for k, v in sizes.items() if v > 1) or (
        "single")


def start_telemetry(trainer, model: str, config: dict) -> Telemetry:
    """The run's ``Telemetry`` from ``trainer.cfg``'s knobs (the shared
    disabled one when they are all off), its run info and config
    recorded; set as ``trainer.telemetry``. Made first in ``run``, so a
    restore in ``init_state`` is in its log."""
    cfg = trainer.cfg
    tel = trainer.telemetry = Telemetry.create(
        telemetry_dir=cfg.telemetry_dir,
        metrics_port=cfg.metrics_port,
        straggler_factor=cfg.straggler_factor,
        device=trainer.device,
    )
    tel.set_run_info(backend=trainer.device.type, mesh=mesh_label(trainer),
                     model=model)
    tel.record_config(config)
    return tel


def resolve_autotune(trainer, tel: Telemetry) -> None:
    """``trainer.cfg.autotune`` resolved before the state is made (a
    winner's remat policy, schedule or flash build is what the first step
    runs), inside a ``tune`` span; then the perf observatory's
    ``programs.json`` keyed like the tune cache, so a cost table and a
    winner of one (model, batch, seq, mesh) point line up."""
    from tpufw_torch.tune.runner import apply_autotune, trainer_cache_key

    if trainer.cfg.autotune != "off":
        with tel.tracer.span("tune"):
            apply_autotune(trainer, events=tel.events, perf=tel.perf)
    if tel.perf.enabled:
        tel.perf.set_key(trainer_cache_key(trainer))


def run_steps(trainer, data: Iterator[dict], meter: Meter,
              on_metrics: Callable[[StepMetrics], None] | None = None,
              shutdown=None, after_sync: Callable[[], None] | None = None,
              log_every: int = 1, telemetry: Telemetry | None = None,
              program: str = "train_step", workload: str = "train",
              on_window: Callable[[StepMetrics], None] | None = None,
              ) -> list[StepMetrics]:
    """The step loop of ``Trainer``, ``PipelineTrainer`` and
    ``VisionTrainer``: ``trainer.train_step`` on each batch until
    ``trainer.cfg.total_steps`` (a restored trainer's ``step`` counts
    towards it), the host synced on the loss after the first step, at
    multiples of ``cfg.sync_every`` (so an aligned evaluation or
    checkpoint fires) and after the last, each sync metering its window
    of steps as one ``StepMetrics`` (passed to ``on_metrics`` every
    ``log_every`` steps, or every window when ``sync_every`` > 1). At
    each sync point, after the metrics: ``after_sync()``, a checkpoint of
    ``trainer.state_dict`` when ``cfg.checkpoint_dir`` is set and the
    step is a multiple of ``checkpoint_every``, then a stop request
    (``shutdown``, or the SIGTERM handler that ``cfg.handle_preemption``
    installs) ends the loop with a forced save and ``trainer.preempted``
    set. Saves stay outside the metered window; the last one is on disk
    on return.

    ``telemetry`` (``tpufw``'s instrumentation, the same events, spans
    and series; closed on return): ``run_start``/``step``/``run_end``
    events, the ``data_fetch``, ``step_dispatch``, ``host_sync``,
    ``eval``, ``checkpoint`` and ``preemption_sync`` spans, the hang
    watchdog armed from each dispatch to its window's sync, the skew
    monitor at each sync, ``program``'s costs counted on the first step
    (``obs.perf.observe_step``: a real step, kept out of the Meter's
    statistics) and its MFU at each later window, ``on_window(sm)``
    inside the sync span, and the profiler's window of steps
    (``cfg.profile_*``, ``TPUFW_PROFILE_STEPS``)."""
    cfg = trainer.cfg
    tel = telemetry if telemetry is not None else Telemetry.disabled()
    trainer.preempted = False
    ckpt = None
    if cfg.checkpoint_dir:
        ckpt = CheckpointManager(cfg.checkpoint_dir,
                                 save_interval_steps=cfg.checkpoint_every,
                                 events=tel.events, tracer=tel.tracer)
    trainer.checkpointer = ckpt
    prof = StepProfiler(
        *resolve_profile_window(
            getattr(cfg, "profile_dir", None),
            getattr(cfg, "profile_start", 3),
            getattr(cfg, "profile_stop", 6),
            telemetry_dir=getattr(cfg, "telemetry_dir", None),
        ),
        rank=torch.distributed.get_rank() if sharding.active() else 0,
    )
    shutdown, owns_shutdown = owned_shutdown(
        shutdown, cfg.handle_preemption, cfg.preemption_sync_every,
        events=tel.events)
    start_step = trainer.step
    remaining = max(0, cfg.total_steps - start_step)
    se = max(1, cfg.sync_every)
    window_n, window_wait, counted = 0, 0.0, False
    history: list[StepMetrics] = []
    m = None
    tel.events.emit(
        "run_start", workload=workload, start_step=start_step,
        total_steps=cfg.total_steps, batch_size=cfg.batch_size,
        seq_len=getattr(cfg, "seq_len", None), sync_every=se,
        n_chips=meter.n_gpus,
    )

    def record_window() -> StepMetrics:
        # One host sync: meter.stop's float(loss) is the barrier; the
        # step event, the skew gather and the MFU ride it.
        with tel.tracer.span("host_sync"):
            sm = meter.stop(trainer.step, m["loss"], data_wait_s=window_wait,
                            n_steps=window_n, warmup=counted)
            tel.events.emit(
                "step", step=sm.step, loss=round(sm.loss, 6),
                step_time_s=round(sm.step_time_s, 6),
                data_wait_s=round(sm.data_wait_s, 6), mfu=round(sm.mfu, 5),
                tokens_per_sec_per_chip=round(sm.tokens_per_sec_per_gpu, 1),
                window_steps=sm.window_steps,
            )
            if tel.skew is not None:
                tel.skew.record(sm.step, sm.step_time_s * sm.window_steps,
                                sm.data_wait_s)
            if on_window is not None:
                on_window(sm)
            if not counted:
                tel.perf.record_wall(program, sm.step_time_s)
        return sm

    try:
        for i, (wait, batch) in enumerate(timed_batches(data)):
            if i >= remaining:
                break
            tel.tracer.complete("data_fetch", wait)
            # Watchdog window: dispatch through the host sync (data
            # fetch, eval and checkpoints have no progress guarantee).
            tel.watchdog.arm()
            with tel.tracer.span("step_dispatch"):
                prof.maybe_start(i)
                if window_n == 0:
                    meter.start()
                counted = counted or tel.perf.will_observe(program)
                with prof.step(i):
                    m = tel.perf.observe_step(program, trainer.train_step,
                                              batch)
                window_n += 1
                window_wait += wait
                prof.maybe_stop(i)
            if not (i == 0 or trainer.step % se == 0 or i + 1 == remaining):
                tel.watchdog.disarm()
                continue
            sm = record_window()
            tel.watchdog.disarm()
            window_n, window_wait, counted = 0, 0.0, False
            history.append(sm)
            if on_metrics and (se > 1 or i % log_every == 0):
                on_metrics(sm)
            if after_sync is not None:
                with tel.tracer.span("eval"):
                    after_sync()
            if ckpt is not None:
                with tel.tracer.span("checkpoint"):
                    ckpt.save(trainer.step, trainer.state_dict)
            # The gang's decision: every rank breaks at one step or none.
            with tel.tracer.span("preemption_sync"):
                stop = checkpoint_stop(shutdown, ckpt, trainer.step,
                                       trainer.state_dict,
                                       watchdog=tel.watchdog)
            if stop:
                trainer.preempted = True
                tel.events.emit("preemption_stop", level="warn",
                                step=trainer.step)
                break
        if window_n:
            # The iterator ended mid-window: meter the steps it ran.
            tel.watchdog.arm()
            sm = record_window()
            tel.watchdog.disarm()
            history.append(sm)
            if on_metrics:
                on_metrics(sm)
            if ckpt is not None:
                with tel.tracer.span("checkpoint"):
                    ckpt.save(trainer.step, trainer.state_dict)
    finally:
        # Flush even on a mid-loop crash: the trace and the last
        # checkpoint are what a post-mortem needs.
        prof.close()
        if ckpt is not None:
            ckpt.close()
        if owns_shutdown:
            shutdown.uninstall()
        tel.events.emit(
            "run_end", steps=len(history),
            last_step=history[-1].step if history else start_step,
            preempted=trainer.preempted,
        )
        tel.close()
    return history


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
    # Held-out evaluation: every eval_every steps (0 = off) run
    # eval_batches forward-only batches of ``Trainer.run(eval_data=...)``.
    eval_every: int = 0
    eval_batches: int = 8
    # Adam first-moment storage dtype (None: the parameters'; "bfloat16"
    # halves the buffer, see LlamaAdamW).
    adam_mu_dtype: Optional[str] = None
    # Steps between host syncs on the loss (1 = every step). The loop
    # also syncs after the first step and the last; metrics then carry
    # window averages (StepMetrics.window_steps) and eval runs at sync
    # points only, so align eval_every to a multiple of sync_every.
    sync_every: int = 1
    # Checkpoints (train.checkpoint): saved at sync points whose step is
    # a multiple of checkpoint_every, and by maybe_restore resumed from.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    # Latch SIGTERM and leave the loop with a forced checkpoint of the
    # current step (train.preemption); the stop flag is read every
    # preemption_sync_every steps.
    handle_preemption: bool = True
    preemption_sync_every: int = 1
    # torch.profiler capture of steps [profile_start, profile_stop) into
    # profile_dir (None disables; TPUFW_PROFILE_STEPS=a:b overrides the
    # window and, without a dir, captures under telemetry_dir/profile).
    # Step 0 is outside the default window.
    profile_dir: Optional[str] = None
    profile_start: int = 3
    profile_stop: int = 6
    # Telemetry (tpufw_torch.obs): telemetry_dir writes events.jsonl,
    # trace.json, goodput.json, programs.json and a final metrics.prom
    # per rank (-p<N> names above rank 0); metrics_port serves the
    # registry at /metrics (0: an ephemeral port, read from
    # Trainer.telemetry.bound_port). Set both alike on every rank: the
    # skew monitor's per-window gather is a collective. Both off: shared
    # no-op objects in the loop.
    telemetry_dir: Optional[str] = None
    metrics_port: Optional[int] = None
    # A rank is flagged (straggler_detected, warn) when its sync
    # window's wall time exceeds the gang's median by this factor.
    straggler_factor: float = 2.0
    # MFU autotuning (tpufw_torch.tune), resolved in run() before the
    # state exists: "off", "cached" (apply a kept winner) or "search"
    # (measure candidates for at most autotune_budget_s, autotune_steps
    # timed steps each, then keep and apply the winner).
    autotune: str = "off"
    autotune_budget_s: float = 120.0
    autotune_steps: int = 3


def on_mesh(method):
    """Run a trainer's ``method`` with its ``attention_mesh`` registered
    as the current mesh (``parallel.context.use_mesh``), as ``tpufw``'s
    trainer runs its steps under its mesh, its tensor and expert groups
    registered (``use_groups``), and its gang's means over its batch-shard
    ranks (``sharding.batch_ranks``) when those are not the world."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with contextlib.ExitStack() as stack:
            stack.enter_context(use_mesh(self.attention_mesh))
            stack.enter_context(use_groups(*self.groups))
            if self.batch_ranks is not None:
                stack.enter_context(sharding.batch_ranks(*self.batch_ranks))
            return method(self, *args, **kwargs)

    return wrapped


class Trainer:
    """Builds the model and optimizer and runs the step loop with
    tokens/s/GPU and MFU metrics: on one device, or, when a process group
    is initialized, sharded over the gang's mesh of ``mesh_cfg`` (default
    ``MeshConfig()``: every rank on ``fsdp``). Without a process group a
    ``mesh_cfg`` must fit one device."""

    # An objective over whole rows of the whole batch (GRPO's rollout,
    # in-batch negatives) takes the data and fsdp axes only.
    whole_rows = False

    def __init__(
        self,
        model_cfg: LlamaConfig,
        trainer_cfg: TrainerConfig,
        mesh_cfg: Optional[MeshConfig] = None,
        device=None,
        groups: tuple = (),
    ):
        """``groups``: one process's ``LocalTensorGroup`` and/or
        ``LocalExpertGroup``, whose shards it computes in turn, and
        optionally a ``LocalSequenceGroup``, the ring its attention runs
        over (a gang's groups come from its mesh)."""
        if mesh_cfg is not None and not isinstance(mesh_cfg, MeshConfig):
            raise TypeError(
                f"mesh_cfg must be a MeshConfig, got {mesh_cfg!r} (pass the "
                "device as device=)")
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.device = resolve_device(device)
        self.mesh_cfg = mesh_cfg or MeshConfig()
        # The DeviceMesh of the gang (None: one device, unsharded).
        self.mesh = None
        # (process group, size) of the batch-shard ranks the gang's means
        # run over, when they are not the whole gang.
        self.batch_ranks = None
        # One process's sequence ring (``groups=``): every shard held.
        self.local_ring = LocalSequenceGroup(1)
        if sharding.active():
            if groups:
                raise ValueError(
                    "groups= holds one process's shards; a gang's tensor "
                    "and expert groups come from its mesh_cfg")
            if self.whole_rows:
                sharding.refuse_split_rows(self.mesh_cfg, type(self).__name__)
            self.mesh = build_mesh(self.mesh_cfg, sharding.world_size(),
                                   self.device.type)
            if "pipe" in self.mesh.mesh_dim_names:
                raise NotImplementedError(
                    "a pipe mesh axis above 1 trains through "
                    "tpufw_torch.train.pipeline_trainer.PipelineTrainer")
            self.groups = model_groups(self.mesh)
        else:
            mesh_shape(self.mesh_cfg, 1)
            rings = [g for g in groups if isinstance(g, LocalSequenceGroup)]
            if len(rings) > 1:
                raise TypeError(f"groups= takes one LocalSequenceGroup, got "
                                f"{groups!r}")
            self.local_ring = rings[0] if rings else self.local_ring
            self.groups = self._local_groups(
                [g for g in groups if g not in rings])
        self._check_model_parallel()
        if self.split and self.gang:
            self.batch_ranks = sharding.batch_group(
                self.mesh, sharding.batch_dims(self.mesh))
        # {parameter name: split} of the model's split parameters, in a
        # tensor- or expert-parallel gang (set by ``_shard``).
        self.splits: dict = {}
        self.model: Optional[Llama] = None
        self.optimizer: Optional[LlamaAdamW] = None
        self.step = 0
        # True when the last run() stopped on a preemption request.
        self.preempted = False
        # The last run()'s CheckpointManager (its saves' numbers).
        self.checkpointer = None
        # The run's Telemetry, made per run() from the cfg knobs; the
        # shared disabled one between runs, so probes never branch.
        self.telemetry = Telemetry.disabled()
        # TuneResult of the last apply_autotune (tpufw_torch.tune); None
        # until cfg.autotune resolves in run().
        self.last_tune = None

    @staticmethod
    def _local_groups(groups) -> tuple:
        by_axis = {}
        for g in groups:
            if not isinstance(g, LocalShardGroup) or g.axis in by_axis:
                raise TypeError(
                    "groups= takes at most one LocalTensorGroup, one "
                    "LocalExpertGroup and one LocalSequenceGroup, got "
                    f"{groups!r}")
            by_axis[g.axis] = g
        return (by_axis.get("tensor", LocalTensorGroup(1)),
                by_axis.get("expert", LocalExpertGroup(1)))

    @property
    def split(self) -> bool:
        """True when the tensor or the expert group has more than one
        shard."""
        return any(g.size > 1 for g in self.groups)

    def _check_model_parallel(self) -> None:
        """The refusals and divisibility checks of the tensor and expert
        axes."""
        if not self.split:
            return
        tp, ep = self.groups
        check_divisible(self.model_cfg, tp.size, ep.size)
        if ep.size > 1 and getattr(self.model_cfg, "moe_dispatch",
                                   "einsum") == "sorted":
            raise ValueError(
                "moe_dispatch='sorted' keeps expert weight stacks whole "
                f"and cannot shard the expert mesh axis (got expert="
                f"{ep.size}); use the default einsum dispatch for "
                "expert parallelism")

    def init_state(self, seed: int = 0, state_dict=None) -> Llama:
        """Random weights from ``seed``, or ``state_dict`` when given
        (e.g. ``tpufw_torch.interop.params_from_flax``); fresh optimizer
        state at step 0. A ``MixtralConfig`` builds a ``Mixtral``, a
        ``GemmaConfig`` a ``Gemma``, a ``DeepseekConfig`` a ``Deepseek``."""
        self.model = model_for_config(
            self.model_cfg, device=self.device, seed=seed
        )
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self._shard(self.model)
        self._fresh_optimizer()
        return self.model

    @property
    def gang(self) -> bool:
        """True when the model is sharded over a process group's mesh."""
        return self.mesh is not None

    @property
    def attention_mesh(self):
        """The mesh the sequence-parallel attention backends run on: the
        gang's, or, on one device, the ring of ``groups=`` (one shard by
        default)."""
        return self.mesh if self.gang else self.local_ring

    def batch_shard(self) -> tuple[int, int]:
        """(this rank's batch shard, the number of batch shards): the rows
        ``[i·b, (i+1)·b)`` of each global batch of ``batch_size`` rows,
        b = batch_size / count, are the ones this rank feeds; (0, 1) on
        one device."""
        return sharding.batch_shard(self.mesh) if self.gang else (0, 1)

    def _shard(self, model) -> None:
        """Shard ``model`` (whole on this rank's device; the policy, or a
        frozen side model) over the mesh: its split parameters cut to
        this rank's shards first."""
        if not self.gang:
            return
        route = None
        if self.split:
            splits = cut_model(model, self.groups)
            if model is self.model:
                self.splits = splits
            route = self.batch_ranks[0]
        sharding.shard_model(model, self.mesh, route_group=route)

    def whole_state(self) -> dict:
        """The policy's state dict with every tensor whole on this rank
        (in a gang a collective: split tensors gathered over their axes,
        then over the batch shards)."""
        state = self.model.state_dict()
        if self.splits:
            state = {k: (sharding.SplitPart(v, self.splits[k], self.groups)
                         if k in self.splits else v)
                     for k, v in state.items()}
        return sharding.full_state_dict(state)

    def _trained_splits(self) -> list:
        """The split of each parameter the optimizer updates, in its
        order (() when replicated)."""
        return [self.splits.get(n, ()) for n, p in
                self.model.named_parameters() if p.requires_grad]

    def _norm_fn(self) -> Optional[Callable]:
        """The optimizer's global-norm function in a tensor- or
        expert-parallel gang, else None (the plain norm)."""
        if not (self.gang and self.split):
            return None
        splits = self._trained_splits()

        def norm_of(ts):
            return sharding.full_tensor(torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(ts))))

        return lambda grads: split_norm(grads, splits, self.groups, norm_of)

    def _split_optimizer_state(self, state: dict, fn) -> dict:
        """``state`` (``LlamaAdamW.state_dict``'s form) with each moment of
        a split parameter replaced by ``fn(moment, split)``."""
        splits = self._trained_splits()
        if "adamw" in state:
            adamw = state["adamw"]
            return dict(state, adamw=dict(adamw, state={
                i: {k: (fn(v, splits[i]) if k != "step" and splits[i]
                        else v) for k, v in st.items()}
                for i, st in adamw["state"].items()}))
        return dict(state, **{k: [fn(v, sp) if sp else v
                                  for v, sp in zip(state[k], splits)]
                              for k in ("mu", "nu")})

    def _fresh_optimizer(self) -> None:
        self.optimizer = default_optimizer(
            self.model.parameters(),
            lr=self.cfg.lr,
            warmup_steps=self.cfg.warmup_steps,
            total_steps=self.cfg.total_steps,
            mu_dtype=self.cfg.adam_mu_dtype,
        )
        self.step = 0

    def assign_model(self, state_dict: dict) -> None:
        """The model built with no weights of its own (the meta device)
        and then given ``state_dict``'s tensors, already on the device.
        The optimizer is left alone (``tools.eval_ppl`` needs none). In
        a gang the tensors (on any device) go whole to this rank's device,
        then the model is sharded."""
        if self.gang:
            state_dict = {k: v.to(self.device) for k, v in state_dict.items()}
        self.model = model_for_config(self.model_cfg, device="meta")
        self.model.load_state_dict(state_dict, assign=True)
        self._shard(self.model)

    def state_dict(self) -> dict:
        """Everything a resumed run needs: step, model and optimizer
        state, and the model config's identity; and the config itself
        (``tools.merge_lora`` writes the merged model's from it)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.splits:
            # A checkpoint holds whole tensors: the split ones gather.
            model = {k: (sharding.SplitPart(v, self.splits[k], self.groups)
                         if k in self.splits else v)
                     for k, v in model.items()}
            opt = self._split_optimizer_state(
                opt, lambda v, sp: sharding.SplitPart(v, sp, self.groups))
        return {"step": self.step,
                "config": config_identity(self.model_cfg),
                "model_config": config_to_dict(self.model_cfg),
                "model": model,
                "optimizer": opt}

    def load_state_dict(self, state: dict) -> None:
        """Resume from ``state_dict()``'s output (tensors on this
        trainer's device; in a gang, whole tensors on any device, as a
        checkpoint holds them); raises ValueError for another model's."""
        check_identity(state["config"], self.model_cfg, "the checkpoint")
        self.assign_model(state["model"])
        self._fresh_optimizer()
        opt = state["optimizer"]
        if self.splits:
            opt = self._split_optimizer_state(
                opt, lambda v, sp: cut_tensor(v, sp, self.groups))
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])

    def maybe_restore(self) -> bool:
        """Resume from the latest checkpoint under ``cfg.checkpoint_dir``,
        if there is one (the gang-restart path). A gang's ranks must see
        the same latest step; ValueError on every rank otherwise."""
        if not self.cfg.checkpoint_dir:
            return False
        mgr = CheckpointManager(self.cfg.checkpoint_dir)
        try:
            latest = mgr.latest_step()
            latest = sharding.gang_agree(-1 if latest is None else latest,
                                         "the latest checkpoint step")
            if latest < 0:
                return False
            # A gang keeps the whole state mapped on the host and moves
            # each rank's shards (the model whole, for its sharding).
            self.load_state_dict(mgr.restore(latest, device=self.device,
                                             mapped=self.gang))
            return True
        finally:
            mgr.close()

    def restore_params(self, path: str) -> dict:
        """The state dict of a bare-params directory (``save_params``,
        the ``tools.import_hf`` CLI's output) on this trainer's device,
        in the model's dtypes; raises ValueError for another model's."""
        return load_params(path, self.model_cfg, self.device)[1]

    def init_from_params(self, path: str, seed: int = 0) -> Llama:
        """Start training from bare params: step 0, fresh optimizer
        state. Only on a fresh trainer (``maybe_restore`` resumes a
        whole run). With LoRA (``lora_rank`` > 0) ``path`` holds the
        base, a rank-0 model's params: the base tensors load from it onto
        a model built on ``meta`` (peak memory one base plus the
        adapters) and the adapters are drawn fresh from ``seed`` with B
        zero, so step 0's model is the base."""
        if self.model is not None:
            raise RuntimeError(
                "init_from_params on an initialized trainer; build a fresh "
                "Trainer (or maybe_restore to resume a run)")
        if not getattr(self.model_cfg, "lora_rank", 0):
            self.assign_model(self.restore_params(path))
            self._fresh_optimizer()
            return self.model
        base_cfg = dataclasses.replace(self.model_cfg, lora_rank=0)
        base = load_params(path, base_cfg, self.device)[1]
        self.model = model_for_config(self.model_cfg, device="meta")
        missing, unexpected = self.model.load_state_dict(
            base, strict=False, assign=True)
        if unexpected or not all(is_lora_name(k) for k in missing):
            raise ValueError(
                f"{path}: not this model's base: missing "
                f"{[k for k in missing if not is_lora_name(k)]}, "
                f"unexpected {unexpected}")
        init_adapters(self.model, seed, self.device)
        self._shard(self.model)
        self._fresh_optimizer()
        return self.model

    def check_grad_accum(self) -> None:
        """``grad_accum`` must divide the batch; in a gang its microbatches
        must divide over the ranks (``tpufw``'s rule and wording), which
        is when each rank's strided microbatch is its part of the global
        one."""
        accum, bs = self.cfg.grad_accum, self.cfg.batch_size
        if accum <= 1:
            return
        if self.gang:
            dp = self.batch_shard()[1]
            if bs % accum or (bs // accum) % dp:
                raise ValueError(
                    f"grad_accum={accum}: batch {bs} must split into "
                    f"{accum} microbatches whose rows divide over data x "
                    f"fsdp = {dp}")
        elif bs % accum:
            raise ValueError(f"grad_accum={accum} must divide batch {bs}")

    @on_mesh
    def train_step(self, batch: dict) -> dict:
        self.check_grad_accum()
        out = train_step(
            self.model, self.optimizer, batch_to_device(batch, self.device),
            self.cfg.loss_chunk_size, self.cfg.loss_chunk_dtype,
            self.cfg.grad_accum, self._norm_fn(),
        )
        self.step += 1
        return out

    @on_mesh
    def evaluate(
        self, data: Iterator[dict], n_batches: Optional[int] = None
    ) -> dict:
        """Token-weighted held-out loss and perplexity over ``n_batches``
        (None: until the iterator ends), with the training objective
        (``batch_loss``), so eval_loss compares with the train curve. The
        model and optimizer are left as they were."""
        if self.model is None:
            raise RuntimeError("evaluate() before init_state()")
        return run_evaluation(
            data, n_batches,
            lambda b: eval_step(
                self.model, batch_to_device(b, self.device),
                self.cfg.loss_chunk_size, self.cfg.loss_chunk_dtype,
            ),
        )

    @on_mesh
    def run(
        self,
        data: Iterator[dict],
        model_flops_per_token: float,
        on_metrics: Callable[[StepMetrics], None] | None = None,
        eval_data: Callable[[], Iterator[dict]] | None = None,
        on_eval: Callable[[dict], None] | None = None,
        shutdown=None,
    ) -> list[StepMetrics]:
        """Train up to ``total_steps`` (a restored run trains what is
        left) through ``run_steps``: one ``StepMetrics`` per host sync,
        checkpoints and the SIGTERM stop. ``eval_data`` makes a fresh
        held-out iterator per evaluation, run at the sync points whose
        step is a multiple of ``eval_every``; ``on_eval`` receives each
        result with its "step". ``cfg.telemetry_dir``, ``metrics_port``
        and ``profile_dir`` turn on ``tpufw``'s telemetry
        (``run_steps``)."""
        tel = start_telemetry(
            self, type(self.model_cfg).__name__.removesuffix("Config"),
            {"trainer": dataclasses.asdict(self.cfg)})
        try:
            resolve_autotune(self, tel)
            if self.model is None:
                self.init_state()
            meter = Meter(
                tokens_per_step=self.cfg.batch_size * (self.cfg.seq_len - 1),
                flops_per_token=model_flops_per_token,
                chip=detect_chip(self.device),
                n_gpus=sharding.world_size() if self.gang else 1,
                registry=tel.registry,
            )
        except BaseException:
            tel.close()
            raise
        return run_steps(self, data, meter, on_metrics, shutdown,
                         after_sync=lambda: self._maybe_eval(eval_data,
                                                             on_eval),
                         log_every=self.cfg.log_every, telemetry=tel)

    def _maybe_eval(self, eval_data, on_eval) -> None:
        every = self.cfg.eval_every
        if not (every and eval_data is not None) or self.step % every:
            return
        ev = self.evaluate(eval_data(), self.cfg.eval_batches)
        ev["step"] = self.step
        emit_eval(self.telemetry, ev)
        if on_eval:
            on_eval(ev)
