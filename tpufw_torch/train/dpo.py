"""Direct Preference Optimization (port of ``tpufw.train.dpo``):
preference-pair fine-tuning.

Each batch is ``[2B, T]`` with the pairs INTERLEAVED, row 2i pair i's
chosen response and row 2i+1 its rejected one, so one forward covers both
and the pairwise split is a stride-2 slice of the per-row log-prob sums
(``ops.loss.chunked_sequence_logprob``: no [B, T, V] logits). The
interleaving keeps pairs aligned under any concatenation of even-sized
blocks, the multi-process contract of the JAX package.

Objective (Rafailov et al. 2023, with conservative-DPO label smoothing):

  r_c = beta * (log pi(y_c|x) - log ref(y_c|x))
  r_r = beta * (log pi(y_r|x) - log ref(y_r|x))
  loss = -(1 - ls) * log sigmoid(r_c - r_r) - ls * log sigmoid(r_r - r_c)

The reference policy is scored outside autograd (``torch.no_grad``). For
a model with ``lora_rank`` > 0 it is the policy's own frozen base with the
adapters bypassed (``models.lora.adapters_bypassed``): no copy of the
base, and exact at step 0, where B = 0. ``tpufw`` snapshots the whole tree
in ``ref_dtype`` instead, which at Llama-3-8B is another 16 GB of bf16.
Without LoRA the reference is that snapshot, a frozen copy in
``ref_dtype`` (``trainer.frozen_copy``). At step 0 every reward is then 0:
the loss is ln 2 and the accuracy 0.5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpufw_torch.models.lora import adapters_bypassed
from tpufw_torch.ops.loss import chunked_sequence_logprob
from tpufw_torch.parallel.context import partial_sequence_group, tensor_group
from tpufw_torch.train import sharding
from tpufw_torch.train.sft import _TEMPLATES, render_conversation
from tpufw_torch.train.trainer import (
    LlamaAdamW,
    Trainer,
    batch_to_device,
    final_soft_cap,
    forward_with_aux,
    frozen_model,
    on_mesh,
    shift_and_mask,
)

# ----------------------------------------------------------------------
# Data: preference pairs -> [2B, T] batches
# ----------------------------------------------------------------------


def read_pairs(path: str | pathlib.Path) -> Iterator[dict]:
    """JSONL preference pairs: {"prompt": <str | message list>,
    "chosen": <str>, "rejected": <str>} per line (the common export
    shape of preference datasets)."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if not (
                isinstance(obj, dict)
                and "prompt" in obj
                and isinstance(obj.get("chosen"), str)
                and isinstance(obj.get("rejected"), str)
            ):
                raise ValueError(
                    f"{path}:{ln}: expected "
                    '{"prompt": ..., "chosen": str, "rejected": str}'
                )
            yield obj


def encode_pair(
    pair: dict,
    encode: Callable[[str], List[int]],
    template: str = "plain",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One pair -> (tokens_c, mask_c, tokens_r, mask_r).

    The prompt (a string is a single user turn, or a message list) is
    rendered through the SFT chat template with the assistant header, so
    both responses continue from the same context; the response content
    and its end-of-turn footer are the trained span, the mask convention
    of ``train.sft.encode_conversation``.
    """
    prompt = pair["prompt"]
    if isinstance(prompt, str):
        prompt = [{"role": "user", "content": prompt}]
    ctx: List[int] = []
    # render_conversation validates the template name (the one
    # canonical check); the direct lookup below can then only succeed.
    for text, _ in render_conversation(prompt, template):
        ctx.extend(encode(text))
    t = _TEMPLATES[template]
    ctx.extend(encode(t["header"].format(role="assistant")))

    rows = []
    for resp in (pair["chosen"], pair["rejected"]):
        resp_ids = encode(resp) + encode(t["footer"])
        toks = np.asarray(ctx + resp_ids, np.int32)
        mask = np.zeros(len(toks), np.float32)
        mask[len(ctx):] = 1.0
        rows.append((toks, mask))
    (tc, mc), (tr, mr) = rows
    return tc, mc, tr, mr


def _pad_row(
    toks: np.ndarray, mask: np.ndarray, seq_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad one fitted row to ``seq_len`` (padding is segment 0)."""
    n = len(toks)
    out_t = np.zeros(seq_len, np.int32)
    out_m = np.zeros(seq_len, np.float32)
    seg = np.zeros(seq_len, np.int32)
    out_t[:n], out_m[:n], seg[:n] = toks, mask, 1
    return out_t, out_m, seg


def _fit_pair(
    tc: np.ndarray,
    mc: np.ndarray,
    tr: np.ndarray,
    mr: np.ndarray,
    seq_len: int,
):
    """Fit BOTH rows of a pair to ``seq_len`` with one shared left
    truncation: both rows drop the same count of OLDEST prompt tokens
    (the pair's worst-case overflow), so chosen and rejected keep the
    IDENTICAL prompt suffix. Truncating each row independently would
    score the two responses against different contexts — a systematic
    length-correlated reward bias (DPO conditions both on the same x).
    """
    drop = max(len(tc), len(tr)) - seq_len
    if drop > 0:
        resp = max(int(mc.sum()), int(mr.sum()))
        if resp >= seq_len:
            raise ValueError(
                f"response ({resp} tokens) does not fit in "
                f"seq_len={seq_len}; raise seq_len or filter the pair"
            )
        # drop <= prompt length: both rows share the prompt, and the
        # longer row is prompt + its response < prompt + seq_len.
        tc, mc = tc[drop:], mc[drop:]
        tr, mr = tr[drop:], mr[drop:]
    return _pad_row(tc, mc, seq_len), _pad_row(tr, mr, seq_len)


def dpo_batches(
    path: str | pathlib.Path,
    batch_pairs: int,
    seq_len: int,
    encode: Callable[[str], List[int]],
    template: str = "plain",
    epochs: Optional[int] = None,
    seed: int = 0,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[dict]:
    """Yield [2B, T] DPO batches (B = ``batch_pairs``): row 2i is pair
    i's chosen, row 2i+1 its rejected (the interleaved layout
    ``dpo_loss_from_logps`` splits with a stride-2 slice). Pairs are
    sharded disjointly across processes before the shuffle (the contract
    of ``train.sft.sft_batches``) and reshuffled each epoch;
    ``epochs=None`` cycles forever."""
    pairs = list(read_pairs(path))
    if not pairs:
        raise ValueError(f"{path}: no preference pairs")
    pairs = pairs[shard_id::num_shards]
    encoded = [encode_pair(p, encode, template) for p in pairs]
    if len(encoded) < batch_pairs:
        # An undersized shard would yield ZERO batches — with
        # epochs=None that is an infinite permute-nothing spin, so fail
        # loudly instead (sft_batches raises on its empty-shard analog).
        raise ValueError(
            f"{path}: shard {shard_id}/{num_shards} holds "
            f"{len(encoded)} pairs < batch_pairs={batch_pairs}"
        )
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(encoded))
        for start in range(0, len(order) - batch_pairs + 1, batch_pairs):
            idx = order[start:start + batch_pairs]
            toks = np.zeros((2 * batch_pairs, seq_len), np.int32)
            mask = np.zeros((2 * batch_pairs, seq_len), np.float32)
            seg = np.zeros((2 * batch_pairs, seq_len), np.int32)
            for row, i in enumerate(idx):
                tc, mc, tr, mr = encoded[i]
                (
                    (toks[2 * row], mask[2 * row], seg[2 * row]),
                    (
                        toks[2 * row + 1],
                        mask[2 * row + 1],
                        seg[2 * row + 1],
                    ),
                ) = _fit_pair(tc, mc, tr, mr, seq_len)
            yield {
                "tokens": toks,
                "loss_mask": mask,
                "segment_ids": seg,
            }
        epoch += 1


# ----------------------------------------------------------------------
# Objective
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    # Reward scale: how hard the policy is pushed away from the
    # reference; the usual range is 0.1-0.5.
    beta: float = 0.1
    # Conservative DPO (label-noise robustness); 0 is the pure objective.
    label_smoothing: float = 0.0
    # Storage dtype of the frozen reference copy of a model without
    # LoRA (a LoRA policy's reference is its own base).
    ref_dtype: str = "bfloat16"


@contextlib.contextmanager
def reference_policy(model, ref_model=None):
    """The model that scores the reference: ``ref_model``, or, when it is
    None, ``model`` with its adapters bypassed (a LoRA policy's frozen
    base), all under ``torch.no_grad``: the reference's log-probs enter
    the differentiated loss as constants (not inference tensors, which
    autograd refuses)."""
    if ref_model is None and not getattr(model.cfg, "lora_rank", 0):
        raise ValueError(
            "no reference policy: a model without LoRA needs a frozen "
            "reference copy (trainer.frozen_copy)")
    with torch.no_grad():
        if ref_model is not None:
            yield ref_model
        else:
            with adapters_bypassed(model):
                yield model


def sequence_logps(model, inputs, targets, seg_in, mask, chunk_size: int,
                   compute_dtype):
    """([2B] per-row response log-prob sums, the MoE router loss or 0.0)
    of ``model`` through the chunked head path (vocab-parallel under the
    registered tensor group). Under a sequence split a rank holds a chunk
    of each row: its partial sums are summed over the ring, with their
    gradient, into the rows' sums."""
    hidden, aux = forward_with_aux(model, inputs, seg_in)
    logps = chunked_sequence_logprob(
        hidden, model.head_kernel(), targets, mask, chunk_size=chunk_size,
        compute_dtype=compute_dtype, logits_soft_cap=final_soft_cap(model),
        group=tensor_group(),
    )
    group = partial_sequence_group()
    if group is not None:
        logps = group.all_sum(logps)
    return logps, aux


def dpo_loss_from_logps(
    policy_logps: torch.Tensor,
    ref_logps: torch.Tensor,
    beta: float,
    label_smoothing: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """[2B] INTERLEAVED (even = chosen, odd = rejected) policy and
    reference log-prob sums -> (scalar loss, metrics)."""
    rewards = beta * (policy_logps - ref_logps)
    r_c, r_r = rewards[0::2], rewards[1::2]
    margin = r_c - r_r
    ls = label_smoothing
    loss = (-(1.0 - ls) * F.logsigmoid(margin)
            - ls * F.logsigmoid(-margin)).mean()
    metrics = {
        # Exact ties count 0.5, so the step-0 anchor (margin 0) reads 0.5.
        "accuracy": ((margin > 0).float()
                     + 0.5 * (margin == 0).float()).mean(),
        "margin": margin.mean(),
        "reward_chosen": r_c.mean(),
        "reward_rejected": r_r.mean(),
    }
    return loss, metrics


def dpo_train_step(
    model,
    optimizer: LlamaAdamW,
    batch: dict,
    ref_model=None,
    beta: float = 0.1,
    label_smoothing: float = 0.0,
    loss_chunk_size: int = 256,
    loss_chunk_dtype: str = "bfloat16",
    norm_fn=None,
) -> dict:
    """One DPO update on a [2B, T] chosen/rejected batch of device
    tensors; returns device tensors {loss, grad_norm, accuracy, margin,
    reward_chosen, reward_rejected}. ``ref_model`` None: the reference is
    ``model``'s base with the adapters bypassed (LoRA). A MoE policy's
    router loss joins the objective, as in ``trainer.batch_loss``.
    Under a process group ``batch`` is this rank's pairs of the global
    batch (a sharded model): the loss, its gradients and the metrics are
    the global batch's means over the pairs. ``norm_fn``: the clip's
    global norm where parameters are split (``LlamaAdamW.step``)."""
    inputs, targets, seg_in, mask = shift_and_mask(batch)
    if mask is None:
        raise ValueError(
            "DPO batch has neither loss_mask nor segment_ids: without a "
            "response mask the pairwise logprob sums would score entire "
            "rows (prompt included); use train.dpo.dpo_batches")
    dtype = getattr(torch, loss_chunk_dtype)
    with reference_policy(model, ref_model) as ref:
        ref_logps, _ = sequence_logps(ref, inputs, targets, seg_in, mask,
                                      loss_chunk_size, dtype)
    optimizer.zero_grad()
    logps, aux = sequence_logps(model, inputs, targets, seg_in, mask,
                                loss_chunk_size, dtype)
    loss, metrics = dpo_loss_from_logps(logps, ref_logps, beta,
                                        label_smoothing)
    loss = loss + aux
    pairs = torch.tensor(float(logps.shape[0] // 2), device=logps.device)
    loss = sharding.backward_global_mean(loss, pairs)
    metrics = dict(zip(metrics, sharding.global_mean(
        torch.stack(list(metrics.values())), pairs)))
    grad_norm = optimizer.step(norm_fn)
    return {"loss": loss.detach(), "grad_norm": grad_norm,
            **{k: v.detach() for k, v in metrics.items()}}


# ----------------------------------------------------------------------
# Trainer
# ----------------------------------------------------------------------


class ReferenceMixin:
    """The frozen reference policy of a trainer (DPO, GRPO with a KL
    term): for ``lora_rank`` > 0 the policy's own base, adapters
    bypassed, so ``ref_model`` stays None; otherwise ``ref_model``, a
    frozen copy of the policy in ``ref_dtype`` taken at
    ``init_state``/``init_from_params`` (step 0), cut as the policy is
    (its split tensors gathered whole, then cut again by ``_shard``), so
    its forward runs under the policy's groups."""

    ref_model = None

    def _lora_reference(self) -> bool:
        return bool(getattr(self.model_cfg, "lora_rank", 0))

    def _snapshot_reference(self, ref_dtype: str) -> None:
        if not self._lora_reference():
            self.ref_model = frozen_model(self.model_cfg, self.whole_state(),
                                          getattr(torch, ref_dtype))
            self._shard(self.ref_model)

    def has_reference(self) -> bool:
        if self._lora_reference():
            return self.model is not None
        return self.ref_model is not None


class DPOTrainer(ReferenceMixin, Trainer):
    """``Trainer`` for preference pairs: ``run``, checkpoints, SIGTERM and
    the ``Meter`` are inherited; ``train_step`` is the DPO update.

    ``TrainerConfig.batch_size`` is the ROW count 2B (what
    ``dpo_batches(batch_pairs=B)`` emits). Tokens/s and MFU count all 2B
    rows; the reference forward (2N per token next to the 6N train
    count) is credited when ``run`` is given ``flops_per_token * 4 / 3``,
    as the train workload does."""

    def __init__(self, model_cfg, trainer_cfg, mesh_cfg=None, device=None,
                 dpo: DPOConfig = DPOConfig(), groups=()):
        super().__init__(model_cfg, trainer_cfg, mesh_cfg, device, groups)
        if trainer_cfg.batch_size % 2:
            raise ValueError(
                f"DPO batch_size is the ROW count 2B; got odd "
                f"{trainer_cfg.batch_size}")
        if trainer_cfg.grad_accum != 1:
            raise NotImplementedError(
                "DPO does not implement grad_accum: microbatch slicing "
                "would split chosen rows from their rejected partners")
        self.dpo = dpo

    def init_state(self, seed: int = 0, state_dict=None):
        out = super().init_state(seed, state_dict)
        self._snapshot_reference(self.dpo.ref_dtype)
        return out

    def init_from_params(self, path: str, seed: int = 0):
        out = super().init_from_params(path, seed)
        self._snapshot_reference(self.dpo.ref_dtype)
        return out

    def maybe_restore(self) -> bool:
        """Resume; the restored policy must not become the reference. A
        LoRA run's reference is the restored base (the checkpoint holds
        it). Without LoRA, a mid-run resume with no reference yet raises:
        call ``init_from_params`` on the original base first."""
        restored = super().maybe_restore()
        if self._lora_reference():
            return restored
        if restored and self.step > 0 and self.ref_model is None:
            raise RuntimeError(
                "resumed a DPO run mid-training without a reference "
                "snapshot: call init_from_params on the ORIGINAL base "
                "checkpoint first (the reference must anchor to step-0 "
                "weights, not the resumed policy)")
        if self.ref_model is None and self.model is not None:
            self._snapshot_reference(self.dpo.ref_dtype)
        return restored

    @on_mesh
    def train_step(self, batch: dict) -> dict:
        if not self.has_reference():
            raise RuntimeError(
                "DPO step before reference snapshot: call init_state() "
                "or init_from_params() first")
        out = dpo_train_step(
            self.model, self.optimizer, batch_to_device(batch, self.device),
            ref_model=self.ref_model, beta=self.dpo.beta,
            label_smoothing=self.dpo.label_smoothing,
            loss_chunk_size=self.cfg.loss_chunk_size or 256,
            loss_chunk_dtype=self.cfg.loss_chunk_dtype,
            norm_fn=self._norm_fn(),
        )
        self.step += 1
        return out
