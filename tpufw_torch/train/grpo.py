"""GRPO, Group Relative Policy Optimization (port of
``tpufw.train.grpo``): on-policy RL fine-tuning.

Each step samples ``group_size`` completions per prompt from the current
policy, scores them with a user reward function and normalizes the
rewards within each prompt's group into advantages (no value network).

- The rollout is the decode path: ``infer.generate`` on a decode view of
  the policy, a decode-config model built on ``meta`` that holds the
  policy's own tensors (no copy), so every rollout samples the current
  weights; it runs plain attention and launches no flash kernel.
- Training rows are RIGHT-padded [N, T] (the prompt at position 0), so
  the update's positions are the ones the decode cache used.
- Per-token log-probs come from ``ops.loss.chunked_token_logprob``,
  tempered like the sampler; the rollout's scoring (``_score``) and the
  update run the same computation, so the first ratio of every step is 1
  exactly.

Objective (clipped importance ratio, sequence-level group advantage, an
optional k3 KL penalty to the frozen reference):

  ratio_t = exp(logpi(y_t) - logpi_old(y_t))
  obj_t   = min(ratio_t * A, clip(ratio_t, 1-eps, 1+eps) * A)
  kl_t    = exp(ref_t - pol_t) - (ref_t - pol_t) - 1
  loss    = -mean_completion_tokens(obj_t - kl_beta * kl_t)

Sampling streams: step i's rollout draws from a ``torch.Generator``
seeded from ``SeedSequence([seed, i])``, so a resumed run resamples what
it would have sampled (the JAX package splits a threefry key per step).

In a gang every rank rolls out the whole global batch from the same
generator on the gathered policy (decode is host-bound: N rows cost
about what N / world rows cost), scores the rewards and the group
advantages of all N rows, and keeps the rows of its batch shard: the
tokens and the advantages are one process's. The old log-probs and the
update run on those rows through the sharded model, the loss being the
global token mean (``sharding.backward_global_mean``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpufw_torch.models import model_for_config
from tpufw_torch.models.lora import is_lora_name
from tpufw_torch.ops.loss import chunked_token_logprob
from tpufw_torch.parallel.context import tensor_group
from tpufw_torch.train import sharding
from tpufw_torch.train.checkpoint import CheckpointManager
from tpufw_torch.train.dpo import ReferenceMixin, reference_policy
from tpufw_torch.train.preemption import checkpoint_stop, owned_shutdown
from tpufw_torch.train.trainer import (
    LlamaAdamW,
    Trainer,
    batch_to_device,
    final_soft_cap,
    forward_with_aux,
    on_mesh,
)


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    # Completions sampled per prompt; advantages normalize within the
    # group (4-16 is the usual range).
    group_size: int = 8
    # PPO-style ratio clip.
    clip_eps: float = 0.2
    # k3-KL weight to the frozen reference; 0 scores no reference.
    kl_beta: float = 0.0
    # Rollout sampling temperature (0 would collapse the group).
    temperature: float = 1.0
    # Generated tokens per completion.
    max_new_tokens: int = 64
    # Storage dtype of the frozen reference copy (kl_beta > 0, no LoRA).
    ref_dtype: str = "bfloat16"
    # Stop token: a completion ends at its first EOS, inclusive; None =
    # fixed-length completions.
    eos_id: Optional[int] = None


def group_advantages(
    rewards: np.ndarray, group_size: int, eps: float = 1e-6
) -> np.ndarray:
    """[N] rewards (rows [i*K, (i+1)*K) are prompt i's K completions) ->
    [N] advantages (r - mean_group) / (std_group + eps). A group of equal
    rewards gets advantage 0."""
    r = np.asarray(rewards, np.float32)
    if r.ndim != 1 or r.shape[0] % group_size:
        raise ValueError(
            f"rewards shape {r.shape} not divisible into groups of "
            f"{group_size}")
    g = r.reshape(-1, group_size)
    adv = (g - g.mean(axis=1, keepdims=True)) / (
        g.std(axis=1, keepdims=True) + eps)
    return adv.reshape(-1)


def token_logps(model, tokens, seg, chunk_size: int, compute_dtype,
                temperature: float):
    """([N, T-1] tempered per-target log-probs of ``tokens`` under
    ``model``, the MoE router loss or 0.0): the one computation of the
    rollout's scoring, the reference's and the update's (vocab-parallel
    under the registered tensor group)."""
    hidden, aux = forward_with_aux(model, tokens[:, :-1], seg[:, :-1])
    logp = chunked_token_logprob(
        hidden, model.head_kernel(), tokens[:, 1:], chunk_size=chunk_size,
        compute_dtype=compute_dtype, logits_soft_cap=final_soft_cap(model),
        logits_scale=1.0 / temperature, group=tensor_group(),
    )
    return logp, aux


def grpo_train_step(
    model,
    optimizer: LlamaAdamW,
    batch: dict,
    ref_model=None,
    clip_eps: float = 0.2,
    kl_beta: float = 0.0,
    temperature: float = 1.0,
    loss_chunk_size: int = 256,
    loss_chunk_dtype: str = "bfloat16",
    norm_fn=None,
) -> dict:
    """One GRPO update on a rollout batch of device tensors: tokens [N, T]
    (right-padded prompt + completion), loss_mask [N, T] (1 on completion
    tokens), segment_ids [N, T], old_logp [N, T-1] (per-target log-probs
    under the rollout policy) and advantages [N]. With ``kl_beta`` > 0 the
    reference is ``ref_model``, or, when it is None, ``model``'s base with
    the adapters bypassed (LoRA). ``temperature`` is the rollout's: the
    ratios and the KL are taken on the distribution sampled from.
    Returns device tensors {loss, grad_norm, mean_ratio, clip_frac,
    kl}. Under a process group ``batch`` is this rank's rows (a sharded
    model): the loss, its gradients and the metrics are the global
    batch's means over its completion tokens, whatever each rank's
    count. ``norm_fn``: the clip's global norm where parameters are split
    (``LlamaAdamW.step``)."""
    tokens, seg = batch["tokens"], batch["segment_ids"]
    # A target position trains iff its predicted token is a completion
    # token (the LM shift of trainer.shift_and_mask).
    mask = batch["loss_mask"][:, 1:].float()
    old_logp = batch["old_logp"]
    adv = batch["advantages"][:, None].float()
    dtype = getattr(torch, loss_chunk_dtype)
    ref_logp = None
    if kl_beta > 0.0:
        with reference_policy(model, ref_model) as ref:
            ref_logp, _ = token_logps(ref, tokens, seg, loss_chunk_size,
                                      dtype, temperature)
    n_local = mask.sum()
    n = torch.clamp(n_local, min=1.0)
    optimizer.zero_grad()
    logp, aux = token_logps(model, tokens, seg, loss_chunk_size, dtype,
                            temperature)
    ratio = torch.exp(logp - old_logp)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    obj = torch.minimum(ratio * adv, clipped * adv)
    if ref_logp is not None:
        d = ref_logp - logp
        kl = torch.exp(d) - d - 1.0  # k3 estimator, >= 0
        obj = obj - kl_beta * kl
        kl_mean = (kl * mask).sum() / n
    else:
        kl_mean = torch.zeros((), dtype=torch.float32, device=logp.device)
    loss = sharding.backward_global_mean(-(obj * mask).sum() / n + aux,
                                         n_local)
    # The share of tokens where the clip binds (the min() takes the
    # clipped term).
    clip_frac = ((clipped * adv < ratio * adv).float() * mask).sum() / n
    mean_ratio, clip_frac, kl_mean = sharding.global_mean(torch.stack([
        (ratio * mask).sum() / n, clip_frac, kl_mean]), n_local)
    grad_norm = optimizer.step(norm_fn)
    return {"loss": loss, "grad_norm": grad_norm, "mean_ratio": mean_ratio,
            "clip_frac": clip_frac, "kl": kl_mean}


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of step ``step``'s rollout: seeded from
    ``SeedSequence([seed, step])``, so a resumed run draws what the
    uninterrupted one would have drawn at that step."""
    seq = np.random.SeedSequence([seed % 2**64, step])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0]))


class GRPOTrainer(ReferenceMixin, Trainer):
    """``Trainer`` for GRPO rollouts and updates. ``batch_size`` is the
    rollout row count N = prompts a step x ``group_size``; ``seq_len``
    bounds prompt + ``max_new_tokens``. ``run_rl`` is the loop (rollout,
    then ``train_step``); checkpoints, SIGTERM and the step budget work as
    in ``Trainer.run``, in a gang through its stop's all-reduce and the
    gathering checkpoint. ``batch_size`` is global in a gang: every rank
    rolls out all N rows and trains the rows of its batch shard. Under
    tensor and expert axes the rollout decodes on the whole policy (its
    shards gathered, ``decode_view``), and the scoring and the update run
    under the groups."""

    whole_rows = True

    def __init__(self, model_cfg, trainer_cfg, mesh_cfg=None, device=None,
                 grpo: GRPOConfig = GRPOConfig(), groups=()):
        super().__init__(model_cfg, trainer_cfg, mesh_cfg, device, groups)
        if trainer_cfg.batch_size % grpo.group_size:
            raise ValueError(
                f"batch_size {trainer_cfg.batch_size} must be a multiple "
                f"of group_size {grpo.group_size}")
        if trainer_cfg.grad_accum != 1:
            raise NotImplementedError(
                "GRPO does not implement grad_accum: microbatch slicing "
                "would split a prompt's group across updates")
        if self.gang and trainer_cfg.batch_size % self.batch_shard()[1]:
            raise ValueError(
                f"batch_size {trainer_cfg.batch_size} does not divide over "
                f"{self.batch_shard()[1]} batch shards")
        self.grpo = grpo
        self._decode_model = None
        self._decode_of = None
        # A gang's LoRA base, gathered whole once: it never changes.
        self._base = None
        self._base_of = None

    # -- reference ---------------------------------------------------------

    def init_state(self, seed: int = 0, state_dict=None):
        out = super().init_state(seed, state_dict)
        if self.grpo.kl_beta > 0.0:
            self._snapshot_reference(self.grpo.ref_dtype)
        return out

    def init_from_params(self, path: str, seed: int = 0):
        out = super().init_from_params(path, seed)
        if self.grpo.kl_beta > 0.0:
            self._snapshot_reference(self.grpo.ref_dtype)
        return out

    def maybe_restore(self) -> bool:
        """Resume; with ``kl_beta`` > 0 and no LoRA, a mid-run resume
        without a reference raises (the restored policy must not become
        the KL anchor): call ``init_from_params`` on the original base
        first. A LoRA run's reference is the restored base."""
        restored = super().maybe_restore()
        if (self.grpo.kl_beta > 0.0 and restored and self.step > 0
                and not self.has_reference()):
            raise RuntimeError(
                "resumed a GRPO run mid-training with kl_beta > 0 and no "
                "KL reference: call init_from_params on the ORIGINAL base "
                "checkpoint BEFORE maybe_restore so the reference anchors "
                "to step-0 weights")
        return restored

    # -- rollout -----------------------------------------------------------

    def decode_view(self):
        """The policy as a decode model (``cfg.decode_config()`` at
        ``max_seq_len`` = ``seq_len``: KV cache, plain attention, no
        remat) built on ``meta`` and holding the policy's own tensors:
        the optimizer's in-place updates show in it, and no weight is
        copied. Rebuilt when the policy model is replaced (a restore).
        In a gang (a collective) the view is made anew for each rollout
        from the policy's whole tensors, which the caller drops after
        it: a rank's shards themselves at world size 1 (no copy), else
        gathered (split tensors over their axes too, ``whole_state``), a
        LoRA base once for the run. Decoding never splits over the
        tensor or expert axes, as ``tpufw``'s serving does not."""
        if self.gang:
            return self._view(self._whole_state())
        if self._decode_of is not self.model:
            self._decode_model = self._view(self.model.state_dict())
            self._decode_of = self.model
        return self._decode_model

    def _view(self, state: dict):
        cfg = dataclasses.replace(self.model.cfg.decode_config(),
                                  max_seq_len=self.cfg.seq_len)
        view = model_for_config(cfg, device="meta")
        view.load_state_dict(state, assign=True)
        return view.eval()

    def _whole_state(self) -> dict:
        """The sharded policy's tensors whole on this rank."""
        if sharding.world_size() == 1:
            return {k: sharding.local_tensor(v)
                    for k, v in self.model.state_dict().items()}
        if not getattr(self.model_cfg, "lora_rank", 0):
            return self.whole_state()
        state = self.model.state_dict()
        if self._base_of is not self.model:
            self._base = {k: sharding.full_tensor(v) for k, v in state.items()
                          if not is_lora_name(k)}
            self._base_of = self.model
        return {k: (sharding.full_tensor(v) if is_lora_name(k)
                    else self._base[k]) for k, v in state.items()}

    @torch.no_grad()
    @on_mesh
    def _score(self, tokens: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """[N, T-1] per-target log-probs of ``tokens`` under the current
        policy, tempered like the sampler: the old policy the ratios
        divide by. ``torch.no_grad``, not ``inference_mode``: the result
        enters the differentiated loss."""
        return token_logps(
            self.model, tokens, seg, self.cfg.loss_chunk_size or 256,
            getattr(torch, self.cfg.loss_chunk_dtype), self.grpo.temperature,
        )[0]

    def rollout(
        self,
        prompts: Sequence[Sequence[int]],
        reward_fn: Callable[[List[List[int]], List[List[int]]], np.ndarray],
        generator: Optional[torch.Generator] = None,
    ) -> tuple[dict, dict]:
        """Sample ``group_size`` completions per prompt from the current
        policy (drawing from ``generator``), score the rewards and build
        one training batch.

        ``reward_fn(prompt_tokens, completion_tokens) -> [N] rewards``
        takes python token lists (completions cut after the first EOS when
        ``eos_id`` is set). Returns (batch, info): the batch feeds
        ``train_step`` (``old_logp`` is a tensor on the device); info holds
        reward_mean, reward_max and completion_len_mean. In a gang (a
        collective) every rank samples and scores all N rows, the same
        ones, and its batch holds the rows of its batch shard; info is the
        N rows'."""
        from tpufw_torch.infer import SamplingConfig, generate, pad_prompts

        if self.model is None:
            raise RuntimeError("rollout() before init_state()/restore")
        g = self.grpo
        n = len(prompts) * g.group_size
        if n != self.cfg.batch_size:
            raise ValueError(
                f"{len(prompts)} prompts x group {g.group_size} = {n} "
                f"rows != batch_size {self.cfg.batch_size}")
        max_p = max(len(p) for p in prompts)
        if max_p + g.max_new_tokens > self.cfg.seq_len:
            raise ValueError(
                f"prompt ({max_p}) + max_new_tokens ({g.max_new_tokens}) "
                f"exceeds seq_len {self.cfg.seq_len}")
        tiled = [list(p) for p in prompts for _ in range(g.group_size)]
        ptoks, pads = pad_prompts(tiled)
        # Left-padded to the fixed width seq_len - max_new, as the JAX
        # package pads for its one compiled decode program a shape.
        fixed_p = self.cfg.seq_len - g.max_new_tokens
        if ptoks.shape[1] < fixed_p:
            extra = fixed_p - ptoks.shape[1]
            ptoks = np.pad(ptoks, ((0, 0), (extra, 0)))
            pads = pads + extra
        view = self.decode_view()
        completions = generate(
            view, ptoks, pads, generator,
            max_new_tokens=g.max_new_tokens,
            sampling=SamplingConfig(temperature=g.temperature),
            eos_id=g.eos_id,
        ).cpu().numpy()
        del view

        # Right-padded training rows: the prompt at position 0, where the
        # decode cache put its RoPE positions.
        t = self.cfg.seq_len
        tokens = np.zeros((n, t), np.int32)
        loss_mask = np.zeros((n, t), np.float32)
        seg = np.zeros((n, t), np.int32)
        comp_lists: List[List[int]] = []
        for i, p in enumerate(tiled):
            comp = completions[i].tolist()
            if g.eos_id is not None and g.eos_id in comp:
                comp = comp[: comp.index(g.eos_id) + 1]
            comp_lists.append(comp)
            row = p + comp
            tokens[i, : len(row)] = row
            seg[i, : len(row)] = 1
            loss_mask[i, len(p): len(row)] = 1.0

        rewards = np.asarray(reward_fn(tiled, comp_lists), np.float32)
        adv = group_advantages(rewards, g.group_size)
        shard, n_shards = self.batch_shard()
        rows = slice(shard * n // n_shards, (shard + 1) * n // n_shards)
        batch = {"tokens": tokens[rows], "loss_mask": loss_mask[rows],
                 "segment_ids": seg[rows], "advantages": adv[rows]}
        dev = batch_to_device({"tokens": batch["tokens"],
                               "segment_ids": batch["segment_ids"]},
                              self.device)
        batch["old_logp"] = self._score(dev["tokens"], dev["segment_ids"])
        info = {
            "reward_mean": float(rewards.mean()),
            "reward_max": float(rewards.max()),
            "completion_len_mean": float(
                np.mean([len(c) for c in comp_lists])),
        }
        return batch, info

    # -- step --------------------------------------------------------------

    @on_mesh
    def train_step(self, batch: dict) -> dict:
        if self.grpo.kl_beta > 0.0 and not self.has_reference():
            raise RuntimeError(
                "GRPO step with kl_beta > 0 before the reference snapshot: "
                "call init_state()/init_from_params() first")
        out = grpo_train_step(
            self.model, self.optimizer, batch_to_device(batch, self.device),
            ref_model=self.ref_model, clip_eps=self.grpo.clip_eps,
            kl_beta=self.grpo.kl_beta, temperature=self.grpo.temperature,
            loss_chunk_size=self.cfg.loss_chunk_size or 256,
            loss_chunk_dtype=self.cfg.loss_chunk_dtype,
            norm_fn=self._norm_fn(),
        )
        self.step += 1
        return out

    def run_rl(
        self,
        prompts,
        reward_fn,
        seed: int = 0,
        on_metrics: Callable[[dict], None] | None = None,
    ) -> list[dict]:
        """The RL loop: up to ``total_steps`` (a restored run trains what
        is left) of rollout then update. ``prompts`` is a fixed prompt set
        or a callable ``step_index -> prompt set``. Step i's rollout draws
        from ``step_generator(seed, i)``. Returns one dict a step: the
        rollout's info, the update's metrics as floats, ``rollout_s`` and
        ``update_s`` (host wall seconds, each ending in a read of its
        results) and ``step``. Checkpoints every ``checkpoint_every``
        steps; SIGTERM stops with a forced save and ``preempted`` set."""
        if self.model is None:
            self.init_state()
        get_prompts = prompts if callable(prompts) else (lambda i: prompts)
        ckpt = None
        if self.cfg.checkpoint_dir:
            ckpt = CheckpointManager(
                self.cfg.checkpoint_dir,
                save_interval_steps=self.cfg.checkpoint_every)
        self.checkpointer = ckpt
        shutdown, owns_shutdown = owned_shutdown(
            None, self.cfg.handle_preemption, self.cfg.preemption_sync_every)
        self.preempted = False
        start = self.step
        history = []
        try:
            for i in range(max(0, self.cfg.total_steps - start)):
                step_i = start + i
                t0 = time.perf_counter()
                batch, info = self.rollout(
                    get_prompts(step_i), reward_fn,
                    step_generator(self.device, seed, step_i))
                t1 = time.perf_counter()
                m = {k: float(v) for k, v in self.train_step(batch).items()}
                entry = {**info, **m, "rollout_s": t1 - t0,
                         "update_s": time.perf_counter() - t1,
                         "step": self.step}
                history.append(entry)
                if on_metrics:
                    on_metrics(entry)
                if ckpt is not None:
                    ckpt.save(self.step, self.state_dict)
                if checkpoint_stop(shutdown, ckpt, self.step,
                                   self.state_dict):
                    self.preempted = True
                    break
        finally:
            if ckpt is not None:
                ckpt.close()
            if owns_shutdown:
                shutdown.uninstall()
        return history
