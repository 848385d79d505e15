"""Slot pool for continuous batching (port of ``tpufw.infer.slots``).

The KV cache is a pool of ``S`` slots with fixed shapes (``[S, cache_len,
heads, dim]`` per layer, or DeepSeek's latents ``[S, cache_len, rank]``)
and per-slot cursors (the cache's ``index`` is an [S] tensor, so the
model's cached attention writes each row at its own offset). Requests
move through it at decode-step granularity:

- ``prefill_row`` runs one request's prompt through a B=1 cache (the
  shared prefill and first-token code of ``generate``);
- ``SlotPool.insert`` copies that row cache into slot ``i``;
- ``SlotPool.decode_steps`` advances every slot ``n`` tokens under
  per-slot ``(pos, done, remaining, seen)`` state, so slots join and
  leave mid-flight without touching the others;
- ``SlotPool.retire`` freezes a slot (error paths; natural completions
  are frozen by the step itself).

Eager PyTorch traces nothing, so the JAX module's ``TRACE_COUNTS`` (jit
traces, proving that occupancy changes never recompile) are not ported:
that contract returns with CUDA graphs or ``torch.compile``.
``spec_steps`` and ``spec_draft_steps`` advance the pool by speculative
passes (``tpufw_torch.infer.speculative``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from tpufw_torch.infer.generate import _decode_step, _on, _prefill_and_first
from tpufw_torch.infer.sampling import SamplingConfig, track_seen
from tpufw_torch.infer.speculative import spec_draft_steps, spec_verify_steps


def pool_cache(model, n_slots: int, cache_len: Optional[int] = None) -> list:
    """A zeroed ``n_slots`` cache of ``cache_len`` slots per row (default
    the model's ``max_seq_len``) with per-slot cursors. Never-written
    slots keep segment 0, which the segment mask hides."""
    return model.init_cache(n_slots, per_row=True, length=cache_len)


@torch.no_grad()
def prefill_row(
    model,
    prompt,
    generator: Optional[torch.Generator],
    *,
    sampling: SamplingConfig,
    eos_id: Optional[int],
    pad_to: Optional[int] = None,
    prefill_chunk_size: Optional[int] = None,
    pad_id: int = 0,
    cache_len: Optional[int] = None,
):
    """B=1 prefill of one request into a row cache of ``cache_len`` slots
    (default the model's ``max_seq_len``). ``pad_to`` left-pads the prompt
    to a bucketed width. Returns ``(row_cache, first, first_int, done,
    seen)``; ``first_int`` is the first token on the host."""
    p = len(prompt)
    width = max(pad_to or p, p)
    tokens = np.full((1, width), pad_id, np.int32)
    if p:
        tokens[0, width - p:] = np.asarray(prompt, np.int32)
    cache, first, _, done, seen = _prefill_and_first(
        model, _on(model, tokens), _on(model, [width - p]), generator,
        sampling=sampling, eos_id=eos_id,
        prefill_chunk_size=prefill_chunk_size, cache_len=cache_len,
    )
    return cache, first, int(first[0]), done, seen


@dataclasses.dataclass
class SlotPool:
    """Device state of one (cache_len, sampling) pool. Which request owns
    which slot is the scheduler's business; this object carries the
    tensors."""

    model: Any
    n_slots: int
    sampling: SamplingConfig
    pad_id: int
    eos_id: Optional[int]
    cache: list
    token: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    remaining: torch.Tensor
    seen: Optional[torch.Tensor]

    @classmethod
    def create(
        cls,
        model,
        n_slots: int,
        *,
        sampling: SamplingConfig = SamplingConfig(),
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        cache_len: Optional[int] = None,
    ) -> "SlotPool":
        """A pool of ``n_slots`` empty slots of ``cache_len`` KV slots
        each (default the model's ``max_seq_len``) over ``model``'s
        weights."""
        dev = model.device
        seen = None
        if track_seen(sampling):
            seen = torch.zeros(
                n_slots, model.cfg.vocab_size, dtype=torch.bool, device=dev
            )
        return cls(
            model=model,
            n_slots=n_slots,
            sampling=sampling,
            pad_id=pad_id,
            eos_id=eos_id,
            cache=pool_cache(model, n_slots, cache_len),
            token=torch.zeros(n_slots, dtype=torch.long, device=dev),
            pos=torch.zeros(n_slots, dtype=torch.long, device=dev),
            # Empty slots are born done with no budget: they emit pad and
            # their zeroed, segment-0 cache rows stay invisible.
            done=torch.ones(n_slots, dtype=torch.bool, device=dev),
            remaining=torch.zeros(n_slots, dtype=torch.long, device=dev),
            seen=seen,
        )

    @property
    def cache_len(self) -> int:
        return int(self.cache[0].seg.shape[1])

    @torch.no_grad()
    def insert(self, slot: int, row_cache, first, pos0: int, budget: int,
               row_seen=None) -> None:
        """Occupy ``slot`` with a prefilled row. ``budget`` is the number
        of decode steps left (max_new − 1: the first token is out)."""
        for pool, row in zip(self.cache, row_cache):
            for f in pool.FEATS:
                getattr(pool, f)[slot].copy_(getattr(row, f)[0])
            pool.seg[slot].copy_(row.seg[0])
            pool.index[slot] = row.index
        self.token[slot] = torch.as_tensor(first).reshape(())
        self.pos[slot] = pos0
        self.done[slot] = False
        self.remaining[slot] = budget
        if self.seen is not None:
            self.seen[slot] = row_seen[0]

    @torch.no_grad()
    def decode_steps(
        self, n_steps: int, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Advance every slot ``n_steps`` tokens; returns [S, n_steps].
        A slot emits its token, then spends budget, so the EOS or last
        token is delivered and the slot freezes after it; done slots keep
        stepping but feed pad back and emit pad."""
        out = []
        for _ in range(n_steps):
            was_done = self.done
            self.token, self.pos, done = _decode_step(
                self.model, self.cache, self.token, self.pos, was_done,
                self.seen, generator, sampling=self.sampling,
                pad_id=self.pad_id, eos_id=self.eos_id,
            )
            self.remaining = torch.where(
                was_done, self.remaining, self.remaining - 1
            )
            self.done = done | (self.remaining <= 0)
            out.append(self.token)
        return torch.stack(out, dim=1)

    def spec_steps(self, proposals, generator=None):
        """One self-draft speculative pass: verify host proposals [S, k]
        in one k+1 target pass (``infer.speculative.spec_verify_steps``).
        Returns (out [S, k+1], n_emit [S], accept [S])."""
        return spec_verify_steps(self, proposals, generator)

    def spec_draft_steps(self, draft_pool, generator=None, k: int = 4):
        """One fused draft and verify pass with ``draft_pool``'s model
        (``infer.speculative.spec_draft_steps``)."""
        return spec_draft_steps(self, draft_pool, generator, k)

    @torch.no_grad()
    def retire(self, slot: int) -> None:
        """Freeze ``slot`` (error paths)."""
        self.done[slot] = True
        self.remaining[slot] = 0
