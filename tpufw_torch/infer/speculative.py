"""Speculative decoding: a draft proposes, the target verifies in one pass
(port of ``tpufw.infer.speculative``).

The draft proposes ``k`` tokens one step at a time, the target scores all
of them in ONE cached forward of k+1 tokens, and the longest accepted
prefix is kept plus one token from the target's own distribution: one
token per pass at worst, k+1 at best.

Two acceptance modes, chosen by ``sampling.temperature``:

- **Greedy** (temperature 0): a draft token is accepted while it equals
  the target's argmax, so the output is exactly the target's greedy
  continuation whatever the draft proposes.
- **Stochastic**: draft token ``x_j ~ q_j`` is accepted iff
  ``u_j < p_j(x_j) / q_j(x_j)``; at the first rejection the replacement
  is drawn from the residual ``norm(max(p_j - q_j, 0))``, and when every
  draft survives the bonus comes from ``p_k``. Each emitted token is
  distributed as target-only sampling. ``p`` and ``q`` are the transformed
  distributions (temperature, top-k, top-p, min-p, repetition penalty),
  and the penalty's seen mask is threaded through the proposals and the
  k+1 verify positions, as in the JAX module.

Random streams of the batch path. The port's ``generate`` draws B·V
uniforms per emission index from one ``torch.Generator``, in index order
(``tpufw_torch.infer.generate``). ``speculative_generate`` draws emission
index ``n``'s uniforms from the same generator, lazily and in the same
increasing order, and uses them for the draft's proposal at index ``n``
and for the bonus draw when index ``n`` is the bonus of a full accept.
The acceptance uniforms and residual draws come from a second generator
seeded from the first one's seed. So a draft equal to the target accepts
every proposal and reproduces ``generate``'s tokens bit for bit under the
same seed, which is the JAX module's self-draft contract with a
``torch.Generator`` in place of threefry's per-index keys.

The batch path's acceptance is uniform across the batch (the min over
rows), its cursor is one int, and its rollback rewinds the cursor and
zeroes the segment ids past it. The slot-pool path (``spec_verify_steps``,
``spec_draft_steps``) accepts per slot and rewinds per-slot cursors only:
the K/V of rejected drafts past a rewound cursor keep segment 1, and the
causal mask by slot hides them until they are overwritten, since every
later query sits at a slot before them. Eager PyTorch traces nothing, so
the JAX module's ``TRACE_COUNTS`` have no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tpufw_torch.infer.generate import (
    _generator,
    _on,
    pad_prompts,
    prefill_cache,
)
from tpufw_torch.infer.sampling import (
    SamplingConfig,
    draw_uniforms,
    gumbel_argmax,
    track_seen,
    transform_logits,
)

_NEG = -1e30


def _rollback(cache: list, new_cursor: int) -> None:
    """Rewind a scalar-cursor decode cache to ``new_cursor`` valid
    entries: the slots at or past it get segment 0 (masked), and the next
    write lands on them."""
    for layer in cache:
        layer.index = new_cursor
        layer.seg[:, new_cursor:] = 0


class _IndexUniforms:
    """The uniforms of each emission index, drawn from ``generator`` in
    increasing index order and each exactly once, so index ``n`` gets the
    draw ``generate`` makes for it."""

    def __init__(self, generator, shape, device):
        self.generator, self.shape, self.device = generator, shape, device
        self.drawn: dict = {}
        self.next = 0

    def __getitem__(self, n: int) -> torch.Tensor:
        while self.next <= n:
            self.drawn[self.next] = draw_uniforms(
                self.shape, self.generator, self.device
            )
            self.next += 1
        return self.drawn[n]

    def forget_below(self, n: int) -> None:
        for i in [i for i in self.drawn if i < n]:
            del self.drawn[i]


def _aux_generator(generator: torch.Generator) -> torch.Generator:
    """The acceptance and residual stream: its own generator, seeded
    from ``generator``'s seed so a run replays."""
    seq = np.random.SeedSequence([generator.initial_seed() % 2**64, 1])
    return torch.Generator(device=generator.device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0])
    )


def _mark(seen: torch.Tensor, tokens: torch.Tensor, live=None) -> None:
    """Set ``seen[b, tokens[b, j]]`` where ``live[b, j]`` (all if None)."""
    if tokens.ndim == 1:
        tokens = tokens[:, None]
    vals = torch.ones_like(tokens, dtype=torch.uint8) if live is None \
        else live.to(torch.uint8)
    upd = torch.zeros(seen.shape, dtype=torch.uint8, device=seen.device)
    upd.scatter_reduce_(1, tokens, vals, reduce="amax")
    seen |= upd.bool()


@torch.no_grad()
def speculative_generate(
    draft_model,
    model,
    prompt_tokens,
    pad_lens,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    k: int = 4,
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    live_rows=None,
    sampling: SamplingConfig = SamplingConfig(),
    prefill_chunk_size: Optional[int] = None,
    cache_len: Optional[int] = None,
) -> tuple[torch.Tensor, dict]:
    """Decode ``model`` with ``draft_model`` speculation.

    Same contract as ``generate`` (left-padded prompts, [B,
    max_new_tokens] out, EOS rows freeze to pad) plus a stats dict
    {"iterations", "emitted"}; emitted / iterations is the tokens per
    target pass (k+1 at most). Both models share the vocabulary; they may
    be one model (self-draft: no second copy of the weights, a second
    cache). Greedy output is exactly ``model``'s greedy continuation;
    with ``sampling.temperature > 0`` (``generator`` required) each token
    is rejection-resampled to the target's transformed distribution.

    ``live_rows`` ([B] bool) names the rows whose acceptance counts
    toward the batch min; filler rows' outputs are not validated past
    their own match point and must be discarded. ``cache_len`` is both
    caches' length (default each model's ``max_seq_len``), as in
    ``generate``.
    """
    tokens = _on(model, prompt_tokens)
    pads = _on(model, pad_lens)
    b, p = tokens.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    stochastic = sampling.temperature != 0.0
    if stochastic and generator is None:
        raise ValueError(
            "sampling.temperature > 0 requires a generator (the rng of the "
            "rejection-resample draws)"
        )
    track = track_seen(sampling)
    for m, who in ((model, "model"), (draft_model, "draft_model")):
        # The verify block may overrun the accepted stream by up to k
        # slots before the rollback.
        max_seq = m.cfg.max_seq_len if cache_len is None else cache_len
        if p + max_new_tokens + k > max_seq:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({max_new_tokens}) + k ({k}) "
                f"exceeds {who}'s KV cache (max_seq_len={max_seq})"
            )
    dev = tokens.device
    col = torch.arange(p, device=dev)[None, :]
    seg = (col >= pads[:, None]).to(torch.int32)
    positions = torch.clamp(col - pads[:, None], min=0)
    t_logits, t_cache = prefill_cache(
        model, tokens, positions, seg, prefill_chunk_size, cache_len
    )
    _, d_cache = prefill_cache(
        draft_model, tokens, positions, seg, prefill_chunk_size, cache_len
    )
    vocab = t_logits.shape[-1]
    seen = None
    if track:
        idx = torch.where(seg > 0, tokens, vocab)
        seen = torch.zeros(b, vocab + 1, dtype=torch.bool, device=dev)
        seen = seen.scatter_(1, idx, True)[:, :vocab].contiguous()
    uniforms = aux = None
    first_logits = transform_logits(t_logits[:, -1, :], sampling, seen)
    if stochastic:
        uniforms = _IndexUniforms(generator, (b, vocab), dev)
        aux = _aux_generator(generator)
        first = gumbel_argmax(first_logits, uniforms[0])
    else:
        first = torch.argmax(first_logits, dim=-1)
    if track:
        _mark(seen, first)
    done = (
        torch.zeros(b, dtype=torch.bool, device=dev)
        if eos_id is None else first == eos_id
    )
    live = None if live_rows is None else _on(model, live_rows).bool()
    # k+1 columns of slack: a block near the end may overrun max_new.
    buf = torch.full((b, max_new_tokens + k + 1), pad_id, dtype=torch.long,
                     device=dev)
    buf[:, 0] = first
    if max_new_tokens == 1:
        return buf[:, :1], {"iterations": 0, "emitted": 1}
    prev, pos = first, p - pads
    ones = torch.ones(b, 1, dtype=torch.int32, device=dev)
    cols = torch.arange(k + 1, device=dev)[None, :]
    rows = torch.arange(b, device=dev)
    n, iters = 1, 0
    while n < max_new_tokens:
        t_cur0, d_cur0 = t_cache[0].index, d_cache[0].index
        # k proposals, then one step that only feeds the k-th proposal
        # so the draft cache holds every proposed token.
        drafts, qs, d_seen = [], [], None if seen is None else seen.clone()
        tok = prev
        for i in range(k + 1):
            out = draft_model(tok[:, None], (pos + i)[:, None], ones,
                              cache=d_cache, return_hidden=i == k)
            if i == k:
                break
            q_i = transform_logits(out[:, -1, :], sampling, d_seen)
            if stochastic:
                tok = gumbel_argmax(q_i, uniforms[n + i])
                qs.append(q_i)
            else:
                tok = torch.argmax(q_i, dim=-1)
            if track:
                _mark(d_seen, tok)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # [B, k]
        verify_in = torch.cat([prev[:, None], drafts], dim=1)
        verify_pos = pos[:, None] + cols
        logits = model(verify_in, verify_pos,
                       torch.ones(b, k + 1, dtype=torch.int32, device=dev),
                       cache=t_cache)
        if track:
            # Position j's mask is seen plus drafts[:, :j]: the mask
            # generate would use at that emission index.
            outs, s = [], seen.clone()
            for j in range(k + 1):
                outs.append(transform_logits(logits[:, j], sampling, s))
                if j < k:
                    _mark(s, drafts[:, j])
            p_trans = torch.stack(outs, dim=1)
        else:
            p_trans = transform_logits(logits, sampling)
        if stochastic:
            logp = torch.log_softmax(p_trans, dim=-1)
            logq = torch.log_softmax(torch.stack(qs, dim=1), dim=-1)
            lp = logp[:, :k].gather(2, drafts[..., None])[..., 0]
            lq = logq.gather(2, drafts[..., None])[..., 0]
            us = torch.rand((b, k), generator=aux, device=dev)
            match = us < torch.exp(lp - lq)
        else:
            greedy = torch.argmax(p_trans, dim=-1)  # [B, k+1]
            match = drafts == greedy[:, :k]
        row_accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
        # Rows whose output no longer matters do not throttle the min:
        # EOS-done rows and filler rows.
        row_accept = torch.where(done, k, row_accept)
        if live is not None:
            row_accept = torch.where(live, row_accept, k)
        a = int(row_accept.min())  # the pass's one host sync
        drafts_pad = torch.cat(
            [drafts, torch.zeros(b, 1, dtype=torch.long, device=dev)], dim=1
        )
        if stochastic:
            if a == k:
                # The bonus draws with index n+k's uniforms, as generate
                # draws that index.
                alt = gumbel_argmax(p_trans[:, k], uniforms[n + k])
            else:
                p_a = torch.exp(logp[:, a])
                q_a = torch.softmax(logq[:, a], dim=-1)
                alt = gumbel_argmax(
                    torch.log(torch.clamp(p_a - q_a, min=0.0)),
                    draw_uniforms((b, vocab), aux, dev),
                )
            col_a = torch.where(row_accept > a, drafts_pad[:, a], alt)
        else:
            col_a = greedy[:, a]
        block = torch.where(cols < a, drafts_pad, col_a[:, None])
        n_block = min(a + 1, max_new_tokens - n)
        live_col = (cols < n_block).expand(b, k + 1)
        if eos_id is None:
            done_before = done[:, None].expand(b, k + 1)
            new_done = done
        else:
            hits = (block == eos_id) & live_col
            ih = hits.long()
            done_before = done[:, None] | ((torch.cumsum(ih, 1) - ih) > 0)
            new_done = done | hits.any(dim=1)
        buf[:, n:n + k + 1] = torch.where(live_col & ~done_before, block,
                                          pad_id)
        # The target verified prev + k drafts and the draft fed them
        # all; both keep prev + a. The bonus is fed next pass.
        _rollback(t_cache, t_cur0 + a + 1)
        _rollback(d_cache, d_cur0 + a + 1)
        prev = block[rows, a]
        if track:
            _mark(seen, block, live_col)
        pos = pos + a + 1
        done = new_done
        n += n_block
        iters += 1
        if stochastic:
            uniforms.forget_below(n)
    return buf[:, :max_new_tokens], {
        "iterations": iters, "emitted": min(n, max_new_tokens)
    }


def speculative_generate_text(
    draft_model,
    model,
    prompts: Sequence[Sequence[int]],
    *,
    max_new_tokens: int,
    k: int = 4,
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    live_rows: Optional[Sequence[bool]] = None,
    sampling: SamplingConfig = SamplingConfig(),
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    prefill_chunk_size: Optional[int] = None,
    cache_len: Optional[int] = None,
) -> tuple[list[list[int]], dict]:
    """Ragged python prompts in, ragged lists out (truncated after EOS),
    as ``generate_text``; an explicit ``generator`` wins over ``seed``.
    Returns (outputs, stats)."""
    if generator is None and sampling.temperature != 0.0:
        generator = _generator(model, seed)
    tokens, pads = pad_prompts(prompts, pad_id)
    out, stats = speculative_generate(
        draft_model, model, tokens, pads, generator,
        max_new_tokens=max_new_tokens, k=k, pad_id=pad_id, eos_id=eos_id,
        live_rows=live_rows, sampling=sampling,
        prefill_chunk_size=prefill_chunk_size, cache_len=cache_len,
    )
    result = []
    for toks in out.cpu().tolist():
        if eos_id is not None and eos_id in toks:
            toks = toks[: toks.index(eos_id) + 1]
        result.append(toks)
    return result, stats


# ---------------------------------------------------------------------------
# Slot-pool speculation
# ---------------------------------------------------------------------------
# Greedy emissions are the argmax of the verify pass's fp32 logits, so
# speculation on the pool gives plain decode_steps' tokens whatever the
# accept counts. Stochastic pools rejection-resample per slot (exact in
# distribution, not bit-equal). Self-drafting (ngram_propose) proposes on
# the host; its q is a one-hot at the proposal, so the accept test is
# u < p(x_j). A repetition penalty is refused: acceptance at position j
# would change the penalized distribution at j+1.


def _set_pool_cursor(cache: list, new: torch.Tensor) -> None:
    """Write the per-slot cursors ``new`` [S] into every layer."""
    for layer in cache:
        layer.index = new.clone()


def _spec_advance(
    logits, proposals, q_trans, generator, token, pos, done, remaining,
    *, sampling, pad_id, eos_id,
):
    """The shared verify tail: target logits [S, k+1, V] of the block
    [token, p_1..p_k] -> per-slot emissions and advanced slot state.

    Emission j follows block position j (col 0 is the token after
    ``token``, col k the bonus after a full accept). The valid mask
    composes acceptance (col <= accept), the per-slot budget,
    first-EOS-inclusive truncation and entry done, as ``decode_steps``
    masks its steps. ``q_trans`` is the draft's transformed logits
    [S, k, V], or None for deterministic proposals (a one-hot q). The
    stochastic draws take from ``generator`` in a fixed order: the [S, k]
    acceptance uniforms, then the [S, V] column-``accept`` draw.

    Returns (out [S, k+1] pad-masked, n_emit [S], accept [S], token, pos,
    done, remaining).
    """
    s, kp1 = logits.shape[:2]
    k = kp1 - 1
    dev = logits.device
    cols = torch.arange(kp1, device=dev)[None, :]
    rows = torch.arange(s, device=dev)
    p_trans = transform_logits(logits, sampling)
    if sampling.temperature == 0.0:
        block = torch.argmax(p_trans, dim=-1)
        match = proposals == block[:, :k]
        accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
    else:
        logp = torch.log_softmax(p_trans, dim=-1)
        lp = logp[:, :k].gather(2, proposals[..., None])[..., 0]
        if q_trans is None:
            lq = torch.zeros_like(lp)
        else:
            lq = torch.log_softmax(q_trans, dim=-1).gather(
                2, proposals[..., None]
            )[..., 0]
        us = draw_uniforms((s, k), generator, dev)
        match = torch.log(us) < (lp - lq)
        accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
        # Column `accept` draws from p on a full accept, else from the
        # residual at the first rejection (for a one-hot q: p with the
        # proposal masked out).
        logp_a = logp[rows, accept]
        at = torch.clamp(accept, max=k - 1)
        if q_trans is None:
            residual = logp_a.clone()
            residual[rows, proposals[rows, at]] = _NEG
        else:
            q_a = torch.softmax(q_trans[rows, at], dim=-1)
            residual = torch.log(
                torch.clamp(torch.exp(logp_a) - q_a, min=1e-30)
            )
        alt_logits = torch.where((accept == k)[:, None], logp_a, residual)
        alt = gumbel_argmax(alt_logits,
                            draw_uniforms(alt_logits.shape, generator, dev))
        props_pad = torch.cat(
            [proposals, torch.zeros(s, 1, dtype=torch.long, device=dev)],
            dim=1,
        )
        block = torch.where(cols < accept[:, None], props_pad, alt[:, None])
    valid = (cols <= accept[:, None]) & (cols < remaining[:, None])
    hits = None
    if eos_id is not None:
        hits = (block == eos_id) & valid
        ih = hits.long()
        # The EOS itself is delivered; everything after it is masked.
        valid = valid & ((torch.cumsum(ih, dim=1) - ih) == 0)
    emit = valid & ~done[:, None]
    out = torch.where(emit, block, pad_id)
    n_emit = emit.sum(dim=1)
    accept = torch.where(done, 0, accept)
    remaining = torch.where(done, remaining, remaining - n_emit)
    newly = remaining <= 0
    if eos_id is not None:
        newly = newly | (hits & emit).any(dim=1)
    # The next feed is the last emitted token; a live row emits >= 1.
    last = torch.clamp(n_emit - 1, min=0)
    token = torch.where(done, pad_id, block[rows, last])
    pos = torch.where(done, pos, pos + n_emit)
    return out, n_emit, accept, token, pos, done | newly, remaining


def _verify(pool, proposals, q_trans, generator):
    """One k+1 target pass over [token, proposals] and the verify tail;
    advances ``pool`` and returns (out, n_emit, accept, entry done)."""
    s, k = proposals.shape
    dev = pool.token.device
    block_in = torch.cat([pool.token[:, None], proposals], dim=1)
    positions = pool.pos[:, None] + torch.arange(k + 1, device=dev)[None, :]
    logits = pool.model(
        block_in, positions,
        torch.ones(s, k + 1, dtype=torch.int32, device=dev),
        cache=pool.cache,
    )
    was_done = pool.done
    (out, n_emit, accept, pool.token, pool.pos, pool.done,
     pool.remaining) = _spec_advance(
        logits, proposals, q_trans, generator, pool.token, pool.pos,
        was_done, pool.remaining, sampling=pool.sampling,
        pad_id=pool.pad_id, eos_id=pool.eos_id,
    )
    return out, n_emit, accept, was_done


def _reject_penalty(sampling: SamplingConfig) -> None:
    if track_seen(sampling):
        raise ValueError(
            "speculative slot-pool decode does not compose with a "
            "repetition penalty (acceptance at position j would change "
            "the penalized distribution at j+1, breaking the one-pass "
            "verify); use plain decode_steps for penalty pools"
        )


@torch.no_grad()
def spec_verify_steps(pool, proposals, generator=None):
    """One self-draft speculative pass over ``pool`` (a ``SlotPool`` or
    ``PagedSlotPool``): verify host proposals [S, k], advance the pool,
    return (out [S, k+1], n_emit [S], accept [S]) on the device. Done
    slots keep their cursors."""
    _reject_penalty(pool.sampling)
    proposals = _on(pool.model, proposals)
    cur0 = pool.cache[0].index.clone()
    out, n_emit, accept, was_done = _verify(pool, proposals, None, generator)
    _set_pool_cursor(pool.cache, torch.where(was_done, cur0, cur0 + n_emit))
    return out, n_emit, accept


@torch.no_grad()
def spec_draft_steps(pool, draft_pool, generator=None, k: int = 4):
    """One fused draft and verify pass: ``draft_pool`` (same slots, its
    cursors in lockstep with ``pool``'s) proposes k tokens in k
    single-token passes and then feeds the k-th, so its cache holds
    [token, p_1..p_k]; the target verifies, and both pools' cursors
    advance by each slot's emit count, which keeps every accepted entry
    in both caches. Returns (out [S, k+1], n_emit [S], accept [S])."""
    _reject_penalty(pool.sampling)
    sampling = pool.sampling
    stochastic = sampling.temperature != 0.0
    s = pool.token.shape[0]
    dev = pool.token.device
    cur0 = pool.cache[0].index.clone()
    d_cur0 = draft_pool.cache[0].index.clone()
    ones = torch.ones(s, 1, dtype=torch.int32, device=dev)
    toks, qs = [], []
    tok = pool.token
    for i in range(k + 1):
        out = draft_pool.model(tok[:, None], (pool.pos + i)[:, None], ones,
                               cache=draft_pool.cache, return_hidden=i == k)
        if i == k:
            break
        if stochastic:
            q_i = transform_logits(out[:, -1, :], sampling)
            tok = gumbel_argmax(
                q_i, draw_uniforms(q_i.shape, generator, dev)
            )
            qs.append(q_i)
        else:
            tok = torch.argmax(out[:, -1, :].float(), dim=-1)
        toks.append(tok)
    proposals = torch.stack(toks, dim=1)
    q_trans = torch.stack(qs, dim=1) if stochastic else None
    out, n_emit, accept, was_done = _verify(pool, proposals, q_trans,
                                            generator)
    _set_pool_cursor(pool.cache, torch.where(was_done, cur0, cur0 + n_emit))
    _set_pool_cursor(draft_pool.cache,
                     torch.where(was_done, d_cur0, d_cur0 + n_emit))
    return out, n_emit, accept


def ngram_propose(
    history: Sequence[int], k: int, *, max_n: int = 3, pad_id: int = 0
) -> List[int]:
    """Prompt-lookup self-drafting (host-side, O(len * n) per call):
    match the longest trailing n-gram (n = max_n..1) of ``history``
    against its earlier occurrences and propose the k tokens that
    followed the MOST RECENT match. A cold miss returns pad fill: the
    verify pass then accepts 0 columns and the pass yields one token,
    never a wrong one. (A copy of ``tpufw``'s.)"""
    h = list(history)
    length = len(h)
    for n in range(min(max_n, length - 1), 0, -1):
        tail = h[length - n:]
        for i in range(length - n - 1, -1, -1):
            if h[i:i + n] == tail:
                cont = h[i + n:i + n + k]
                if cont:
                    return (cont + [pad_id] * (k - len(cont)))[:k]
    return [pad_id] * k


class AcceptEMA:
    """Per-slot EMA of the accepted-draft fraction (accept / k), the
    host-side signal behind acceptance-aware scheduling (a copy of
    ``tpufw``'s). Slots start OPTIMISTIC (EMA 1.0 on occupy) so every
    request gets at least one speculative pass; the pool runs spec while
    the mean EMA over active slots clears ``min_accept``, and otherwise
    falls back to plain chunked decode, re-probing with one spec pass
    every ``probe_every`` fallback chunks (0 disables probing: draft-model
    pools set it, because plain chunks leave the draft KV stale)."""

    def __init__(
        self,
        n_slots: int,
        *,
        alpha: float = 0.25,
        min_accept: float = 0.25,
        probe_every: int = 8,
    ) -> None:
        self.alpha = float(alpha)
        self.min_accept = float(min_accept)
        self.probe_every = int(probe_every)
        self.ema: List[Optional[float]] = [None] * n_slots
        self._since_spec = 0

    def occupy(self, slot: int) -> None:
        self.ema[slot] = 1.0

    def vacate(self, slot: int) -> None:
        self.ema[slot] = None

    def update(self, slot: int, frac: float) -> None:
        prev = self.ema[slot]
        if prev is None:
            prev = 1.0
        self.ema[slot] = (1.0 - self.alpha) * prev + self.alpha * float(
            frac
        )

    def fallback_slots(self, slots: Sequence[int]) -> int:
        """Active slots currently below the acceptance threshold."""
        return sum(
            1
            for s in slots
            if self.ema[s] is not None and self.ema[s] < self.min_accept
        )

    def use_spec(self, slots: Sequence[int]) -> bool:
        vals = [self.ema[s] for s in slots if self.ema[s] is not None]
        if not vals:
            return False
        if sum(vals) / len(vals) >= self.min_accept:
            self._since_spec = 0
            return True
        self._since_spec += 1
        if self.probe_every and self._since_spec >= self.probe_every:
            self._since_spec = 0
            return True
        return False
