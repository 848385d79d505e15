"""Autoregressive generation: KV-cache prefill and a decode loop (port of
``tpufw.infer.generate``).

Prompts are LEFT-padded to one length and the KV cache has
``cfg.max_seq_len`` slots per row: every live token sits flush against
the cache cursor, RoPE positions are slot − pad length, and pad slots
carry segment 0, so attention never sees them. Rows that reach ``eos_id``
keep stepping with their outputs frozen to ``pad_id`` (masking, not
control flow), so the loop never waits on the host.

The model is a decode model (``Llama``, ``Mixtral`` or ``Gemma`` of
``cfg.decode_config()``); it holds its own weights, so no params argument
is passed.

Randomness contract. One ``torch.Generator`` on the model's device,
seeded with ``seed`` (or passed in), drives every sampled token in one
fixed order: the first token (sampled from the prefill's last logits)
draws first, then decode steps 1, 2, ... in turn, each draw taking B·V
uniforms (``sampling.sample_token``). ``generate_stream`` runs the same
prefill and the same step in the same order, so its chunks concatenate
to exactly ``generate``'s output under the same seed. Greedy decoding
draws nothing. The JAX package's threefry key splits cannot be
reproduced, so sampled tokens agree with it in distribution, not bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpufw_torch.infer.sampling import SamplingConfig, sample_token, track_seen
from tpufw_torch.models.llama import QuantProjection
from tpufw_torch.models.mixtral import QuantExperts


def cast_decode_params(model, dtype=torch.bfloat16):
    """Serving-precision cast, in place: every fp32 parameter of ``model``
    becomes ``dtype``, one tensor at a time, so the model never holds two
    full copies. Int8 codes and the fp32 scales of ``QuantProjection`` and
    ``QuantExperts`` stay as they are; RMSNorm weights are cast like the
    rest."""
    with torch.no_grad():
        for module in model.modules():
            quant = isinstance(module, (QuantProjection, QuantExperts))
            for name, p in module.named_parameters(recurse=False):
                if p.dtype == torch.float32 and not (quant and name == "scale"):
                    p.data = p.data.to(dtype)
    return model


def pad_prompts(
    prompts: Sequence[Sequence[int]], pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Left-pad ragged prompts to [B, max_len]; returns (tokens, pad_lens)."""
    max_len = max(len(p) for p in prompts)
    out = np.full((len(prompts), max_len), pad_id, np.int32)
    pads = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        pads[i] = max_len - len(p)
        if len(p):
            out[i, pads[i]:] = np.asarray(p, np.int32)
    return out, pads


def _check_budget(model, p: int, max_new_tokens: int,
                  cache_len: Optional[int] = None) -> None:
    """Only p + max_new_tokens − 1 slots are written (the last sampled
    token is never fed back); the cache holds ``cache_len`` slots
    (default ``cfg.max_seq_len``)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    max_seq = model.cfg.max_seq_len if cache_len is None else cache_len
    if p + max_new_tokens - 1 > max_seq:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the KV cache (max_seq_len={max_seq})"
        )


def _generator(model, seed: int) -> torch.Generator:
    return torch.Generator(device=model.device).manual_seed(seed)


def _on(model, x) -> torch.Tensor:
    """Ids, lengths or masks (list, numpy or tensor) as int64 on the
    model's device."""
    return torch.as_tensor(x, device=model.device).long()


def prefill_cache(
    model,
    prompt_tokens: torch.Tensor,
    positions: torch.Tensor,
    seg: torch.Tensor,
    prefill_chunk_size: Optional[int],
    cache_len: Optional[int] = None,
):
    """The whole (padded) prompt through a fresh cache of ``cache_len``
    slots (default ``cfg.max_seq_len``): one pass, or chunks of
    ``prefill_chunk_size`` positions (the cursor advances per chunk;
    slot-ordered causality makes both write the same cache). Returns
    (logits of the last chunk, cache); left padding makes their last
    column every row's final prompt token."""
    b, p = prompt_tokens.shape
    cache = model.init_cache(b, length=cache_len)
    c = prefill_chunk_size
    if not (c is not None and 1 <= c < p):
        c = p
    for s in range(0, p, c):
        logits = model(
            prompt_tokens[:, s:s + c], positions[:, s:s + c],
            seg[:, s:s + c], cache=cache,
        )
    return logits, cache


def _prefill_and_first(
    model,
    prompt_tokens: torch.Tensor,
    pad_lens: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    sampling: SamplingConfig,
    eos_id: Optional[int],
    prefill_chunk_size: Optional[int],
    live_rows: Optional[torch.Tensor] = None,
    cache_len: Optional[int] = None,
):
    """Prefill and the first token, shared by ``generate``, the stream
    and the slot pool. Returns (cache, first, pos0, done, seen); ``seen``
    is the [B, V] bool mask of prompt and emitted tokens, None unless the
    repetition penalty needs it."""
    b, p = prompt_tokens.shape
    col = torch.arange(p, device=prompt_tokens.device)[None, :]
    seg = (col >= pad_lens[:, None]).to(torch.int32)
    positions = torch.clamp(col - pad_lens[:, None], min=0)
    logits, cache = prefill_cache(
        model, prompt_tokens, positions, seg, prefill_chunk_size, cache_len
    )
    seen = None
    if track_seen(sampling):
        vocab = logits.shape[-1]
        # Padding scatters into a spare column that is then dropped.
        idx = torch.where(seg > 0, prompt_tokens, vocab)
        seen = torch.zeros(b, vocab + 1, dtype=torch.bool, device=idx.device)
        seen = seen.scatter_(1, idx, True)[:, :vocab].contiguous()
    first = sample_token(logits[:, -1, :], sampling, generator, seen)
    if seen is not None:
        seen[torch.arange(b, device=first.device), first] = True
    # The EOS token itself is emitted; only rows already done emit pad.
    done = (
        torch.zeros(b, dtype=torch.bool, device=first.device)
        if eos_id is None else first == eos_id
    )
    if live_rows is not None:
        # Filler rows are born done: they emit pad from step 1.
        done = done | ~live_rows
    return cache, first, p - pad_lens, done, seen


def _decode_step(
    model, cache, token, pos, done, seen, generator, *, sampling, pad_id,
    eos_id,
):
    """One decode step for every row: sample, update ``seen``, pad the
    rows already done, mark EOS. Returns (emitted, pos + 1, done); the
    emitted token is what the next step feeds back."""
    b = token.shape[0]
    ones = torch.ones(b, 1, dtype=torch.int32, device=token.device)
    logits = model(token[:, None], pos[:, None], ones, cache=cache)
    nxt = sample_token(logits[:, -1, :], sampling, generator, seen)
    if seen is not None:
        seen[torch.arange(b, device=nxt.device), nxt] = True
    emitted = torch.where(done, pad_id, nxt)
    if eos_id is not None:
        done = done | (nxt == eos_id)
    return emitted, pos + 1, done


@torch.no_grad()
def generate(
    model,
    prompt_tokens,
    pad_lens,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    sampling: SamplingConfig = SamplingConfig(),
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    prefill_chunk_size: Optional[int] = None,
    live_rows=None,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Generate continuations: [B, max_new_tokens] int64 on the model's
    device.

    Args:
      model: a decode model (``Llama`` or ``Gemma`` of
        ``cfg.decode_config()``).
      prompt_tokens: [B, P] LEFT-padded token ids (see ``pad_prompts``).
      pad_lens: [B] pad count per row.
      generator: the ``torch.Generator`` sampled tokens draw from (on the
        model's device; unused for greedy). None draws from torch's
        default generator.
      max_new_tokens: decode length; rows that hit ``eos_id`` emit
        ``pad_id`` from then on.
      prefill_chunk_size: run the prompt through the cache in chunks of
        this many positions; a chunk >= the prompt is one pass.
      live_rows: optional [B] bool mask; False rows (batch fillers) start
        done and emit ``pad_id`` from step 1.
      cache_len: the KV cache's length (default ``cfg.max_seq_len``); the
        masks make the tokens independent of it. ``tpufw`` builds a model
        of that ``max_seq_len`` instead (the server's request-sized
        caches).
    """
    tokens = _on(model, prompt_tokens)
    _check_budget(model, tokens.shape[1], max_new_tokens, cache_len)
    cache, token, pos, done, seen = _prefill_and_first(
        model, tokens, _on(model, pad_lens), generator, sampling=sampling,
        eos_id=eos_id, prefill_chunk_size=prefill_chunk_size,
        live_rows=None if live_rows is None else _on(model, live_rows).bool(),
        cache_len=cache_len,
    )
    out = [token]
    for _ in range(max_new_tokens - 1):
        token, pos, done = _decode_step(
            model, cache, token, pos, done, seen, generator,
            sampling=sampling, pad_id=pad_id, eos_id=eos_id,
        )
        out.append(token)
    return torch.stack(out, dim=1)


@torch.no_grad()
def generate_stream(
    model,
    prompts: Sequence[Sequence[int]],
    *,
    max_new_tokens: int,
    chunk_size: int = 16,
    sampling: SamplingConfig = SamplingConfig(),
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    prefill_chunk_size: Optional[int] = None,
    live_rows: Optional[Sequence[bool]] = None,
    cache_len: Optional[int] = None,
):
    """Streaming decode: yields [B, n] int64 numpy chunks whose
    concatenation equals ``generate``'s output under the same generator,
    stopping early once every row is past its eos (the dropped tail is
    all pad). The first chunk carries the prefill-sampled token plus
    ``chunk_size`` − 1 steps, later ones ``chunk_size`` steps; the host
    syncs once per chunk. ``cache_len`` as in ``generate``."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    tokens, pads = pad_prompts(prompts, pad_id)
    _check_budget(model, tokens.shape[1], max_new_tokens, cache_len)
    if generator is None:
        generator = _generator(model, seed)
    cache, token, pos, done, seen = _prefill_and_first(
        model, _on(model, tokens), _on(model, pads), generator,
        sampling=sampling, eos_id=eos_id,
        prefill_chunk_size=prefill_chunk_size,
        live_rows=None if live_rows is None else _on(model, live_rows).bool(),
        cache_len=cache_len,
    )
    emitted = 1
    pending = [token]
    while True:
        if len(pending) == chunk_size or emitted == max_new_tokens:
            yield torch.stack(pending, dim=1).cpu().numpy()
            pending = []
            if emitted == max_new_tokens or (
                eos_id is not None and bool(done.all())
            ):
                return
        token, pos, done = _decode_step(
            model, cache, token, pos, done, seen, generator,
            sampling=sampling, pad_id=pad_id, eos_id=eos_id,
        )
        pending.append(token)
        emitted += 1


def generate_text_stream(
    model,
    prompts: Sequence[Sequence[int]],
    *,
    max_new_tokens: int,
    chunk_size: int = 16,
    sampling: SamplingConfig = SamplingConfig(),
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    seed: int = 0,
    prefill_chunk_size: Optional[int] = None,
    live_rows: Optional[Sequence[bool]] = None,
    cache_len: Optional[int] = None,
):
    """Ragged streaming wrapper: yields, per chunk, one ``list[int]`` of
    new tokens per row; a row stops after its eos (the eos included), so
    a row's chunks concatenate to the row ``generate_text`` returns."""
    row_done = [False] * len(prompts)
    for chunk in generate_stream(
        model, prompts,
        max_new_tokens=max_new_tokens, chunk_size=chunk_size,
        sampling=sampling, pad_id=pad_id, eos_id=eos_id, seed=seed,
        prefill_chunk_size=prefill_chunk_size, live_rows=live_rows,
        cache_len=cache_len,
    ):
        out: list[list[int]] = []
        for i, row in enumerate(chunk):
            toks = [] if row_done[i] else row.tolist()
            if eos_id is not None and not row_done[i] and eos_id in toks:
                toks = toks[: toks.index(eos_id) + 1]
                row_done[i] = True
            out.append(toks)
        yield out


def generate_text(
    model,
    prompts: Sequence[Sequence[int]],
    *,
    max_new_tokens: int,
    sampling: SamplingConfig = SamplingConfig(),
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    seed: int = 0,
    prefill_chunk_size: Optional[int] = None,
    live_rows: Optional[Sequence[bool]] = None,
    cache_len: Optional[int] = None,
) -> list[list[int]]:
    """Ragged python prompts in, ragged lists out (truncated after eos)."""
    tokens, pads = pad_prompts(prompts, pad_id)
    out = generate(
        model, tokens, pads, _generator(model, seed),
        max_new_tokens=max_new_tokens, sampling=sampling, pad_id=pad_id,
        eos_id=eos_id, prefill_chunk_size=prefill_chunk_size,
        live_rows=live_rows, cache_len=cache_len,
    )
    result = []
    for toks in out.cpu().tolist():
        if eos_id is not None and eos_id in toks:
            toks = toks[: toks.index(eos_id) + 1]
        result.append(toks)
    return result
