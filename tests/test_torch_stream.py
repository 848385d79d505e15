"""Streaming, the slot pool and sampling of tpufw_torch.infer.

- ``generate_stream``'s chunks concatenate to exactly ``generate``'s
  output under the same generator seed, for greedy, sampled and penalized
  decoding and chunk sizes 1, 4, 7 and 64 (``tests/test_stream.py``);
- a row decoded through ``SlotPool`` (prefill_row -> insert ->
  decode_steps, another row inserted mid-flight) emits ``generate_text``'s
  tokens (``tests/test_slots.py``);
- the sampling transforms equal the JAX package's within 1e-6, and the
  sampler's frequencies follow the softmax of the transformed logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import sampling as j_sampling
from tpufw_torch.infer import (
    SamplingConfig,
    SlotPool,
    apply_top_k,
    apply_top_p,
    generate,
    generate_stream,
    generate_text,
    generate_text_stream,
    pad_prompts,
    prefill_row,
    sample_token,
    transform_logits,
)
from tpufw_torch.models import LLAMA_CONFIGS, Llama

CFG = dataclasses.replace(
    LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32
).decode_config()
PROMPTS = [[5, 6, 7], [9], [1, 2, 3, 4, 5, 6]]
GREEDY = SamplingConfig()
SAMPLED = SamplingConfig(temperature=0.8, top_p=0.9)
PENALIZED = SamplingConfig(temperature=0.7, top_k=12, repetition_penalty=1.4)


@pytest.fixture(scope="module")
def model():
    return Llama(CFG, device="cpu", seed=0)


def _oneshot(model, max_new, sampling, eos_id=None, seed=0):
    toks, pads = pad_prompts(PROMPTS)
    return generate(
        model, toks, pads, torch.Generator().manual_seed(seed),
        max_new_tokens=max_new, sampling=sampling, eos_id=eos_id,
    ).numpy()


def _streamed(model, max_new, chunk, sampling, eos_id=None, seed=0):
    chunks = list(generate_stream(
        model, PROMPTS, max_new_tokens=max_new, chunk_size=chunk,
        sampling=sampling, eos_id=eos_id, seed=seed,
    ))
    return chunks, np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("chunk", [1, 4, 7, 64])
@pytest.mark.parametrize(
    "sampling", [GREEDY, SAMPLED, PENALIZED],
    ids=["greedy", "sampled", "penalized"],
)
def test_stream_chunks_equal_oneshot(model, sampling, chunk):
    want = _oneshot(model, 15, sampling, seed=3)
    chunks, got = _streamed(model, 15, chunk, sampling, seed=3)
    np.testing.assert_array_equal(got, want)
    sizes = [c.shape[1] for c in chunks]
    assert sizes[:-1] == [chunk] * (len(sizes) - 1) and sizes[-1] <= chunk


def test_sampled_output_depends_on_the_seed(model):
    assert not np.array_equal(_oneshot(model, 15, SAMPLED, seed=3),
                              _oneshot(model, 15, SAMPLED, seed=4))


def test_eos_early_stop_drops_only_pad(model):
    eos = int(_oneshot(model, 10, GREEDY)[0][2])
    want = _oneshot(model, 10, GREEDY, eos_id=eos)
    _, got = _streamed(model, 10, 3, GREEDY, eos_id=eos)
    n = got.shape[1]
    np.testing.assert_array_equal(got, want[:, :n])
    assert (want[:, n:] == 0).all()


def test_text_stream_rows_match_generate_text(model):
    eos = generate_text(model, PROMPTS, max_new_tokens=10)[0][2]
    want = generate_text(model, PROMPTS, max_new_tokens=10, eos_id=eos)
    rows = [[] for _ in PROMPTS]
    for chunk in generate_text_stream(
        model, PROMPTS, max_new_tokens=10, chunk_size=3, eos_id=eos
    ):
        for i, toks in enumerate(chunk):
            rows[i].extend(toks)
    assert rows == want


def test_single_token(model):
    chunks, got = _streamed(model, 1, 8, GREEDY)
    assert len(chunks) == 1
    np.testing.assert_array_equal(got, _oneshot(model, 1, GREEDY))


def test_stream_cache_budget_is_loud(model):
    with pytest.raises(ValueError, match="KV cache"):
        list(generate_stream(model, [list(range(1, 100))],
                             max_new_tokens=40, chunk_size=8))


# ---------------------------------------------------------------------------
# Slot pool.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sampling", [GREEDY, SamplingConfig(repetition_penalty=1.5)],
    ids=["greedy", "greedy_penalized"],
)
def test_pool_matches_generate_text_with_mid_flight_insert(model, sampling):
    """Rows 0 and 1 start together; row 2 joins a free slot after two
    decode steps; each row's tokens equal ``generate_text``'s. Slots keep
    their own cursors, positions and budgets."""
    max_new = 6
    want = generate_text(model, PROMPTS, max_new_tokens=max_new,
                         sampling=sampling)
    pool = SlotPool.create(model, 4, sampling=sampling)
    rows, slot_of = {}, {0: 0, 1: 2, 2: 3}

    def admit(i):
        cache, _, first, _, seen = prefill_row(
            model, PROMPTS[i], None, sampling=sampling, eos_id=None,
            pad_to=16,
        )
        pool.insert(slot_of[i], cache, first, len(PROMPTS[i]), max_new - 1,
                    row_seen=seen)
        rows[i] = [first]

    admit(0)
    admit(1)
    for step in range(4):
        if step == 1:
            admit(2)
        out = pool.decode_steps(2).numpy()
        for i in rows:
            rows[i].extend(out[slot_of[i], : max_new - len(rows[i])].tolist())
    assert [rows[i] for i in range(3)] == want
    # Budgets spent: every slot is done and emits pad.
    assert pool.done.all()
    assert (pool.decode_steps(1) == 0).all()


def test_pool_retire_and_unported_speculation(model):
    pool = SlotPool.create(model, 2)
    cache, _, first, _, _ = prefill_row(
        model, [4, 4], None, sampling=GREEDY, eos_id=None
    )
    pool.insert(1, cache, first, 2, 5)
    assert not pool.done[1] and pool.cache[0].index[1] == 2
    pool.retire(1)
    assert pool.done[1] and pool.remaining[1] == 0
    assert (pool.decode_steps(2) == 0).all()
    assert pool.cache_len == CFG.max_seq_len
    # A retired slot emits nothing under speculation either, and its
    # cursor stays where it was.
    cursor = int(pool.cache[0].index[1])
    out, n_emit, accept = pool.spec_steps(torch.tensor([[3, 4], [5, 6]]))
    assert (out == 0).all() and (n_emit == 0).all() and (accept == 0).all()
    assert int(pool.cache[0].index[1]) == cursor
# ---------------------------------------------------------------------------
# Sampling.
# ---------------------------------------------------------------------------

KNOBS = {
    "greedy": SamplingConfig(),
    "temperature": SamplingConfig(temperature=0.7),
    "top_k": SamplingConfig(temperature=1.0, top_k=5),
    "top_p": SamplingConfig(temperature=0.9, top_p=0.8),
    "top_p_zero": SamplingConfig(temperature=1.0, top_p=0.0),
    "min_p": SamplingConfig(temperature=1.0, min_p=0.1),
    "penalty": SamplingConfig(temperature=0.8, repetition_penalty=1.5),
    "greedy_penalty": SamplingConfig(repetition_penalty=1.3),
    "all": SamplingConfig(temperature=0.8, top_k=10, top_p=0.9, min_p=0.05,
                          repetition_penalty=1.2),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_transform_logits_matches_jax(knob):
    cfg = KNOBS[knob]
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    seen = rng.random((4, 64)) < 0.2
    want = j_sampling.transform_logits(
        jnp.asarray(logits), j_sampling.SamplingConfig(**vars(cfg)),
        jnp.asarray(seen),
    )
    got = transform_logits(torch.tensor(logits), cfg, torch.tensor(seen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sampler_frequencies_match_the_transformed_softmax():
    """200k draws at vocab 16 from one seeded generator: each token's
    frequency within 0.005 (about 4 standard deviations at p = 0.25) of
    the softmax of the JAX package's transformed logits."""
    cfg = SamplingConfig(temperature=0.8, top_k=12, top_p=0.95,
                         repetition_penalty=1.3)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal(16).astype(np.float32)
    seen = rng.random(16) < 0.3
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    draws = sample_token(
        torch.tensor(logits).expand(n, 16), cfg, gen,
        torch.tensor(seen).expand(n, 16),
    )
    freq = np.bincount(draws.numpy(), minlength=16) / n
    want = jax.nn.softmax(j_sampling.transform_logits(
        jnp.asarray(logits)[None], j_sampling.SamplingConfig(**vars(cfg)),
        jnp.asarray(seen)[None],
    ))[0]
    np.testing.assert_allclose(freq, np.asarray(want), atol=5e-3)
    # Masked tokens are never drawn.
    assert (freq[np.asarray(want) == 0] == 0).all()


def test_sampling_is_reproducible_from_the_generator():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
    cfg = SamplingConfig(temperature=1.0)
    a = sample_token(logits, cfg, torch.Generator().manual_seed(7))
    b = sample_token(logits, cfg, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert torch.equal(sample_token(logits, SamplingConfig()),
                       logits.argmax(-1))


def test_top_k_and_top_p_masks():
    logits = torch.tensor([[1.0, 5.0, 3.0, 2.0]])
    masked = apply_top_k(logits, 2)
    assert masked[0, 1] == 5.0 and masked[0, 2] == 3.0
    assert masked[0, 0] < -1e29 and masked[0, 3] < -1e29
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    masked = apply_top_p(logits, 0.7)
    assert masked[0, 0] == 2.0 and masked[0, 1] == 1.0
    assert (masked[0, 2:] < -1e29).all()
    assert torch.equal(apply_top_p(logits, 1.0), logits)
    zero = apply_top_p(logits, 0.0)
    assert zero[0, 0] == 2.0 and (zero[0, 1:] < -1e29).all()
