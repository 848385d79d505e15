"""tpufw_torch.infer vs tpufw.infer on the tiny presets in fp32, with the
Flax weights moved into the port: greedy generation token for token
(ragged batches, chunked prefill, EOS, dead filler rows), prefill and
decode-step logits within 2e-4, the cache budget, and the serving cast.
Sampling, streaming and the slot pool are in test_torch_stream.py."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import PRESETS, flax_params, pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.infer import (
    cast_decode_params,
    generate,
    generate_text,
    pad_prompts,
    prefill_cache,
)
from tpufw_torch.models import Llama

# ``tpufw.infer.generate`` the module; the package exports the function.
j_generate = importlib.import_module("tpufw.infer.generate")
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_NEW = 8
# Ragged; the 37-token prompt runs past mistral_tiny's 32-token window.
PROMPTS = [
    np.random.default_rng(1).integers(1, 256, n).tolist() for n in (37, 2, 11)
]


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg, tcfg = pair(name)
    params = flax_params(jcfg)
    jmodel = JLlama(jcfg.decode_config())
    ref = j_generate.generate_text(
        jmodel, params, PROMPTS, max_new_tokens=MAX_NEW
    )
    return jcfg, jmodel, params, torch_model(tcfg.decode_config(), params), ref


@pytest.mark.parametrize("chunk", [None, 4, 5, 64])
@pytest.mark.parametrize("name", PRESETS)
def test_greedy_generate_text_matches_jax(name, chunk):
    """Token-identical to the JAX package's one-shot greedy decode, for
    one-shot and chunked prefill (4 and 5 leave a tail chunk, 64 is
    longer than the prompt)."""
    *_, model, ref = _setup(name)
    got = generate_text(
        model, PROMPTS, max_new_tokens=MAX_NEW, prefill_chunk_size=chunk
    )
    assert got == ref


@pytest.mark.parametrize("name", PRESETS)
def test_eos_and_dead_rows_match_jax(name):
    """EOS freezes a row to pad after the EOS token; a dead filler row
    (``live_rows`` False, as ``run_batch`` pads a batch) emits pad from
    step 1. Raw [B, max_new] outputs equal the JAX package's."""
    _, jmodel, params, model, ref = _setup(name)
    eos = ref[0][2]
    prompts = PROMPTS + [[eos]]
    live = [True, True, True, False]
    tokens, pads = pad_prompts(prompts)
    want = j_generate.generate(
        jmodel, params, jnp.asarray(tokens), jnp.asarray(pads),
        jax.random.key(0), max_new_tokens=MAX_NEW, eos_id=eos,
        live_rows=jnp.asarray(live),
    )
    got = generate(
        model, tokens, pads, max_new_tokens=MAX_NEW, eos_id=eos,
        live_rows=live,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 2] == eos and (got[0, 3:] == 0).all()
    assert (got[3, 1:] == 0).all()


@pytest.mark.parametrize("name", PRESETS)
def test_prefill_and_step_logits_match_jax(name):
    """The cached forward itself: prefill logits of the left-padded batch
    at every position, then one decode step, against the JAX decode
    model's cache collection."""
    _, jmodel, params, model, _ = _setup(name)
    tokens, pads = pad_prompts(PROMPTS)
    b, p = tokens.shape
    col = np.arange(p)[None, :]
    seg = (col >= pads[:, None]).astype(np.int32)
    pos = np.maximum(col - pads[:, None], 0)
    apply = jax.jit(functools.partial(jmodel.apply, mutable=["cache"]))
    j_logits, j_vars = apply(
        {"params": params}, tokens, positions=pos, segment_ids=seg
    )
    nxt = np.asarray(j_logits[:, -1].argmax(-1))[:, None]
    step_pos = (p - pads)[:, None]
    ones = np.ones((b, 1), np.int32)
    j_step, _ = apply(
        {"params": params, **j_vars}, nxt, positions=step_pos,
        segment_ids=ones,
    )
    with torch.no_grad():
        logits, cache = prefill_cache(
            model, torch.tensor(tokens).long(), torch.tensor(pos),
            torch.tensor(seg), None,
        )
        step = model(torch.tensor(nxt), torch.tensor(step_pos),
                     torch.tensor(ones), cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(j_step), **TOL)
    assert all(c.index == p + 1 for c in cache)


def test_cached_decode_matches_full_forward():
    """Greedy decode through the cache equals re-running the uncached
    forward of the same model on the growing sequence."""
    *_, model, _ = _setup("llama3_tiny")
    prompt = PROMPTS[2]
    toks, want = list(prompt), []
    with torch.no_grad():
        for _ in range(6):
            nxt = int(model(torch.tensor([toks]))[0, -1].argmax())
            want.append(nxt)
            toks.append(nxt)
    assert generate_text(model, [prompt], max_new_tokens=6)[0] == want


def test_cache_budget_guard():
    """p + n − 1 == max_seq_len fits (the last token is never fed back);
    one more raises."""
    *_, model, _ = _setup("llama3_tiny")
    p = model.cfg.max_seq_len - 4
    prompt = list(range(1, p + 1))
    assert len(generate_text(model, [prompt], max_new_tokens=5)[0]) == 5
    with pytest.raises(ValueError, match="KV cache"):
        generate_text(model, [prompt], max_new_tokens=6)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate_text(model, [prompt], max_new_tokens=0)


def test_cache_length_is_output_invariant():
    """A shorter cache is numerically invisible: never-written slots are
    masked (the serving cache ladder relies on it)."""
    jcfg, tcfg = pair("llama3_tiny")
    *_, model, ref = _setup("llama3_tiny")
    small = Llama(
        dataclasses.replace(tcfg, max_seq_len=48).decode_config(), device="cpu"
    )
    small.load_state_dict(model.state_dict())
    assert generate_text(small, PROMPTS, max_new_tokens=MAX_NEW) == ref


def test_cache_needs_a_decode_model():
    _, tcfg = pair("llama3_tiny")
    model = Llama(tcfg, device="cpu")
    with pytest.raises(ValueError, match="decode_config"):
        model(torch.zeros(1, 2, dtype=torch.long),
              cache=model.init_cache(1))
    dcfg = tcfg.decode_config()
    assert dcfg.decode and not dcfg.remat and dcfg.attention_backend == "xla"


def test_pad_prompts_matches_jax():
    prompts = [[1, 2, 3], [7], []]
    for got, want in zip(pad_prompts(prompts, 9),
                         j_generate.pad_prompts(prompts, 9)):
        np.testing.assert_array_equal(got, want)


def test_cast_decode_params_rules():
    """fp32 weights -> bf16, one tensor at a time; int8 codes and their
    fp32 scales stay; RMSNorm weights cast too."""
    from tpufw_torch.workloads.serve import quantize_model

    _, tcfg = pair("qwen25_tiny")
    model = quantize_model(Llama(tcfg.decode_config(), device="cpu"))
    scale = model.layers[0].attn.q.scale.clone()
    cast_decode_params(model)
    q = model.layers[0].attn.q
    assert q.weight.dtype == torch.int8 and q.scale.dtype == torch.float32
    assert q.bias.dtype == torch.bfloat16
    assert model.layers[0].attn_norm.weight.dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    assert model.lm_head.scale.dtype == torch.float32
    assert torch.equal(q.scale, scale)
