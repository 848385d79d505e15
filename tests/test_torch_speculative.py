"""tpufw_torch.infer.speculative's batch path against tpufw's
(``tests/test_speculative.py``), on llama3_tiny in fp32 with the Flax
weights moved into the port; the draft is a different tiny model (one
layer, its own weights), which gives partial acceptance.

- greedy: the output is the target's greedy continuation whatever the
  draft, for k = 1, 3, 4, ragged prompts, EOS, one token, filler rows,
  chunked prefill and a repetition penalty, and it equals ``tpufw``'s
  ``speculative_generate_text`` on the same weights;
- stochastic: a draft equal to the target reproduces the port's
  ``generate`` bit for bit under one generator seed (with and without a
  repetition penalty, with EOS), and an unrelated draft leaves the first
  speculated token distributed as plain sampling's (total variation
  under 0.25 over 256 rows, the reference's bound);
- a rolled-back verify block leaves the cache as plain decode needs it.

Every reference test has its counterpart here; the random streams differ
(``torch.Generator`` here, threefry keys there), so sampled tokens are
compared with the port's own ``generate``, not with JAX's.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair, flax_params, pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import generate_text as j_generate_text
from tpufw.infer import speculative_generate_text as j_spec_text
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.infer import (
    SamplingConfig,
    generate,
    generate_text,
    pad_prompts,
    prefill_cache,
    speculative_generate,
    speculative_generate_text,
)
from tpufw_torch.infer.speculative import _rollback
from tpufw_torch.workloads import serve

SEQ = 128
PROMPTS = [[5, 6, 7], [9], [1, 2, 3, 4, 5, 6]]


def _target():
    return decode_pair(max_seq_len=SEQ)


@functools.lru_cache(maxsize=None)
def _draft():
    """(JAX draft, its params, port draft): one layer, seed 99."""
    jcfg, tcfg = pair("llama3_tiny", n_layers=1, max_seq_len=SEQ)
    params = flax_params(jcfg, seed=99)
    return (JLlama(jcfg.decode_config()), params,
            torch_model(tcfg.decode_config(), params))


def _greedy(max_new, eos_id=None, sampling=SamplingConfig()):
    return generate_text(_target()[2], PROMPTS, max_new_tokens=max_new,
                         eos_id=eos_id, sampling=sampling)


def _tokens(prompts):
    toks, pads = pad_prompts(prompts)
    return torch.as_tensor(toks), torch.as_tensor(pads)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_matches_plain_greedy_with_unrelated_draft(k):
    want = _greedy(12)
    got, stats = speculative_generate_text(
        _draft()[2], _target()[2], PROMPTS, max_new_tokens=12, k=k
    )
    assert got == want, f"k={k}: {got} != {want}"
    assert stats["emitted"] == 12 and stats["iterations"] <= 12
    if k == 3:
        jmodel, params, _ = _target()
        jdraft, dparams, _ = _draft()
        jgot, _ = j_spec_text(jdraft, dparams, jmodel, params, PROMPTS,
                              max_new_tokens=12, k=k)
        assert got == jgot


def test_self_draft_accepts_everything():
    k = 4
    model = _target()[2]
    got, stats = speculative_generate_text(model, model, PROMPTS,
                                           max_new_tokens=15, k=k)
    assert got == _greedy(15)
    assert stats["iterations"] == -(-15 // (k + 1))


def test_eos_rows_freeze():
    eos = _greedy(10)[0][2]
    got, _ = speculative_generate_text(
        _draft()[2], _target()[2], PROMPTS, max_new_tokens=10, k=3,
        eos_id=eos,
    )
    assert got == _greedy(10, eos_id=eos)


def test_single_token():
    got, stats = speculative_generate_text(
        _draft()[2], _target()[2], PROMPTS, max_new_tokens=1, k=4
    )
    assert got == _greedy(1) and stats == {"iterations": 0, "emitted": 1}


def test_cache_budget_is_loud():
    with pytest.raises(ValueError, match="KV cache"):
        speculative_generate_text(
            _draft()[2], _target()[2], [list(range(1, 100))],
            max_new_tokens=30, k=4,
        )


def test_live_rows_mask_preserves_real_rows():
    got, _ = speculative_generate_text(
        _draft()[2], _target()[2], PROMPTS + [[0] * 32], max_new_tokens=10,
        k=3, live_rows=[True, True, True, False],
    )
    assert got[: len(PROMPTS)] == _greedy(10)


def test_serve_draft_composes_repetition_penalty(clear_tpufw_env):
    """The batch path threads the penalty's seen mask through proposals
    and verification, so the workload builds the draft with a penalty
    set; the draft is the preset with its own seed."""
    for k, v in {"DRAFT_MODEL": "llama3_tiny", "TEMPERATURE": "0",
                 "REPETITION_PENALTY": "1.3", "DEVICE": "cpu",
                 "SEED": "4", "DRAFT_K": "3"}.items():
        clear_tpufw_env.setenv(f"TPUFW_{k}", v)
    draft, k = serve.build_draft_generator()
    assert k == 3 and draft.cfg.n_layers == 2 and draft.cfg.decode
    from tpufw_torch.models import Llama

    same = Llama(draft.cfg, device="cpu", seed=5)
    assert torch.equal(draft.embed, same.embed)


def test_stochastic_self_draft_bit_matches_generate():
    model = _target()[2]
    cfg = SamplingConfig(temperature=0.7, top_p=0.9)
    toks, pads = _tokens(PROMPTS)
    want = generate(model, toks, pads, torch.Generator().manual_seed(42),
                    max_new_tokens=15, sampling=cfg)
    got, stats = speculative_generate(
        model, model, toks, pads, torch.Generator().manual_seed(42),
        max_new_tokens=15, k=4, sampling=cfg,
    )
    assert torch.equal(got, want)
    assert stats["iterations"] == -(-15 // 5)


def test_stochastic_unrelated_draft_matches_target_distribution():
    model, draft = _target()[2], _draft()[2]
    b = 256
    cfg = SamplingConfig(temperature=1.0, top_k=8)
    toks = torch.tensor([[5, 6, 7]]).repeat(b, 1)
    pads = torch.zeros(b, dtype=torch.long)
    plain = generate(model, toks, pads, torch.Generator().manual_seed(7),
                     max_new_tokens=4, sampling=cfg).numpy()
    spec = speculative_generate(
        draft, model, toks, pads, torch.Generator().manual_seed(7),
        max_new_tokens=4, k=3, sampling=cfg,
    )[0].numpy()
    # Token 0 is sampled before any speculation, from the same draw.
    assert (spec[:, 0] == plain[:, 0]).all()

    def dist(col):
        v = np.bincount(col, minlength=model.cfg.vocab_size)
        return v / v.sum()

    tvd = 0.5 * np.abs(dist(spec[:, 1]) - dist(plain[:, 1])).sum()
    assert tvd < 0.25, f"TVD {tvd}"


def test_chunked_prefill_matches_oneshot():
    model, draft = _target()[2], _draft()[2]
    long_prompts = [list(range(1, 30)), [7] * 11]
    cfg = SamplingConfig(temperature=0.8, top_k=12)
    for sampling in (SamplingConfig(), cfg):
        base, _ = speculative_generate_text(
            draft, model, long_prompts, max_new_tokens=8, k=3,
            sampling=sampling, seed=5,
        )
        chunked, _ = speculative_generate_text(
            draft, model, long_prompts, max_new_tokens=8, k=3,
            sampling=sampling, seed=5, prefill_chunk_size=8,
        )
        assert chunked == base


def test_stochastic_requires_rng():
    model = _target()[2]
    with pytest.raises(ValueError, match="generator"):
        speculative_generate(
            model, model, torch.tensor([[1, 2]]), torch.zeros(1),
            max_new_tokens=4, sampling=SamplingConfig(temperature=0.5),
        )


def test_penalty_greedy_matches_generate():
    cfg = SamplingConfig(repetition_penalty=1.5)
    want = _greedy(12, sampling=cfg)
    got, stats = speculative_generate_text(
        _draft()[2], _target()[2], PROMPTS, max_new_tokens=12, k=3,
        sampling=cfg,
    )
    assert got == want and stats["emitted"] == 12
    # The penalty does real work here.
    assert want != _greedy(12)
    jmodel, params, _ = _target()
    from tpufw.infer import SamplingConfig as JSampling

    assert want == j_generate_text(
        jmodel, params, PROMPTS, max_new_tokens=12,
        sampling=JSampling(repetition_penalty=1.5),
    )


def test_penalty_stochastic_self_draft_bit_matches_generate():
    model = _target()[2]
    cfg = SamplingConfig(temperature=0.7, top_k=12, repetition_penalty=1.4)
    toks, pads = _tokens(PROMPTS)
    want = generate(model, toks, pads, torch.Generator().manual_seed(21),
                    max_new_tokens=15, sampling=cfg)
    got, stats = speculative_generate(
        model, model, toks, pads, torch.Generator().manual_seed(21),
        max_new_tokens=15, k=4, sampling=cfg,
    )
    assert torch.equal(got, want)
    assert stats["iterations"] == -(-15 // 5)


def test_stochastic_eos_rows_freeze():
    model = _target()[2]
    cfg = SamplingConfig(temperature=0.7)
    toks = torch.tensor([[5, 6, 7], [9, 9, 9]])
    pads = torch.zeros(2, dtype=torch.long)

    def plain(eos):
        return generate(model, toks, pads, torch.Generator().manual_seed(3),
                        max_new_tokens=8, sampling=cfg, eos_id=eos)

    eos = int(plain(None)[0, 2])
    got, _ = speculative_generate(
        model, model, toks, pads, torch.Generator().manual_seed(3),
        max_new_tokens=8, k=3, sampling=cfg, eos_id=eos,
    )
    assert torch.equal(got, plain(eos))


def test_rollback_then_plain_decode_equals_plain():
    """A verify block [tok, junk x 3] that accepts no draft rolls back to
    one new entry (tok) with segment 0 past the cursor; the block's first
    logits and plain decode steps from there give generate's tokens."""
    model = _target()[2]
    prompt = PROMPTS[2]
    want = _greedy(6)[2]
    p = len(prompt)
    ones = torch.ones(1, 1, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = prefill_cache(
            model, torch.tensor([prompt]), torch.arange(p)[None],
            torch.ones(1, p, dtype=torch.int32), None,
        )
        got = [int(logits[0, -1].argmax())]
        block = torch.tensor([[got[0], 3, 1, 4]])
        out = model(block, p + torch.arange(4)[None],
                    torch.ones(1, 4, dtype=torch.int32), cache=cache)
        _rollback(cache, p + 1)
        assert all(c.index == p + 1 and not c.seg[:, p + 1:].any()
                   for c in cache)
        got.append(int(out[0, 0].argmax()))
        for i in range(1, 5):
            nxt = model(torch.tensor([[got[-1]]]), torch.tensor([[p + i]]),
                        ones, cache=cache)
            got.append(int(nxt[0, -1].argmax()))
    assert got == want
