"""Speculative decoding on the port's slot pool against tpufw's
(``tests/test_spec_slots.py``), on llama3_tiny at a 64-slot cache in fp32
with the Flax weights moved into the port:

- parity: whatever the proposer (oracle, reject-all, n-gram self-draft,
  the target itself as a draft pool), greedy ``spec_steps`` and
  ``spec_draft_steps`` emit ``tpufw``'s greedy tokens, contiguous and
  paged; an int8 pool's speculation emits its own plain decode's tokens;
- the rewind: plain decode after a partial accept, and a row driven to
  its last KV slot (the speculative slack exactly reserved), give plain
  decode's tokens;
- draft pages: a draft pool draws its page ids from the target's
  allocator into its own arena, a self-draft accepts everything (the
  fewest passes possible), and releasing both rows returns every page;
- stochastic: the first token of a speculative pass is distributed as a
  plain step's, with one-hot and draft-model proposals;
- scheduling: ``AcceptEMA`` and ``ngram_propose`` give ``tpufw``'s values,
  and the scheduler's speculative outputs equal ``tpufw``'s scheduler's.

Left out: ``test_spec_zero_retrace_across_accept_and_churn`` (eager
PyTorch traces nothing; ROADMAP.md Queue 3) and
``test_disagg_spec_decode_parity_cold_bundle`` (page bundles wait for the
disaggregated roles, ROADMAP.md Queue 1 item 9). The reference's
``test_draft_pool_pages_shared_allocator_no_leak`` fails in ``tpufw``
(its draft cache lacks the k-th proposal after a full accept, so it needs
5 passes where 3 do); its counterpart here holds the contract it states.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair, flax_params, pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import generate_text as j_generate_text
from tpufw.infer import pages as j_pages
from tpufw.infer import slots as j_slots
from tpufw.infer import speculative as j_spec
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.infer import (
    AcceptEMA,
    PagedSlotPool,
    SamplingConfig,
    SlotPool,
    ngram_propose,
    prefill_row,
)
from tpufw_torch.workloads import serve

GREEDY = SamplingConfig()
MAX_NEW = 9
PAGE = 16
N_SLOTS = 4
K = 3
SEQ = 64
PROMPTS = [[1, 5, 9], [2, 7], [3]]


def _model():
    return decode_pair(max_seq_len=SEQ)[2]


def _want(prompts=PROMPTS, max_new=MAX_NEW):
    jmodel, params, _ = decode_pair(max_seq_len=SEQ)
    return j_generate_text(jmodel, params, prompts, max_new_tokens=max_new,
                           sampling=JSampling(temperature=0.0))


def _contiguous_pool(prompts=PROMPTS, max_new=MAX_NEW, cache_len=None,
                     model=None, sampling=GREEDY, n_slots=N_SLOTS):
    model = model or _model()
    pool = SlotPool.create(model, n_slots, sampling=sampling,
                           cache_len=cache_len)
    firsts = []
    for i, p in enumerate(prompts):
        cache, _f, first, _d, seen = prefill_row(
            model, p, None, sampling=GREEDY, eos_id=None,
            pad_to=32,
            cache_len=pool.cache_len,
        )
        pool.insert(i, cache, first, len(p), max_new - 1, row_seen=seen)
        firsts.append(first)
    return pool, firsts


def _paged_pool(kv_quant="", allocator=None, prefix_cache=True, model=None,
                cache_len=SEQ, sampling=GREEDY, n_slots=N_SLOTS):
    return PagedSlotPool.create_paged(
        model or _model(), n_slots, cache_len=cache_len, page=PAGE,
        n_pages=2 * n_slots * (cache_len // PAGE) + 1, kv_quant=kv_quant,
        sampling=sampling, allocator=allocator, prefix_cache=prefix_cache,
    )


def _admit_paged(pool, slot, prompt, budget=MAX_NEW - 1, extra=K):
    ids, _shared = pool.acquire_pages(prompt, len(prompt) + budget + extra)
    cache, _f, first, _d, seen = prefill_row(
        pool.model, prompt, None, sampling=GREEDY, eos_id=None,
        pad_to=len(prompt), cache_len=pool.cache_len,
    )
    pool.insert_paged(slot, cache, first, len(prompt), budget, ids, 0,
                      row_seen=seen)
    return first


def _drive_spec(pool, proposer, firsts, prompts=PROMPTS, max_new=MAX_NEW,
                passes_max=40):
    """The scheduler's speculative loop without the scheduler: propose,
    one verify pass, extend each row by its emitted run."""
    rows = {i: [t] for i, t in enumerate(firsts)}
    passes = 0
    while any(len(t) < max_new for t in rows.values()) and passes < passes_max:
        props = np.zeros((pool.n_slots, K), np.int64)
        for i in rows:
            props[i] = proposer(prompts[i] + rows[i], K, i)
        out, n_emit, _accept = pool.spec_steps(props)
        for i in rows:
            take = min(int(n_emit[i]), max_new - len(rows[i]))
            rows[i].extend(out[i, :take].tolist())
        passes += 1
    return [rows[i] for i in range(len(prompts))], passes


def _decode_rest(pool, rows, max_new=MAX_NEW, chunk=2):
    while any(len(t) < max_new for t in rows):
        out = pool.decode_steps(chunk).tolist()
        for i, r in enumerate(rows):
            r.extend(out[i][: max_new - len(r)])
    return rows


def _oracle(want, prompts=PROMPTS):
    def prop(hist, k, i):
        n = len(hist) - len(prompts[i])
        return (list(want[i][n:n + k]) + [0] * k)[:k]
    return prop


def _reject_all(want, vocab):
    oracle = _oracle(want)

    def prop(hist, k, i):
        return [(t + 1) % vocab for t in oracle(hist, k, i)]
    return prop


def _ngram(hist, k, i):
    return ngram_propose(hist, k)


PROPOSERS = {
    "oracle": lambda want, v: _oracle(want),
    "reject_all": lambda want, v: _reject_all(want, v),
    "ngram": lambda want, v: _ngram,
}


@pytest.mark.parametrize("proposer", sorted(PROPOSERS))
@pytest.mark.parametrize("paged", [False, True])
def test_spec_steps_equal_jax_greedy(paged, proposer):
    want = _want()
    if paged:
        pool = _paged_pool()
        firsts = [_admit_paged(pool, i, p) for i, p in enumerate(PROMPTS)]
    else:
        pool, firsts = _contiguous_pool()
    got, passes = _drive_spec(
        pool, PROPOSERS[proposer](want, _model().cfg.vocab_size), firsts
    )
    assert got == want
    if proposer == "oracle":
        assert passes == -(-(MAX_NEW - 1) // (K + 1))
    if proposer == "reject_all":
        assert passes == MAX_NEW - 1


def _j_int8_plain():
    """tpufw's int8-KV paged pool decoding PROMPTS plainly (greedy)."""
    jrow, params, _ = decode_pair(max_seq_len=SEQ)
    pcfg = dataclasses.replace(
        jrow.cfg, kv_page=PAGE, kv_pages=2 * N_SLOTS * (SEQ // PAGE) + 1,
        kv_quant="int8",
    )
    pool = j_pages.PagedSlotPool.create_paged(
        JLlama(pcfg), jrow, params, N_SLOTS,
        sampling=JSampling(temperature=0.0), eos_id=None,
    )
    rows = []
    for i, p in enumerate(PROMPTS):
        ids, _ = pool.acquire_pages(p, len(p) + MAX_NEW - 1 + K)
        cache, _f, first, _d, seen = j_slots.prefill_row(
            pool.row_model, params, p, jax.random.key(i),
            sampling=pool.sampling, eos_id=None, pad_to=len(p),
        )
        pool.insert_paged(i, cache, first, len(p), MAX_NEW - 1, ids, 0,
                          row_seen=seen)
        rows.append([first])
    step = 0
    while any(len(r) < MAX_NEW for r in rows):
        key = jax.random.fold_in(jax.random.key(1), step)
        out = np.asarray(pool.decode_steps(jax.random.split(key, 2)))
        for i, r in enumerate(rows):
            r.extend(out[i, : MAX_NEW - len(r)].tolist())
        step += 1
    return rows


def test_spec_int8_equal_to_int8_plain():
    """An int8-KV pool speculates to its own plain decode's tokens, which
    are tpufw's int8 pool's (oracle, n-gram and a self-draft pool)."""
    ref_pool = _paged_pool(kv_quant="int8")
    rows = [[_admit_paged(ref_pool, i, p)] for i, p in enumerate(PROMPTS)]
    want8 = _decode_rest(ref_pool, rows)
    assert want8 == _j_int8_plain()
    pool = _paged_pool(kv_quant="int8")
    firsts = [_admit_paged(pool, i, p) for i, p in enumerate(PROMPTS)]
    assert _drive_spec(pool, _oracle(want8), firsts)[0] == want8
    pool = _paged_pool(kv_quant="int8")
    firsts = [_admit_paged(pool, i, p) for i, p in enumerate(PROMPTS)]
    assert _drive_spec(pool, _ngram, firsts)[0] == want8
    tgt = _paged_pool(kv_quant="int8")
    draft = _paged_pool(kv_quant="int8", allocator=tgt.allocator,
                        prefix_cache=False)
    rows = []
    for i, p in enumerate(PROMPTS):
        rows.append([_admit_paged(tgt, i, p)])
        _admit_paged(draft, i, p)
    while any(len(r) < MAX_NEW for r in rows):
        out, n_emit, _ = tgt.spec_draft_steps(draft, None, K)
        for i, r in enumerate(rows):
            r.extend(out[i, : min(int(n_emit[i]), MAX_NEW - len(r))].tolist())
    assert rows == want8


@pytest.mark.parametrize("paged", [False, True])
def test_spec_then_plain_fallback_equals_plain(paged):
    """A partial accept leaves the rejected drafts' K/V past the rewound
    cursor with segment 1; plain decode steps after it must not see
    them."""
    want = _want()
    if paged:
        pool = _paged_pool()
        firsts = [_admit_paged(pool, i, p) for i, p in enumerate(PROMPTS)]
    else:
        pool, firsts = _contiguous_pool()
    oracle = _oracle(want)

    def one_right(hist, k, i):
        props = oracle(hist, k, i)
        return props[:1] + [(t + 7) % 256 for t in props[1:]]

    rows, passes = _drive_spec(pool, one_right, firsts, passes_max=2)
    assert passes == 2 and all(len(r) == 5 for r in rows)
    assert _decode_rest(pool, rows) == want


def _row_keys(pool, slot, end):
    """Every layer's keys of ``slot``'s logical slots [0, end)."""
    keys = []
    for c in pool.cache:
        if hasattr(c, "table"):
            k = c.key[c.table[slot]].reshape(-1, *c.key.shape[2:])
        else:
            k = c.key[slot]
        keys.append(k[:end])
    return torch.stack(keys)


@pytest.mark.parametrize("paged", [False, True])
def test_row_reaches_its_last_kv_slot(paged):
    """The slack reservation, 9 tokens at k = 3. Contiguous: a 20-token
    prompt needs 31 KV slots and gets a cache of exactly 31. Paged: a
    24-token prompt needs 35, so it owns 3 pages of 16 where prompt and
    budget alone need 2, and its last blocks cross into the third page.
    Reject-all advances one token per pass, so the last block starts at
    the row's last cursor and writes its last slack slot. Spec gives
    plain decode's tokens, and the row's K over the slots it wrote equals
    plain decode's. (A contiguous cache 3 slots short clamps those
    blocks back over valid entries; the tiny model's greedy tokens hide
    that, its K does not.)"""
    prompt = list(range(10, 34 if paged else 30))
    want = _want([prompt])
    need = len(prompt) + MAX_NEW - 1 + K

    def admitted():
        if paged:
            pool = _paged_pool(cache_len=3 * PAGE, n_slots=1)
            first = _admit_paged(pool, 0, prompt)
            assert len(pool.slot_pages[0]) == 3 == -(-need // PAGE)
            return pool, first
        pool = SlotPool.create(_model(), 1, cache_len=need)
        cache, _f, first, _d, _s = prefill_row(
            _model(), prompt, None, sampling=GREEDY, eos_id=None,
            cache_len=need,
        )
        pool.insert(0, cache, first, len(prompt), MAX_NEW - 1)
        return pool, first

    pool, first = admitted()
    got, _ = _drive_spec(pool, _reject_all(want, 256), [first], [prompt])
    assert got == want
    plain, first = admitted()
    assert _decode_rest(plain, [[first]]) == want
    written = len(prompt) + MAX_NEW - 1
    torch.testing.assert_close(_row_keys(pool, 0, written),
                               _row_keys(plain, 0, written),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_pool_accepts_everything_and_returns_pages(paged):
    """The target itself as the draft pool (a second cache over the same
    weights): every proposal is accepted, so the pool takes the fewest
    passes, ceil((max_new - 1) / (k + 1)); in paged mode the draft pool
    charges the target's allocator and releasing both rows returns every
    page (tpufw's test_draft_pool_pages_shared_allocator_no_leak)."""
    want = _want()
    model = _model()
    if paged:
        tgt = _paged_pool()
        draft = _paged_pool(allocator=tgt.allocator, prefix_cache=False)
        assert draft.allocator is tgt.allocator
        firsts = []
        for i, p in enumerate(PROMPTS):
            firsts.append(_admit_paged(tgt, i, p, extra=0))
            _admit_paged(draft, i, p, budget=MAX_NEW - 1 + K, extra=0)
    else:
        tgt, firsts = _contiguous_pool(model=model)
        draft, _ = _contiguous_pool(model=model)
    rows = {i: [f] for i, f in enumerate(firsts)}
    passes = 0
    while any(len(t) < MAX_NEW for t in rows.values()):
        out, n_emit, accept = tgt.spec_draft_steps(draft, None, K)
        for i in rows:
            take = min(int(n_emit[i]), MAX_NEW - len(rows[i]))
            rows[i].extend(out[i, :take].tolist())
        passes += 1
        assert passes < 40
    assert [rows[i] for i in range(len(PROMPTS))] == want
    assert passes <= -(-MAX_NEW // (K + 1))
    if paged:
        assert tgt.allocator.in_use > 0
        for i in range(len(PROMPTS)):
            tgt.release_slot(i)
            draft.release_slot(i)
        assert tgt.allocator.in_use == 0


def test_shared_allocator_size_must_match():
    tgt = _paged_pool()
    with pytest.raises(ValueError, match="shared allocator"):
        PagedSlotPool.create_paged(
            _model(), N_SLOTS, cache_len=SEQ, page=PAGE, n_pages=9,
            sampling=GREEDY, allocator=tgt.allocator,
        )


def test_penalty_pool_refuses_speculation():
    pool = SlotPool.create(_model(), N_SLOTS,
                           sampling=SamplingConfig(repetition_penalty=1.3))
    with pytest.raises(ValueError, match="repetition penalty"):
        pool.spec_steps(np.zeros((N_SLOTS, K), np.int64))


@pytest.mark.parametrize("draft", [False, True])
def test_stochastic_first_spec_token_matches_plain_distribution(draft):
    """Rejection-resampling per slot: over 128 slots holding one prompt,
    the first token a speculative pass emits (an accepted proposal or a
    residual draw) is distributed as a plain sampled step's."""
    n = 128
    sampling = SamplingConfig(temperature=1.0, top_k=8)
    prompt = [5, 6, 7]
    model = _model()

    def pool_of():
        pool, _ = _contiguous_pool([prompt] * n, model=model,
                                   sampling=sampling, n_slots=n)
        return pool

    plain = pool_of().decode_steps(
        1, torch.Generator().manual_seed(1))[:, 0].numpy()
    pool = pool_of()
    gen = torch.Generator().manual_seed(2)
    if draft:
        dpool, _ = _contiguous_pool([prompt] * n, model=_one_layer(),
                                    n_slots=n)
        out, n_emit, _ = pool.spec_draft_steps(dpool, gen, K)
    else:
        props = torch.randint(0, 256, (n, K), generator=gen)
        out, n_emit, _ = pool.spec_steps(props, gen)
    assert (n_emit >= 1).all()
    spec = out[:, 0].numpy()

    def dist(col):
        v = np.bincount(col, minlength=256)
        return v / v.sum()

    tvd = 0.5 * np.abs(dist(spec) - dist(plain)).sum()
    assert tvd < 0.25, f"TVD {tvd}"


def _one_layer():
    jcfg, tcfg = pair("llama3_tiny", n_layers=1, max_seq_len=SEQ)
    return torch_model(tcfg.decode_config(), flax_params(jcfg, seed=99))


# ------------------------------------------------------------ scheduling


def test_accept_ema_trace_equals_jax():
    rng = np.random.default_rng(0)
    pe = AcceptEMA(4, alpha=0.25, min_accept=0.25, probe_every=3)
    je = j_spec.AcceptEMA(4, alpha=0.25, min_accept=0.25, probe_every=3)
    trace_p, trace_j = [], []
    for _ in range(200):
        op = rng.integers(0, 4)
        slot = int(rng.integers(0, 4))
        frac = float(rng.integers(0, 4)) / 3
        slots = sorted({int(s) for s in rng.integers(0, 4, 3)})
        for ema, trace in ((pe, trace_p), (je, trace_j)):
            if op == 0:
                ema.occupy(slot)
            elif op == 1:
                ema.vacate(slot)
            elif op == 2:
                ema.update(slot, frac)
            trace.append((ema.use_spec(slots), ema.fallback_slots(slots),
                          list(ema.ema)))
    assert trace_p == trace_j


def test_accept_ema_units():
    """tpufw's test_accept_ema_units on the port's copy."""
    ema = AcceptEMA(4, alpha=0.25, min_accept=0.25, probe_every=3)
    ema.occupy(0)
    assert ema.ema[0] == 1.0 and ema.use_spec([0])
    for n in range(5):
        assert ema.use_spec([0]), f"benched too early (update {n})"
        ema.update(0, 0.0)
    assert ema.ema[0] < 0.25 and ema.fallback_slots([0]) == 1
    assert not ema.use_spec([0])
    assert not ema.use_spec([0])
    assert ema.use_spec([0])
    assert not ema.use_spec([0])
    ema.update(0, 1.0)
    ema.update(0, 1.0)
    assert ema.use_spec([0])
    ema.occupy(1)
    ema.update(1, 0.0)
    ema.update(1, 0.0)
    assert ema.use_spec([0, 1])
    ema.vacate(0)
    ema.vacate(1)
    assert not ema.use_spec([0, 1])
    sticky = AcceptEMA(1, alpha=0.25, min_accept=0.25, probe_every=0)
    sticky.occupy(0)
    for _ in range(6):
        sticky.update(0, 0.0)
    assert all(not sticky.use_spec([0]) for _ in range(20))


def test_ngram_propose_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        hist = rng.integers(0, 5, int(rng.integers(0, 40))).tolist()
        k = int(rng.integers(1, 6))
        max_n = int(rng.integers(1, 5))
        assert ngram_propose(hist, k, max_n=max_n, pad_id=0) == \
            j_spec.ngram_propose(hist, k, max_n=max_n, pad_id=0)


@pytest.mark.parametrize("page", [0, PAGE])
def test_scheduler_spec_parity_vs_jax(page):
    """tpufw's test_scheduler_spec_parity_vs_plain across the packages:
    the port's scheduler with n-gram speculation gives tpufw's
    scheduler's tokens, speculating or not (at a 128-slot cache: the
    contiguous rows' 64-token prompt bucket needs it)."""
    from tpufw.workloads import serve as j_serve

    jmodel, params, model = decode_pair(max_seq_len=128)
    prompt = [5, 9, 5, 9, 5, 9, 5, 9, 5, 9]
    j_sched = j_serve._SlotScheduler(
        jmodel, params, eos_id=None,
        default_sampling=JSampling(temperature=0.0),
        metrics=j_serve._Metrics(), seed_base=0, page=PAGE, spec_k=4,
        spec_draft="", spec_min_accept=0.25,
    )
    want = j_sched.submit([prompt], 12, None)[0][0]
    for spec_k in (4, 0):
        sched = serve._SlotScheduler(
            model, eos_id=None, default_sampling=GREEDY,
            metrics=serve._Metrics(), seed_base=0, page=page,
            spec_k=spec_k, spec_draft="", spec_min_accept=0.25,
        )
        try:
            assert sched.submit([prompt], 12, None)[0][0] == want
            assert (sched.spec_passes > 0) is bool(spec_k)
        finally:
            sched.close()
