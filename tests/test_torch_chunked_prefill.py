"""Chunked paged prefill of the port (``PagedSlotPool.start_chunked`` /
``chunk_step`` / ``finalize_chunked`` / ``abandon_chunked`` and the slot
scheduler's mixed prefill and decode passes) against tpufw's
(``tests/test_chunked_prefill.py``), on llama3_tiny in fp32 with the Flax
weights moved into the port:

- parity: a prompt prefilled one page-aligned chunk at a time (1 or 2
  pages a chunk, bf16 or int8 pool) samples the monolithic prefill's
  first token and decodes its greedy continuation, and its row cache
  matches ``prefill_row``'s over the prompt span;
- against ``tpufw``: the arena after a chunked prefill holds ``tpufw``'s
  chunked K/V in the same pages, int8 codes equal;
- resume: an abandoned chunked prefill leaves its full pages in the trie,
  and a re-admission resumes from them with the same tokens;
- the scheduler: chunked admission interleaved with decoding slots gives
  the monolithic scheduler's and ``tpufw``'s chunked scheduler's tokens,
  sequentially and concurrently; sampled tokens replay with and without
  chunking (the final chunk samples with the cold prefill's generator);
- no head-of-line blocking: a short prompt sent after a long one streams
  its first token first.

Left out: ``test_zero_retrace_across_chunk_count`` (eager PyTorch traces
nothing; ROADMAP.md Queue 3).
"""

import dataclasses
import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import pages as j_pages
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.infer import PagedSlotPool, SamplingConfig, prefill_row
from tpufw_torch.workloads import serve

GREEDY = SamplingConfig()
MAX_NEW = 6
PAGE = 16
N_SLOTS = 4
SEQ = 64
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4,
          6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 0, 2, 8, 8]  # 36 tokens


def _model(seq=SEQ):
    return decode_pair(max_seq_len=seq)[2]


def _pool(kv_quant=""):
    return PagedSlotPool.create_paged(
        _model(), N_SLOTS, cache_len=SEQ, page=PAGE, kv_quant=kv_quant,
        sampling=GREEDY,
    )


def _decode_all(pool, first, chunk=2):
    row = [first]
    while len(row) < MAX_NEW:
        out = pool.decode_steps(chunk).tolist()
        row.extend(out[0][: MAX_NEW - len(row)])
    return row


def _monolithic(pool, prompt=PROMPT):
    ids, shared = pool.acquire_pages(prompt, len(prompt) + MAX_NEW - 1)
    assert shared == 0
    cache, _f, first, _d, seen = prefill_row(
        pool.model, prompt, None, sampling=GREEDY, eos_id=None,
        pad_to=len(prompt), cache_len=pool.cache_len,
    )
    pool.insert_paged(0, cache, first, len(prompt), MAX_NEW - 1, ids, 0,
                      row_seen=seen)
    return cache, first


def _chunked(pool, chunk_pages, prompt=PROMPT):
    cp = pool.start_chunked(prompt, len(prompt) + MAX_NEW - 1, None,
                            chunk_pages)
    while True:
        status = pool.chunk_step(cp)
        assert status != "stalled"
        if status == "done":
            break
    pool.finalize_chunked(0, cp, MAX_NEW - 1)
    return cp


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_chunked_equal_monolithic(kv_quant, chunk_pages):
    pool_a = _pool(kv_quant)
    _cache, first_a = _monolithic(pool_a)
    ref = _decode_all(pool_a, first_a)
    pool_b = _pool(kv_quant)
    cp = _chunked(pool_b, chunk_pages)
    assert cp.first_int == first_a
    assert cp.n_chunks == -(-3 // chunk_pages)
    assert pool_b.cache[0].index[0] == len(PROMPT)
    assert _decode_all(pool_b, cp.first_int) == ref


def test_chunked_row_cache_matches_prefill_row():
    """The chunk-built row cache against ``prefill_row``'s over the
    prompt span: the same cursor and segment ids, K/V within fp32
    rounding (the chunks run their products at other shapes than the
    whole prompt)."""
    pool = _pool()
    cp = pool.start_chunked(PROMPT, len(PROMPT) + MAX_NEW - 1, None, 2)
    while pool.chunk_step(cp) != "done":
        pass
    ref, _f, first, _d, _s = prefill_row(
        pool.model, PROMPT, None, sampling=GREEDY, eos_id=None,
        pad_to=len(PROMPT), cache_len=pool.cache_len,
    )
    assert cp.first_int == first
    p = len(PROMPT)
    for got, want in zip(cp.row_cache, ref):
        assert got.index == want.index == p
        assert torch.equal(got.seg, want.seg)
        torch.testing.assert_close(got.key[:, :p], want.key[:, :p],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got.value[:, :p], want.value[:, :p],
                                   rtol=1e-5, atol=1e-5)


def _j_chunked(kv_quant, chunk_pages):
    jrow, params, _ = decode_pair(max_seq_len=SEQ)
    pcfg = dataclasses.replace(
        jrow.cfg, kv_page=PAGE, kv_pages=N_SLOTS * (SEQ // PAGE) + 1,
        kv_quant=kv_quant,
    )
    pool = j_pages.PagedSlotPool.create_paged(
        JLlama(pcfg), jrow, params, N_SLOTS,
        sampling=JSampling(temperature=0.0), eos_id=None,
    )
    rng = jax.random.fold_in(jax.random.key(0), 0)
    cp = pool.start_chunked(PROMPT, len(PROMPT) + MAX_NEW - 1, rng,
                            chunk_pages)
    while pool.chunk_step(cp) != "done":
        pass
    pool.finalize_chunked(0, cp, MAX_NEW - 1)
    return pool, cp


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_arena_after_chunked_prefill_equals_jax(kv_quant):
    jpool, jcp = _j_chunked(kv_quant, 1)
    pool = _pool(kv_quant)
    cp = _chunked(pool, 1)
    assert cp.first_int == jcp.first_int
    assert pool.slot_pages == jpool.slot_pages
    ids = pool.slot_pages[0]
    slots = np.arange(len(PROMPT))
    phys, off = np.asarray(ids)[slots // PAGE], slots % PAGE
    flat = jax.tree_util.tree_flatten_with_path(jpool.cache)[0]
    leaves = {str(p[-1].key): np.asarray(x) for p, x in flat}
    for name, attr in (("cached_key", "key"), ("cached_value", "value")):
        jx = leaves[name].reshape(-1, *leaves[name].shape[-4:])
        for layer, c in enumerate(pool.cache):
            got = getattr(c, attr).numpy()[phys, off]
            want = jx[layer][phys, off]
            if kv_quant:
                assert got.dtype == want.dtype == np.int8
                np.testing.assert_array_equal(got, want)
                js = leaves[name + "_scale"].reshape(
                    -1, *leaves[name].shape[-4:-2])
                np.testing.assert_allclose(
                    getattr(c, attr + "_scale").numpy()[phys, off],
                    js[layer][phys, off], rtol=1e-5)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_resume_from_trie_checkpoint():
    pool_a = _pool()
    _cache, first_a = _monolithic(pool_a)
    ref = _decode_all(pool_a, first_a)
    pool = _pool()
    cp = pool.start_chunked(PROMPT, len(PROMPT) + MAX_NEW - 1, None, 1)
    assert pool.chunk_step(cp) == "ran"
    assert pool.chunk_step(cp) == "ran"  # 2 full pages committed
    pool.abandon_chunked(cp)
    assert cp.page_ids == [] and pool.allocator.in_use == 2
    cp2 = pool.start_chunked(PROMPT, len(PROMPT) + MAX_NEW - 1, None, 1)
    assert cp2.resumed and cp2.shared_n == 2
    assert pool.chunk_step(cp2) == "done"  # one final chunk
    assert cp2.first_int == first_a
    pool.finalize_chunked(0, cp2, MAX_NEW - 1)
    assert _decode_all(pool, cp2.first_int) == ref


def test_chunk_stalls_when_the_arena_is_full():
    """A chunk whose pages the arena cannot supply reports "stalled" and
    consumes nothing; after a release it runs."""
    pool = PagedSlotPool.create_paged(
        _model(), N_SLOTS, cache_len=SEQ, page=PAGE, n_pages=4,
        sampling=GREEDY, prefix_cache=False,
    )
    held = pool.allocator.alloc(2)
    cp = pool.start_chunked(PROMPT, len(PROMPT) + MAX_NEW - 1, None, 1)
    assert pool.chunk_step(cp) == "ran"
    assert pool.chunk_step(cp) == "stalled"
    assert cp.cursor == PAGE and len(cp.page_ids) == 1
    pool.allocator.release(held)
    assert pool.chunk_step(cp) == "ran"


# ---------------------------------------------------------- the scheduler


def _scheduler(model, prefill_chunk_pages, sampling=GREEDY, **kw):
    return serve._SlotScheduler(
        model, eos_id=None, default_sampling=sampling, seed_base=0,
        page=PAGE, prefix_cache=True, metrics=serve._Metrics(),
        prefill_chunk_pages=prefill_chunk_pages, **kw,
    )


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_mixed_pool_pass_parity(kv_quant):
    """Chunked admissions interleave with decoding slots in the same
    passes; outputs equal the monolithic scheduler's and tpufw's chunked
    scheduler's, sequential and concurrent, with fp and int8 KV."""
    from tpufw.workloads import serve as j_serve

    jmodel, params, model = decode_pair(max_seq_len=256)
    prompts = [[i + 1, 5, 9, 2, 6] * 8 for i in range(3)]  # 40 tokens
    j_sched = j_serve._SlotScheduler(
        jmodel, params, eos_id=None,
        default_sampling=JSampling(temperature=0.0), seed_base=0,
        page=PAGE, arena_pages=None, prefix_cache=True,
        prefill_chunk_pages=1, kv_quant=kv_quant,
    )
    want = [j_sched.submit([p], 8)[0][0] for p in prompts]
    scheds = [_scheduler(model, n, kv_quant=kv_quant) for n in (0, 1, 1)]
    try:
        mono, seq, conc = scheds
        assert [mono.submit([p], 8)[0][0] for p in prompts] == want
        assert [seq.submit([p], 8)[0][0] for p in prompts] == want
        results = {}

        def run(i, p):
            results[i] = conc.submit([p], 8)[0][0]

        threads = [threading.Thread(target=run, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [results[i] for i in range(3)] == want
        reg = seq._metrics.registry
        assert reg.counter("tpufw_prefill_chunks_total").value() > 0
        assert reg.counter("tpufw_prefill_resumes_total").value() == 0
        assert seq.pages_in_use == len(seq.pool.prefix)
    finally:
        for s in scheds:
            s.close()


def test_sampled_tokens_replay_with_and_without_chunking():
    model = _model(256)
    sampling = SamplingConfig(temperature=0.8, top_k=20)
    prompts = [list(range(1, 41)), [7, 3] * 20]
    outs = []
    for chunk_pages in (0, 1, 2):
        sched = _scheduler(model, chunk_pages, sampling=sampling)
        try:
            outs.append([sched.submit([p], 8)[0][0] for p in prompts])
        finally:
            sched.close()
    assert outs[0] == outs[1] == outs[2]


def test_long_prompt_no_hol():
    sched = _scheduler(_model(256), 1)
    long_p = [7, 3] * 80  # 160 tokens = 10 chunk passes
    short_p = [1, 2, 3, 4, 5, 6, 7, 8]
    ql: "queue.Queue" = queue.Queue()
    qs: "queue.Queue" = queue.Queue()
    try:
        sched.submit_stream([long_p], 8, GREEDY, ql)
        time.sleep(0.01)
        sched.submit_stream([short_p], 8, GREEDY, qs)

        def drain(q):
            first = None
            while True:
                kind, payload = q.get(timeout=120)
                if kind == "chunk" and first is None and any(payload):
                    first = time.perf_counter()
                if kind in ("done", "error"):
                    return first, kind

        out = {}
        tl = threading.Thread(target=lambda: out.setdefault("l", drain(ql)))
        ts = threading.Thread(target=lambda: out.setdefault("s", drain(qs)))
        tl.start()
        ts.start()
        tl.join()
        ts.join()
    finally:
        sched.close()
    (long_first, long_kind), (short_first, short_kind) = out["l"], out["s"]
    assert long_kind == "done" and short_kind == "done"
    assert short_first < long_first


def test_chunked_prefill_needs_pages():
    with pytest.raises(ValueError, match="TPUFW_SERVE_PAGE"):
        serve._SlotScheduler(_model(), page=0, prefill_chunk_pages=2)
