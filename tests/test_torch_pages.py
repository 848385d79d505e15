"""tpufw_torch.infer.pages and .prefix against tpufw.infer.pages and
.prefix (``tests/test_pages.py``), on llama3_tiny at a 64-slot cache in
fp32 with the Flax weights moved into the port:

- greedy tokens of the paged pool equal the contiguous path's and those
  of ``tpufw``'s ``PagedSlotPool`` fed the same admissions; the int8 pool's tokens equal JAX's int8 pool's and its arena holds
  JAX's int8 codes;
- a prefix share attaches the same physical pages by reference and gives
  the cold prefill's tokens, with private pages past the shared point;
- the allocator and the trie, driven through the same operations, end in
  ``tpufw``'s states;
- the scheduler's page-budget admission defers what does not fit;
- a released slot's stale writes land in page 0 only.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import generate_text as j_generate_text
from tpufw.infer import pages as j_pages
from tpufw.infer import slots as j_slots
from tpufw.infer.prefix import PrefixCache as JPrefixCache
from tpufw.models.llama import Llama as JLlama
from tpufw_torch.infer import (
    PageAllocator,
    PagedSlotPool,
    PrefixCache,
    SamplingConfig,
    generate_text,
    prefill_row,
)
from tpufw_torch.workloads import serve

GREEDY = SamplingConfig()
MAX_NEW = 6
PAGE = 16
N_SLOTS = 4
SEQ = 64
PROMPTS = [[1, 5, 9], [2, 7], list(range(3, 37))]


def _setup():
    jrow, params, model = decode_pair(max_seq_len=SEQ)
    return jrow.cfg, jrow, params, model


def _j_pool(kv_quant=""):
    jcfg, jrow, params, _ = _setup()
    pcfg = dataclasses.replace(
        jcfg, kv_page=PAGE, kv_pages=N_SLOTS * (SEQ // PAGE) + 1,
        kv_quant=kv_quant,
    )
    return j_pages.PagedSlotPool.create_paged(
        JLlama(pcfg), jrow, params, N_SLOTS,
        sampling=JSampling(temperature=0.0), eos_id=None,
    )


def _j_admit(pool, slot, prompt, i):
    """tests/test_pages.py's admission flow on the JAX pool."""
    rng = jax.random.fold_in(jax.random.key(0), i)
    ids, shared_n = pool.acquire_pages(prompt, len(prompt) + MAX_NEW - 1)
    if shared_n:
        cache, _f, first, _d, seen = pool.prefill_shared(
            prompt, ids[:shared_n], rng
        )
    else:
        cache, _f, first, _d, seen = j_slots.prefill_row(
            pool.row_model, pool.params, prompt, rng,
            sampling=pool.sampling, eos_id=None, pad_to=len(prompt),
        )
    pool.insert_paged(slot, cache, first, len(prompt), MAX_NEW - 1, ids,
                      shared_n, row_seen=seen)
    pool.register_prefix(prompt, ids)
    return first


def _j_decode_all(pool, firsts, chunk=2):
    rows = {i: [f] for i, f in firsts.items()}
    ci = 0
    while any(len(t) < MAX_NEW for t in rows.values()):
        key = jax.random.fold_in(jax.random.key(1), ci)
        ci += 1
        out = np.asarray(pool.decode_steps(jax.random.split(key, chunk)))
        for i in rows:
            rows[i].extend(out[i, : MAX_NEW - len(rows[i])].tolist())
    return [rows[i] for i in sorted(rows)]


def _t_pool(kv_quant="", n_pages=None):
    return PagedSlotPool.create_paged(
        _setup()[3], N_SLOTS, cache_len=SEQ, page=PAGE, n_pages=n_pages,
        kv_quant=kv_quant, sampling=GREEDY,
    )


def _t_admit(pool, slot, prompt, max_new=MAX_NEW):
    """The scheduler's paged admission flow on the port's pool: acquire,
    shared or cold prefill, scatter-insert, register in the trie."""
    ids, shared_n = pool.acquire_pages(prompt, len(prompt) + max_new - 1)
    if shared_n:
        cache, _f, first, _d, seen = pool.prefill_shared(
            prompt, ids[:shared_n], None
        )
    else:
        cache, _f, first, _d, seen = prefill_row(
            pool.model, prompt, None, sampling=GREEDY, eos_id=None,
            pad_to=len(prompt), cache_len=pool.cache_len,
        )
    pool.insert_paged(slot, cache, first, len(prompt), max_new - 1, ids,
                      shared_n, row_seen=seen)
    pool.register_prefix(prompt, ids)
    return first, shared_n


def _t_decode_all(pool, firsts, max_new=MAX_NEW, chunk=2):
    rows = {i: [f] for i, f in firsts.items()}
    while any(len(t) < max_new for t in rows.values()):
        out = pool.decode_steps(chunk).tolist()
        for i in rows:
            rows[i].extend(out[i][: max_new - len(rows[i])])
    return [rows[i] for i in sorted(rows)]


@functools.lru_cache(maxsize=None)
def _j_paged_tokens(kv_quant):
    pool = _j_pool(kv_quant)
    firsts = {i: _j_admit(pool, i, p, i) for i, p in enumerate(PROMPTS)}
    return _j_decode_all(pool, firsts), pool


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_paged_decode_matches_contiguous_and_jax(kv_quant):
    """Greedy tokens of the port's paged pool equal JAX's paged pool fed
    the same admissions; in full precision both equal the contiguous
    one-shot path of each package. Contiguous insert is refused."""
    _, jrow, params, model = _setup()
    want, _ = _j_paged_tokens(kv_quant)
    pool = _t_pool(kv_quant)
    firsts = {i: _t_admit(pool, i, p)[0] for i, p in enumerate(PROMPTS)}
    assert _t_decode_all(pool, firsts) == want
    if not kv_quant:
        assert want == generate_text(model, PROMPTS, max_new_tokens=MAX_NEW)
        assert want == j_generate_text(jrow, params, PROMPTS,
                                       max_new_tokens=MAX_NEW)
    with pytest.raises(TypeError):
        pool.insert(0, None, 0, 1, 1)


def test_int8_arena_holds_jax_codes():
    """After the same admissions and decode steps, every layer's int8
    K/V codes and fp32 scales in the port's arena equal those in JAX's
    (same allocator, so the same physical pages)."""
    _, jpool = _j_paged_tokens("int8")
    pool = _t_pool("int8")
    firsts = {i: _t_admit(pool, i, p)[0] for i, p in enumerate(PROMPTS)}
    _t_decode_all(pool, firsts)
    assert pool.slot_pages == jpool.slot_pages
    flat = jax.tree_util.tree_flatten_with_path(jpool.cache)[0]
    leaves = {str(p[-1].key): np.asarray(x) for p, x in flat}
    used = sorted({i for ids in pool.slot_pages for i in ids})
    for name, attr in (("cached_key", "key"), ("cached_value", "value")):
        jq = leaves[name].reshape(-1, *leaves[name].shape[-4:])
        js = leaves[name + "_scale"].reshape(-1, *leaves[name].shape[-4:-2])
        assert jq.dtype == np.int8
        for layer, c in enumerate(pool.cache):
            got = getattr(c, attr)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy()[used], jq[layer][used])
            np.testing.assert_allclose(
                getattr(c, attr + "_scale").numpy()[used], js[layer][used],
                rtol=1e-5,
            )


def test_prefix_share_matches_cold_and_cow():
    """A second prompt sharing 2 full pages attaches the donor's pages
    by reference (refcount 2), decodes the cold path's tokens, keeps its
    pages private past the shared point, and the trie keeps the shared
    pages when the donor retires."""
    _, jrow, params, _ = _setup()
    shared = list(range(40, 76))  # 36 tokens = 2 full pages + 4
    pa, pb = shared + [7, 9], shared + [11, 3, 5]
    want = j_generate_text(jrow, params, [pa, pb], max_new_tokens=MAX_NEW)
    pool = _t_pool()
    fa, sn_a = _t_admit(pool, 0, pa)
    fb, sn_b = _t_admit(pool, 1, pb)
    assert (sn_a, sn_b) == (0, 2)
    assert (pool.prefix_hits, pool.prefix_misses) == (1, 1)
    assert pool.slot_pages[1][:2] == pool.slot_pages[0][:2]
    assert all(pool.allocator.refs[i] == 2 for i in pool.slot_pages[0][:2])
    assert set(pool.slot_pages[0][2:]).isdisjoint(pool.slot_pages[1][2:])
    assert _t_decode_all(pool, {0: fa, 1: fb}) == want
    held = list(pool.slot_pages[0][:2])
    pool.release_slot(0)
    assert all(i in pool.allocator.held for i in held)
    assert pool.allocator.in_use == len(pool.allocator.held) + len(
        set(pool.slot_pages[1]) - pool.allocator.held)


def test_released_slot_writes_land_in_page_zero():
    """A released row keeps stepping (done rows are masked, not
    skipped); with its table row zeroed, its writes go to page 0 and
    never to the pages it gave back."""
    pool = _t_pool()
    f0, _ = _t_admit(pool, 0, [1, 5, 9])
    f1, _ = _t_admit(pool, 1, [2, 7])
    _t_decode_all(pool, {0: f0, 1: f1}, max_new=3)
    freed = list(pool.slot_pages[0])
    pool.release_slot(0)
    assert (pool.cache[0].table[0] == 0).all()
    before = [(c.key[freed].clone(), c.seg[freed].clone()) for c in pool.cache]
    page0 = pool.cache[0].key[0].clone()
    pool.decode_steps(4)
    for c, (k, s) in zip(pool.cache, before):
        assert torch.equal(c.key[freed], k) and torch.equal(c.seg[freed], s)
    assert not torch.equal(pool.cache[0].key[0], page0)


def _allocator_ops(alloc_cls):
    """tests/test_pages.py's allocator sequence; the state after each
    operation."""
    a = alloc_cls(5)
    trace = []

    def snap(result):
        trace.append((result, sorted(a.free), dict(a.refs), sorted(a.held),
                      a.freed_total, a.n_free, a.in_use, a.capacity))

    ids = a.alloc(3)
    snap(ids)
    snap(a.alloc(2))
    a.ref(ids[:1])
    snap(a.release(ids[:1]))
    snap(a.release(ids))
    ids = a.alloc(2)
    snap(ids)
    a.hold(ids[:1])
    snap(a.release(ids))
    snap(a.drop(ids[:1]))
    return trace


def test_allocator_matches_jax():
    assert _allocator_ops(PageAllocator) == _allocator_ops(
        j_pages.PageAllocator)
    for cls in (PageAllocator, j_pages.PageAllocator):
        with pytest.raises(ValueError):
            cls(1)


def _trie_ops(alloc_cls, trie_cls):
    a, trie = alloc_cls(9), trie_cls(2)
    out = []
    ids1 = a.alloc(3)
    a.hold(trie.insert([1, 2, 3, 4, 5, 6], ids1))
    out.append(a.release(ids1))
    ids2 = a.alloc(3)
    adopted = trie.insert([1, 2, 9, 9, 4], ids2)
    a.hold(adopted)
    out += [adopted, a.release(ids2), len(trie), a.in_use]
    out.append(trie.match([1, 2, 3, 4, 7]))
    out.append(trie.match([1, 2, 9, 9, 9]))
    a.ref(trie.match([1, 2, 3, 4]))  # a row pins (1,2)->(3,4)
    out.append(trie.evict(3, a))  # LRU leaves first; pinned ones stay
    out += [len(trie), a.in_use, sorted(a.free), sorted(a.held)]
    return out


def test_prefix_trie_eviction_matches_jax():
    assert _trie_ops(PageAllocator, PrefixCache) == _trie_ops(
        j_pages.PageAllocator, JPrefixCache)


def test_scheduler_page_budget_admission():
    """A 6-usable-page arena cannot hold three rows of 3 pages at once:
    the third waits for a retire and every row still gets JAX's greedy
    tokens; a row that can never fit is refused at submit."""
    _, jrow, params, model = _setup()
    metrics = serve._Metrics()
    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=GREEDY, metrics=metrics,
        page=16, arena_pages=7,
    )
    try:
        prompts = [list(range(10 + i, 40 + i)) for i in range(3)]
        outs, _ = sched.submit(prompts, MAX_NEW)
        assert outs == j_generate_text(jrow, params, prompts,
                                       max_new_tokens=MAX_NEW)
        reg = metrics.registry
        assert reg.counter("tpufw_serve_pages_freed_total").value() > 0
        assert sched.pool.allocator.peak_in_use <= 6
        assert sched.pages_in_use < sched.pages_total == 6
    finally:
        sched.close()
    small = serve._SlotScheduler(model, default_sampling=GREEDY, page=16,
                                 arena_pages=3)
    try:
        with pytest.raises(ValueError, match="3 KV pages"):
            small.submit([list(range(20))], 29)
    finally:
        small.close()
