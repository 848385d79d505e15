"""The port's KV spill tier against ``tpufw``'s (``tests/test_spill.py``):

- ``tpufw_torch.infer.spill.SpillTier``: LRU accounting in pages,
  demote-to-disk past the RAM budget and reload, drop without a
  directory, session write-through on the path ``session_path`` computes,
  torn-file drop, ``trie_key``;
- ``tpufw_torch.serve.bundle``: ``chunk_digests`` and
  ``advertised_digests`` equal ``tpufw``'s, the TPFB bytes of one state
  are the same from both packages and decode in either;
- the paged pool: a trie page evicted to the tier and restored by the
  next admission sharing the prefix is bit-equal storage (fp32, bf16,
  and int8 codes with their scales) and decodes the never-spilled greedy
  tokens;
- across packages: a trie page ``tpufw``'s ``PagedSlotPool`` spills
  restores into the port's pool with equal int8 codes, scales and greedy
  tokens, and the other way round;
- the scheduler (``TPUFW_KV_SPILL``) spills and restores under arena
  pressure and serves ``tpufw``'s greedy tokens.

llama3_tiny in fp32 (bf16 arenas from the same weights), page 16.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair, torch_model
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import generate_text as j_generate_text
from tpufw.infer import pages as j_pages
from tpufw.infer import slots as j_slots
from tpufw.infer.spill import SpillTier as JSpillTier
from tpufw.infer.spill import key_name as j_key_name
from tpufw.infer.spill import trie_key as j_trie_key
from tpufw.models.llama import Llama as JLlama
from tpufw.serve import bundle as j_bundle
from tpufw_torch.infer import PagedSlotPool, SamplingConfig, prefill_row
from tpufw_torch.infer.spill import SpillTier, key_name, trie_key
from tpufw_torch.serve import bundle
from tpufw_torch.workloads import serve

PAGE = 16
MAX_NEW = 6
SEQ = 64
N_SLOTS = 4
GREEDY = SamplingConfig()
BASE = list(range(3, 35))  # 32 tokens = 2 full trie pages
TAILS = ([7, 9], [99, 98], [77, 76])


def _blob(n_bytes=64, fill=0x5A):
    return bytes([fill]) * n_bytes


# ------------------------------------------------------- SpillTier


def test_spill_lru_demotes_to_disk_and_reloads(tmp_path):
    tier = SpillTier(2, str(tmp_path), persist_kinds=())
    tier.put("trie", "a", _blob(fill=1), 1)
    tier.put("trie", "b", _blob(fill=2), 1)
    tier.put("trie", "c", _blob(fill=3), 1)  # RAM 3 > 2: "a" demotes
    st = tier.stats()
    assert st["ram_pages"] == 2 and st["dir_pages"] == 1
    assert os.path.exists(tmp_path / key_name("trie", "a"))
    assert tier.get("trie", "a") == _blob(fill=1)
    assert tier.get("trie", "b") == _blob(fill=2)
    tier.pop("trie", "a")
    assert not os.path.exists(tmp_path / key_name("trie", "a"))
    assert ("trie", "a") not in tier
    assert tier.restored_total == 1
    assert tier.stats()["spilled_pages_total"] == 3


def test_spill_without_directory_drops_lru():
    tier = SpillTier(2, "")
    for i, name in enumerate(("a", "b", "c")):
        tier.put("trie", name, _blob(fill=i), 1)
    assert tier.get("trie", "a") is None  # dropped, nowhere to demote
    assert tier.dropped_total == 1
    assert tier.get("trie", "c") == _blob(fill=2)
    assert tier.get("trie", "b") is not None  # b is now the MRU
    tier.put("trie", "d", _blob(), 1)
    assert tier.get("trie", "c") is None and tier.get("trie", "b")


def test_spill_session_write_through_matches_session_path(tmp_path):
    tier = SpillTier(64, str(tmp_path))
    tier.put("session", "user-42", b"SESSBYTES", 3)
    assert bundle.load_session(str(tmp_path), "user-42") == b"SESSBYTES"
    assert bundle.session_path(str(tmp_path), "user-42") == os.path.join(
        str(tmp_path), key_name("session", "user-42")
    )
    # The port's and tpufw's names agree, so either process finds it.
    assert bundle.session_path("d", "s") == j_bundle.session_path("d", "s")
    bundle.store_session(str(tmp_path), "other", b"X")
    assert bundle.load_session(str(tmp_path), "other") == b"X"
    bundle.drop_session(str(tmp_path), "other")
    assert bundle.load_session(str(tmp_path), "other") is None
    bundle.drop_session(str(tmp_path), "other")  # idempotent


def test_spill_torn_file_dropped_not_served(tmp_path):
    tier = SpillTier(0, str(tmp_path), persist_kinds=())
    tier.put("trie", "x", _blob(), 1)  # budget 0: demotes at once
    os.unlink(tmp_path / key_name("trie", "x"))
    assert tier.get("trie", "x") is None
    assert tier.dropped_total == 1
    assert ("trie", "x") not in tier


def test_trie_key_is_the_full_token_path():
    assert trie_key([3, 1, 4]) == "3,1,4"
    assert trie_key([]) == ""
    assert key_name("trie", "a/b\\c") != key_name("trie", "a_b_c")
    assert key_name("trie", "x") != key_name("session", "x")
    # Both packages name an entry alike (one shared directory tier).
    assert key_name("trie", "3,1") == j_key_name("trie", "3,1")
    assert trie_key((5, 6)) == j_trie_key((5, 6))


# --------------------------------------------------------- digests


def test_chunk_digests_cumulative_page_aligned_and_capped():
    toks = list(range(100, 140))  # 40 tokens = 2 full pages + tail
    d = bundle.chunk_digests(toks, PAGE, 4)
    assert d == j_bundle.chunk_digests(toks, PAGE, 4)
    assert len(d) == 2
    assert d[0] == bundle.chunk_digests(toks[:PAGE], PAGE, 4)[0]
    other = [1] + toks[1:]
    assert bundle.chunk_digests(other, PAGE, 4)[0] != d[0]
    deep = toks[:PAGE] + [9] + toks[PAGE + 1:]
    d2 = bundle.chunk_digests(deep, PAGE, 4)
    assert d2[0] == d[0] and d2[1] != d[1]
    assert bundle.chunk_digests(toks, PAGE, 1) == d[:1]
    assert bundle.chunk_digests(toks, 0, 4) == []
    assert bundle.chunk_digests(toks, PAGE, 0) == []


def test_advertised_digests_cover_resident_and_spilled_paths():
    """The port's trie (``version``, ``paths``) under
    ``advertised_digests``: resident paths by their deepest digest,
    spilled ones at every depth, cached until the trie version or the
    spill counters move."""
    from tpufw_torch.infer import PageAllocator, PrefixCache

    trie, alloc = PrefixCache(PAGE), PageAllocator(8)
    base = list(range(200, 232))
    ids = alloc.alloc(2)
    alloc.hold(trie.insert(base, ids))
    alloc.release(ids)

    class Pool:
        prefix, page = trie, PAGE

    tier = SpillTier(8, "")
    spilled = list(range(50, 82))
    tier.put("trie", trie_key(spilled), _blob(), 1)
    cache = {}
    ads = bundle.advertised_digests(Pool, tier, 4, cache)
    assert bundle.chunk_digests(base, PAGE, 4)[-1] in ads
    assert bundle.chunk_digests(base, PAGE, 4)[0] in ads
    for h in bundle.chunk_digests(spilled, PAGE, 4):
        assert h in ads
    assert bundle.advertised_digests(Pool, tier, 4, cache) is ads
    tier.pop("trie", trie_key(spilled))
    ads2 = bundle.advertised_digests(Pool, tier, 4, cache)
    assert ads2 is not ads
    assert bundle.chunk_digests(spilled, PAGE, 4)[0] not in ads2
    v0 = trie.version
    trie.match(base)  # a match moves nothing
    assert trie.version == v0
    assert bundle.advertised_digests(Pool, tier, 4, cache) is ads2
    trie.evict(1, alloc)
    assert trie.version == v0 + 1
    assert bundle.advertised_digests(Pool, tier, 4, cache) is not ads2


def test_trie_evict_hook_and_paths_match_jax():
    """``on_evict`` sees each victim's full token path before the drop,
    in ``tpufw``'s order; ``paths`` and ``version`` agree with its
    trie's."""
    from tpufw.infer.pages import PageAllocator as JAlloc
    from tpufw.infer.prefix import PrefixCache as JPrefix
    from tpufw_torch.infer import PageAllocator, PrefixCache

    seen = {}
    for name, alloc_cls, trie_cls in (("jax", JAlloc, JPrefix),
                                      ("port", PageAllocator, PrefixCache)):
        trie, alloc = trie_cls(4), alloc_cls(16)
        for toks in ([1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 9, 9, 9, 9],
                     [5, 5, 5, 5]):
            ids = alloc.alloc(len(toks) // 4)
            alloc.hold(trie.insert(toks, ids))
            alloc.release(ids)
        trie.match([1, 2, 3, 4, 9, 9, 9, 9])
        paths = sorted(trie.paths(4))
        events = []
        dropped = trie.evict(
            3, alloc, on_evict=lambda p, pid: events.append((p, pid)))
        seen[name] = (paths, events, dropped, trie.version, len(trie))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------- bundle


def test_bundle_bytes_equal_jax_and_decode_both_ways():
    """One page state, bf16 K/V among int32 and fp32 arrays: the port's
    TPFB bytes (bf16 as raw 16-bit patterns) equal ``tpufw``'s (bf16
    through ml_dtypes), and each package decodes the other's."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 1, PAGE, 2, 8)).astype(ml_dtypes.bfloat16)
    seg = rng.integers(0, 3, (2, 1, PAGE)).astype(np.int32)
    scale = rng.random((2, 1, PAGE)).astype(np.float32)
    meta = {"page": PAGE, "kv_quant": "", "n_pages": 1, "token": 0,
            "pos": 0, "remaining": 0, "done": True, "cache_index": 0,
            "seen": None, "paths": ["k", "seg", "scale"]}
    j_bytes = j_bundle.encode_bundle(dict(meta, arrays=[k, seg, scale]))
    t_bytes = bundle.encode_bundle(dict(
        meta, arrays=[k.view(np.uint16), seg, scale],
        dtypes=["bfloat16", "int32", "float32"]))
    assert t_bytes == j_bytes
    got = bundle.decode_bundle(j_bytes)
    assert got["dtypes"] == ["bfloat16", "int32", "float32"]
    assert got["arrays"][0].tobytes() == k.tobytes()
    assert got["arrays"][0].dtype == np.uint16
    back = j_bundle.decode_bundle(t_bytes)
    assert back["arrays"][0].dtype == k.dtype
    for a, b in zip(back["arrays"], (k, seg, scale)):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(bundle.BundleError, match="checksum"):
        bundle.decode_bundle(t_bytes[:-5] + b"x" + t_bytes[-4:])


# --------------------------------------- arena spill <-> restore (port)


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """The port's decode model of llama3_tiny (max_seq_len 64) with the
    Flax weights, activations and K/V in ``dtype``."""
    jrow, params, model = decode_pair(max_seq_len=SEQ)
    if dtype == "float32":
        return model
    cfg = dataclasses.replace(model.cfg, dtype=getattr(torch, dtype))
    return torch_model(cfg, params)


def _t_pool(model, kv_quant, n_pages=None):
    return PagedSlotPool.create_paged(
        model, N_SLOTS, cache_len=SEQ, page=PAGE, n_pages=n_pages,
        kv_quant=kv_quant, sampling=GREEDY,
    )


def _t_run(pool, prompt, slot=0):
    """Admit ``prompt`` (the scheduler's paged flow), decode MAX_NEW
    greedy tokens, release the slot. Returns (tokens, shared pages)."""
    ids, shared_n = pool.acquire_pages(prompt, len(prompt) + MAX_NEW - 1)
    if shared_n:
        cache, _f, first, _d, seen = pool.prefill_shared(
            prompt, ids[:shared_n], None)
    else:
        cache, _f, first, _d, seen = prefill_row(
            pool.model, prompt, None, sampling=GREEDY, eos_id=None,
            pad_to=len(prompt), cache_len=pool.cache_len)
    pool.insert_paged(slot, cache, first, len(prompt), MAX_NEW - 1, ids,
                      shared_n, row_seen=seen)
    pool.register_prefix(prompt, ids)
    toks = [first]
    while len(toks) < MAX_NEW:
        toks.extend(pool.decode_steps(2).tolist()[slot])
    pool.release_slot(slot)
    return toks[:MAX_NEW], shared_n


def _spill_base(pool, tier):
    """Evict the resident BASE path through the pool's spill hook, as
    arena pressure does inside acquire_pages."""
    free0 = pool.allocator.n_free
    pool.prefix.evict(2, pool.allocator, on_evict=pool._spill_hook())
    assert pool.prefix.match(BASE) == []
    assert pool.allocator.n_free == free0 + 2
    assert set(tier.names("trie")) == {trie_key(BASE[:PAGE]),
                                       trie_key(BASE)}


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_trie_spill_restore_bit_equal(kv):
    """A resident path evicted to the tier and restored by the next
    admission sharing it: the arena bytes after the restore equal those
    that left (K/V, segment ids, and for int8 the codes' fp32 scales),
    the restored path is a prefix hit, and it decodes the greedy tokens
    of a pool that never spilled."""
    model = _model("float32" if kv == "int8" else kv)
    quant = "int8" if kv == "int8" else ""
    tier = SpillTier(64)
    pool = _t_pool(model, quant)
    bundle.attach_spill(pool, tier)
    ref = _t_pool(model, quant)
    want = [_t_run(ref, BASE + t)[0] for t in TAILS]
    assert _t_run(pool, BASE + TAILS[0]) == (want[0], 0)
    for cycle in (1, 2):
        ids0 = pool.prefix.match(BASE)
        before = pool.export_pages_state(ids0)
        _spill_base(pool, tier)
        toks, shared = _t_run(pool, BASE + TAILS[cycle])
        assert toks == want[cycle]
        assert shared == 2
        assert pool.spill_pages_out == pool.spill_pages_in == 2 * cycle
        assert tier.names("trie") == []  # consumed on restore
        after = pool.export_pages_state(pool.prefix.match(BASE))
        assert before["paths"] == after["paths"]
        assert before["dtypes"] == after["dtypes"]
        for a, b, path in zip(before["arrays"], after["arrays"],
                              before["paths"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), path
    assert pool.prefix_hits == 2


def test_spill_through_tier_bytes_and_directory(tmp_path):
    """The restore reads back through the TPFB codec from the directory
    tier too (RAM budget 0: every spilled page demotes to disk)."""
    model = _model("float32")
    tier = SpillTier(0, str(tmp_path), persist_kinds=())
    pool = _t_pool(model, "int8")
    bundle.attach_spill(pool, tier)
    first, _ = _t_run(pool, BASE + TAILS[0])
    _spill_base(pool, tier)
    assert tier.stats()["dir_pages"] == 2
    assert len(os.listdir(tmp_path)) == 2
    toks, shared = _t_run(pool, BASE + TAILS[0])
    assert (toks, shared) == (first, 2)
    assert os.listdir(tmp_path) == []


# ------------------------------------------------ across the packages


def _j_pool(kv_quant):
    jrow, params, _ = decode_pair(max_seq_len=SEQ)
    pcfg = dataclasses.replace(
        jrow.cfg, kv_page=PAGE, kv_pages=N_SLOTS * (SEQ // PAGE) + 1,
        kv_quant=kv_quant,
    )
    return j_pages.PagedSlotPool.create_paged(
        JLlama(pcfg), jrow, params, N_SLOTS,
        sampling=JSampling(temperature=0.0), eos_id=None,
    )


def _j_run(pool, prompt, slot=0):
    rng = jax.random.key(0)
    ids, shared_n = pool.acquire_pages(prompt, len(prompt) + MAX_NEW - 1)
    if shared_n:
        cache, _f, first, _d, seen = pool.prefill_shared(
            prompt, ids[:shared_n], rng)
    else:
        cache, _f, first, _d, seen = j_slots.prefill_row(
            pool.row_model, pool.params, prompt, rng,
            sampling=pool.sampling, eos_id=None, pad_to=len(prompt))
    pool.insert_paged(slot, cache, first, len(prompt), MAX_NEW - 1, ids,
                      shared_n, row_seen=seen)
    pool.register_prefix(prompt, ids)
    toks = [int(first)]
    ci = 0
    while len(toks) < MAX_NEW:
        key = jax.random.fold_in(jax.random.key(1), ci)
        ci += 1
        out = np.asarray(pool.decode_steps(jax.random.split(key, 2)))
        toks.extend(out[slot].tolist())
    pool.release_slot(slot)
    return toks[:MAX_NEW], shared_n


def _same_pages(a, b):
    """Two export states hold the same bytes leaf by leaf (a ``tpufw``
    state's bf16 arrays are ml_dtypes, the port's raw patterns)."""
    assert list(a["paths"]) == list(b["paths"])
    for x, y, path in zip(a["arrays"], b["arrays"], a["paths"]):
        assert x.shape == y.shape, path
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), path


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_jax_spilled_page_restores_in_port(kv_quant):
    """``tpufw``'s pool spills the BASE path through its own
    ``attach_spill``; the bytes go into the port's tier; the port's pool
    restores them for a prompt sharing BASE: its arena then holds
    ``tpufw``'s bytes (int8 codes and scales included), and it decodes
    the greedy tokens ``tpufw``'s pool decodes from the same restore."""
    jpool, jtier = _j_pool(kv_quant), JSpillTier(64)
    j_bundle.attach_spill(jpool, jtier)
    _j_run(jpool, BASE + TAILS[0])
    j_before = jpool.export_pages_state(jpool.prefix.match(BASE))
    jpool.prefix.evict(2, jpool.allocator, on_evict=jpool._spill_hook())
    tier = SpillTier(64)
    for name in jtier.names("trie"):
        tier.put("trie", name, jtier.get("trie", name), 1)
    want, j_shared = _j_run(jpool, BASE + TAILS[1])
    assert j_shared == 2
    pool = _t_pool(_model("float32"), kv_quant)
    bundle.attach_spill(pool, tier)
    toks, shared = _t_run(pool, BASE + TAILS[1])
    assert shared == 2 and pool.spill_pages_in == 2
    assert toks == want
    _same_pages(j_before, pool.export_pages_state(pool.prefix.match(BASE)))


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_port_spilled_page_restores_in_jax(kv_quant):
    """The other way: the port's pool spills BASE, ``tpufw``'s pool
    restores the port's bytes with its own ``attach_spill`` and decodes
    the port's greedy tokens from the same restore; its arena holds the
    port's bytes."""
    tier = SpillTier(64)
    pool = _t_pool(_model("float32"), kv_quant)
    bundle.attach_spill(pool, tier)
    _t_run(pool, BASE + TAILS[0])
    before = pool.export_pages_state(pool.prefix.match(BASE))
    _spill_base(pool, tier)
    jtier = JSpillTier(64)
    for name in tier.names("trie"):
        jtier.put("trie", name, tier.get("trie", name), 1)
    want, shared = _t_run(pool, BASE + TAILS[1])
    assert shared == 2
    jpool = _j_pool(kv_quant)
    j_bundle.attach_spill(jpool, jtier)
    toks, j_shared = _j_run(jpool, BASE + TAILS[1])
    assert j_shared == 2 and jpool.spill_pages_in == 2
    assert toks == want
    _same_pages(jpool.export_pages_state(jpool.prefix.match(BASE)), before)


def test_import_checks_layout_before_the_arena():
    pool = _t_pool(_model("float32"), "int8")
    _t_run(pool, BASE + TAILS[0])
    state = pool.export_pages_state(pool.prefix.match(BASE)[:1])
    ids = pool.allocator.alloc(1)
    for bad, match in (({"page": 8}, "page size"),
                       ({"kv_quant": ""}, "kv_quant"),
                       ({"n_pages": 2}, "carries"),
                       ({"paths": state["paths"][:-1]}, "layout")):
        with pytest.raises(ValueError, match=match):
            pool.import_pages(ids, dict(state, **bad))
    pool.import_pages(ids, state)  # the unchanged state imports


# ---------------------------------------------------------- scheduler


def test_scheduler_spill_tier_restores_shared_prefix(clear_tpufw_env):
    """TPUFW_KV_SPILL on the paged scheduler with an arena of 4 usable
    pages: a second request that fits only by evicting the first's two
    trie pages spills them, a third sharing the first's prefix restores
    them, and every request gives ``tpufw``'s greedy tokens. The spill
    series appear on /metrics."""
    clear_tpufw_env.setenv("TPUFW_KV_SPILL", "64")
    clear_tpufw_env.setenv("TPUFW_SERVE_CHUNK", "2")
    jmodel, params, model = decode_pair()
    metrics = serve._Metrics()
    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=GREEDY, page=PAGE,
        arena_pages=5, metrics=metrics,
    )
    # 3 pages, then 4 (the whole arena: both trie pages must go), then 3.
    reqs = ((BASE + TAILS[0], MAX_NEW), (list(range(100, 120)), 40),
            (BASE + TAILS[1], MAX_NEW))
    try:
        for prompt, max_new in reqs:
            outs, _ = sched.submit([prompt], max_new)
            want = j_generate_text(jmodel, params, [prompt],
                                   max_new_tokens=max_new)
            assert outs == want
        assert sched.pool.spill_pages_out >= 2
        assert sched.pool.spill_pages_in == 2
        assert sched.pool.prefix_hits >= 1
    finally:
        sched.close()

    class Srv:  # the server's scrape-time state, without a listener
        _batcher = sched

    Srv.metrics = metrics
    text = metrics.render(serve._Server._gauge_values(Srv))
    assert 'tpufw_kv_spill_pages{tier="ram"}' in text
    assert "tpufw_kv_restore_seconds_count 2" in text
    bytes_line = [ln for ln in text.splitlines()
                  if ln.startswith("tpufw_kv_spill_bytes_total")]
    assert bytes_line and float(bytes_line[0].split()[1]) > 0


class _Sink:
    def __init__(self):
        self.events = []

    def emit(self, kind, level="info", **fields):
        self.events.append((kind, level, fields))


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_attach_spill_serve_spill_events_equal_jax(kv_quant, tmp_path):
    """``attach_spill(..., events=)`` emits one ``serve_spill`` record per
    spill ("out") and per restore ("in"), with the page count and the TPFB
    bytes, the same records ``tpufw``'s emits for the same cycle (the
    restore's wall time aside); they pass the port's event schema, and a
    ``PrefillEngine`` given an event log wires it into its pool."""
    from tpufw_torch.obs.events import EventLog, read_events
    from tpufw_torch.serve.roles import PrefillEngine

    sink, j_sink = _Sink(), _Sink()
    tier = SpillTier(64)
    pool = _t_pool(_model("float32"), kv_quant)
    bundle.attach_spill(pool, tier, events=sink)
    _t_run(pool, BASE + TAILS[0])
    _spill_base(pool, tier)
    _t_run(pool, BASE + TAILS[1])
    jpool, jtier = _j_pool(kv_quant), JSpillTier(64)
    j_bundle.attach_spill(jpool, jtier, events=j_sink)
    _j_run(jpool, BASE + TAILS[0])
    jpool.prefix.evict(2, jpool.allocator, on_evict=jpool._spill_hook())
    _j_run(jpool, BASE + TAILS[1])

    def strip(evs):
        return [(k, lvl, {n: v for n, v in f.items() if n != "wall_s"})
                for k, lvl, f in evs]

    assert strip(sink.events) == strip(j_sink.events)
    assert [f["direction"] for _k, _l, f in sink.events] == [
        "out", "out", "in", "in"]
    assert all(f["wall_s"] >= 0 for _k, _l, f in sink.events
               if f["direction"] == "in")

    log = EventLog(str(tmp_path / "events.jsonl"))
    pe = PrefillEngine(_model("float32"), sampling=GREEDY, page=PAGE,
                       kv_quant=kv_quant, spill=SpillTier(64), events=log)
    pe.prefill(BASE + TAILS[0], MAX_NEW)
    pe.pool.prefix.evict(2, pe.pool.allocator,
                         on_evict=pe.pool._spill_hook())
    log.close()
    spills = [e for e in read_events(str(tmp_path / "events.jsonl"))
              if e["kind"] == "serve_spill"]
    assert [(e["entry"], e["direction"], e["pages"]) for e in spills] == [
        ("trie", "out", 1), ("trie", "out", 1)]
