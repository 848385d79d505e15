"""DeepSeek's latent caches in the port's serving stack, against ``tpufw``
(``tests/test_pages.py``'s DeepSeek paged parity, ``tests/test_migrate.py``'s
MLA migration and ``tests/test_deepseek.py``'s latent speculation), on
``deepseek_tiny`` (dense MLA), ``deepseek_moe_tiny`` (every layer MoE, a
scanned tree) and its ``first_k_dense=1`` variant (an unscanned tree), in
fp32 with the Flax weights moved into the port, a 64-slot cache, page 16:

- POOLS: ``SlotPool`` (per-row cursors) and ``PagedSlotPool`` (latent
  arenas, unquantized and int8) with an idle slot and uneven budgets give
  ``tpufw``'s pools' greedy tokens, the MoE pool at capacity 1.0 so the
  idle slot's valid mask must be ``tpufw``'s; the per-row cache and the
  arenas hold what the contiguous cache holds;
- PAGES: a prefix hit, a chunked prefill and a spill/restore give the
  cold admission's tokens, the restored pages bit-equal to the spilled;
- MIGRATION: a prompt prefilled on one engine decodes on another with the
  never-migrated tokens, and bundles cross between the packages both ways
  with ``tpufw``'s leaf paths, scanned and per layer;
- SPECULATION: batch ``speculative_generate`` with a one-layer latent
  draft, and pool ``spec_steps``/``spec_draft_steps``, emit greedy tokens;
- SERVING: the slot scheduler (paged, with the spill tier), the tick
  batcher and the roles serve a DeepSeek model with ``generate_text``'s
  tokens.

The ids "bf16"/"int8" follow ``tests/test_migrate.py``: "bf16" is the
unquantized arena, in the model's dtype (fp32 here).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import generate_text as j_generate_text
from tpufw.infer import pages as j_pages
from tpufw.infer import slots as j_slots
from tpufw.models.deepseek import DEEPSEEK_CONFIGS as J_CONFIGS
from tpufw.models.deepseek import Deepseek as JDeepseek
from tpufw.serve import roles as j_roles
from tpufw_torch.infer import (
    PagedSlotPool,
    SamplingConfig,
    SlotPool,
    generate_text,
    prefill_row,
    speculative_generate_text,
)
from tpufw_torch.infer.spill import SpillTier
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import DEEPSEEK_CONFIGS, Deepseek
from tpufw_torch.models.deepseek import LatentCache, PagedLatentCache
from tpufw_torch.serve import bundle
from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine
from tpufw_torch.serve.transport import LoopbackTransport
from tpufw_torch.workloads import serve

SEQ = 64
PAGE = 16
MAX_NEW = 6
N_SLOTS = 4
K = 3
GREEDY = SamplingConfig()
J_GREEDY = JSampling(temperature=0.0)
PROMPTS = [
    np.random.default_rng(1).integers(1, 256, n).tolist() for n in (29, 3, 11)
]
BASE = list(range(3, 37))  # 34 tokens = 2 full pages + tail
# name, overrides of the preset (the MoE pools at capacity 1.0 drop).
VARIANTS = {
    "dense": ("deepseek_tiny", {}),
    "moe": ("deepseek_moe_tiny", {}),
    "moe_cap1": ("deepseek_moe_tiny", {"capacity_factor": 1.0}),
    "first_dense": ("deepseek_moe_tiny", {"first_k_dense": 1, "n_layers": 3,
                                          "scan_layers": False}),
}
KV = pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])


@functools.lru_cache(maxsize=None)
def _decode_pair(variant, seq=SEQ):
    """(tpufw decode model, Flax params, the port's decode model) of
    ``variant`` in fp32 at ``seq`` slots."""
    name, over = VARIANTS[variant]
    over = {**over, "max_seq_len": seq}
    jcfg = dataclasses.replace(J_CONFIGS[name], dtype=jnp.float32,
                               param_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(DEEPSEEK_CONFIGS[name], dtype=torch.float32,
                               param_dtype=torch.float32, **over)
    params = jax.device_get(meta.unbox(jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = Deepseek(tcfg.decode_config(), device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    return JDeepseek(jcfg.decode_config()), params, model


def _want(variant, prompts=PROMPTS, max_new=MAX_NEW):
    jmodel, params, _ = _decode_pair(variant)
    return j_generate_text(jmodel, params, prompts, max_new_tokens=max_new,
                           sampling=J_GREEDY)


# ----------------------------------------------------------------- pools

# Three rows with uneven budgets (row 1 finishes first); slot 3 idle.
BUDGETS = (MAX_NEW, 3, MAX_NEW)


def _pool_rows(decode, firsts):
    rows = {i: [f] for i, f in firsts.items()}
    while any(len(rows[i]) < BUDGETS[i] for i in rows):
        out = decode()
        for i in rows:
            rows[i].extend(out[i, : BUDGETS[i] - len(rows[i])].tolist())
    return [rows[i] for i in sorted(rows)]


def _j_pool_tokens(variant, kind):
    jrow, params, _ = _decode_pair(variant)
    if kind == "slots":
        pool = j_slots.SlotPool.create(jrow, params, N_SLOTS,
                                       sampling=J_GREEDY)
    else:
        pcfg = dataclasses.replace(
            jrow.cfg, kv_page=PAGE, kv_pages=N_SLOTS * (SEQ // PAGE) + 1,
            kv_quant="int8" if kind == "paged_int8" else "")
        pool = j_pages.PagedSlotPool.create_paged(
            JDeepseek(pcfg), jrow, params, N_SLOTS, sampling=J_GREEDY,
            eos_id=None)
    firsts = {}
    for i, p in enumerate(PROMPTS):
        rng = jax.random.fold_in(jax.random.key(0), i)
        cache, _f, first, _d, seen = j_slots.prefill_row(
            jrow, params, p, rng, sampling=J_GREEDY, eos_id=None,
            pad_to=32 if kind == "slots" else len(p))
        if kind == "slots":
            pool.insert(i, cache, first, len(p), BUDGETS[i] - 1,
                        row_seen=seen)
        else:
            ids, _ = pool.acquire_pages(p, len(p) + BUDGETS[i] - 1 + K)
            pool.insert_paged(i, cache, first, len(p), BUDGETS[i] - 1, ids, 0,
                              row_seen=seen)
        firsts[i] = first
    keys = iter(range(100))
    return _pool_rows(lambda: np.asarray(pool.decode_steps(jax.random.split(
        jax.random.fold_in(jax.random.key(1), next(keys)), 2))), firsts)


def _port_pool(model, kind, **kw):
    if kind == "slots":
        return SlotPool.create(model, N_SLOTS, sampling=GREEDY, cache_len=SEQ)
    return PagedSlotPool.create_paged(
        model, N_SLOTS, cache_len=SEQ, page=PAGE,
        n_pages=N_SLOTS * (SEQ // PAGE) + 1, sampling=GREEDY,
        kv_quant="int8" if kind == "paged_int8" else "", **kw)


def _admit(pool, slot, prompt, budget, pad_to=None):
    """Prefill ``prompt`` into ``slot`` (a paged row without left padding,
    its pages covering the budget and K slots of speculative slack)."""
    if pad_to is None:
        pad_to = len(prompt) if isinstance(pool, PagedSlotPool) else 32
    cache, _f, first, _d, seen = prefill_row(
        pool.model, prompt, None, sampling=GREEDY, eos_id=None, pad_to=pad_to,
        cache_len=pool.cache_len)
    if isinstance(pool, PagedSlotPool):
        ids, shared = pool.acquire_pages(prompt, len(prompt) + budget + K)
        pool.insert_paged(slot, cache, first, len(prompt), budget, ids, 0,
                          row_seen=seen)
    else:
        pool.insert(slot, cache, first, len(prompt), budget, row_seen=seen)
    return first


POOL_CASES = [("dense", "slots"), ("moe_cap1", "slots"),
              ("dense", "paged"), ("first_dense", "paged"),
              ("moe_cap1", "paged_int8")]


@pytest.mark.parametrize("variant, kind", POOL_CASES,
                         ids=[f"{v}-{k}" for v, k in POOL_CASES])
def test_pools_with_idle_slots_match_jax(variant, kind):
    model = _decode_pair(variant)[2]
    pool = _port_pool(model, kind)
    cache_type = LatentCache if kind == "slots" else PagedLatentCache
    assert all(isinstance(c, cache_type) for c in pool.cache)
    firsts = {i: _admit(pool, i, p, BUDGETS[i] - 1)
              for i, p in enumerate(PROMPTS)}
    got = _pool_rows(lambda: pool.decode_steps(2), firsts)
    assert got == _j_pool_tokens(variant, kind)
    if kind == "paged_int8":
        assert pool.cache[0].ckv.dtype == torch.int8
        assert pool.cache[0].kpe_scale.dtype == torch.float32


@pytest.mark.parametrize("kind", ["slots", "paged"])
def test_pool_rows_hold_the_contiguous_cache(kind):
    """A row inserted into a pool holds, at its slots, exactly the latents
    and segment ids of its contiguous prefill cache."""
    model = _decode_pair("dense")[2]
    pool = _port_pool(model, kind)
    prompt = PROMPTS[0]
    row = prefill_row(model, prompt, None, sampling=GREEDY, eos_id=None,
                      pad_to=32 if kind == "slots" else len(prompt),
                      cache_len=SEQ)[0]
    _admit(pool, 1, prompt, MAX_NEW - 1)
    for layer, r in zip(pool.cache, row):
        for f in ("ckv", "kpe", "seg"):
            got = getattr(layer, f)
            if kind == "paged":
                got = got[layer.table[1]].reshape(
                    SEQ, *got.shape[2:])[None]
            else:
                got = got[1:2]
            assert torch.equal(got, getattr(r, f)), f
        assert int(layer.index[1]) == r.index


# ----------------------------------------------------------------- pages


def _cold_tokens(model, prompt, max_new=MAX_NEW):
    return generate_text(model, [prompt], max_new_tokens=max_new,
                         sampling=GREEDY)[0]


def _decode_row(pool, slot, first, max_new=MAX_NEW):
    toks = [first]
    while len(toks) < max_new:
        toks.extend(pool.decode_steps(1)[slot].tolist())
    return toks[:max_new]


@KV
def test_prefix_hit_chunked_prefill_and_spill(kv_quant):
    """On the first_dense model: a prompt sharing BASE's first page hits
    the trie and decodes the cold tokens (unquantized); a chunked prefill
    writes the monolithic prefill's pages and decodes its tokens; BASE's
    trie pages spilled under arena pressure come back bit-equal and are
    hit again."""
    model = _decode_pair("first_dense")[2]
    pool = PagedSlotPool.create_paged(
        model, 2, cache_len=SEQ, page=PAGE, n_pages=2 * (SEQ // PAGE) + 1,
        kv_quant=kv_quant, sampling=GREEDY)
    first = _admit(pool, 0, BASE, MAX_NEW - 1)
    base = _decode_row(pool, 0, first)
    pool.register_prefix(BASE, pool.slot_pages[0])
    pool.release_slot(0)
    other = BASE[:PAGE] + [99, 98]
    ids, shared = pool.acquire_pages(other, len(other) + MAX_NEW)
    assert shared == 1 and pool.prefix_hits == 1
    cache, _f, first, _d, seen = pool.prefill_shared(other, ids[:shared],
                                                     None)
    pool.insert_paged(1, cache, first, len(other), MAX_NEW - 1, ids, shared,
                      row_seen=seen)
    hit = _decode_row(pool, 1, first)
    pool.release_slot(1)
    if not kv_quant:
        assert base == _cold_tokens(model, BASE)
        assert hit == _cold_tokens(model, other)

    # Chunked prefill, one page a chunk, on a pool without a trie.
    mono = PagedSlotPool.create_paged(
        model, 1, cache_len=SEQ, page=PAGE, kv_quant=kv_quant,
        sampling=GREEDY, prefix_cache=False)
    want_first = _admit(mono, 0, BASE, MAX_NEW - 1)
    chunked = PagedSlotPool.create_paged(
        model, 1, cache_len=SEQ, page=PAGE, kv_quant=kv_quant,
        sampling=GREEDY, prefix_cache=False)
    cp = chunked.start_chunked(BASE, len(BASE) + MAX_NEW, None, 1)
    steps = []
    while not steps or steps[-1] != "done":
        steps.append(chunked.chunk_step(cp))
    assert steps == ["ran", "ran", "done"] and cp.first_int == want_first
    chunked.finalize_chunked(0, cp, MAX_NEW - 1)
    for a, b in zip(mono.cache, chunked.cache):
        ia, ib = a.table[0, :3], b.table[0, :3]
        for f in ("ckv", "kpe") + (("ckv_scale", "kpe_scale")
                                   if kv_quant else ()):
            x, y = getattr(a, f)[ia], getattr(b, f)[ib]
            if x.dtype == torch.int8:
                assert (x.int() - y.int()).abs().max() <= 1, f
            else:
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4,
                                           atol=2e-4, err_msg=f)
        assert torch.equal(a.seg[ia], b.seg[ib])
    assert (_decode_row(chunked, 0, cp.first_int)
            == _decode_row(mono, 0, want_first))

    # Spill: BASE's two trie pages leave under pressure, then return.
    store = {}
    pool.trie_spill = lambda path, state: store.__setitem__(path, state)
    pool.trie_restore = lambda path: store.pop(path, None)
    trie_ids = pool.prefix.match(BASE)[:2]
    before = {f: [getattr(c, f)[trie_ids].clone() for c in pool.cache]
              for f in ("ckv", "kpe", "seg")}
    hog = pool.allocator.alloc(pool.allocator.n_free - 2)
    filler = list(range(100, 100 + 3 * PAGE))
    ids, _ = pool.acquire_pages(filler, SEQ)
    assert pool.spill_pages_out == 2 and len(store) == 2
    pool.release_pages(ids + hog)
    ids, shared = pool.acquire_pages(BASE, len(BASE) + MAX_NEW)
    assert shared == 2 and pool.spill_pages_in == 2
    for f, layers in before.items():
        for c, want in zip(pool.cache, layers):
            assert torch.equal(getattr(c, f)[ids[:2]], want), f


# ------------------------------------------------------------- migration


def _engines(variant, kv_quant):
    model = _decode_pair(variant)[2]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, kv_quant=kv_quant,
                       n_slots=2)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, kv_quant=kv_quant,
                      n_slots=N_SLOTS, chunk=2)
    return pe, de


def _j_engines(variant, kv_quant):
    jmodel, params, _ = _decode_pair(variant)
    pe = j_roles.PrefillEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                               kv_quant=kv_quant, n_slots=2)
    de = j_roles.DecodeEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                              kv_quant=kv_quant, n_slots=N_SLOTS, chunk=2)
    return pe, de


MIGRATE = [(v, q) for v in ("moe", "first_dense") for q in ("", "int8")]


@pytest.mark.parametrize("variant, kv_quant", MIGRATE,
                         ids=[f"{v}-{q or 'bf16'}" for v, q in MIGRATE])
def test_migration_and_bundles_across_packages(variant, kv_quant):
    """Port -> port over the loopback wire into a polluted decode arena,
    tpufw -> port and port -> tpufw: every route decodes tpufw's own
    engines' tokens (unquantized: tpufw's generate_text); both packages'
    bundles carry the same paths (per layer for the unscanned tree), page
    counts and cursors."""
    pe, de = _engines(variant, kv_quant)
    jpe, jde = _j_engines(variant, kv_quant)
    assert de.pool.allocator.alloc(1) is not None  # decoy
    prompts = [PROMPTS[0], BASE, [2, 7]]
    lt = LoopbackTransport()
    got = []
    for p in prompts:
        lt.a.send(pe.prefill(p, MAX_NEW))
        got.append(de.collect(de.submit(lt.b.recv(timeout=5.0))))
    jdatas = [jpe.prefill(p, MAX_NEW) for p in prompts]
    want = [jde.collect(jde.submit(d)) for d in jdatas]
    assert got == want
    if not kv_quant:
        assert got == _want(variant, prompts)
    assert [de.collect(de.submit(d)) for d in jdatas] == want
    datas = [pe.prefill(p, MAX_NEW) for p in prompts]
    assert [jde.collect(jde.submit(d)) for d in datas] == want
    a, b = bundle.decode_bundle(datas[1]), bundle.decode_bundle(jdatas[1])
    assert a["paths"] == b["paths"]
    scanned = "['layers']" in a["paths"][0]
    assert scanned == (variant == "moe")
    leaves = {p.split("['")[-1][:-2] for p in a["paths"]}
    assert leaves == {"cached_ckv", "cached_kpe", "cached_segment_ids"} | (
        {"cached_ckv_scale", "cached_kpe_scale"} if kv_quant else set())
    for k in ("page", "kv_quant", "n_pages", "token", "pos", "remaining",
              "done", "cache_index"):
        assert a[k] == b[k], k
    assert de.pool.allocator.in_use == 1  # only the decoy is left


# ----------------------------------------------------------- speculation


def test_batch_speculation_with_latent_caches():
    """tpufw's test_speculative_decode_with_latent_cache on the port: a
    one-layer MLA draft speculating for the MLA target emits exactly the
    target's greedy continuation through both latent caches."""
    jmodel, params, model = _decode_pair("moe")
    draft = Deepseek(dataclasses.replace(model.cfg, n_layers=1), device="cpu",
                     seed=1)
    prompts = [[5, 6, 7], [9]]
    ref = generate_text(model, prompts, max_new_tokens=8, sampling=GREEDY)
    assert ref == j_generate_text(jmodel, params, prompts, max_new_tokens=8,
                                  sampling=J_GREEDY)
    spec, stats = speculative_generate_text(draft, model, prompts,
                                            max_new_tokens=8, k=3)
    assert spec == ref and stats["emitted"] == 8


@pytest.mark.parametrize("kind", ["slots", "paged"])
def test_pool_speculation_gives_greedy_tokens(kind):
    """spec_steps with oracle and reject-all proposals, and
    spec_draft_steps with the target as its own draft pool, emit the
    greedy tokens (a rejected pass rewinds the latent cursors)."""
    model = _decode_pair("first_dense")[2]
    prompts = [[1, 5, 9], [2, 7], [3]]
    max_new = 9
    want = _want("first_dense", prompts, max_new)

    def fresh(**kw):
        pool = _port_pool(model, kind, **kw)
        firsts = [_admit(pool, i, p, max_new - 1)
                  for i, p in enumerate(prompts)]
        return pool, {i: [f] for i, f in enumerate(firsts)}

    for proposer in ("oracle", "reject"):
        pool, rows = fresh()
        while any(len(r) < max_new for r in rows.values()):
            props = np.zeros((N_SLOTS, K), np.int64)
            for i, r in rows.items():
                if proposer == "oracle":
                    nxt = want[i][len(r):len(r) + K]
                    props[i, :len(nxt)] = nxt
                else:
                    props[i] = 255
            out, n_emit, _ = pool.spec_steps(props)
            for i, r in rows.items():
                r.extend(out[i, :int(n_emit[i])].tolist())
        assert [rows[i][:max_new] for i in sorted(rows)] == want, proposer
    pool, rows = fresh()
    kw = {"allocator": pool.allocator} if kind == "paged" else {}
    draft = _port_pool(model, kind, **kw)
    for i, p in enumerate(prompts):
        _admit(draft, i, p, max_new - 1)
    while any(len(r) < max_new for r in rows.values()):
        out, n_emit, _ = pool.spec_draft_steps(draft, k=K)
        for i, r in rows.items():
            r.extend(out[i, :int(n_emit[i])].tolist())
    assert [rows[i][:max_new] for i in sorted(rows)] == want


# --------------------------------------------------------------- serving


@pytest.mark.parametrize("page", [0, PAGE], ids=["contiguous", "paged"])
def test_scheduler_serves_a_deepseek_model(page, clear_tpufw_env):
    """The slot scheduler, contiguous or paged with the spill tier on an
    arena of 4 usable pages, gives generate_text's tokens for a DeepSeek
    MoE model: BASE's trie pages are hit, spilled to admit a 3-page row,
    and restored for BASE's second request."""
    model = _decode_pair("first_dense", 128)[2]
    clear_tpufw_env.setenv("TPUFW_SERVE_CHUNK", "2")
    if page:
        clear_tpufw_env.setenv("TPUFW_KV_SPILL", "64")
    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=GREEDY, page=page,
        arena_pages=5 if page else None)
    prompts = [BASE, BASE[:PAGE] + [99, 98], PROMPTS[0], BASE]
    try:
        got = [sched.submit([p], MAX_NEW)[0][0] for p in prompts]
        if page:
            assert sched.pool.prefix_hits >= 2
            assert sched.pool.spill_pages_out >= 1
            assert sched.pool.spill_pages_in >= 1
    finally:
        sched.close()
    assert got == generate_text(model, prompts, max_new_tokens=MAX_NEW,
                                sampling=GREEDY)


def test_tick_batcher_serves_a_deepseek_model(clear_tpufw_env):
    """TPUFW_SERVE_SLOTS=0: the tick server batches a DeepSeek model's
    requests with tpufw's generate_text tokens."""
    model = _decode_pair("moe", 128)[2]
    clear_tpufw_env.setenv("TPUFW_SERVE_SLOTS", "0")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    clear_tpufw_env.setattr(serve, "build_generator",
                            lambda: (model, model.cfg, False))
    srv = serve._Server(0, MAX_NEW)
    try:
        outs = srv.generate(PROMPTS, MAX_NEW)
    finally:
        srv.shutdown()
    assert outs[0] == _want("moe")


def test_roles_serve_a_deepseek_model_with_spec_and_chunks():
    """A chunked-prefill PrefillEngine and a speculative DecodeEngine with
    a spill tier take a DeepSeek model; the migrated tokens are greedy."""
    model = _decode_pair("first_dense")[2]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE,
                       prefill_chunk_pages=1)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, spec_k=K,
                      spill=SpillTier(8, None))
    got = [de.collect(de.submit(pe.prefill(p, MAX_NEW)))
           for p in (BASE, PROMPTS[1])]
    assert got == _want("first_dense", [BASE, PROMPTS[1]])


def test_per_layer_bundles_follow_tpufw_flatten_order():
    """An unscanned config's bundle lists its layers as tpufw flattens
    them (``layer_10`` before ``layer_2``), and a bundle whose per-layer
    leaves come in another order splices to the same arena bytes."""
    cfg = dataclasses.replace(
        DEEPSEEK_CONFIGS["deepseek_moe_tiny"], dtype=torch.float32,
        param_dtype=torch.float32, n_layers=11, first_k_dense=1,
        scan_layers=False, max_seq_len=SEQ).decode_config()
    model = Deepseek(cfg, device="cpu")
    src = _port_pool(model, "paged")
    _admit(src, 0, BASE, MAX_NEW - 1)
    state = src.export_slot(0)
    layers = list(dict.fromkeys(p.split("['")[2][:-2]
                                for p in state["paths"]))
    assert layers == sorted(f"layer_{i}" for i in range(11))
    assert layers[1:4] == ["layer_1", "layer_10", "layer_2"]
    order = sorted(range(len(state["paths"])), key=lambda i: (
        int(state["paths"][i].split("layer_")[1].split("'")[0]), i))
    shuffled = dict(state, **{k: [state[k][i] for i in order]
                              for k in ("paths", "arrays", "dtypes")})
    for st in (state, shuffled):
        dst = _port_pool(model, "paged")
        ids = dst.allocator.alloc(len(src.slot_pages[0]))
        dst.splice_slot(2, st, ids)
        for a, b in zip(src.cache, dst.cache):
            for f in ("ckv", "kpe", "seg"):
                assert torch.equal(getattr(a, f)[a.table[0]],
                                   getattr(b, f)[b.table[2]]), f
