"""Page migration in the port (``tpufw_torch.serve.roles``,
``PagedSlotPool.export_slot``/``splice_slot``) against ``tpufw``
(``tests/test_migrate.py``, the drain half of ``tests/test_spill.py``):

- PARITY: prompts prefilled on a ``PrefillEngine``, shipped as page
  bundles over the loopback wire and spliced into a ``DecodeEngine``
  whose arena holds a decoy page decode to the port's and ``tpufw``'s
  ``generate_text`` greedy tokens; with int8 KV to a never-migrated int8
  paged run of the port (codes and fp32 scales travel raw);
- ACROSS THE PACKAGES: ``tpufw``'s bundles splice into the port's decode
  engine and the port's into ``tpufw``'s, with the same tokens; both
  packages' bundles of one prompt carry the same paths, page counts and
  cursors, fp32 KV within 2e-4 and int8 codes within one step, and
  those only at rounding boundaries;
- ``splice_slot`` rejects a mismatched bundle before it writes;
- a bundle that arrives done releases its pages at submit; the
  scheduler's ``page_export`` hook exports the chunk-boundary snapshot of
  a row that finishes mid-chunk;
- DRAIN: a drained session resumes on a second decode engine with the
  undisturbed client tokens;
- sampled decoding draws the port's scheduler's streams.

llama3_tiny in fp32 (max_seq_len 64), page 16. The ids "bf16"/"int8"
follow ``tests/test_migrate.py``: "bf16" is the unquantized arena, in the
model's dtype (fp32 here).
"""

import functools
import json

import numpy as np
import pytest
import torch

from tests.torch_parity import decode_pair
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import generate_text as j_generate_text
from tpufw.serve import roles as j_roles
from tpufw_torch.infer import SamplingConfig, generate_text
from tpufw_torch.infer.spill import SpillTier
from tpufw_torch.serve import bundle
from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine
from tpufw_torch.serve.transport import LoopbackTransport
from tpufw_torch.workloads import serve

PAGE = 16
MAX_NEW = 6
SEQ = 64
GREEDY = SamplingConfig()
J_GREEDY = JSampling(temperature=0.0)
BASE = list(range(3, 37))  # 34 tokens = 2 full pages + tail
PROMPTS = [
    [1, 5, 9],
    [2, 7],
    BASE,
    BASE[:PAGE] + [99, 98],  # full-page prefix shared with BASE
]
KV = pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])


@functools.lru_cache(maxsize=None)
def _tiny():
    """(tpufw decode model, Flax params, the port's model) at SEQ."""
    return decode_pair(max_seq_len=SEQ)


def _engines(kv_quant="", decode_slots=4, **decode_kw):
    model = _tiny()[2]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE,
                       kv_quant=kv_quant, n_slots=2)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, kv_quant=kv_quant,
                      n_slots=decode_slots, chunk=2, **decode_kw)
    return pe, de


def _j_engines(kv_quant=""):
    jmodel, params, _ = _tiny()
    pe = j_roles.PrefillEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                               kv_quant=kv_quant, n_slots=2)
    de = j_roles.DecodeEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                              kv_quant=kv_quant, n_slots=4, chunk=2)
    return pe, de


def _migrate(pe, de, lt, prompt, max_new=MAX_NEW):
    """Prefill on A, ship the bundle over the loopback wire, splice into
    B. Returns B's slot handle."""
    lt.a.send(pe.prefill(prompt, max_new))
    return de.submit(lt.b.recv(timeout=5.0))


@functools.lru_cache(maxsize=None)
def _never_migrated(kv_quant):
    """Greedy tokens of PROMPTS from the port's paged scheduler (one pool,
    no migration) with ``kv_quant`` arenas."""
    model = _tiny()[2]
    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=GREEDY, page=PAGE,
        kv_quant=kv_quant, prefix_cache=True, spec_k=0,
        prefill_chunk_pages=0,
    )
    try:
        return sched.submit(PROMPTS, MAX_NEW)[0]
    finally:
        sched.close()


@KV
def test_migration_parity_llama(kv_quant, clear_tpufw_env):
    jmodel, params, model = _tiny()
    pe, de = _engines(kv_quant)
    lt = LoopbackTransport()
    # Pollute the decode arena: spliced physical ids differ from the
    # exported ones, so parity must come from the page table.
    assert de.pool.allocator.alloc(1) is not None
    got = [de.collect(s) for s in [_migrate(pe, de, lt, p) for p in PROMPTS]]
    want = generate_text(model, PROMPTS, max_new_tokens=MAX_NEW,
                         sampling=GREEDY)
    if kv_quant:
        assert got == _never_migrated("int8")
        # Whether int8 KV also gives the unquantized tokens (the
        # reference's tests/test_migrate.py asks for that and fails):
        print("int8 migrated == unquantized generate_text:", got == want)
    else:
        assert got == want
        assert got == j_generate_text(jmodel, params, PROMPTS,
                                      max_new_tokens=MAX_NEW,
                                      sampling=J_GREEDY)
    assert pe.migrations == len(PROMPTS) == de.migrations
    # The prefix-sharing prompt attached BASE's first page from the
    # prefill replica's trie (prefilled once, exported twice).
    assert pe.pool.prefix_hits == 1
    assert pe.pool.allocator.in_use > 0
    assert de.pool.allocator.in_use == 1  # only the decoy is left
    if kv_quant:
        state = bundle.decode_bundle(pe.prefill(BASE, MAX_NEW))
        scales = [a for p, a in zip(state["paths"], state["arrays"])
                  if p.endswith("_scale']")]
        assert len(scales) == 2
        assert all(a.dtype == np.float32 for a in scales)


@pytest.mark.parametrize("case", ["max_new1", "eos_first"])
def test_submit_time_done_job_releases_its_pages(case):
    """A bundle that arrives done (max_new=1, or EOS as the first token)
    never passes through a decode chunk, so submit releases its pages."""
    model = _tiny()[2]
    prompt = [1, 5, 9]
    first = generate_text(model, [prompt], max_new_tokens=1,
                          sampling=GREEDY)[0]
    if case == "max_new1":
        pe, de = _engines()
        max_new = 1
    else:
        pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, n_slots=2,
                           eos_id=first[0])
        de = DecodeEngine(model, sampling=GREEDY, page=PAGE, n_slots=4,
                          eos_id=first[0])
        max_new = MAX_NEW
    baseline = de.pool.allocator.in_use
    slot = _migrate(pe, de, LoopbackTransport(), prompt, max_new=max_new)
    assert de.pool.allocator.in_use == baseline, "submit-time-done leak"
    assert de.collect(slot) == first
    assert de.signals()["slots_active"] == 0


def _export_states(model, prompts, arena_pages):
    """PROMPTS through the port's paged scheduler with the page_export
    hook installed: (outputs, {prompt tuple: exported state})."""
    captured = {}

    def hook(job, state):
        captured[tuple(job.prompt)] = state

    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=GREEDY, seed_base=0,
        metrics=serve._Metrics(), page=PAGE, arena_pages=arena_pages,
        page_export=hook, spec_k=0, prefill_chunk_pages=0,
    )
    try:
        outs, _bw = sched.submit(prompts, MAX_NEW)
    finally:
        sched.close()
    assert sorted(captured) == sorted(tuple(p) for p in prompts)
    return outs, captured


def test_same_chunk_completion_exports_snapshot_pages(clear_tpufw_env):
    """Under arena contention the third row queues until an earlier
    retire frees pages, every row finishes MID-chunk (budget 5 < chunk
    8), and freed pages are granted again within the same pass. Each
    row's export must equal that prompt's export from an uncontended
    run: an export reading post-retire state sees granted-again or
    junk-sink pages."""
    jmodel, params, model = _tiny()
    # 30-token prompts = 3 pages each with the decode budget; an arena
    # of 6 usable pages holds two rows at once.
    prompts = [list(range(10 + i, 40 + i)) for i in range(3)]
    outs, contended = _export_states(model, prompts, arena_pages=7)
    assert outs == j_generate_text(jmodel, params, prompts,
                                   max_new_tokens=MAX_NEW,
                                   sampling=J_GREEDY)
    for p in prompts:
        _solo, solo = _export_states(model, [p], arena_pages=7)
        a, b = contended[tuple(p)], solo[tuple(p)]
        assert a["paths"] == b["paths"]
        assert a["n_pages"] == b["n_pages"] == 3
        for k in ("page", "kv_quant", "token", "pos", "remaining", "done"):
            assert a[k] == b[k], k
        for pa, pb, path in zip(a["arrays"], b["arrays"], a["paths"]):
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert pa.tobytes() == pb.tobytes(), path


# ------------------------------------------------ across the packages


@KV
def test_jax_bundle_splices_into_port_decode(kv_quant):
    """``tpufw``'s PrefillEngine exports, the port's DecodeEngine splices
    and decodes: unquantized, ``tpufw``'s generate_text tokens; int8,
    the tokens ``tpufw``'s own DecodeEngine decodes from the same
    bundles."""
    jmodel, params, _ = _tiny()
    jpe, jde = _j_engines(kv_quant)
    _, de = _engines(kv_quant)
    assert de.pool.allocator.alloc(1) is not None  # decoy
    datas = [jpe.prefill(p, MAX_NEW) for p in PROMPTS]
    got = [de.collect(de.submit(d)) for d in datas]
    if kv_quant:
        want = [jde.collect(jde.submit(d)) for d in datas]
    else:
        want = j_generate_text(jmodel, params, PROMPTS,
                               max_new_tokens=MAX_NEW, sampling=J_GREEDY)
    assert got == want


@KV
def test_port_bundle_splices_into_jax_decode(kv_quant):
    """The other way: the port's PrefillEngine exports, ``tpufw``'s
    DecodeEngine splices and decodes the port's tokens."""
    jmodel, params, _ = _tiny()
    _, jde = _j_engines(kv_quant)
    pe, de = _engines(kv_quant)
    datas = [pe.prefill(p, MAX_NEW) for p in PROMPTS]
    got = [jde.collect(jde.submit(d)) for d in datas]
    want = [de.collect(de.submit(d)) for d in datas]
    assert got == want
    if not kv_quant:
        assert got == j_generate_text(jmodel, params, PROMPTS,
                                      max_new_tokens=MAX_NEW,
                                      sampling=J_GREEDY)


@KV
def test_bundles_agree_across_packages(kv_quant):
    jpe, _ = _j_engines(kv_quant)
    pe, _ = _engines(kv_quant)
    fp = {}
    if kv_quant:
        # The unquantized K/V of the same prompt locates the int8
        # rounding boundaries.
        fp = bundle.decode_bundle(_engines("")[0].prefill(BASE, MAX_NEW))
    for prompt in (BASE, [2, 7]):
        a = bundle.decode_bundle(pe.prefill(prompt, MAX_NEW))
        b = bundle.decode_bundle(jpe.prefill(prompt, MAX_NEW))
        assert a["paths"] == b["paths"]
        for k in ("page", "kv_quant", "n_pages", "token", "pos",
                  "remaining", "done", "cache_index"):
            assert a[k] == b[k], k
        for x, y, path in zip(a["arrays"], b["arrays"], a["paths"]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, path
            if x.dtype == np.int8:
                d = np.abs(x.astype(np.int32) - y.astype(np.int32))
                assert d.max() <= 1, path
                if d.any() and prompt is BASE:
                    # Only where x / scale sits on a .5 boundary.
                    leaf = "key" if "key" in path else "value"
                    ref = fp["arrays"][fp["paths"].index(path)]
                    scale = a["arrays"][a["paths"].index(
                        path.replace(f"cached_{leaf}",
                                     f"cached_{leaf}_scale"))]
                    q = np.abs(ref / scale[..., None, None])
                    off = np.abs(q - np.floor(q) - 0.5)
                    assert off[d > 0].max() < 1e-2, path
            elif x.dtype == np.int32:
                assert np.array_equal(x, y), path
            else:
                np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4,
                                           err_msg=path)


# ----------------------------------------------------- splice checks


def _bad_state(state, case):
    if case == "page":
        return dict(state, page=8)
    if case == "kv_quant":
        return dict(state, kv_quant="int8")
    if case == "too_few":
        return dict(state, n_pages=state["n_pages"] + 5)
    if case == "layout":
        paths = list(state["paths"])
        paths[0] = paths[0].replace("['layers']", "['layer_0']")
        return dict(state, paths=paths)
    return dict(state, seen=np.zeros(8, bool))  # "seen": one-sided


@pytest.mark.parametrize(
    "case", ["page", "kv_quant", "too_few", "layout", "seen"])
def test_splice_rejects_before_writing(case):
    pe, de = _engines()
    state = bundle.decode_bundle(pe.prefill(BASE, MAX_NEW))
    ids = de.pool.allocator.alloc(state["n_pages"])
    before = [t.clone() for c in de.pool.cache
              for t in (c.key, c.value, c.seg, c.table, c.index)]
    cursors = [t.clone() for t in (de.pool.token, de.pool.pos,
                                   de.pool.done, de.pool.remaining)]
    with pytest.raises(ValueError):
        de.pool.splice_slot(0, _bad_state(state, case), ids)
    after = [t for c in de.pool.cache
             for t in (c.key, c.value, c.seg, c.table, c.index)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert all(torch.equal(x, y) for x, y in zip(
        cursors, (de.pool.token, de.pool.pos, de.pool.done,
                  de.pool.remaining)))
    de.pool.splice_slot(0, state, ids)  # the unchanged state splices


# ----------------------------------------------------- drain / resume


@KV
def test_drained_session_resumes_with_zero_divergence(tmp_path, kv_quant):
    """A session decoding on replica A is drained: its slot exports as a
    session bundle to the shared spill directory, replica B restores it
    through the normal splice path, and the client's tokens equal the
    undisturbed control."""
    model = _tiny()[2]
    prompt = BASE
    pe, de_c = _engines(kv_quant)
    want = de_c.collect(de_c.submit(pe.prefill(prompt, 12)))
    common = dict(sampling=GREEDY, page=PAGE, kv_quant=kv_quant, chunk=2,
                  n_slots=4)
    de_a = DecodeEngine(model, spill=SpillTier(64, str(tmp_path)), **common)
    de_b = DecodeEngine(model, spill=SpillTier(64, str(tmp_path)), **common)
    slot = de_a.submit(pe.prefill(prompt, 12, session="mig"))
    with de_a._cv:
        de_a._run_chunk_locked()  # two tokens decode before the drain
    drained = de_a.drain()
    assert drained == {"drained": True, "sessions": ["mig"], "dropped": 0}
    out_a = de_a.collect_ex(slot)
    assert out_a["drained"] is True and out_a["session"] == "mig"
    assert len(out_a["tokens"]) == 3
    assert de_a.pool.allocator.in_use == 0
    data = bundle.load_session(str(tmp_path), "mig")
    assert data is not None
    out = de_b.collect_ex(de_b.submit(data))
    assert out["tokens"] == want, "token divergence across the drain"
    assert de_a.sessions_drained == 1 and de_b.sessions_resumed == 1
    assert de_b.signals()["sessions_resumed"] == 1
    assert de_b.pool.allocator.in_use == 0  # retired clean
    assert de_a.signals()["draining"] == 1
    with pytest.raises(RuntimeError, match="draining"):
        de_a.submit(data)
    assert de_a.drain() == {"drained": True, "sessions": [], "dropped": 0}


def test_draining_engine_refuses_piggyback():
    pe, de = _engines(prefill_chunk_pages=1, piggyback=0.25)
    assert de.can_piggyback(2)
    de.drain()
    assert not de.can_piggyback(2) and not de.can_accept(1)
    with pytest.raises(RuntimeError, match="draining"):
        de.submit_raw([1, 5, 9], 4)


def test_piggyback_prefill_gives_migrated_tokens():
    """A raw prompt prefilled chunk by chunk inside the decode replica's
    passes decodes the tokens of the prefill -> bundle path."""
    model = _tiny()[2]
    _, de = _engines(prefill_chunk_pages=1, piggyback=0.25)
    want = generate_text(model, [BASE], max_new_tokens=MAX_NEW,
                         sampling=GREEDY)[0]
    out = de.collect_ex(de.submit_raw(BASE, MAX_NEW, session="s"))
    assert out["tokens"] == want
    assert out["piggyback"] is True and out["prefill_chunks"] == 3
    assert de.pool.allocator.in_use == 2  # the trie keeps BASE's pages


def test_chunked_prefill_engine_exports_prompt_pages():
    """A chunked prefill engine's bundle carries the prompt's pages only;
    the decode side allocates the budget's tail and decodes the same
    tokens."""
    model = _tiny()[2]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, n_slots=2,
                       prefill_chunk_pages=1)
    _, de = _engines()
    data = pe.prefill(BASE, 20)
    state = bundle.decode_bundle(data)
    assert state["n_pages"] == 3  # 34 prompt tokens, no budget pages
    assert set(state["trace"]["stages"]) == {
        "queue", "admit", "queue_chunks", "compute", "export"}
    assert pe.prefill_chunks == 3
    assert de.collect(de.submit(data)) == generate_text(
        model, [BASE], max_new_tokens=20, sampling=GREEDY)[0]


def test_speculative_decode_engine_gives_greedy_tokens():
    model = _tiny()[2]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, n_slots=2)
    _, de = _engines(spec_k=3)
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5]
    got = de.collect(de.submit(pe.prefill(prompt, 12)))
    assert got == generate_text(model, [prompt], max_new_tokens=12,
                                sampling=GREEDY)[0]
    assert de.spec_passes > 0


def test_sampled_request_draws_the_schedulers_streams(clear_tpufw_env):
    """temperature > 0: one request through prefill -> bundle -> decode
    draws the streams the port's paged scheduler draws for it alone (a
    step's draws span every slot, so both pools have the scheduler's 8),
    so the sampled tokens are equal."""
    model = _tiny()[2]
    hot = SamplingConfig(temperature=0.9, top_k=20)
    clear_tpufw_env.setenv("TPUFW_SERVE_CHUNK", "4")
    sched = serve._SlotScheduler(
        model, eos_id=None, default_sampling=hot, seed_base=3, page=PAGE,
        spec_k=0, prefill_chunk_pages=0,
    )
    try:
        want = sched.submit([BASE], 11)[0][0]
    finally:
        sched.close()
    pe = PrefillEngine(model, sampling=hot, page=PAGE, seed_base=3)
    de = DecodeEngine(model, sampling=hot, page=PAGE, seed_base=3, chunk=4,
                      n_slots=8)
    got = de.collect(de.submit(pe.prefill(BASE, 11)))
    assert got == want
    # A different seed draws other tokens (the streams are not inert).
    pe = PrefillEngine(model, sampling=hot, page=PAGE, seed_base=4)
    de = DecodeEngine(model, sampling=hot, page=PAGE, seed_base=4, chunk=4,
                      n_slots=8)
    assert de.collect(de.submit(pe.prefill(BASE, 11))) != want


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_migration_parity_deepseek_mla(kv_quant):
    """tpufw's test_migration_parity_deepseek_mla on the port: both roles
    take the DeepSeek model, its latent pages migrate into a polluted
    decode arena, and the tokens are tpufw's engines' (unquantized:
    generate_text's). tests/test_torch_latent_pools.py covers the MoE
    models and the bundles across the packages."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from tpufw.models.deepseek import DEEPSEEK_CONFIGS as J_CONFIGS
    from tpufw.models.deepseek import Deepseek as JDeepseek
    from tpufw_torch.interop import params_from_flax
    from tpufw_torch.models import model_for_config
    from tpufw_torch.models.deepseek import DEEPSEEK_CONFIGS

    jcfg = dataclasses.replace(J_CONFIGS["deepseek_tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32, max_seq_len=SEQ)
    cfg = dataclasses.replace(DEEPSEEK_CONFIGS["deepseek_tiny"],
                              dtype=torch.float32, param_dtype=torch.float32,
                              max_seq_len=SEQ)
    params = jax.device_get(meta.unbox(jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = model_for_config(cfg.decode_config(), device="cpu")
    model.load_state_dict(params_from_flax(params, cfg))
    jmodel = JDeepseek(jcfg.decode_config())
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, kv_quant=kv_quant)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, kv_quant=kv_quant,
                      n_slots=4, chunk=2)
    assert de.pool.allocator.alloc(1) is not None  # decoy
    lt = LoopbackTransport()
    got = [de.collect(s) for s in [_migrate(pe, de, lt, p) for p in PROMPTS]]
    jpe = j_roles.PrefillEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                                kv_quant=kv_quant, n_slots=2)
    jde = j_roles.DecodeEngine(jmodel, params, sampling=J_GREEDY, page=PAGE,
                               kv_quant=kv_quant, n_slots=4, chunk=2)
    assert got == [jde.collect(jde.submit(jpe.prefill(p, MAX_NEW)))
                   for p in PROMPTS]
    if not kv_quant:
        assert got == j_generate_text(jmodel, params, PROMPTS,
                                      max_new_tokens=MAX_NEW,
                                      sampling=J_GREEDY)
    assert pe.migrations == de.migrations == len(PROMPTS)
    assert pe.pool.prefix_hits == 1


def test_role_telemetry_writes_schema_checked_events(clear_tpufw_env,
                                                     tmp_path):
    """``TPUFW_TELEMETRY_DIR`` gives each role its event log and trace:
    a chunked prefill, a migration, a speculative decode and a drain emit
    events that pass the schema, and the request's stage spans carry its
    trace id in both roles' traces."""
    from tpufw_torch.obs import events, reqtrace
    from tpufw_torch.serve.roles import role_telemetry

    clear_tpufw_env.setenv("TPUFW_TELEMETRY_DIR", str(tmp_path))
    model = _tiny()[2]
    (pev, ptr), (dev, dtr) = role_telemetry("prefill"), role_telemetry(
        "decode")
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE,
                       prefill_chunk_pages=1, events=pev, tracer=ptr)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, spec_k=3,
                      spill=SpillTier(8, str(tmp_path / "s")), events=dev,
                      tracer=dtr)
    ctx = reqtrace.mint("vip")
    out = de.collect_ex(de.submit(pe.prefill(BASE, MAX_NEW,
                                             trace=ctx.wire())))
    assert out["tokens"] == generate_text(model, [BASE],
                                          max_new_tokens=MAX_NEW,
                                          sampling=GREEDY)[0]
    de.drain()
    for log in (pev, ptr, dev, dtr):
        log.close()
    kinds = {e["kind"] for e in events.read_events(
        str(tmp_path / "events-prefill.jsonl"))}
    assert {"serve_prefill_chunk", "serve_migration"} <= kinds
    kinds = {e["kind"] for e in events.read_events(
        str(tmp_path / "events-decode.jsonl"))}
    assert {"serve_migration", "serve_spec", "serve_spill"} <= kinds
    for role, span in (("prefill", "req_prefill_compute"),
                       ("decode", "req_splice")):
        doc = json.loads((tmp_path / f"trace-{role}.json").read_text())
        hits = [e for e in doc["traceEvents"] if e.get("name") == span]
        assert hits and hits[0]["args"]["trace"] == ctx.trace_id
