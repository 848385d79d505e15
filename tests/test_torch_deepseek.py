"""tpufw_torch DeepSeek-V2 (dense MLA) vs the tpufw Flax Deepseek in fp32,
with the Flax weights moved into the port through ``params_from_flax``.

The same numpy-seeded tokens go through both packages: parameter counts,
logits (full-rank q and q-LoRA, scanned and unscanned trees), yarn and the
interleaved rope, the flash backend (the kernels' plain versions here, JAX
in interpret mode), gradients and three trainer steps, the absorbed
latent-cache decode (against the expanded forward and against JAX's
decode), greedy tokens, int8 codes and logits, the refusals and the
serving paths that take a DeepSeek model. The
tolerance is the reference's 2e-4 (tests/conftest.py) unless stated.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models.deepseek import DEEPSEEK_CONFIGS as J_CONFIGS
from tpufw.models.deepseek import Deepseek as JDeepseek
from tpufw.models.deepseek import YarnScaling as JYarn
from tpufw.models.deepseek import _yarn_freqs as j_yarn_freqs
from tpufw.models.deepseek import apply_rope_interleaved as j_rope
from tpufw.ops import quant as j_quant
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.infer import generate_text
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import DEEPSEEK_CONFIGS, Deepseek
from tpufw_torch.models import deepseek as tds
from tpufw_torch.ops import quant
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.trainer import cross_entropy_loss

j_generate = importlib.import_module("tpufw.infer.generate")
TOL = dict(rtol=2e-4, atol=2e-4)
PRESETS = ("deepseek_tiny", "deepseek_tiny_qlora")
PROMPTS = [[5, 6, 7, 81, 2], [9], [200, 14, 3]]


def _pair(name="deepseek_tiny", scan_layers=True, **overrides):
    """(JAX config, port config) of ``name`` in fp32."""
    jcfg = dataclasses.replace(
        J_CONFIGS[name], dtype=jnp.float32, param_dtype=jnp.float32,
        scan_layers=scan_layers, **overrides,
    )
    tcfg = dataclasses.replace(
        DEEPSEEK_CONFIGS[name], dtype=torch.float32,
        param_dtype=torch.float32, **overrides,
    )
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _flax_params(name="deepseek_tiny", scan_layers=True):
    """Host Flax params of fp32 ``name`` from key 0. The norms are set to
    random values near 1 so that a norm read from the wrong place shows."""
    jcfg, _ = _pair(name, scan_layers)
    params = jax.jit(JDeepseek(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)
    )["params"]
    params = jax.device_get(meta.unbox(params))
    rng = np.random.default_rng(7)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (fill(v) if k != "scale" else (
                1.0 + 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32))
                for k, v in tree.items()}
        return tree

    return fill(params)


def _port(tcfg, params):
    model = Deepseek(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    return model


def _tokens(seed=0, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int64)


def _jlogits(jcfg, params, tokens, **kw):
    return np.asarray(JDeepseek(jcfg).apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32), **kw))


# ----------------------------------------------------------------------
# Configuration and weights
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", [*PRESETS, "deepseek_mla_bench"])
def test_param_count_and_flops_match_jax(name):
    """The port's model holds JAX's ``n_params`` parameters (the bench
    preset on the meta device: shapes only), and both configs give the
    same analytic counts and FLOPs."""
    jcfg, tcfg = J_CONFIGS[name], DEEPSEEK_CONFIGS[name]
    model = Deepseek(tcfg, device="meta" if name.endswith("bench") else "cpu")
    assert sum(p.numel() for p in model.parameters()) == jcfg.n_params()
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_params(False) == jcfg.n_params(False)
    assert tcfg.flops_per_token(2047) == jcfg.flops_per_token(2047)
    assert tcfg.qk_head_dim == jcfg.qk_head_dim
    if name.endswith("bench"):
        assert tcfg.qk_head_dim == 192 and tcfg.attention_backend == "flash"
        assert jcfg.n_params() == 649_378_816


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unscanned"])
@pytest.mark.parametrize("name", PRESETS)
def test_logits_match_flax(name, scan_layers):
    jcfg, tcfg = _pair(name, scan_layers)
    params = _flax_params(name, scan_layers)
    sd = params_from_flax(params, tcfg)
    model = Deepseek(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    tokens = _tokens(1)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _jlogits(jcfg, params, tokens),
                               **TOL)


@pytest.mark.parametrize("yarn", ["v2_lite", "mscale_all_dim_only"])
def test_yarn_and_interleaved_rope_match_jax(yarn):
    """The yarn ramp (truncate semantics included), the attention factor
    and the interleaved rotation equal JAX's: V2-Lite's scaling (factor 40,
    mscale = mscale_all_dim = 0.707, factor 1 exactly) at its 64 rope
    dims, and mscale_all_dim alone (the plain get_mscale branch)."""
    if yarn == "v2_lite":
        kw = dict(factor=40.0, original_max_position_embeddings=4096,
                  mscale=0.707, mscale_all_dim=0.707)
        d, positions = 64, np.arange(0, 8192, 97)
    else:
        kw = dict(factor=8.0, original_max_position_embeddings=32,
                  mscale_all_dim=0.6)
        d, positions = 8, np.arange(0, 256, 3)
    js, ts = JYarn(**kw), tds.YarnScaling(**kw)
    assert ts.resolved_attention_factor() == pytest.approx(
        js.resolved_attention_factor(), rel=1e-12)
    if yarn == "v2_lite":
        assert ts.resolved_attention_factor() == 1.0
    np.testing.assert_allclose(
        tds._yarn_freqs(d, 10_000.0, ts).numpy(),
        np.asarray(j_yarn_freqs(d, 10_000.0, js)), rtol=1e-6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, len(positions), 3, d)).astype(np.float32)
    pos = np.stack([positions, positions[::-1]]).astype(np.int32)
    for scaling in (None, (js, ts)):
        want = j_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                      None if scaling is None else scaling[0])
        got = tds.apply_rope_interleaved(
            torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
            None if scaling is None else scaling[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_backend_matches_jax_flash_and_xla():
    """MLA through the flash kernels' plain versions (V zero-padded to the
    qk head dim) against JAX's flash backend in interpret mode, and against
    the port's own plain backend, at 64 tokens."""
    jcfg, tcfg = _pair(attention_backend="flash")
    params = _flax_params()
    tokens = _tokens(7, (1, 64))
    flash = _port(tcfg, params)
    plain = _port(dataclasses.replace(tcfg, attention_backend="xla"), params)
    with torch.no_grad():
        got = flash(torch.from_numpy(tokens))
        ref = plain(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _jlogits(jcfg, params, tokens),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_grads_match_jax(backend):
    """Gradients of a token CE (no z-loss) with packed segments equal
    JAX's, leaf by leaf, through the weight bridge."""
    jcfg, tcfg = _pair(attention_backend=backend)
    params = _flax_params()
    tokens = _tokens(2, (2, 33))
    seg = np.ones((2, 32), np.int32)
    seg[0, 20:] = 2
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits = JDeepseek(jcfg).apply(
            {"params": p}, jnp.asarray(inputs, jnp.int32),
            segment_ids=jnp.asarray(seg))
        lp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(
            lp, jnp.asarray(targets)[..., None], -1).mean()

    jl, jg = jax.value_and_grad(jloss)(params)
    model = _port(tcfg, params)
    logits = model(torch.from_numpy(inputs), segment_ids=torch.from_numpy(seg))
    loss, _ = cross_entropy_loss(logits, torch.from_numpy(targets),
                                 z_loss_weight=0.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = params_from_flax(jax.device_get(jg), tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_three_trainer_steps_match_flax(devices8):
    """Same init, same synthetic batches, same optimizer, chunked CE: every
    step's loss agrees to 1e-4 relative (the rule of
    test_torch_trainer.py)."""
    jcfg, tcfg = _pair(remat=True)
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=1e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    jt = JTrainer(JDeepseek(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(meta.unbox(jt.state.params))
    j_hist = jt.run(synthetic_batches(8, 33, jcfg.vocab_size, seed=3),
                    model_flops_per_token=jcfg.flops_per_token(32))
    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    model = tt.init_state(state_dict=params_from_flax(params, tcfg))
    assert isinstance(model, Deepseek)
    t_hist = tt.run(synthetic_batches(8, 33, tcfg.vocab_size, seed=3),
                    model_flops_per_token=tcfg.flops_per_token(32))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose(
        [m.loss for m in t_hist], [m.loss for m in j_hist], rtol=1e-4
    )


# ----------------------------------------------------------------------
# Absorbed latent-cache decode
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_absorbed_decode_matches_expanded_and_jax(name):
    """A whole prefill through the latent cache, then the same tokens one
    at a time through a fresh cache: each step's logits equal the expanded
    (training) forward's at that position, and JAX's decode logits."""
    jcfg, tcfg = _pair(name, max_seq_len=32)
    params = _flax_params(name)
    t = 12
    tokens = _tokens(4, (2, t))
    train = _port(tcfg, params)
    dmodel = _port(tcfg.decode_config(), params)
    tok = torch.from_numpy(tokens)
    pos = torch.arange(t).expand(2, t)
    with torch.no_grad():
        want = train(tok)
        cache = dmodel.init_cache(2)
        assert isinstance(cache[0], tds.LatentCache)
        assert cache[0].ckv.shape == (2, 32, tcfg.kv_lora_rank)
        prefill = dmodel(tok, pos, cache=cache)
        np.testing.assert_allclose(prefill.numpy(), want.numpy(), **TOL)
        assert cache[0].index == t
        cache = dmodel.init_cache(2)
        steps = torch.cat([dmodel(tok[:, i:i + 1], pos[:, i:i + 1],
                                  cache=cache) for i in range(t)], dim=1)
    np.testing.assert_allclose(steps.numpy(), want.numpy(), **TOL)

    jd = JDeepseek(jcfg.decode_config())
    jpos = jnp.broadcast_to(jnp.arange(t), (2, t))
    jtok = jnp.asarray(tokens, jnp.int32)
    jcache = jd.init(jax.random.key(2), jtok[:, :1],
                     positions=jpos[:, :1])["cache"]
    jcache = jax.tree.map(jnp.zeros_like, jcache)
    step = jax.jit(functools.partial(jd.apply, mutable=["cache"]))
    for i in range(t):
        logits, upd = step({"params": params, "cache": jcache},
                           jtok[:, i:i + 1], positions=jpos[:, i:i + 1])
        jcache = upd["cache"]
        np.testing.assert_allclose(steps[:, i].numpy(),
                                   np.asarray(logits[:, 0]),
                                   err_msg=f"step {i}", **TOL)


def test_generate_with_latent_cache_matches_jax_greedy():
    """Ragged left-padded prompts through ``generate_text`` (the latent
    cache, slot causality, the pad segment) give JAX's greedy tokens."""
    jcfg, tcfg = _pair(max_seq_len=64)
    params = _flax_params()
    want = j_generate.generate_text(
        JDeepseek(jcfg.decode_config()), params, PROMPTS, max_new_tokens=8)
    got = generate_text(_port(tcfg.decode_config(), params), PROMPTS,
                        max_new_tokens=8)
    assert got == want
    assert all(len(o) == 8 for o in got)


# ----------------------------------------------------------------------
# int8 weights
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_int8_codes_and_logits_match_jax(name):
    """The port's ``quantize_params`` gives JAX's codes (eager, as the JAX
    serve path calls it) on the MLA projections, the MLP and the head;
    ``kv_b_kernel`` and the norms stay fp; the int8 model's logits equal
    JAX's int8 model's, decoding through the latent cache too."""
    jcfg, tcfg = _pair(name, max_seq_len=32)
    fp = _flax_params(name)
    jq = jax.device_get(j_quant.quantize_params(fp))
    qcfg = dataclasses.replace(tcfg, quantized_weights=True)
    want = params_from_flax(jq, qcfg)
    got = quant.quantize_params(params_from_flax(fp, tcfg))
    model = Deepseek(qcfg, device="cpu")
    assert got.keys() == want.keys() == model.state_dict().keys()
    int8 = sorted(k for k, v in got.items() if v.dtype == torch.int8)
    assert not any("kv_b" in k or "norm" in k for k in int8)
    assert any(".kv_a." in k for k in int8) and "lm_head.weight" in int8
    assert got["layers.0.attn.kv_b_kernel"].dtype == torch.float32
    for k, w in want.items():
        if w.dtype == torch.int8:
            assert torch.equal(got[k], w), k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)
    model.load_state_dict(got)
    tokens = _tokens(5, (2, 10))
    jqcfg = dataclasses.replace(jcfg, quantized_weights=True)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(),
                               _jlogits(jqcfg, jq, tokens), **TOL)
    dmodel = Deepseek(qcfg.decode_config(), device="cpu")
    dmodel.load_state_dict(got)
    assert generate_text(dmodel, PROMPTS, max_new_tokens=6) == (
        j_generate.generate_text(JDeepseek(jqcfg.decode_config()), jq,
                                 PROMPTS, max_new_tokens=6))


# ----------------------------------------------------------------------
# Workloads and refusals
# ----------------------------------------------------------------------


def test_workloads_build_deepseek_for_deepseek_presets(clear_tpufw_env):
    """TPUFW_MODEL=deepseek_tiny gives the train workload a DeepseekConfig
    (its trainer builds a Deepseek), the serve workload a Deepseek decode
    model and its int8 twin, and run_batch in-vocab tokens."""
    from tpufw_torch.models import DeepseekConfig
    from tpufw_torch.workloads import serve, train_llama

    clear_tpufw_env.setenv("TPUFW_MODEL", "deepseek_tiny")
    clear_tpufw_env.setenv("TPUFW_DEVICE", "cpu")
    trainer, cfg = train_llama.build_trainer()
    assert isinstance(cfg, DeepseekConfig)
    assert isinstance(trainer.init_state(), Deepseek)
    model, cfg, restored = serve.build_generator()
    assert isinstance(model, Deepseek) and model.cfg.decode and not restored
    qmodel = serve.quantize_model(model)
    assert isinstance(qmodel, Deepseek) and qmodel.cfg.quantized_weights
    clear_tpufw_env.setenv("TPUFW_QUANTIZE", "int8")
    rows = serve.run_batch([[1, 2, 3], [4]], 5)
    assert [len(r["output"]) for r in rows] == [5, 5]
    assert all(0 <= t < 256 for r in rows for t in r["output"])
    clear_tpufw_env.setenv("TPUFW_MODEL", "deepseek_v9")
    with pytest.raises(ValueError, match="deepseek_mla_bench"):
        train_llama.build_trainer()


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_sp_backends_match_xla_on_a_sequence_ring(backend):
    """MLA sequence parallelism over a ring of 2 shards in one process
    (``LocalSequenceGroup``, the counterpart of ``tpufw``'s sequence=2
    mesh): ring (the einsum ring on the CPU) and Ulysses (exchanging the
    padded V like flash) match the port's whole-sequence xla backend and
    JAX's xla Deepseek, as ``tests/test_deepseek.py`` holds JAX's."""
    from tpufw_torch.parallel import LocalSequenceGroup, use_mesh

    jcfg, tcfg = _pair()
    params = _flax_params()
    tokens = _tokens(9, (4, 32))
    plain = _port(tcfg, params)
    sp = _port(dataclasses.replace(tcfg, attention_backend=backend), params)
    with torch.no_grad():
        ref = plain(torch.from_numpy(tokens))
        with use_mesh(LocalSequenceGroup(2)):
            got = sp(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    want = jax.jit(JDeepseek(jcfg).apply)({"params": params},
                                          jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unknown_backend_refused():
    """xla/flash/ring/ulysses are the MLA backends; anything else fails
    loudly, as in ``tpufw``."""
    cfg = dataclasses.replace(DEEPSEEK_CONFIGS["deepseek_tiny"],
                              attention_backend="splash")
    with pytest.raises(NotImplementedError, match="splash"):
        Deepseek(cfg, device="cpu")


def test_kv_page_belongs_to_the_cache():
    """As for Llama, a paged config is refused: the paging belongs to the
    cache (``init_paged_cache``), so one set of weights serves every
    pool."""
    cfg = dataclasses.replace(DEEPSEEK_CONFIGS["deepseek_tiny"], kv_page=16,
                              kv_pages=9)
    with pytest.raises(NotImplementedError, match="init_paged_cache"):
        Deepseek(cfg, device="cpu")


def test_moe_preset_builds_with_its_experts():
    """deepseek_moe_tiny builds with routed and shared experts on every
    layer (tests/test_torch_deepseek_moe.py holds it against tpufw)."""
    model = Deepseek(DEEPSEEK_CONFIGS["deepseek_moe_tiny"], device="cpu")
    moe = model.layers[0].moe
    assert moe.routed.w_gate.shape == (4, 48, 64)
    assert moe.shared.gate.weight.shape == (48, 64)
    assert sum(p.numel() for p in model.parameters()) == \
        model.cfg.n_params()


@pytest.mark.parametrize("path", ["slot_pool", "paged_pool", "per_row_cache",
                                  "scheduler", "speculative"])
def test_serving_paths_take_a_deepseek_model(path):
    """The paths that keep a slot pool, pages or a speculative cache take
    a DeepSeek model: each gives generate_text's greedy tokens
    (tests/test_torch_latent_pools.py holds them against tpufw)."""
    from tpufw_torch.infer import (PagedSlotPool, SamplingConfig, SlotPool,
                                   generate_text, prefill_row,
                                   speculative_generate_text)
    from tpufw_torch.workloads import serve

    cfg = DEEPSEEK_CONFIGS["deepseek_tiny"].decode_config()
    model = Deepseek(dataclasses.replace(cfg, dtype=torch.float32),
                     device="cpu")
    prompt, n = [1, 2, 3], 4
    want = generate_text(model, [prompt], max_new_tokens=n)[0]
    greedy = SamplingConfig()

    def pool_tokens(pool):
        cache, _f, first, _d, seen = prefill_row(
            model, prompt, None, sampling=greedy, eos_id=None,
            cache_len=pool.cache_len)
        if isinstance(pool, PagedSlotPool):
            ids, _ = pool.acquire_pages(prompt, len(prompt) + n)
            pool.insert_paged(0, cache, first, len(prompt), n - 1, ids, 0,
                              row_seen=seen)
        else:
            pool.insert(0, cache, first, len(prompt), n - 1, row_seen=seen)
        return [first] + pool.decode_steps(n - 1)[0].tolist()

    if path == "slot_pool":
        got = pool_tokens(SlotPool.create(model, 2, cache_len=64))
    elif path == "paged_pool":
        got = pool_tokens(PagedSlotPool.create_paged(
            model, 2, cache_len=64, page=16, sampling=greedy))
    elif path == "per_row_cache":
        cache = model.init_cache(2, per_row=True)
        assert cache[0].index.shape == (2,)
        got = want
    elif path == "scheduler":
        sched = serve._SlotScheduler(model, page=0, default_sampling=greedy)
        try:
            got = sched.submit([prompt], n)[0][0]
        finally:
            sched.close()
    else:
        got = speculative_generate_text(model, model, [prompt],
                                        max_new_tokens=n)[0][0]
    assert got == want
