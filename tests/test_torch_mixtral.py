"""tpufw_torch Mixtral vs the tpufw Flax Mixtral on ``mixtral_tiny`` in
fp32, with the Flax weights moved into the port through
``params_from_flax`` (norm scales drawn at random so that a norm read from
the wrong place shows).

Parity, at tests/conftest.py's 2e-4: logits and the router aux loss in
both dispatch modes on a scanned and an unscanned tree, with left padding
(segment 0, which takes no expert capacity) and a capacity that drops
tokens; gradients; three trainer steps (the aux enters the loss on the
chunked and the full-logit path); the analytic counts; greedy tokens of
``generate``; a ``SlotPool`` and a ``PagedSlotPool`` with idle slots and
uneven occupancy at capacity factor 1.0, where every pool step routes the
idle slots too, so the ``valid`` mask must be ``tpufw``'s; one slot
migrated from a prefill engine to a decode engine. On the port alone:
cached decode against prefill at a dropless capacity, the remat policies
bit-equal to "everything", a checkpoint round trip, and a Mixtral
checkpoint refused by a Llama trainer.
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
from tpufw.infer import SamplingConfig as JSampling
from tpufw.infer import pages as j_pages
from tpufw.infer import slots as j_slots
from tpufw.mesh import MeshConfig
from tpufw.models.mixtral import MIXTRAL_CONFIGS as J_CONFIGS
from tpufw.models.mixtral import Mixtral as JMixtral
from tpufw.serve import roles as j_roles
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train.trainer import batch_loss as j_batch_loss
from tpufw_torch.infer import (
    PagedSlotPool,
    SamplingConfig,
    SlotPool,
    generate_text,
    prefill_row,
)
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS, MIXTRAL_CONFIGS, Mixtral
from tpufw_torch.models.llama import REMAT_POLICIES
from tpufw_torch.serve.roles import DecodeEngine, PrefillEngine
from tpufw_torch.serve.transport import LoopbackTransport
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.trainer import batch_loss

j_generate = importlib.import_module("tpufw.infer.generate")
TOL = dict(rtol=2e-4, atol=2e-4)
T = 40
SEQ = 64
PAGE = 16
GREEDY = SamplingConfig()
J_GREEDY = JSampling(temperature=0.0)
PROMPTS = [
    np.random.default_rng(1).integers(1, 256, n).tolist() for n in (29, 3, 11)
]
MAX_NEW = 6


def _pair(scan_layers=True, **overrides):
    """(JAX config, port config) of mixtral_tiny in fp32."""
    jcfg = dataclasses.replace(
        J_CONFIGS["mixtral_tiny"], dtype=jnp.float32, param_dtype=jnp.float32,
        scan_layers=scan_layers, **overrides)
    tcfg = dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_tiny"], dtype=torch.float32,
        param_dtype=torch.float32, **overrides)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _flax_params(scan_layers=True):
    jcfg, _ = _pair(scan_layers)
    params = jax.jit(JMixtral(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.device_get(meta.unbox(params))
    rng = np.random.default_rng(7)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: (fill(v) if k != "scale" else
                        (1.0 + 0.1 * rng.standard_normal(np.shape(v))
                         ).astype(np.float32))
                    for k, v in tree.items()}
        return tree

    return fill(params)


def _port(tcfg, params):
    model = Mixtral(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, tcfg))
    return model


def _batch(seed=0):
    """tokens [2, T] and segment ids with row 1 left-padded by 9."""
    tokens = np.random.default_rng(seed).integers(0, 256, (2, T))
    seg = np.ones((2, T), np.int32)
    seg[1, :9] = 0
    return tokens.astype(np.int32), seg


MODES = [(s, m) for s in (True, False) for m in ("einsum", "sorted")]


@pytest.mark.parametrize("scan_layers, mode", MODES,
                         ids=[f"{'scanned' if s else 'unscanned'}-{m}"
                              for s, m in MODES])
def test_logits_and_aux_match_flax(scan_layers, mode):
    jcfg, tcfg = _pair(scan_layers, moe_dispatch=mode, capacity_factor=1.0)
    params = _flax_params(scan_layers)
    model = _port(tcfg, params)
    assert set(params_from_flax(params, tcfg)) == set(model.state_dict())
    tokens, seg = _batch()
    want, want_aux = jax.jit(JMixtral(jcfg).apply)(
        {"params": params}, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens),
                         segment_ids=torch.from_numpy(seg), return_aux=True)
        plain = model(torch.from_numpy(tokens),
                      segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # Without return_aux the serving call sites get the logits alone.
    assert torch.equal(plain, got)


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_gradients_match_jax(mode):
    jcfg, tcfg = _pair(moe_dispatch=mode, capacity_factor=1.0)
    params = _flax_params()
    tokens, seg = _batch(1)
    r = np.random.default_rng(2).standard_normal((2, T, 256)).astype(
        np.float32)

    def j_loss(p):
        lg, aux = JMixtral(jcfg).apply({"params": p}, jnp.asarray(tokens),
                                       segment_ids=jnp.asarray(seg))
        return (lg * r).sum() + aux

    want = params_from_flax(jax.device_get(jax.jit(jax.grad(j_loss))(params)),
                            tcfg)
    model = _port(tcfg, params)
    lg, aux = model(torch.from_numpy(tokens),
                    segment_ids=torch.from_numpy(seg), return_aux=True)
    ((lg * torch.from_numpy(r)).sum() + aux).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("chunk", [None, 16], ids=["full_logits", "chunked"])
def test_batch_loss_adds_aux_as_jax(chunk):
    """batch_loss = CE + aux on both loss paths, as tpufw's."""
    jcfg, tcfg = _pair()
    params = _flax_params()
    tokens, seg = _batch(3)
    jb = {"tokens": jnp.asarray(tokens), "segment_ids": jnp.asarray(seg)}
    want, wn = jax.jit(lambda p, b: j_batch_loss(
        JMixtral(jcfg).apply, p, b, chunk, "float32"))(params, jb)
    model = _port(tcfg, params)
    tb = {"tokens": torch.from_numpy(tokens),
          "segment_ids": torch.from_numpy(seg)}
    with torch.no_grad():
        got, n = batch_loss(model, tb, chunk, "float32")
        _, aux = model(tb["tokens"][:, :-1],
                       segment_ids=tb["segment_ids"][:, :-1], return_aux=True)
    assert float(n) == float(wn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(aux) > 0.0


def test_three_trainer_steps_match_flax(devices8):
    """Same init, same synthetic batches, same optimizer, chunked CE with
    the aux loss in the objective: every step's loss within 1e-4
    relative (the rule of test_torch_trainer.py)."""
    jcfg, tcfg = _pair()
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=1e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    jt = JTrainer(JMixtral(jcfg), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(meta.unbox(jt.state.params))
    j_hist = jt.run(synthetic_batches(8, 33, jcfg.vocab_size, seed=3),
                    model_flops_per_token=jcfg.flops_per_token(32))
    tt = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    model = tt.init_state(state_dict=params_from_flax(params, tcfg))
    assert isinstance(model, Mixtral)
    t_hist = tt.run(synthetic_batches(8, 33, tcfg.vocab_size, seed=3),
                    model_flops_per_token=tcfg.flops_per_token(32))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose(
        [m.loss for m in t_hist], [m.loss for m in j_hist], rtol=1e-4)


@pytest.mark.parametrize("name", ["mixtral_8x7b", "mixtral_tiny"])
def test_param_and_flop_counts_match_jax(name):
    cfg, jcfg = MIXTRAL_CONFIGS[name], J_CONFIGS[name]
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_params(False) == jcfg.n_params(False)
    assert cfg.flops_per_token(4096) == jcfg.flops_per_token(4096)
    model = Mixtral(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    if name == "mixtral_8x7b":
        assert 46e9 < cfg.n_params() < 48e9
        assert model.layers[0].moe.w_down.shape == (8, 4096, 14_336)


def test_cached_decode_matches_prefill():
    """At a dropless capacity (the serve slices'), a prompt prefilled
    through the cache and then fed one token at a time gives the
    uncached forward's logits at every position."""
    _, tcfg = _pair(capacity_factor=4.0)
    model = _port(tcfg.decode_config(), _flax_params())
    tokens = torch.from_numpy(_batch(4)[0][:1])
    n = 24
    with torch.no_grad():
        want = model(tokens)
        cache = model.init_cache(1, length=SEQ)
        got = [model(tokens[:, :n], cache=cache)]
        for j in range(n, T):
            got.append(model(tokens[:, j:j + 1],
                             torch.tensor([[j]]), cache=cache))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               **TOL)


@functools.lru_cache(maxsize=None)
def _decode_pair(cf=None):
    """(JAX decode model, Flax params, port decode model) at SEQ slots,
    capacity factor ``cf`` (None: the preset's 1.25)."""
    over = {"max_seq_len": SEQ}
    if cf is not None:
        over["capacity_factor"] = cf
    jcfg, tcfg = _pair(**over)
    params = _flax_params()
    return (JMixtral(jcfg.decode_config()), params,
            _port(tcfg.decode_config(), params))


def test_greedy_generate_matches_jax():
    jmodel, params, model = _decode_pair()
    want = j_generate.generate_text(jmodel, params, PROMPTS,
                                    max_new_tokens=MAX_NEW)
    assert generate_text(model, PROMPTS, max_new_tokens=MAX_NEW) == want


# Pool runs: 4 slots, three admitted with uneven budgets (slot 3 stays
# idle; slot 1 finishes first), greedy, capacity factor 1.0.
N_SLOTS = 4
BUDGETS = (MAX_NEW, 3, MAX_NEW)


def _pool_rows(decode, firsts):
    rows = {i: [f] for i, f in firsts.items()}
    while any(len(rows[i]) < BUDGETS[i] for i in rows):
        out = decode()
        for i in rows:
            rows[i].extend(out[i, : BUDGETS[i] - len(rows[i])].tolist())
    return [rows[i] for i in sorted(rows)]


def _j_pool_tokens(paged):
    jrow, params, _ = _decode_pair(1.0)
    if paged:
        pcfg = dataclasses.replace(jrow.cfg, kv_page=PAGE,
                                   kv_pages=N_SLOTS * (SEQ // PAGE) + 1)
        pool = j_pages.PagedSlotPool.create_paged(
            JMixtral(pcfg), jrow, params, N_SLOTS, sampling=J_GREEDY,
            eos_id=None)
    else:
        pool = j_slots.SlotPool.create(jrow, params, N_SLOTS,
                                       sampling=J_GREEDY)
    firsts = {}
    for i, p in enumerate(PROMPTS):
        rng = jax.random.fold_in(jax.random.key(0), i)
        cache, _f, first, _d, seen = j_slots.prefill_row(
            jrow, params, p, rng, sampling=J_GREEDY, eos_id=None,
            pad_to=32)
        if paged:
            ids, _ = pool.acquire_pages(p, len(p) + BUDGETS[i] - 1)
            pool.insert_paged(i, cache, first, len(p), BUDGETS[i] - 1, ids, 0,
                              row_seen=seen)
        else:
            pool.insert(i, cache, first, len(p), BUDGETS[i] - 1,
                        row_seen=seen)
        firsts[i] = first
    keys = iter(range(100))
    return _pool_rows(lambda: np.asarray(pool.decode_steps(jax.random.split(
        jax.random.fold_in(jax.random.key(1), next(keys)), 2))), firsts)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_pools_with_idle_slots_match_jax(paged):
    model = _decode_pair(1.0)[2]
    if paged:
        pool = PagedSlotPool.create_paged(
            model, N_SLOTS, cache_len=SEQ, page=PAGE,
            n_pages=N_SLOTS * (SEQ // PAGE) + 1, sampling=GREEDY)
    else:
        pool = SlotPool.create(model, N_SLOTS, sampling=GREEDY, cache_len=SEQ)
    firsts = {}
    for i, p in enumerate(PROMPTS):
        cache, _f, first, _d, seen = prefill_row(
            model, p, None, sampling=GREEDY, eos_id=None, pad_to=32,
            cache_len=pool.cache_len)
        if paged:
            ids, _ = pool.acquire_pages(p, len(p) + BUDGETS[i] - 1)
            pool.insert_paged(i, cache, first, len(p), BUDGETS[i] - 1, ids, 0,
                              row_seen=seen)
        else:
            pool.insert(i, cache, first, len(p), BUDGETS[i] - 1,
                        row_seen=seen)
        firsts[i] = first
    got = _pool_rows(lambda: pool.decode_steps(2), firsts)
    assert got == _j_pool_tokens(paged)


def test_migrated_slot_matches_jax_engines():
    """One prompt prefilled on a PrefillEngine, shipped over the loopback
    wire and spliced into a 4-slot DecodeEngine (three slots idle) gives
    the tokens of tpufw's engines on the same weights."""
    jrow, params, model = _decode_pair(1.0)
    prompt = PROMPTS[0]
    pe = PrefillEngine(model, sampling=GREEDY, page=PAGE, n_slots=2)
    de = DecodeEngine(model, sampling=GREEDY, page=PAGE, n_slots=N_SLOTS,
                      chunk=2)
    lt = LoopbackTransport()
    lt.a.send(pe.prefill(prompt, MAX_NEW))
    got = de.collect(de.submit(lt.b.recv(timeout=5.0)))
    jpe = j_roles.PrefillEngine(jrow, params, sampling=J_GREEDY, page=PAGE,
                                n_slots=2)
    jde = j_roles.DecodeEngine(jrow, params, sampling=J_GREEDY, page=PAGE,
                               n_slots=N_SLOTS, chunk=2)
    want = jde.collect(jde.submit(jpe.prefill(prompt, MAX_NEW)))
    assert got == want and len(got) == MAX_NEW
    assert pe.migrations == de.migrations == 1


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_remat_policies_bit_equal_everything(mode):
    """Each remat policy's loss (CE-like sum + aux) and gradients equal
    "everything"'s bit for bit."""
    _, tcfg = _pair(moe_dispatch=mode, capacity_factor=1.0, remat=True)
    params = _flax_params()
    tokens, seg = (torch.from_numpy(x) for x in _batch(5))
    r = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, T, 256)).astype(np.float32))

    def run(policy):
        model = _port(dataclasses.replace(tcfg, remat_policy=policy), params)
        lg, aux = model(tokens, segment_ids=seg, return_aux=True)
        loss = (lg * r).sum() + aux
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    ref_l, ref_g = run("everything")
    for policy in REMAT_POLICIES:
        got_l, got_g = run(policy)
        assert got_l == ref_l, policy
        for name, g in got_g.items():
            assert torch.equal(g, ref_g[name]), (policy, name)


def test_checkpoint_round_trip_and_llama_refused(tmp_path):
    """A Mixtral trainer's checkpoint restores into a fresh Mixtral trainer
    bit for bit, and under any dispatch mode; a Llama trainer refuses it."""
    _, tcfg = _pair()
    kw = dict(batch_size=2, seq_len=17, total_steps=2, warmup_steps=1,
              checkpoint_dir=str(tmp_path), checkpoint_every=2)
    a = Trainer(tcfg, TrainerConfig(**kw), device="cpu")
    a.init_state(seed=3)
    a.run(synthetic_batches(2, 17, tcfg.vocab_size), 1.0)
    b = Trainer(dataclasses.replace(tcfg, moe_dispatch="sorted"),
                TrainerConfig(**kw), device="cpu")
    assert b.maybe_restore() and b.step == 2
    assert isinstance(b.model, Mixtral)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    llama = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                                dtype=torch.float32, param_dtype=torch.float32)
    c = Trainer(llama, TrainerConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="MixtralConfig"):
        c.maybe_restore()
