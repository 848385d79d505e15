"""The trainer knobs of the port against ``tpufw``'s, on tiny presets in
fp32 with numpy-seeded inputs (tolerance 2e-4, tests/conftest.py):

- ``remat_policy`` (``tests/test_llama.py:57``): every policy gives the
  loss and gradients of "nothing" exactly, and ``tpufw``'s at the same
  policy, for Llama, Mixtral (its router loss in the objective), Gemma-2
  and DeepSeek MLA, through the plain and the flash attention path; an
  unknown name raises;
- ``Trainer.evaluate`` and the eval hook (``tests/test_eval.py``): a
  token-weighted loss equal to ``tpufw``'s, no state change, the hook on
  schedule, an empty iterator loud;
- ``sync_every`` (``tests/test_sync_window.py``): the sync cadence,
  window averages, the flush of an open window, eval at sync points only;
- ``adam_mu_dtype`` (``tests/test_grad_accum.py:89``): a bf16 first
  moment, its updates and a three-step trajectory equal optax's;
- the workload's ``TPUFW_EVAL_EVERY``, ``TPUFW_SYNC_EVERY``,
  ``TPUFW_ADAM_MU_DTYPE`` and ``TPUFW_MOE_DISPATCH``.
"""

import dataclasses
import functools
import itertools
import json
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig
from tpufw.models.deepseek import DEEPSEEK_CONFIGS as J_DEEPSEEK
from tpufw.models.deepseek import Deepseek as JDeepseek
from tpufw.models.gemma import GEMMA_CONFIGS as J_GEMMA
from tpufw.models.gemma import Gemma as JGemma
from tpufw.models.llama import LLAMA_CONFIGS as J_LLAMA
from tpufw.models.llama import Llama as JLlama
from tpufw.models.mixtral import MIXTRAL_CONFIGS as J_MIXTRAL
from tpufw.models.mixtral import Mixtral as JMixtral
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train.trainer import default_optimizer as j_default_optimizer
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import (
    DEEPSEEK_CONFIGS,
    GEMMA_CONFIGS,
    LLAMA_CONFIGS,
    MIXTRAL_CONFIGS,
    Mixtral,
    model_for_config,
)
from tpufw_torch.models.llama import REMAT_POLICIES
from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches
from tpufw_torch.train.trainer import LlamaAdamW

TOL = dict(rtol=2e-4, atol=2e-4)
TINY = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
J_TINY = dataclasses.replace(J_LLAMA["llama3_tiny"], dtype=jnp.float32)

# family: (JAX model class, JAX preset, port preset)
FAMILIES = {
    "llama": (JLlama, J_LLAMA["llama3_tiny"], LLAMA_CONFIGS["llama3_tiny"]),
    "gemma": (JGemma, J_GEMMA["gemma2_tiny"], GEMMA_CONFIGS["gemma2_tiny"]),
    "deepseek": (JDeepseek, J_DEEPSEEK["deepseek_tiny"],
                 DEEPSEEK_CONFIGS["deepseek_tiny"]),
    "mixtral": (JMixtral, J_MIXTRAL["mixtral_tiny"],
                MIXTRAL_CONFIGS["mixtral_tiny"]),
}


def _fp32(cfg, dtype, **kw):
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _family(family):
    """(JAX model class, JAX fp32 config, port fp32 config, host Flax
    params, tokens [2, 40], cotangent r) of ``family``."""
    jcls, jbase, tbase = FAMILIES[family]
    jcfg = _fp32(jbase, jnp.float32, remat=True)
    tcfg = _fp32(tbase, torch.float32, remat=True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    r = rng.standard_normal((2, 40, jcfg.vocab_size)).astype(np.float32)
    params = jax.jit(jcls(jcfg).init)(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcls, jcfg, tcfg, jax.device_get(meta.unbox(params)), tokens, r


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(family, policy):
    jcls, jcfg, tcfg, params, tokens, r = _family(family)
    model = jcls(dataclasses.replace(jcfg, remat_policy=policy))

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(tokens))
        if isinstance(out, tuple):  # a MoE model: (logits, router loss)
            return (out[0] * r).sum() + out[1]
        return (out * r).sum()

    lv, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(lv), params_from_flax(jax.device_get(g), tcfg)


def _port_loss_and_grads(family, policy, backend):
    _, _, tcfg, params, tokens, r = _family(family)
    cfg = dataclasses.replace(tcfg, remat_policy=policy,
                              attention_backend=backend)
    model = model_for_config(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params, cfg))
    if isinstance(model, Mixtral):
        logits, aux = model(torch.from_numpy(tokens), return_aux=True)
        loss = (logits * torch.from_numpy(r)).sum() + aux
    else:
        loss = (model(torch.from_numpy(tokens)) * torch.from_numpy(r)).sum()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_policies_match_nothing_and_jax(family, backend):
    """The policy changes what is kept, never the numbers: every policy's
    loss and gradients equal "nothing"'s bit for bit, and ``tpufw``'s at
    the same policy within 2e-4."""
    ref_l, ref_g = _port_loss_and_grads(family, "nothing", backend)
    for policy in REMAT_POLICIES:
        got_l, got_g = _port_loss_and_grads(family, policy, backend)
        assert got_l == ref_l, policy
        for name, g in got_g.items():
            np.testing.assert_array_equal(g.numpy(), ref_g[name].numpy(),
                                          err_msg=f"{policy} {name}")
        if backend == "xla":
            jl, jg = _jax_loss_and_grads(family, policy)
            np.testing.assert_allclose(got_l, jl, rtol=1e-5)
            for name, g in got_g.items():
                np.testing.assert_allclose(
                    g.numpy(), jg[name].numpy(), err_msg=f"{policy} {name}",
                    **TOL)


def test_default_policy_is_dots_and_unknown_raises():
    for _, jbase, tbase in FAMILIES.values():
        assert tbase.remat_policy == jbase.remat_policy == "dots"
        bad = dataclasses.replace(tbase, remat=True, remat_policy="most")
        with pytest.raises(ValueError, match="unknown remat_policy 'most'"):
            model_for_config(bad, device="cpu")
        # A model that does not remat never reads it, as in tpufw.
        model_for_config(dataclasses.replace(bad, remat=False, n_layers=2),
                         device="cpu")


def test_dots_saves_the_projection_outputs(monkeypatch):
    """"dots" is JAX's checkpoint_dots_with_no_batch_dims: in the forward
    it keeps the seven projection outputs of each Llama block (q, k, v, o,
    gate, up, down: matmuls without batch dims) and nothing else; the
    attention's batched products are recomputed."""
    from tpufw_torch.models import llama

    decisions = []
    real = llama._save_dots

    def spy(ctx, op, *args, **kwargs):
        d = real(ctx, op, *args, **kwargs)
        if ctx.is_recompute is False:
            decisions.append((str(op), d.name))
        return d

    monkeypatch.setattr(llama, "_save_dots", spy)
    cfg = dataclasses.replace(TINY, remat=True, remat_policy="dots")
    model = model_for_config(cfg, device="cpu")
    model(torch.from_numpy(_family("llama")[4])).sum().backward()
    saved = [op for op, d in decisions if d == "MUST_SAVE"]
    assert saved == ["aten.mm.default"] * 7 * cfg.n_layers
    assert ("aten.bmm.default", "PREFER_RECOMPUTE") in decisions


# ---- evaluate and the eval hook ----


@pytest.fixture(scope="module")
def trainer():
    t = Trainer(TINY, TrainerConfig(batch_size=8, seq_len=33, total_steps=6,
                                    lr=1e-2, warmup_steps=2), device="cpu")
    t.init_state(seed=0)
    return t


def test_evaluate_reports_weighted_loss(trainer):
    out = trainer.evaluate(synthetic_batches(8, 33, TINY.vocab_size, seed=7),
                           n_batches=3)
    assert out["eval_batches"] == 3
    assert out["eval_tokens"] == 3 * 8 * 32
    assert np.isfinite(out["eval_loss"])
    assert abs(out["eval_loss"] - np.log(TINY.vocab_size)) < 1.5
    assert out["eval_ppl"] == pytest.approx(np.exp(out["eval_loss"]),
                                            rel=1e-6)


def test_evaluate_matches_jax(devices8):
    """Same weights, same held-out batches (a chunked-CE objective):
    ``tpufw``'s ``Trainer.evaluate`` and the port's agree."""
    kw = dict(batch_size=8, seq_len=17, loss_chunk_size=8,
              loss_chunk_dtype="float32")
    jt = JTrainer(JLlama(J_TINY), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    tt = Trainer(TINY, TrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(jt.state.params), TINY))
    data = lambda: synthetic_batches(8, 17, TINY.vocab_size, seed=5)  # noqa
    want, got = jt.evaluate(data(), 2), tt.evaluate(data(), 2)
    assert got["eval_tokens"] == want["eval_tokens"] == 2 * 8 * 16
    assert got["eval_batches"] == want["eval_batches"] == 2
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], **TOL)


def test_evaluate_does_not_mutate_state(trainer):
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.evaluate(synthetic_batches(8, 33, TINY.vocab_size, seed=8),
                     n_batches=2)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer.step == 0 and trainer.optimizer.count == 0
    assert all(p.grad is None for p in trainer.model.parameters())


def test_eval_hook_fires_on_schedule():
    t = Trainer(TINY, TrainerConfig(batch_size=8, seq_len=33, total_steps=6,
                                    lr=1e-2, warmup_steps=2, eval_every=2,
                                    eval_batches=1), device="cpu")
    t.init_state(seed=0)
    evals = []
    t.run(synthetic_batches(8, 33, TINY.vocab_size),
          model_flops_per_token=TINY.flops_per_token(32),
          eval_data=lambda: synthetic_batches(8, 33, TINY.vocab_size,
                                              seed=99),
          on_eval=evals.append)
    assert [e["step"] for e in evals] == [2, 4, 6]
    assert evals[-1]["eval_loss"] < evals[0]["eval_loss"]


def test_empty_eval_iterator_is_loud(trainer):
    with pytest.raises(ValueError, match="empty eval iterator"):
        trainer.evaluate(iter(()))
    with pytest.raises(RuntimeError, match="before init_state"):
        Trainer(TINY, TrainerConfig(), device="cpu").evaluate(iter(()))


# ---- sync_every ----


def _run(total, sync_every, data=None, **kw):
    t = Trainer(TINY, TrainerConfig(batch_size=8, seq_len=17,
                                    total_steps=total, lr=1e-3,
                                    sync_every=sync_every, **kw),
                device="cpu")
    t.init_state(seed=0)
    seen = []
    hist = t.run(data or synthetic_batches(8, 17, TINY.vocab_size),
                 model_flops_per_token=TINY.flops_per_token(16),
                 on_metrics=seen.append)
    return t, hist, seen


def test_trainer_windowed_sync_cadence():
    t, hist, seen = _run(5, 2, log_every=1)
    # Syncs at step 1, at multiples of sync_every (2, 4) and at the last.
    assert [m.step for m in hist] == [1, 2, 4, 5]
    assert [m.window_steps for m in hist] == [1, 1, 2, 1]
    assert len(seen) == 4
    assert all(math.isfinite(m.loss) for m in hist)
    assert t.step == 5 and t.optimizer.count == 5


def test_trainer_default_sync_is_per_step():
    _, hist, _ = _run(3, 1)
    assert [m.step for m in hist] == [1, 2, 3]
    assert all(m.window_steps == 1 for m in hist)


def test_windowed_losses_are_the_per_step_run_s():
    """A window only delays the host read: its entries' losses are those
    of the same steps synced every step."""
    _, every, _ = _run(5, 1)
    _, windowed, _ = _run(5, 2)
    by_step = {m.step: m.loss for m in every}
    for m in windowed:
        assert m.loss == by_step[m.step]


def test_exhausted_iterator_flushes_open_window():
    data = itertools.islice(synthetic_batches(8, 17, TINY.vocab_size), 6)
    t, hist, _ = _run(100, 4, data=data)
    assert [m.step for m in hist] == [1, 4, 6]
    assert [m.window_steps for m in hist] == [1, 3, 2]
    assert t.step == 6


def test_window_data_wait_is_per_step_average():
    def slow(it, delay):
        for b in it:
            time.sleep(delay)
            yield b

    _, hist, _ = _run(4, 4, data=slow(
        synthetic_batches(8, 17, TINY.vocab_size), 0.05))
    w = hist[-1]  # steps 2-4
    assert w.window_steps == 3
    assert 0.03 < w.data_wait_s < 0.12, w.data_wait_s


def test_eval_runs_at_sync_points_only():
    """eval_every=2 under sync_every=4 over 6 steps: syncs at 1, 4 and 6,
    so the hook fires at 4 and 6, never at 2."""
    t = Trainer(TINY, TrainerConfig(batch_size=8, seq_len=17, total_steps=6,
                                    lr=1e-3, sync_every=4, eval_every=2,
                                    eval_batches=1), device="cpu")
    t.init_state(seed=0)
    evals = []
    t.run(synthetic_batches(8, 17, TINY.vocab_size),
          model_flops_per_token=TINY.flops_per_token(16),
          eval_data=lambda: synthetic_batches(8, 17, TINY.vocab_size, seed=1),
          on_eval=evals.append)
    assert [e["step"] for e in evals] == [4, 6]


# ---- adam_mu_dtype ----


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off / on
def test_bf16_mu_updates_match_optax(grad_scale):
    """Three updates of clip + AdamW(mu_dtype=bfloat16) + schedule against
    ``tpufw``'s optax chain: the parameters, and the bf16 first moment
    bit for bit."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * grad_scale
              for s in shapes] for _ in range(3)]
    tx = j_default_optimizer(lr=1e-2, warmup_steps=1, total_steps=4,
                             mu_dtype="bfloat16")
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = LlamaAdamW(tp, lr=1e-2, warmup_steps=1, total_steps=4,
                     mu_dtype="bfloat16")
    assert opt.adamw is None
    assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    assert all(v.dtype == torch.float32 for v in opt.nu)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    j_mu = [x for x in jax.tree.leaves(state)
            if getattr(x, "dtype", None) == jnp.bfloat16]
    for a, b in zip(opt.mu, j_mu):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_bf16_mu_halves_moment_and_trains():
    t = Trainer(TINY, TrainerConfig(batch_size=8, seq_len=33, total_steps=6,
                                    lr=1e-2, warmup_steps=1,
                                    adam_mu_dtype="bfloat16"), device="cpu")
    t.init_state(seed=0)
    assert all(m.dtype == torch.bfloat16 for m in t.optimizer.mu)
    hist = t.run(synthetic_batches(8, 33, TINY.vocab_size),
                 model_flops_per_token=TINY.flops_per_token(32))
    assert hist[-1].loss < hist[0].loss


def test_bf16_mu_trajectory_matches_flax_trainer(devices8):
    """The same init and numpy-seeded batches through ``tpufw``'s trainer
    and the port's, both with adam_mu_dtype="bfloat16": every step's
    loss agrees to 1e-4 relative."""
    kw = dict(batch_size=8, seq_len=17, total_steps=3, lr=1e-2,
              warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32",
              adam_mu_dtype="bfloat16")
    jt = JTrainer(JLlama(J_TINY), JTrainerConfig(**kw), MeshConfig(data=8))
    jt.init_state(seed=0)
    params = jax.device_get(jt.state.params)
    j_hist = jt.run(synthetic_batches(8, 17, TINY.vocab_size, seed=3),
                    model_flops_per_token=TINY.flops_per_token(16))
    tt = Trainer(TINY, TrainerConfig(**kw), device="cpu")
    tt.init_state(state_dict=params_from_flax(params, TINY))
    t_hist = tt.run(synthetic_batches(8, 17, TINY.vocab_size, seed=3),
                    model_flops_per_token=TINY.flops_per_token(16))
    assert len(t_hist) == len(j_hist) == 3
    np.testing.assert_allclose([m.loss for m in t_hist],
                               [m.loss for m in j_hist], rtol=1e-4)


def test_bad_mu_dtype_is_loud():
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        LlamaAdamW([torch.zeros(2, requires_grad=True)], mu_dtype="bf17")


# ---- the workload's knobs ----


def test_workload_eval_sync_and_mu_knobs(monkeypatch, capsys):
    from tpufw_torch.workloads import train_llama

    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    for k, v in dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
                     SEQ_LEN="17", TOTAL_STEPS="4", LOSS_CHUNK_SIZE="8",
                     EVAL_EVERY="2", EVAL_BATCHES="2", SYNC_EVERY="2",
                     ADAM_MU_DTYPE="bfloat16").items():
        monkeypatch.setenv(f"TPUFW_{k}", v)
    trainer, _ = train_llama.build_trainer()
    assert (trainer.cfg.eval_every, trainer.cfg.eval_batches,
            trainer.cfg.sync_every, trainer.cfg.adam_mu_dtype) == (
        2, 2, 2, "bfloat16")
    assert train_llama.main() == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    steps = [ln["step"] for ln in lines if "loss" in ln]
    evals = [ln for ln in lines if "eval_loss" in ln]
    assert steps == [1, 2, 4]
    assert [e["step"] for e in evals] == [2, 4]
    assert all(e["eval_tokens"] == 2 * 2 * 16 for e in evals)


# --- Weights, state and data knobs of the workload ------------------------

def _workload_env(monkeypatch, **env):
    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    base = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
                SEQ_LEN="17", LOSS_CHUNK_SIZE="8")
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(f"TPUFW_{k}", str(v))


STATE_KNOBS = ("checkpoint_dir", "checkpoint_every", "handle_preemption",
               "preemption_sync_every")


@pytest.mark.parametrize("env", [
    {},
    {"CHECKPOINT_DIR": "/ck", "CHECKPOINT_EVERY": "7",
     "HANDLE_PREEMPTION": "0", "PREEMPTION_SYNC_EVERY": "3"},
], ids=["defaults", "set"])
def test_state_knobs_match_tpufw_build_trainer(monkeypatch, env):
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    _workload_env(monkeypatch, **env)
    mine, _ = train_llama.build_trainer()
    theirs, _ = j_train_llama.build_trainer()
    assert {k: getattr(mine.cfg, k) for k in STATE_KNOBS} == {
        k: getattr(theirs.cfg, k) for k in STATE_KNOBS}


BENCH_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "deploy", "configs", "bench-v5e1.yaml")

# Every knob ``tpufw``'s build_trainer honours and the port did not:
# (a value that turns it on, the ROADMAP.md Queue 1 item it names).
REFUSED_TRAIN_KNOBS = {
    # Honoured since item 13c: the YAML of record is the base of every
    # TrainerConfig field ("yaml"), the autotune mode lands as the rest.
    "CONFIG": (BENCH_YAML, "yaml"),
    "AUTOTUNE": ("search", "config"),
    # Honoured since item 13a ("config"): the knob lands in the
    # TrainerConfig field of that name as tpufw's build_trainer puts it.
    "PROFILE_DIR": ("/prof", "config"),
    "TELEMETRY_DIR": ("/tel", "config"),
    "METRICS_PORT": ("0", "config"),
    "STRAGGLER_FACTOR": ("3.0", "config"),
    # Honoured since item 12e (None): above the one-process world they
    # raise tpufw's ValueError, word for word.
    "MESH_EXPERT": ("2", None),
    "MESH_TENSOR": ("2", None),
}


@pytest.mark.parametrize("knob", sorted(REFUSED_TRAIN_KNOBS))
def test_post_training_objectives_are_refused(monkeypatch, knob):
    """Each knob raises, naming its item, in the serve workload's words;
    the knob's name leads the message. A knob the port honours since
    item 13a lands in ``TrainerConfig`` as in ``tpufw``'s trainer."""
    from tpufw_torch.workloads import train_llama

    value, item = REFUSED_TRAIN_KNOBS[knob]
    _workload_env(monkeypatch, **{knob: value})
    if item == "yaml":
        from tpufw.workloads import train_llama as j_train_llama

        mine = train_llama.build_trainer()[0].cfg
        theirs = j_train_llama.build_trainer()[0].cfg
        shared = [f.name for f in dataclasses.fields(mine)
                  if hasattr(theirs, f.name)]
        assert {f: getattr(mine, f) for f in shared} == {
            f: getattr(theirs, f) for f in shared}
        # From the YAML (lr, warmup, log cadence) under the env's shape.
        assert (mine.lr, mine.warmup_steps, mine.log_every) == (1e-4, 2, 1)
        assert (mine.batch_size, mine.loss_chunk_size) == (2, 8)
        return
    if item == "config":
        from tpufw.workloads import train_llama as j_train_llama

        field = knob.lower()
        mine = getattr(train_llama.build_trainer()[0].cfg, field)
        theirs = getattr(j_train_llama.build_trainer()[0].cfg, field)
        assert mine == theirs and mine is not None
        assert str(mine) == value
        return
    if item is None:
        from tpufw.mesh import build_mesh as j_build_mesh

        axis = knob.removeprefix("MESH_").lower()
        with pytest.raises(ValueError) as want:
            j_build_mesh(MeshConfig(**{axis: int(value)}),
                         devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            train_llama.build_trainer()
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(NotImplementedError,
                       match=rf"^TPUFW_{knob}: .* is not ported to "
                             rf"tpufw_torch yet \(ROADMAP.md Queue 1 "
                             rf"item {item}\)$"):
        train_llama.build_trainer()


# Mesh knobs the port honours: a mesh larger than the one-process world
# raises tpufw's ValueError, word for word.
MESH_MISMATCH = {
    "data2_fsdp1": {"MESH_DATA": "2", "MESH_FSDP": "1"},
    "fsdp4": {"MESH_FSDP": "4"},
    "data2_fill": {"MESH_DATA": "2"},
    "dcn2": {"MESH_DCN_DATA": "2"},
    "sequence2": {"MESH_SEQUENCE": "2"},
}


@pytest.mark.parametrize("case", sorted(MESH_MISMATCH))
def test_mesh_larger_than_the_world_raises_tpufws_error(monkeypatch, case):
    from tpufw.mesh import build_mesh as j_build_mesh
    from tpufw_torch.workloads import train_llama

    env = MESH_MISMATCH[case]
    kw = {k.removeprefix("MESH_").lower(): int(v) for k, v in env.items()}
    with pytest.raises(ValueError) as want:
        j_build_mesh(MeshConfig(**kw), devices=jax.devices()[:1])
    _workload_env(monkeypatch, **env)
    with pytest.raises(ValueError) as got:
        train_llama.build_trainer()
    assert str(got.value) == str(want.value)


def test_sorted_dispatch_under_a_one_device_expert_fill(monkeypatch):
    """TPUFW_MESH_EXPERT=-1 resolves to one device in a one-process run,
    so the sorted dispatch builds; tpufw refuses it for -1 itself."""
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    _workload_env(monkeypatch, MODEL="mixtral_tiny", MESH_EXPERT="-1",
                  MESH_FSDP="1", MOE_DISPATCH="sorted")
    trainer, cfg = train_llama.build_trainer()
    assert cfg.moe_dispatch == "sorted" and not trainer.gang
    with pytest.raises(ValueError, match="moe_dispatch='sorted'"):
        j_train_llama.build_trainer()


@pytest.mark.parametrize("env", [
    {"AUTOTUNE": "off", "STRAGGLER_FACTOR": "2", "LORA_RANK": "0",
     "LORA_ALPHA": "16", "MESH_DATA": "1", "MESH_FSDP": "-1",
     "METRICS_PORT": "", "CONFIG": "", "MOE_DISPATCH": ""},
], ids=["defaults"])
def test_unported_train_knobs_at_their_defaults_pass(monkeypatch, env):
    from tpufw_torch.workloads import train_llama

    _workload_env(monkeypatch, **env)
    trainer, _ = train_llama.build_trainer()
    assert trainer.cfg.batch_size == 2


@pytest.mark.parametrize("model, dispatch", [
    ("mixtral_tiny", "einsum"), ("mixtral_tiny", "sorted"),
    ("llama3_tiny", "sorted")])
def test_moe_dispatch_knob_is_honoured(monkeypatch, capsys, model, dispatch):
    """TPUFW_MOE_DISPATCH sets a Mixtral's dispatch, as tpufw's
    build_trainer does, and a dense config ignores it; the workload trains
    two finite steps on it."""
    from tpufw.workloads import train_llama as j_train_llama
    from tpufw_torch.workloads import train_llama

    _workload_env(monkeypatch, MODEL=model, MOE_DISPATCH=dispatch,
                  TOTAL_STEPS=2, WARMUP_STEPS=1, HANDLE_PREEMPTION=0)
    trainer, cfg = train_llama.build_trainer()
    _, jcfg = j_train_llama.build_trainer()
    assert type(cfg).__name__ == type(jcfg).__name__
    assert getattr(cfg, "moe_dispatch", None) == getattr(
        jcfg, "moe_dispatch", None)
    if model == "mixtral_tiny":
        assert cfg.moe_dispatch == dispatch
        assert isinstance(trainer.init_state(), Mixtral)
        assert trainer.model.layers[0].moe.mode == dispatch
    assert train_llama.main() == 0
    steps = _steps(capsys.readouterr().out)
    assert len(steps) == 2 and all(math.isfinite(s["loss"]) for s in steps)


def _steps(out):
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"step"')]


def test_workload_trains_on_a_corpus_and_resumes(monkeypatch, capsys,
                                                 tmp_path):
    """TPUFW_DATA_PREFIX through TokenCorpus (shuffled, seed from
    resume_data_seed) and prefetch; TPUFW_EVAL_DATA_PREFIX in order;
    TPUFW_CHECKPOINT_DIR saves and a second run resumes at its step."""
    import tpufw_torch.train as ttrain
    from tpufw.workloads._common import resume_data_seed as j_seed
    from tpufw_torch.train import write_token_corpus
    from tpufw_torch.workloads import train_llama

    rng = np.random.default_rng(0)
    write_token_corpus(str(tmp_path / "c"), [
        rng.integers(1, 256, rng.integers(3, 30)) for _ in range(80)])
    opened = []

    class Recording(ttrain.TokenCorpus):
        def __init__(self, prefix, *a, **kw):
            opened.append((prefix, kw.get("shuffle", False),
                           kw.get("seed", 0)))
            super().__init__(prefix, *a, native=False, **kw)

    monkeypatch.setattr(ttrain, "TokenCorpus", Recording)
    env = dict(DATA_PREFIX=tmp_path / "c", EVAL_DATA_PREFIX=tmp_path / "c",
               EVAL_EVERY=2, EVAL_BATCHES=1, CHECKPOINT_DIR=tmp_path / "ck",
               CHECKPOINT_EVERY=2, DATA_SEED=5, TOTAL_STEPS=2)
    _workload_env(monkeypatch, **env)
    assert train_llama.main() == 0
    out = capsys.readouterr().out
    assert [s["step"] for s in _steps(out)] == [1, 2]
    assert '"eval_loss"' in out
    assert opened[0] == (str(tmp_path / "c"), True, 5)
    assert opened[1] == (str(tmp_path / "c"), False, 0)
    _workload_env(monkeypatch, **{**env, "TOTAL_STEPS": 4})
    assert train_llama.main() == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out
    assert [s["step"] for s in _steps(out)] == [3, 4]
    assert opened[2] == (str(tmp_path / "c"), True, j_seed(5, 2))


def test_workload_init_from_bare_params(monkeypatch, capsys, tmp_path):
    from tpufw_torch.models import PRESETS
    from tpufw_torch.train.checkpoint import save_params
    from tpufw_torch.workloads import train_llama

    cfg = PRESETS["llama3_tiny"]
    src = Trainer(cfg, TrainerConfig(), device="cpu")
    src.init_state(seed=9)
    save_params(str(tmp_path / "p"), src.model.state_dict(), cfg)
    _workload_env(monkeypatch, INIT_FROM=tmp_path / "p", TOTAL_STEPS=1)
    assert train_llama.main() == 0
    out = capsys.readouterr().out
    assert f"initialized params from {tmp_path / 'p'}" in out
    want = Trainer(cfg, TrainerConfig(batch_size=2, seq_len=17, total_steps=1,
                                      warmup_steps=10, loss_chunk_size=8),
                   device="cpu")
    want.init_state(state_dict=src.model.state_dict())
    hist = want.run(synthetic_batches(2, 17, cfg.vocab_size, seed=0), 1.0)
    assert _steps(out)[0]["loss"] == hist[0].loss


def test_workload_sigterm_prints_preempted_and_resumes(tmp_path):
    """The entry point as a child process: SIGTERM after its second step
    line gives {"preempted": true, "step": N}, exit 0 and step N on disk;
    rerun, it resumes at N."""
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    env.update(TPUFW_DEVICE="cpu", TPUFW_MODEL="llama3_tiny",
               TPUFW_BATCH_SIZE="2", TPUFW_SEQ_LEN="17",
               TPUFW_TOTAL_STEPS="1000000", TPUFW_LOSS_CHUNK_SIZE="8",
               TPUFW_CHECKPOINT_DIR=str(tmp_path / "ck"))
    cmd = [sys.executable, "-m", "tpufw_torch.workloads.train_llama"]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            text=True)
    lines, steps = [], 0
    try:
        for ln in proc.stdout:
            lines.append(ln)
            steps += ln.startswith('{"step"')
            if steps == 2:
                proc.send_signal(signal.SIGTERM)
                steps += 1
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    pre = [json.loads(ln) for ln in lines if ln.startswith('{"preempted"')]
    assert len(pre) == 1 and pre[0]["preempted"] is True
    n = pre[0]["step"]
    from tpufw_torch.train import CheckpointManager

    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [n]
    env["TPUFW_TOTAL_STEPS"] = str(n + 1)
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"resumed from checkpoint at step {n}" in res.stdout
    assert [s["step"] for s in _steps(res.stdout)] == [n + 1]
