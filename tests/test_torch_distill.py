"""tpufw_torch distillation vs tpufw: ``chunked_distill_loss`` at 2e-4
(``tests/conftest.py``'s tolerance) with and without both soft caps, 3
``DistillTrainer`` steps with ``tpufw``'s losses at rtol 1e-4 (a
Gemma-2 teacher, ``teacher_dtype`` float32), the teacher from a
bare-params directory, the guards, and ``train_llama`` with
``TPUFW_DISTILL_TEACHER``. CPU, fp32; weights cross through
``params_from_flax``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpufw.mesh import MeshConfig
from tpufw.models import GEMMA_CONFIGS as J_GEMMA
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import Gemma as JGemma
from tpufw.models import Llama as JLlama
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import distill as j_distill
from tpufw.train.data import synthetic_batches
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import GEMMA_CONFIGS, LLAMA_CONFIGS, model_for_config
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import distill
from tpufw_torch.train.checkpoint import save_params

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("caps, dtype", [
    ((None, None), "float32"), ((5.0, 9.0), "float32"),
    ((None, None), "bfloat16")])
def test_chunked_distill_loss_matches_tpufw(caps, dtype):
    rng = np.random.default_rng(0)
    b, t, ds, dt, v = 3, 21, 8, 12, 40
    arrs = [rng.standard_normal(s).astype(np.float32) * 2
            for s in ((b, t, ds), (ds, v), (b, t, dt), (dt, v))]
    targets = rng.integers(0, v, (b, t))
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    kw = dict(temperature=2.0, alpha=0.3, chunk_size=8,
              student_soft_cap=caps[0], teacher_soft_cap=caps[1])
    got = distill.chunked_distill_loss(
        *map(torch.as_tensor, arrs), torch.as_tensor(targets),
        torch.as_tensor(mask), compute_dtype=getattr(torch, dtype), **kw)
    want = j_distill.chunked_distill_loss(
        *map(jnp.asarray, arrs), jnp.asarray(targets), jnp.asarray(mask),
        compute_dtype=jnp.dtype(dtype), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)


def test_identical_models_zero_kl():
    rng = np.random.default_rng(1)
    h = torch.as_tensor(rng.standard_normal((2, 8, 8)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((8, 16)).astype(np.float32))
    total, kl, _ = distill.chunked_distill_loss(
        h, k, h, k, torch.zeros(2, 8, dtype=torch.long), torch.ones(2, 8),
        temperature=1.0, alpha=1.0, chunk_size=4,
        compute_dtype=torch.float32)
    assert abs(float(kl)) < 1e-6 and abs(float(total)) < 1e-6


# A wider and deeper Llama teacher for the bare-params test.
WIDE = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], d_model=96,
                           n_layers=3, d_ff=192)


def test_distill_trainer_matches_tpufw(devices8):
    """A Gemma-2 teacher (another family, its own final cap) for a Llama
    student; a teacher of another width is held in the op's test."""
    jcfg = dataclasses.replace(J_LLAMA["llama3_tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32)
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=5e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    conf = dict(temperature=2.0, alpha=0.5, teacher_dtype="float32")
    jt = j_distill.DistillTrainer(JLlama(jcfg), JTrainerConfig(**kw),
                                  MeshConfig(data=8),
                                  distill=j_distill.DistillConfig(**conf))
    jt.init_state(seed=0)
    j_teacher = JGemma(dataclasses.replace(J_GEMMA["gemma2_tiny"],
                                           dtype=jnp.float32))
    t_params = jax.device_get(meta.unbox(jax.jit(j_teacher.init)(
        jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"]))
    t_cfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"],
                                dtype=torch.float32)
    jt.set_teacher(j_teacher, t_params)
    tt = distill.DistillTrainer(tcfg, TrainerConfig(**kw), device="cpu",
                                distill=distill.DistillConfig(**conf))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(jt.state.params), tcfg))
    port_teacher = model_for_config(t_cfg, device="cpu")
    port_teacher.load_state_dict(params_from_flax(t_params, t_cfg))
    tt.set_teacher(port_teacher)
    assert tt.teacher is not port_teacher
    assert not any(p.requires_grad for p in tt.teacher.parameters())
    batches = list(synthetic_batches(8, 33, 256, seed=3, n_batches=3))
    step = jt.compiled_step(batches[0])
    for batch in batches:
        jt.state, jm = step(jt.state, batch)
        tm = tt.train_step(batch)
        for k in ("loss", "kl_loss", "ce_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)


def _student(**kw):
    tcfg = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                               dtype=torch.float32)
    return distill.DistillTrainer(
        tcfg, TrainerConfig(batch_size=4, seq_len=17, **kw), device="cpu")


def test_set_teacher_from_a_params_directory(tmp_path):
    """The teacher from the port's bare-params directory, cast to
    teacher_dtype (bf16): equal to the saved tensors so cast."""
    teacher = model_for_config(WIDE, device="cpu", seed=3)
    save_params(str(tmp_path / "t"), teacher.state_dict(), WIDE)
    tr = _student()
    tr.set_teacher_from(WIDE, str(tmp_path / "t"))
    got = tr.teacher.state_dict()
    for k, v in teacher.state_dict().items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], v.to(torch.bfloat16))
    tr.init_state()
    out = tr.train_step(next(synthetic_batches(4, 17, 256, seed=0)))
    assert float(out["kl_loss"]) > 0 and np.isfinite(float(out["loss"]))


def test_guards(tmp_path):
    with pytest.raises(NotImplementedError, match="grad_accum"):
        _student(grad_accum=2)
    tr = _student()
    tr.init_state()
    with pytest.raises(RuntimeError, match="set_teacher"):
        tr.train_step(next(synthetic_batches(4, 17, 256, seed=0)))
    big = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], vocab_size=512)
    with pytest.raises(ValueError, match="vocab"):
        tr.set_teacher(model_for_config(big, device="meta"))
    with pytest.raises(ValueError, match="vocab"):
        tr.set_teacher_from(big, str(tmp_path))


ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE="2",
       SEQ_LEN="33", LOSS_CHUNK_SIZE="8", TOTAL_STEPS="2",
       WARMUP_STEPS="1", HANDLE_PREEMPTION="0")


def _env(monkeypatch, **env):
    workload_env(monkeypatch, ENV, **env)


@pytest.mark.parametrize("ckpt", [False, True], ids=["random", "ckpt"])
def test_train_llama_distill_teacher_trains(tmp_path, monkeypatch, capsys,
                                            ckpt):
    """TPUFW_DISTILL_TEACHER trains a DistillTrainer, its MFU crediting
    the teacher's forward (a third of its 6N count); without
    TPUFW_DISTILL_TEACHER_CKPT the teacher is random, with a warning."""
    from tpufw_torch.train.metrics import Meter
    from tpufw_torch.workloads import train_llama

    t_name = "gemma2_tiny"
    env = dict(DISTILL_TEACHER=t_name, DISTILL_TEMPERATURE="3")
    if ckpt:
        tc = GEMMA_CONFIGS[t_name]
        save_params(str(tmp_path / "t"),
                    model_for_config(tc, device="cpu").state_dict(), tc)
        env["DISTILL_TEACHER_CKPT"] = str(tmp_path / "t")
    _env(monkeypatch, **env)
    counts = []
    init = Meter.__init__
    monkeypatch.setattr(Meter, "__init__", lambda self, *a, **k: (
        counts.append(k["flops_per_token"]), init(self, *a, **k))[1])
    assert train_llama.main() == 0
    cfg = LLAMA_CONFIGS["llama3_tiny"]
    assert counts == [pytest.approx(
        cfg.flops_per_token(32)
        + GEMMA_CONFIGS[t_name].flops_per_token(32) / 3)]
    out = capsys.readouterr().out
    assert ("RANDOM-INIT" in out) != ckpt
    steps = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"step"')]
    assert len(steps) == 2 and all(np.isfinite(s["loss"]) for s in steps)
