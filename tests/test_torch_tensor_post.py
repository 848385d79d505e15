"""The post-trainers' heads over vocabulary shards: the port's DPO and
distillation on one process's ``LocalTensorGroup(2)`` against ``tpufw``'s
on ``MeshConfig(data=2, fsdp=2, tensor=2)`` (``tests/test_dpo.py``'s and
``tests/test_distill.py``'s meshes), both from the same Flax weights in
fp32: losses and metrics at rtol 1e-4, grad norms at 2e-4
(``tests/conftest.py``); and the vocab-parallel log-probs and distillation
KL against ``tpufw``'s functions on the whole vocabulary."""

import dataclasses
import json
import math

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
from tpufw.ops import loss as j_loss
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw.train import distill as j_distill
from tpufw.train import dpo as j_dpo
from tpufw.train.data import synthetic_batches
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import TP_MESH
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import GEMMA_CONFIGS, LLAMA_CONFIGS, model_for_config
from tpufw_torch.ops import loss
from tpufw_torch.parallel import LocalTensorGroup
from tpufw_torch.train import TrainerConfig
from tpufw_torch.train import distill, dpo
from tpufw_torch.train.sft import byte_encode

TOL = dict(rtol=2e-4, atol=2e-4)


def _logprob_inputs(seed=0, b=3, t=21, d=8, v=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((d, v)).astype(np.float32) * 0.7,
            rng.integers(0, v, (b, t)),
            (rng.random((b, t)) > 0.3).astype(np.float32))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cap", [None, 3.0])
def test_sequence_logprob_vocab_parallel_matches_tpufw(tp, cap):
    """Each shard's part of the log-sum-exp and the target's logit,
    summed: ``tpufw``'s per-row sums on the whole vocabulary, and the
    gradients of the hidden states and of the head those of the unsplit
    path."""
    hidden, kernel, targets, mask = _logprob_inputs()
    want = j_loss.chunked_sequence_logprob(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(targets),
        jnp.asarray(mask), chunk_size=8, compute_dtype=jnp.float32,
        logits_soft_cap=cap)
    grads = []
    for group in (None, LocalTensorGroup(tp)):
        h = torch.tensor(hidden, requires_grad=True)
        k = torch.tensor(kernel, requires_grad=True)
        got = loss.chunked_sequence_logprob(
            h, k, torch.as_tensor(targets), torch.as_tensor(mask),
            chunk_size=8, compute_dtype=torch.float32, logits_soft_cap=cap,
            group=group)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        (got * torch.arange(1.0, 4.0)).sum().backward()
        grads.append((h.grad, k.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cap, scale", [(None, 1.0), (3.0, 1.0 / 0.7)])
def test_token_logprob_vocab_parallel_matches_tpufw(tp, cap, scale):
    """Per-token log-probs over vocabulary shards, the cap then the
    temperature as the sampler applies them: ``tpufw``'s on the whole
    vocabulary."""
    hidden, kernel, targets, _ = _logprob_inputs(1)
    want = j_loss.chunked_token_logprob(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(targets),
        chunk_size=8, compute_dtype=jnp.float32, logits_soft_cap=cap,
        logits_scale=scale)
    got = loss.chunked_token_logprob(
        torch.as_tensor(hidden), torch.as_tensor(kernel),
        torch.as_tensor(targets), chunk_size=8, compute_dtype=torch.float32,
        logits_soft_cap=cap, logits_scale=scale, group=LocalTensorGroup(tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("caps", [(None, None), (5.0, 9.0)])
def test_distill_kl_vocab_parallel_matches_tpufw(tp, caps):
    """Both heads split on the vocabulary: each softmax's max and
    log-sum-exp reduced over the shards, the KL a position the sum of the
    shards' parts; ``tpufw``'s (total, kl, ce) on the whole vocabulary,
    a teacher of another width included."""
    rng = np.random.default_rng(2)
    b, t, ds, dt, v = 3, 19, 8, 12, 40
    arrs = [rng.standard_normal(s).astype(np.float32) * 2
            for s in ((b, t, ds), (ds, v), (b, t, dt), (dt, v))]
    targets = rng.integers(0, v, (b, t))
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    kw = dict(temperature=2.0, alpha=0.3, chunk_size=8,
              student_soft_cap=caps[0], teacher_soft_cap=caps[1])
    want = j_distill.chunked_distill_loss(
        *map(jnp.asarray, arrs), jnp.asarray(targets), jnp.asarray(mask),
        compute_dtype=jnp.float32, **kw)
    got = distill.chunked_distill_loss(
        *map(torch.as_tensor, arrs), torch.as_tensor(targets),
        torch.as_tensor(mask), compute_dtype=torch.float32,
        group=LocalTensorGroup(tp), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)


def _pairs_file(path, n=8):
    rows = [{"prompt": f"item {i} " * (i % 3 + 1),
             "chosen": "good answer" + "!" * i, "rejected": "bad"}
            for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return path


def _llama_pair():
    return (dataclasses.replace(J_LLAMA["llama3_tiny"], dtype=jnp.float32),
            dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                                dtype=torch.float32))


def _steps(jt, tt, batches, keys):
    """Each batch through ``tpufw``'s compiled step and the port's
    ``train_step``: their metrics compared."""
    step = jt.compiled_step(batches[0])
    out = []
    for batch in batches:
        jt.state, jm = step(jt.state, jt.globalize_batch(batch))
        tm = tt.train_step(batch)
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-4)
        out.append(tm)
    return out


def test_dpo_over_tensor_shards_matches_tpufw(tmp_path, devices8):
    """3 DPO steps, the reference a frozen fp32 copy cut as the policy
    is: step 0 at ln 2, every metric and grad norm ``tpufw``'s on its
    tensor mesh."""
    path = _pairs_file(tmp_path / "p.jsonl")
    jcfg, tcfg = _llama_pair()
    kw = dict(batch_size=8, seq_len=48, total_steps=3, lr=5e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    conf = dict(beta=0.5, ref_dtype="float32")
    jt = j_dpo.DPOTrainer(JLlama(jcfg), JTrainerConfig(**kw),
                          MeshConfig(**TP_MESH), dpo=j_dpo.DPOConfig(**conf))
    jt.init_state(seed=0)
    tt = dpo.DPOTrainer(tcfg, TrainerConfig(**kw), device="cpu",
                        dpo=dpo.DPOConfig(**conf),
                        groups=(LocalTensorGroup(2),))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(meta.unbox(jt.state.params)), tcfg))
    assert tt.ref_model is not None and tt.split
    batches = list(dpo.dpo_batches(path, 4, 48, byte_encode, epochs=1,
                                   seed=1))[:2] * 2
    out = _steps(jt, tt, batches[:3], ("loss", "accuracy", "margin",
                                       "reward_chosen", "reward_rejected"))
    assert float(out[0]["loss"]) == pytest.approx(math.log(2), abs=1e-6)


def test_distill_over_tensor_shards_matches_tpufw(devices8):
    """A Gemma-2 teacher (another family, its own final cap) cut by the
    student's tensor group: 3 steps of ``tpufw``'s losses and grad
    norms on its tensor mesh."""
    jcfg, tcfg = _llama_pair()
    kw = dict(batch_size=8, seq_len=33, total_steps=3, lr=5e-3,
              warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
    conf = dict(temperature=2.0, alpha=0.5, teacher_dtype="float32")
    jt = j_distill.DistillTrainer(JLlama(jcfg), JTrainerConfig(**kw),
                                  MeshConfig(**TP_MESH),
                                  distill=j_distill.DistillConfig(**conf))
    jt.init_state(seed=0)
    j_teacher = JGemma(dataclasses.replace(J_GEMMA["gemma2_tiny"],
                                           dtype=jnp.float32))
    t_params = jax.device_get(meta.unbox(jax.jit(j_teacher.init)(
        jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"]))
    jt.set_teacher(j_teacher, t_params)
    t_cfg = dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"],
                                dtype=torch.float32)
    tt = distill.DistillTrainer(tcfg, TrainerConfig(**kw), device="cpu",
                                distill=distill.DistillConfig(**conf),
                                groups=(LocalTensorGroup(2),))
    tt.init_state(state_dict=params_from_flax(
        jax.device_get(meta.unbox(jt.state.params)), tcfg))
    teacher = model_for_config(t_cfg, device="cpu")
    teacher.load_state_dict(params_from_flax(t_params, t_cfg))
    tt.set_teacher(teacher)
    batches = list(synthetic_batches(8, 33, 256, seed=3, n_batches=3))
    _steps(jt, tt, batches, ("loss", "kl_loss", "ce_loss"))


def test_teacher_must_divide_over_the_students_axes():
    """A teacher whose heads or vocabulary the student's tensor axis does
    not divide raises ``tpufw``'s kind of ValueError, naming the
    dimension."""
    _, tcfg = _llama_pair()
    tt = distill.DistillTrainer(tcfg, TrainerConfig(batch_size=4,
                                                    seq_len=17),
                                device="cpu", groups=(LocalTensorGroup(2),))
    odd = dataclasses.replace(tcfg, n_heads=3, n_kv_heads=1, d_model=48)
    with pytest.raises(ValueError, match="must divide n_heads=3"):
        tt.set_teacher(model_for_config(odd, device="cpu"))
    wide = dataclasses.replace(tcfg, d_model=96, d_ff=129)
    with pytest.raises(ValueError, match="must divide d_ff=129"):
        tt.set_teacher(model_for_config(wide, device="cpu"))
    assert tt.teacher is None
