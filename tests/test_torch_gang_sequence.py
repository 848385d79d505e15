"""Sequence parallelism in the port's sharded Trainer: one 2-process gloo
gang on the CPU with ``sequence=2`` (each rank holds all 8 rows of the
global batch and half of the 64 trained positions, ``seq_len`` 65, as
``tests/test_ulysses.py`` trains ``tpufw``), against ``tpufw``'s Trainer
on ``MeshConfig(fsdp=4, sequence=2)`` (its 8 virtual devices, the ring
backend) on the same global batches from the same Flax weights.

Cases, all in the one spawn: llama3_tiny on ``ring``, on ``ulysses`` and
on ``xla`` (the gathered sequence), losses within rtol 1e-4 and gathered
parameters within 2e-4 (tests/conftest.py), both ranks' losses equal;
the gang's stop on ``ring`` (rank 1 alone signalled after step 2: both
stop, one forced checkpoint gathered over the fsdp x sequence mesh) whose
checkpoint resumes in one process to the unbroken gang's last step; and
the attention bodies alone over the process group's ring (its send and
receive rotations, the autograd all-to-all and all-gather): ring-flash
(the kernels' plain versions) with segments, a window and the cap, the
einsum ring non-causal, and Ulysses, forward and gradients against
``tpufw``'s ``xla_attention`` at 2e-4. Mixtral and DPO:
``test_torch_gang_sequence_objectives.py``. The gang imports no JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_gang import (
    finish,
    global_batches,
    read_outputs,
    start_gang,
    WORKER,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_sp import (
    assert_gang_matches_tpufw,
    GANG_B,
    GANG_KW,
    GANG_SEQ,
    GANG_STEPS,
    qkv,
    SEQ2,
    segments,
    TOL,
    tpufw_sequence_trainer,
)
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import Llama as JLlama
from tpufw.ops.attention import xla_attention as j_xla
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import Trainer, TrainerConfig
from tpufw_torch.train.checkpoint import CheckpointManager

JCFG = dataclasses.replace(J_LLAMA["llama3_tiny"], dtype=jnp.float32,
                           param_dtype=jnp.float32)
CASES = {f"llama_{backend}": dataclasses.replace(
    LLAMA_CONFIGS["llama3_tiny"], attention_backend=backend,
    dtype=torch.float32, param_dtype=torch.float32)
    for backend in ("ring", "ulysses", "xla")}

# The attention bodies over the gang's ring: inputs [B, T] of 2 shards,
# and each call's (backend, kwargs) beside tpufw's xla arguments.
q_, k_, v_ = qkv(11, 2, 128, 4, 2, 32)
ATTN_INPUTS = {"q": q_, "k": k_, "v": v_,
               "do": np.random.default_rng(12).standard_normal(
                   q_.shape).astype(np.float32),
               "seg": segments(2, 128, (0, 40, 100, 128))}
ATTN_CALLS = {
    "ring_flash": (("ring", dict(impl="flash", sliding_window=80,
                                 logits_soft_cap=5.0)),
                   dict(causal=True, sliding_window=80, logits_soft_cap=5.0)),
    "ring_einsum_noncausal": (("ring", dict(impl="einsum", causal=False)),
                              dict(causal=False)),
    "ulysses": (("ulysses", dict(backend="flash")), dict(causal=True)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_sequence")
    data = global_batches(GANG_B, GANG_SEQ, GANG_STEPS)
    jt = tpufw_sequence_trainer(JLlama, JCFG)
    jparams = jax.device_get(jt.state.params)
    kw = dict(GANG_KW, handle_preemption=False)
    paths = {name: write_case(tmp / f"{name}.pt", name, tcfg, kw, SEQ2,
                              params_from_flax(jparams, tcfg), data)
             for name, tcfg in CASES.items()}
    ckpt = str(tmp / "ckpt")
    paths["llama_ring_stop"] = write_case(
        tmp / "stop.pt", "llama_ring_stop", CASES["llama_ring"],
        dict(GANG_KW, checkpoint_dir=ckpt, checkpoint_every=1000,
             log_every=1), SEQ2,
        params_from_flax(jparams, CASES["llama_ring"]), data,
        signal_rank=1, signal_at=2)
    paths["attention"] = write_case(
        tmp / "attention.pt", "attention", None, {}, SEQ2, {}, [],
        kind="attention", inputs=ATTN_INPUTS,
        calls={name: call for name, (call, _) in ATTN_CALLS.items()})
    procs = start_gang([WORKER, *paths.values()])
    try:
        hist = jt.run(iter(data), model_flops_per_token=1.0)
        want = ([m.loss for m in hist], jax.device_get(jt.state.params))
    finally:
        finish(procs)
    outs = {name: read_outputs(p) for name, p in paths.items()}
    return outs, want, ckpt, data


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_gang_matches_tpufw(runs, name):
    outs, (losses, jparams), _, _ = runs
    assert_gang_matches_tpufw(outs[name], losses,
                              params_from_flax(jparams, CASES[name]))


def test_sequence_gang_stop_resumes_in_one_process(runs):
    outs, _, ckpt, data = runs
    cut, full = outs["llama_ring_stop"], outs["llama_ring"]
    assert [o["preempted"] for o in cut] == [True, True]
    assert [o["step"] for o in cut] == [2, 2]
    assert cut[0]["losses"] == cut[1]["losses"] == full[0]["losses"][:2]
    assert CheckpointManager(ckpt).all_steps() == [2]
    one = Trainer(CASES["llama_ring"], TrainerConfig(
        **GANG_KW, checkpoint_dir=ckpt, handle_preemption=False),
        device="cpu")
    assert one.maybe_restore() and one.step == 2
    losses = []
    step = one.train_step
    one.train_step = lambda b: losses.append(step(b)) or losses[-1]
    one.run(iter(data[2:]), model_flops_per_token=1.0)
    np.testing.assert_allclose([float(m["loss"]) for m in losses],
                               full[0]["losses"][2:], rtol=1e-4)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), full[0]["params"][k].numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name", sorted(ATTN_CALLS))
def test_attention_over_the_process_ring_matches_tpufw(runs, name):
    outs = runs[0]["attention"]
    got = [np.concatenate([o[name][i].numpy() for o in outs], axis=1)
           for i in range(4)]
    x = ATTN_INPUTS
    seg = jnp.asarray(x["seg"])
    kw = ATTN_CALLS[name][1]
    out, vjp = jax.vjp(lambda q, k, v: j_xla(q, k, v, segment_ids=seg, **kw),
                       *(jnp.asarray(x[k]) for k in "qkv"))
    want = [np.asarray(out), *(np.asarray(g) for g in vjp(
        jnp.asarray(x["do"])))]
    for g, w, part in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=part, **TOL)
