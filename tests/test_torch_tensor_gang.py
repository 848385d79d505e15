"""Tensor and expert parallelism across processes: 2-rank gloo gangs on
the CPU (processes that import no JAX, ``tests/torch_gang_worker.py``),
each rank holding its shard of the split parameters, against one
process's local groups (``LocalTensorGroup``/``LocalExpertGroup``, held
to ``tpufw`` in ``test_torch_tensor*.py`` and ``test_torch_expert*.py``):

- Llama at ``tensor=2`` and Mixtral at ``expert=2``: both ranks' losses
  equal, and the losses, grad norms, gathered parameters and every
  parameter's gradient (the router's, which only the combine of a rank's
  own experts reaches, included) within 1e-5 of one process;
- the checkpoint is independent of the world size: each gang resumes
  from a one-process checkpoint of step 1 and writes its own at step 3,
  which one process resumes and trains a fourth step from, equal to the
  one-process run's fourth;
- ``python -m tpufw_torch.workloads.train_llama`` under
  ``TPUFW_MESH_TENSOR=2`` trains as a gang, its losses one process's.

One gang runs every case and one process the workload's reference, while
this process computes the others."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from tests.torch_gang import (
    WORKER,
    finish,
    global_batches,
    read_outputs,
    start_gang,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_tensor import local_groups
from tpufw_torch.models import PRESETS, model_for_config
from tpufw_torch.train import Trainer, TrainerConfig

SEQ, STEPS, BATCH = 17, 3, 8
KW = dict(seq_len=SEQ, lr=1e-3, warmup_steps=1, batch_size=BATCH,
          loss_chunk_size=8, loss_chunk_dtype="float32")
# name: (preset, the gang's mesh, the one-process (expert, tensor)).
CASES = {
    "llama_tensor2": ("llama3_tiny", {"tensor": 2, "fsdp": 1}, (1, 2)),
    "mixtral_expert2": ("mixtral_tiny", {"expert": 2, "fsdp": 1}, (2, 1)),
}
WORKLOAD_ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=4,
                    SEQ_LEN=SEQ, TOTAL_STEPS=STEPS, LR="1e-3",
                    WARMUP_STEPS=1, LOSS_CHUNK_SIZE=8,
                    LOSS_CHUNK_DTYPE="float32")


def _cfg(preset):
    return dataclasses.replace(PRESETS[preset], dtype=torch.float32)


def _trainer(preset, groups, ckpt=None, total=STEPS + 1):
    return Trainer(_cfg(preset), TrainerConfig(
        **KW, total_steps=total, checkpoint_dir=ckpt, checkpoint_every=1,
        handle_preemption=False), device="cpu", groups=groups)


def _grads(trainer, batch):
    from tests.torch_gang_worker import objective_grads

    return objective_grads(trainer, batch)


def _local(preset, groups, state, data, ckpt):
    """One process's run: step 1 saved to ``ckpt``, then steps 2-3 (the
    gang's), the gradients there, and step 4."""
    tr = _trainer(preset, groups)
    tr.init_state(state_dict=state)
    rec = []
    for i, b in enumerate(data[:STEPS]):
        m = tr.train_step(b)
        rec.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            from tpufw_torch.train.checkpoint import CheckpointManager

            mgr = CheckpointManager(ckpt)
            mgr.save(1, tr.state_dict)
            mgr.close()
    params = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    grads = _grads(tr, data[1])
    step4 = float(tr.train_step(data[STEPS])["loss"])
    return rec, params, grads, step4


def _workload_losses(stdout):
    return [json.loads(ln)["loss"] for ln in stdout.splitlines()
            if ln.startswith('{"step"')]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_gang")
    data = global_batches(BATCH, SEQ, STEPS + 1)
    refs, paths = {}, {}
    for name, (preset, mesh, (ep, tp)) in CASES.items():
        state = model_for_config(_cfg(preset), device="cpu").state_dict()
        one = tmp / f"{name}_one"
        refs[name] = _local(preset, local_groups(ep, tp), state, data,
                            str(one))
        ckpt = tmp / f"{name}_gang"
        shutil.copytree(one, ckpt)
        paths[name] = write_case(
            tmp / f"{name}.pt", name, _cfg(preset),
            dict(KW, total_steps=STEPS + 1, checkpoint_dir=str(ckpt),
                 checkpoint_every=STEPS, handle_preemption=False),
            mesh, state, data[1:STEPS], resume=True, grads=True)
    work = {n: write_case(tmp / f"workload_{n}.pt", "workload", None, {},
                          {}, {}, [], kind="workload", module="train_llama",
                          env=dict(WORKLOAD_ENV, MESH_FSDP=1, **extra))
            for n, extra in (("gang", {"MESH_TENSOR": 2}), ("one", {}))}
    procs = start_gang([WORKER, *paths.values(), work["gang"]])
    one = start_gang([WORKER, work["one"]], world=1)
    outs = finish(procs, timeout=240)
    (one_process, _), = finish(one, timeout=240)
    return ({name: read_outputs(p) for name, p in paths.items()}, refs,
            data, tmp, outs, one_process)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_equals_one_process(gang, name):
    outs, refs = gang[:2]
    rec, params, grads, _ = refs[name]
    assert outs[name][0]["losses"] == outs[name][1]["losses"]
    np.testing.assert_allclose(outs[name][0]["losses"],
                               [r[0] for r in rec[1:]], rtol=1e-5)
    np.testing.assert_allclose(outs[name][0]["grad_norms"],
                               [r[1] for r in rec[1:]], rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(outs[name][0]["params"][k].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    got = outs[name][0]["grads"]
    assert got.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_checkpoint_resumes_in_one_process(gang, name):
    """The gang resumed one process's step 1 and saved step 3 whole; one
    process resumes it and trains the fourth step of the one-process
    run."""
    _, refs, data, tmp = gang[:4]
    preset = CASES[name][0]
    tr = _trainer(preset, (), ckpt=str(tmp / f"{name}_gang"))
    assert tr.maybe_restore() and tr.step == STEPS
    for k, v in refs[name][1].items():
        np.testing.assert_allclose(tr.model.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(tr.train_step(data[STEPS])["loss"]),
                               refs[name][3], rtol=1e-5)


def test_train_llama_workload_trains_as_a_tensor_gang(gang):
    outs, one_process = gang[4], gang[5]
    want = _workload_losses(one_process)
    assert len(want) == STEPS
    for rank, (out, _) in enumerate(outs):
        assert f"process {rank}/2 rank {rank}/2" in out
        assert "'tensor': 2" in out
        np.testing.assert_allclose(_workload_losses(out), want, rtol=1e-5)
