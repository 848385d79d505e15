"""The tensor and expert axes beside a sequence ring across processes: one
4-rank gloo gang on the CPU (``tests/torch_gang_worker.py``, no JAX) on
``sequence=2 x tensor=2`` and ``sequence=2 x expert=2``, every rank
feeding all 8 rows of each global batch and half of their 64 trained
positions, with its heads (or experts) of the split parameters, against
``tpufw``'s Trainer on the same axes (``fsdp=2`` on its 8 virtual
devices) from the same Flax weights, in fp32:

- ``llama3_tiny`` on ``ring`` (the einsum ring on the CPU), ``ulysses``
  (1 KV head a tensor shard, repeated up to the query heads before the
  swap) and ``xla`` (the gathered sequence); ``gemma2_tiny`` on ``ring``
  (its window of 32 spans the ring's chunks, soft caps); ``deepseek_tiny``
  on ``ring`` (MLA's padded V); ``mixtral_tiny`` on ``ring`` over
  ``expert=2`` (capacity 0.5, so the routing's drops see the global
  token order across the sequence ranks);
- losses and grad norms within 2e-4 over 2 steps, every rank's losses
  equal, and the gathered parameters within 2e-4;
- the gang's checkpoint of step 1 resumes in one process, whose second
  step equals the gang's.

One gang runs every case while this process computes ``tpufw``'s."""

import dataclasses

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
from tests.torch_sp import GANG_B, GANG_SEQ, TOL
from tests.torch_tensor import jax_trainer, jax_train
import tpufw.models as J_MODELS
import tpufw_torch.models as T_MODELS
from tpufw_torch.train import Trainer, TrainerConfig
from tpufw_torch.train.checkpoint import CheckpointManager

STEPS = 2
KW = dict(batch_size=GANG_B, seq_len=GANG_SEQ, total_steps=STEPS, lr=1e-2,
          warmup_steps=1, loss_chunk_size=16, loss_chunk_dtype="float32")
SEQ_TP = {"data": 1, "fsdp": 1, "sequence": 2, "tensor": 2}
SEQ_EP = {"data": 1, "fsdp": 1, "sequence": 2, "expert": 2}
# name: (preset dict, preset, config overrides, the gang's mesh).
CASES = {
    **{f"llama_{b}": ("LLAMA_CONFIGS", "llama3_tiny",
                      {"attention_backend": b}, SEQ_TP)
       for b in ("ring", "ulysses", "xla")},
    "gemma_ring": ("GEMMA_CONFIGS", "gemma2_tiny",
                   {"attention_backend": "ring"}, SEQ_TP),
    "deepseek_ring": ("DEEPSEEK_CONFIGS", "deepseek_tiny",
                      {"attention_backend": "ring"}, SEQ_TP),
    "mixtral_ring": ("MIXTRAL_CONFIGS", "mixtral_tiny",
                     {"attention_backend": "ring", "capacity_factor": 0.5},
                     SEQ_EP),
}
# tpufw computes one reference per model: its ring, Ulysses and gathered
# attention agree to rounding (tests/test_torch_gang_sequence.py).
REFERENCE = {name: "llama_ring" if name.startswith("llama") else name
             for name in CASES}
RESUMED = "llama_ring"


def _pair(name):
    """(tpufw's config, the port's) of case ``name`` in fp32."""
    import jax.numpy as jnp

    table, preset, over, _ = CASES[name]
    jcfg = dataclasses.replace(
        getattr(J_MODELS, table)[preset], dtype=jnp.float32,
        param_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(
        getattr(T_MODELS, table)[preset], dtype=torch.float32,
        param_dtype=torch.float32, **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("sequence_tensor")
    data = global_batches(GANG_B, GANG_SEQ, STEPS)
    ckpt = str(tmp / "ckpt")
    # tpufw's Trainer of each reference, its initial state the gang's.
    refs = {}
    for ref in sorted(set(REFERENCE.values())):
        jcfg, tcfg = _pair(ref)
        refs[ref] = (tcfg, *jax_trainer(jcfg, tcfg, dict(CASES[ref][3],
                                                         fsdp=2),
                                        GANG_B, KW))
    paths = {}
    for name, (_, _, _, mesh) in CASES.items():
        extra = ({"checkpoint_dir": ckpt, "checkpoint_every": 1}
                 if name == RESUMED else {})
        paths[name] = write_case(
            tmp / f"{name}.pt", name, _pair(name)[1],
            dict(KW, handle_preemption=False, log_every=1, **extra), mesh,
            refs[REFERENCE[name]][2], data)
    procs = start_gang([WORKER, *paths.values()], world=4)
    try:
        want = {ref: jax_train(jt, tcfg, data)
                for ref, (tcfg, jt, _) in refs.items()}
    finally:
        finish(procs, timeout=300)
    return ({name: read_outputs(p, world=4) for name, p in paths.items()},
            want, data, ckpt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_gang_with_model_axes_matches_tpufw(runs, name):
    outs, (j_losses, j_norms, j_params) = (runs[0][name],
                                           runs[1][REFERENCE[name]])
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    assert len(outs[0]["losses"]) == STEPS
    np.testing.assert_allclose(outs[0]["losses"], j_losses, rtol=2e-4)
    np.testing.assert_allclose(outs[0]["grad_norms"], j_norms, rtol=2e-4)
    got = outs[0]["params"]
    assert got.keys() == j_params.keys()
    for k, v in j_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **TOL)


def test_sequence_gang_checkpoint_resumes_in_one_process(runs):
    """The ``sequence=2 x tensor=2`` gang saved steps 1 and 2 whole; one
    process restores step 1 and trains the second step to the gang's
    loss and parameters."""
    outs, _, data, ckpt = runs
    gang = outs[RESUMED][0]
    assert CheckpointManager(ckpt).all_steps() == [1, 2]
    one = Trainer(_pair(RESUMED)[1], TrainerConfig(
        **KW, handle_preemption=False), device="cpu")
    mgr = CheckpointManager(ckpt)
    one.load_state_dict(mgr.restore(1, device="cpu"))
    mgr.close()
    assert one.step == 1
    loss = float(one.train_step(data[1])["loss"])
    np.testing.assert_allclose(loss, gang["losses"][1], rtol=1e-5)
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), gang["params"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
