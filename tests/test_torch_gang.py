"""The port's sharded Trainer as a 2-process gloo gang on the CPU against
``tpufw``'s Trainer on the concatenated global batch (its 8 virtual
devices), from the same Flax weights: each rank takes its half of every
global batch. Held: both ranks' losses equal, the losses and the grad
norms within rtol 1e-4 of ``tpufw``'s and the gathered parameters within
2e-4 (``tests/conftest.py``'s tolerance), for ``fsdp=2`` and ``data=2``,
for a masked batch whose halves carry different target counts, and for
``grad_accum=2``.

The gang (``tests/torch_gang_worker.py``) imports no JAX; it runs every
case in one process group while this process computes the references."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_gang import finish, read_outputs, start_gang, write_case, WORKER
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import synthetic_batches

SEQ, STEPS = 17, 3
KW = dict(seq_len=SEQ, total_steps=STEPS, lr=1e-3, warmup_steps=1,
          loss_chunk_size=8, loss_chunk_dtype="float32")
JCFG = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32,
                           param_dtype=jnp.float32)
TCFG = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32,
                           param_dtype=torch.float32)


def _batches(batch, seed, masked=False):
    """STEPS global batches; ``masked``: a loss mask that trains ~90% of
    the first half's targets and ~20% of the second's."""
    it = synthetic_batches(batch, SEQ, TCFG.vocab_size, seed=seed)
    out = [next(it) for _ in range(STEPS)]
    if masked:
        rng = np.random.default_rng(seed)
        keep = np.where(np.arange(batch)[:, None] < batch // 2, 0.9, 0.2)
        for b in out:
            b["loss_mask"] = (rng.random((batch, SEQ)) < keep).astype(
                np.int32)
    return out


def _jax_run(batches, batch, grad_accum=1):
    """(losses, grad norms, final params as the port's state dict) of
    tpufw's Trainer on the global batches: its run's step function is
    wrapped to keep each step's grad_norm, which its history lacks."""
    jt = JTrainer(JLlama(JCFG), JTrainerConfig(batch_size=batch,
                                                grad_accum=grad_accum, **KW),
                  JMeshConfig(data=8))
    jt.init_state(seed=0)
    norms, compiled = [], jt.compiled_step

    def recording(b=None):
        step = compiled(b)

        def run(state, gb):
            state, m = step(state, gb)
            norms.append(float(m["grad_norm"]))
            return state, m

        return run

    jt.compiled_step = recording
    hist = jt.run(iter(batches), model_flops_per_token=1.0)
    return ([m.loss for m in hist], norms,
            params_from_flax(jax.device_get(jt.state.params), TCFG))


# name: (mesh, global batch, grad_accum, masked, the tpufw run it equals).
CASES = {
    "fsdp2": ({"data": 1, "fsdp": 2}, 8, 1, False, "plain"),
    "data2": ({"data": 2, "fsdp": 1}, 8, 1, False, "plain"),
    "masked": ({"data": 1, "fsdp": 2}, 8, 1, True, "masked"),
    "grad_accum2": ({"data": 1, "fsdp": 2}, 16, 2, False, "accum"),
}
REFS = {"plain": (8, 3, 1, False), "masked": (8, 3, 1, True),
        "accum": (16, 5, 2, False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang")
    jt = JTrainer(JLlama(JCFG), JTrainerConfig(batch_size=8, **KW),
                  JMeshConfig(data=8))
    jt.init_state(seed=0)
    state = params_from_flax(jax.device_get(jt.state.params), TCFG)
    data = {ref: _batches(b, seed, masked) for ref, (b, seed, _, masked)
            in REFS.items()}
    paths = {}
    for name, (mesh, batch, accum, _, ref) in CASES.items():
        paths[name] = write_case(
            tmp / f"{name}.pt", name, TCFG,
            dict(KW, batch_size=batch, grad_accum=accum,
                 handle_preemption=False),
            mesh, state, data[ref])
    procs = start_gang([WORKER, *paths.values()])
    try:
        want = {ref: _jax_run(data[ref], b, accum)
                for ref, (b, _, accum, _) in REFS.items()}
    finally:
        finish(procs)
    return {name: read_outputs(p) for name, p in paths.items()}, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_losses_match_tpufw_global_batch(runs, name):
    outs, want = runs
    losses, _, _ = want[CASES[name][4]]
    assert outs[name][0]["losses"] == outs[name][1]["losses"]
    assert outs[name][0]["grad_norms"] == outs[name][1]["grad_norms"]
    np.testing.assert_allclose(outs[name][0]["losses"], losses, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_grad_norms_match_tpufw(runs, name):
    """The global gradient's norm, before the clip, is tpufw's at each
    step: a gradient scaled by the world size (which Adam would nearly
    hide from the losses and parameters) shows here."""
    outs, want = runs
    _, norms, _ = want[CASES[name][4]]
    assert len(norms) == STEPS
    np.testing.assert_allclose(outs[name][0]["grad_norms"], norms,
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_params_match_tpufw(runs, name):
    outs, want = runs
    _, _, params = want[CASES[name][4]]
    got = outs[name][0]["params"]
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def test_masked_halves_carry_different_target_counts():
    """The masked case is the one where FSDP's average of the ranks'
    means is not the global mean."""
    b = _batches(8, 3, masked=True)[0]["loss_mask"][:, 1:]
    assert b[:4].sum() > 2 * b[4:].sum() > 0
