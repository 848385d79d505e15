"""The sequence-parallel gang's objectives beyond the plain LM loss: one
2-process gloo gang on the CPU with ``sequence=2`` (each rank all 8 rows
and half of the 64 trained positions), against ``tpufw``'s Trainer on
``MeshConfig(fsdp=4, sequence=2)`` on the same global batches from the
same Flax weights, the ring backend on both sides:

- ``mixtral_tiny`` under each dispatch, at half the balanced load so that
  experts drop tokens: which ones depends on the global token order the
  gang's routing group must keep (``ops.moe.routing_order``);
- DPO: a row's response log-prob sum crosses the two ranks and is summed
  over the ring, with its gradient, before the sigmoid.

Losses within rtol 1e-4, gathered parameters within 2e-4
(tests/conftest.py), both ranks' losses equal. The gang imports no JAX."""

import dataclasses

import jax
import jax.numpy as jnp
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
    SEQ2,
    tpufw_sequence_trainer,
)
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import MIXTRAL_CONFIGS as J_MIXTRAL
from tpufw.models import Llama as JLlama
from tpufw.models import Mixtral as JMixtral
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS, MIXTRAL_CONFIGS

F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
J32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
DPO = dict(beta=0.5, ref_dtype="float32")
# Mixtral's capacity factor: half the balanced load, so experts drop
# tokens, and which ones depends on the routing group's token order.
DROPS = 0.5

# tpufw's runs: name -> (model class, config, DPO kwargs or None).
REFS = {
    "mixtral": (JMixtral, dataclasses.replace(
        J_MIXTRAL["mixtral_tiny"], capacity_factor=DROPS, **J32), None),
    "dpo": (JLlama, dataclasses.replace(J_LLAMA["llama3_tiny"], **J32), DPO),
}
# The gang's cases: name -> (the tpufw run it equals, port config).
CASES = {
    **{f"mixtral_{mode}_ring": ("mixtral", dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_tiny"], attention_backend="ring",
        moe_dispatch=mode, capacity_factor=DROPS, **F32))
       for mode in ("einsum", "sorted")},
    "dpo_ring": ("dpo", dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], attention_backend="ring", **F32)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_sequence_objectives")
    data = {"mixtral": global_batches(GANG_B, GANG_SEQ, GANG_STEPS),
            "dpo": global_batches(GANG_B, GANG_SEQ, GANG_STEPS, dpo=True)}
    jts = {ref: tpufw_sequence_trainer(*args) for ref, args in REFS.items()}
    paths = {}
    for name, (ref, tcfg) in CASES.items():
        state = params_from_flax(jax.device_get(jts[ref].state.params), tcfg)
        paths[name] = write_case(
            tmp / f"{name}.pt", name, tcfg,
            dict(GANG_KW, handle_preemption=False), SEQ2, state, data[ref],
            kind="dpo" if ref == "dpo" else "lm", dpo=DPO)
    procs = start_gang([WORKER, *paths.values()])
    try:
        want = {}
        for ref, jt in jts.items():
            hist = jt.run(iter(data[ref]), model_flops_per_token=1.0)
            want[ref] = ([m.loss for m in hist],
                         jax.device_get(jt.state.params))
    finally:
        finish(procs)
    return {name: read_outputs(p) for name, p in paths.items()}, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_gang_objective_matches_tpufw(runs, name):
    outs, want = runs
    ref, tcfg = CASES[name]
    losses, jparams = want[ref]
    assert_gang_matches_tpufw(outs[name], losses,
                              params_from_flax(jparams, tcfg))
