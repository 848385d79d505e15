"""The port's sharded Trainer as a 2-process gloo gang (``fsdp=2``) on the
CPU against ``tpufw``'s Trainer on the concatenated global batch (its 8
virtual devices, the same Flax weights): ``mixtral_tiny`` under the einsum
dispatch (the routing group is the global batch, as ``tpufw``'s) and
llama3_tiny with rank-4 LoRA; losses within rtol 1e-4, gathered parameters
within 2e-4, and the LoRA base bit-unchanged. The other families and the
post-training objectives: ``test_torch_gang_families.py``."""

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
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.models import MIXTRAL_CONFIGS as J_MIXTRAL
from tpufw.models import Llama as JLlama
from tpufw.models import Mixtral as JMixtral
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS, MIXTRAL_CONFIGS
from tpufw_torch.models.lora import is_lora_name

B, SEQ, STEPS = 8, 17, 3
KW = dict(batch_size=B, seq_len=SEQ, total_steps=STEPS, lr=1e-2,
          warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32")
F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
J32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
FSDP2 = {"data": 1, "fsdp": 2}


def _jax_init(jcls, jcfg, tcfg):
    """(tpufw's Trainer initialized from seed 0, its params as the port's
    state dict)."""
    jt = JTrainer(jcls(jcfg), JTrainerConfig(**KW), JMeshConfig(data=8))
    jt.init_state(seed=0)
    return jt, params_from_flax(jax.device_get(jt.state.params), tcfg)


def _jax_run(jt, tcfg, batches):
    """(losses, final params) of tpufw's Trainer ``jt``."""
    hist = jt.run(iter(batches), model_flops_per_token=1.0)
    return [m.loss for m in hist], params_from_flax(
        jax.device_get(jt.state.params), tcfg)


CASES = {
    "mixtral_einsum": (JMixtral, dataclasses.replace(
        J_MIXTRAL["mixtral_tiny"], moe_dispatch="einsum", **J32),
        dataclasses.replace(MIXTRAL_CONFIGS["mixtral_tiny"],
                            moe_dispatch="einsum", **F32)),
    "llama_lora": (JLlama, dataclasses.replace(
        J_LLAMA["llama3_tiny"], lora_rank=4, **J32),
        dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], lora_rank=4, **F32)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_models")
    data = global_batches(B, SEQ, STEPS)
    inits, paths = {}, {}
    for name, (jcls, jcfg, tcfg) in CASES.items():
        inits[name] = _jax_init(jcls, jcfg, tcfg)
        paths[name] = write_case(tmp / f"{name}.pt", name, tcfg,
                                 dict(KW, handle_preemption=False), FSDP2,
                                 inits[name][1], data)
    procs = start_gang([WORKER, *paths.values()])
    try:
        refs = {name: _jax_run(inits[name][0], CASES[name][2], data)
                for name in CASES}
    finally:
        finish(procs)
    refs["llama_lora_start"] = inits["llama_lora"][1]
    return {name: read_outputs(p) for name, p in paths.items()}, refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_matches_global_batch_run(runs, name):
    outs, refs = runs
    losses, params = refs[name]
    assert outs[name][0]["losses"] == outs[name][1]["losses"]
    np.testing.assert_allclose(outs[name][0]["losses"], losses, rtol=1e-4)
    got = outs[name][0]["params"]
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


def test_lora_gang_trains_adapters_only(runs):
    """Under fully_shard the frozen base stays bit for bit as it was and
    every adapter moves: the optimizer and grad_norm see the adapters
    alone."""
    outs, refs = runs
    got, start = outs["llama_lora"][0]["params"], refs["llama_lora_start"]
    adapters = [k for k in got if is_lora_name(k)]
    assert adapters
    for k, v in got.items():
        assert torch.equal(v, start[k]) != is_lora_name(k), k
