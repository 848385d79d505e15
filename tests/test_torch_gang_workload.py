"""``python -m tpufw_torch.workloads.train_llama``'s ``main`` as a 2-process
gloo gang on the CPU (processes that import no JAX) under
``TPUFW_MESH_FSDP=2`` and under ``TPUFW_MESH_DATA=2``, told its rank
through ``TPUFW_COORDINATOR``/``TPUFW_NUM_PROCESSES``/``TPUFW_PROCESS_ID``,
on SFT conversations whose two shards carry different target counts,
from ``tpufw``'s init (``TPUFW_INIT_FROM``): both ranks print the same
losses, within rtol 1e-4 of ``tpufw``'s Trainer on the concatenated
global batches."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_gang import finish, start_gang, WORKER
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.mesh import MeshConfig as JMeshConfig
from tpufw.models import LLAMA_CONFIGS as J_CONFIGS
from tpufw.models import Llama as JLlama
from tpufw.train import Trainer as JTrainer
from tpufw.train import TrainerConfig as JTrainerConfig
from tpufw_torch.interop import params_from_flax
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.train import sft
from tpufw_torch.train.checkpoint import save_params

TCFG = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
JCFG = dataclasses.replace(J_CONFIGS["llama3_tiny"], dtype=jnp.float32)

LOCAL_BS, SEQ, STEPS = 4, 48, 3
ENV = dict(DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=2 * LOCAL_BS,
           SEQ_LEN=SEQ, TOTAL_STEPS=STEPS, LR="1e-3", WARMUP_STEPS=1,
           LOSS_CHUNK_SIZE=8, LOSS_CHUNK_DTYPE="float32",
           SFT_TEMPLATE="chatml")


def _conversations(path):
    """Even conversations (rank 0's shard) answer at length, odd ones
    (rank 1's) in a word: the ranks' batches carry different numbers of
    trained targets."""
    rows = []
    for i in range(12):
        answer = f"answer number {i} " * 3 if i % 2 == 0 else "ok"
        rows.append({"messages": [
            {"role": "user", "content": f"question {i} about things"},
            {"role": "assistant", "content": answer}]})
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _global_batches(path):
    """Every step's global batch: rank 0's rows, then rank 1's, as the
    workload's ``sft_batches`` shards give them."""
    shards = [sft.sft_batches(path, LOCAL_BS, SEQ, sft.byte_encode,
                              template="chatml", seed=0, shard_id=r,
                              num_shards=2) for r in range(2)]
    out = []
    for _ in range(STEPS):
        parts = [next(s) for s in shards]
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
    return out


def _losses(stdout):
    return [json.loads(ln)["loss"] for ln in stdout.splitlines()
            if ln.startswith('{"step"')]


@pytest.fixture(scope="module")
def workload_runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("gang_workload")
    data = _conversations(tmp / "chats.jsonl")
    jt = JTrainer(JLlama(JCFG), JTrainerConfig(
        batch_size=2 * LOCAL_BS, seq_len=SEQ, total_steps=STEPS, lr=1e-3,
        warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32"),
        JMeshConfig(data=8))
    jt.init_state(seed=0)
    params = tmp / "params"
    save_params(str(params), params_from_flax(
        jax.device_get(jt.state.params), TCFG), TCFG)
    env = {f"TPUFW_{k}": str(v) for k, v in ENV.items()}
    env |= {"TPUFW_SFT_DATA": data, "TPUFW_INIT_FROM": str(params)}
    gangs = {
        "fsdp2": start_gang([WORKER, "--workload"],
                            env=env | {"TPUFW_MESH_FSDP": "2"}),
        "data2": start_gang([WORKER, "--workload"],
                            env=env | {"TPUFW_MESH_DATA": "2"}),
    }
    batches = _global_batches(data)
    try:
        hist = jt.run(iter(batches), model_flops_per_token=1.0)
    finally:
        outs = {name: finish(procs) for name, procs in gangs.items()}
    return outs, [m.loss for m in hist], batches


@pytest.mark.parametrize("mesh", ["fsdp2", "data2"])
def test_workload_gang_losses_match_tpufw(workload_runs, mesh):
    outs, want, _ = workload_runs
    ranks = [_losses(out) for out, _ in outs[mesh]]
    assert len(ranks[0]) == STEPS and ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], want, rtol=1e-4)
    shape = {"fsdp2": "{'data': 1, 'fsdp': 2, 'sequence': 1}",
             "data2": "{'data': 2, 'fsdp': 1, 'sequence': 1}"}[mesh]
    for rank, (out, _) in enumerate(outs[mesh]):
        assert f"process {rank}/2 rank {rank}/2" in out
        assert f"mesh={shape}" in out
        assert f"TRAIN OK: {STEPS} steps" in out


def test_workload_gang_ranks_carry_different_target_counts(workload_runs):
    *_, batches = workload_runs
    for b in batches:
        mask = b["loss_mask"][:, 1:] * (b["segment_ids"][:, 1:] > 0)
        assert mask[:LOCAL_BS].sum() > 2 * mask[LOCAL_BS:].sum() > 0
