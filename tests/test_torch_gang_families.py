"""The other model families and the post-training objectives of the port's
sharded trainers as a 2-process gloo gang (``fsdp=2``) on the CPU, against
the port's own one-process trainers on the global batches (the port's
families and objectives are held to ``tpufw`` one process at a time in
their own test files): Mixtral's sorted dispatch, Gemma-2, DeepSeek's MLA
with its MoE FFN (the routing group the global batch), DPO (the reference
a sharded frozen copy) and distillation (a sharded frozen teacher);
losses within rtol 1e-5 and parameters within 1e-5."""

import dataclasses

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
from tpufw_torch.models import (
    DEEPSEEK_CONFIGS,
    GEMMA_CONFIGS,
    LLAMA_CONFIGS,
    MIXTRAL_CONFIGS,
    model_for_config,
)
from tpufw_torch.train import DistillTrainer, DPOTrainer, Trainer, TrainerConfig

B, SEQ, STEPS = 8, 17, 3
KW = dict(batch_size=B, seq_len=SEQ, total_steps=STEPS, lr=1e-2,
          warmup_steps=1, loss_chunk_size=8, loss_chunk_dtype="float32",
          handle_preemption=False)
F32 = dict(dtype=torch.float32, param_dtype=torch.float32)
TINY = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], **F32)
FSDP2 = {"data": 1, "fsdp": 2}

# name: (config, trainer class, kind).
CASES = {
    "mixtral_sorted": (dataclasses.replace(
        MIXTRAL_CONFIGS["mixtral_tiny"], moe_dispatch="sorted", **F32),
        Trainer, "lm"),
    "gemma2": (dataclasses.replace(GEMMA_CONFIGS["gemma2_tiny"], **F32),
               Trainer, "lm"),
    "deepseek_moe": (dataclasses.replace(
        DEEPSEEK_CONFIGS["deepseek_moe_tiny"], **F32), Trainer, "lm"),
    "dpo": (TINY, DPOTrainer, "dpo"),
    "distill": (TINY, DistillTrainer, "distill"),
}


def _one_process(cls, cfg, state, batches, teacher=None):
    """(losses, final params) of the port's one-process trainer."""
    tr = cls(cfg, TrainerConfig(**KW), device="cpu")
    tr.init_state(state_dict=state)
    if teacher is not None:
        tr.set_teacher(teacher)
    steps = []
    step = tr.train_step
    tr.train_step = lambda b: steps.append(step(b)) or steps[-1]
    tr.run(iter(batches), model_flops_per_token=1.0)
    return [float(m["loss"]) for m in steps], tr.model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang_families")
    data = {"lm": global_batches(B, SEQ, STEPS),
            "dpo": global_batches(B, SEQ, STEPS, dpo=True)}
    data["distill"] = data["lm"]
    teacher = model_for_config(TINY, device="cpu", seed=7)
    paths, inputs = {}, {}
    for name, (cfg, cls, kind) in CASES.items():
        state = model_for_config(cfg, device="cpu", seed=0).state_dict()
        extra = ({"teacher_cfg": cfg, "teacher_state": teacher.state_dict()}
                 if kind == "distill" else {})
        paths[name] = write_case(tmp / f"{name}.pt", name, cfg, KW, FSDP2,
                                 state, data[kind], kind=kind, **extra)
        inputs[name] = (cls, cfg, state, data[kind],
                        teacher if extra else None)
    procs = start_gang([WORKER, *paths.values()])
    try:
        refs = {name: _one_process(*args) for name, args in inputs.items()}
    finally:
        finish(procs)
    return {name: read_outputs(p) for name, p in paths.items()}, refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_gang_matches_global_batch_run(runs, name):
    outs, refs = runs
    losses, params = refs[name]
    assert outs[name][0]["losses"] == outs[name][1]["losses"]
    np.testing.assert_allclose(outs[name][0]["losses"], losses, rtol=1e-5)
    got = outs[name][0]["params"]
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
