"""A pipeline across processes: two gloo ranks at ``pipe=2``, each holding
one stage (``ProcessPipeGroup``: activations and cotangents by
``batch_isend_irecv``, GPipe's hand-off differentiable), run GPipe and
1F1B through ``PipelineTrainer`` and ``train_pipeline.main`` for two
steps; their losses and the gathered params equal one process's
``LocalPipeGroup`` run within 1e-6, and the 1F1B gang's checkpoint (the
whole model, gathered over the pipe) resumes in one process. One spawn
for the trainer cases, one for the workload, run side by side."""

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
from tests.torch_parity import one_torch_thread  # noqa: F401
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.parallel.pipeline import (
    PipelineConfig,
    init_pipeline_params,
    tree_leaves,
)
from tpufw_torch.train import PipelineTrainer, TrainerConfig, synthetic_batches

CFG = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], n_layers=4,
                          dtype=torch.float32)
B, SEQ, STEPS = 8, 17, 2
KW = dict(batch_size=B, seq_len=SEQ, total_steps=STEPS, lr=1e-2,
          warmup_steps=1, log_every=1, handle_preemption=False)
SCHEDULES = ("gpipe", "1f1b")
TOL = 1e-6
# The workload's run: tpufw's knobs, llama3_tiny at 4 layers in fp32.
WL_ENV = dict(PIPE_STAGES=2, PIPE_MICROBATCHES=4, MODEL="llama3_tiny",
              BATCH_SIZE=B, SEQ_LEN=SEQ, TOTAL_STEPS=STEPS, LR=1e-2,
              WARMUP_STEPS=1, LOG_EVERY=1, PIPELINE_SCHEDULE="1f1b",
              HANDLE_PREEMPTION=0, DEVICE="cpu")


def _local(schedule, state, batches):
    tr = PipelineTrainer(CFG, PipelineConfig(2, 4, schedule),
                         TrainerConfig(**KW), device="cpu")
    tr.init_state(params=state)
    rec = []
    step = tr.train_step
    tr.train_step = lambda b: rec.append(step(b)) or rec[-1]
    tr.run(iter(batches), model_flops_per_token=1.0)
    return [float(m["loss"]) for m in rec], tr.whole_params()


def _close(got: dict, want: dict):
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=TOL,
                                   atol=TOL, err_msg=path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang_pipeline")
    state = init_pipeline_params(CFG, PipelineConfig(2, 4), seed=1,
                                 device="cpu")
    data = global_batches(B, SEQ, STEPS)
    # 1F1B's gang also checkpoints each step (rank 0 writes the whole
    # model, each rank's stages gathered over the pipe).
    ckpt = str(tmp / "ckpt")
    kws = {"gpipe": KW, "1f1b": dict(KW, checkpoint_dir=ckpt,
                                     checkpoint_every=1)}
    paths = {s: write_case(tmp / f"{s}.pt", s, CFG, kws[s],
                           dict(pipe=2, fsdp=1), state, data,
                           kind="pipeline",
                           pipe=dict(n_stages=2, n_microbatches=4,
                                     schedule=s))
             for s in SCHEDULES}
    wl_out = str(tmp / "workload")
    procs = start_gang([WORKER, *paths.values()])
    wl_procs = start_gang([WORKER, "--pipeline-workload", wl_out],
                          env={f"TPUFW_{k}": str(v) for k, v in
                               WL_ENV.items()})
    try:
        want = {s: _local(s, state, data) for s in SCHEDULES}
        # The workload's one-process twin: seed 0, shard 0's stream.
        wl_cfg = TrainerConfig(**KW)
        tr = PipelineTrainer(CFG, PipelineConfig(2, 4, "1f1b"), wl_cfg,
                             device="cpu")
        tr.init_state(seed=0)
        hist = tr.run(synthetic_batches(B, SEQ, CFG.vocab_size, seed=0),
                      model_flops_per_token=1.0)
        want["workload"] = ([h.loss for h in hist], tr.whole_params())
    finally:
        finish(procs)
        wl_outs = finish(wl_procs)
    got = {s: read_outputs(p) for s, p in paths.items()}
    got["workload"] = read_outputs(wl_out)
    return got, want, wl_outs, ckpt


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipe_gang_matches_one_process(runs, schedule):
    got, want, _, _ = runs
    losses, params = want[schedule]
    assert [o["held"] for o in got[schedule]] == [(0,), (1,)]
    for o in got[schedule]:
        np.testing.assert_allclose(o["losses"], losses, rtol=TOL)
        _close(o["params"], params)
    assert got[schedule][0]["grad_norms"] == got[schedule][1]["grad_norms"]


def test_pipe_gang_workload_matches_one_process(runs):
    import json

    got, want, wl_outs, _ = runs
    losses, params = want["workload"]
    for out, _ in wl_outs:
        steps = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"step"')]
        np.testing.assert_allclose([s["loss"] for s in steps], losses,
                                   rtol=TOL)
    assert [o["held"] for o in got["workload"]] == [(0,), (1,)]
    for o in got["workload"]:
        assert o["step"] == STEPS
        _close(o["params"], params)


def test_pipe_gang_checkpoint_resumes_in_one_process(runs):
    """The gang's last checkpoint holds the whole model and its moments
    (gathered over the pipe): one process holding both stages restores
    its params bit-equal to the gang's and trains on."""
    got, _, _, ckpt = runs
    tr = PipelineTrainer(CFG, PipelineConfig(2, 4, "1f1b"), TrainerConfig(
        **dict(KW, total_steps=STEPS + 1, checkpoint_dir=ckpt)),
        device="cpu")
    assert tr.maybe_restore() and tr.step == STEPS
    for (path, a), (_, b) in zip(tree_leaves(tr.params),
                                 tree_leaves(got["1f1b"][0]["params"])):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0, msg=path)
    assert tr.optimizer.count == STEPS
    hist = tr.run(iter(global_batches(B, SEQ, 1, seed=5)),
                  model_flops_per_token=1.0)
    assert tr.step == STEPS + 1 and np.isfinite(hist[-1].loss)
