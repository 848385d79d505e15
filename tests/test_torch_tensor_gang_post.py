"""The tensor and expert axes of items 12g-1 and 12g-2 across processes:
one 4-rank gloo gang on the CPU (``tests/torch_gang_worker.py``, which
imports no JAX), each rank holding its shards, against one process's
local groups over the same global batches (held to ``tpufw`` in
``test_torch_tensor_post.py``, ``test_torch_tensor_embed.py`` and
``test_torch_pipeline*_tensor.py``):

- DPO, distillation, E5 embeddings and GRPO on ``tensor=2 x fsdp=2``:
  the batch-shard ranks of a tensor coordinate are two of the four, so
  the gang's means, the gathered in-batch negatives (each row once, not
  once a tensor rank) and the GRPO rows run over them; the DPO reference
  and the teacher are cut as the policy is, the GRPO decode view gathered
  whole;
- GPipe and 1F1B on ``pipe=2 x tensor=2`` (the manual schedule's
  per-stage ``autograd.grad`` through the all-reduces) and Mixtral's
  GPipe on ``pipe=2 x expert=2``;
- a ``pipe=2 x tensor=2`` checkpoint: the gang saves its step 2 (the split
  stage leaves and their moments gathered whole), resumes it (cut again)
  and trains step 3, which one process resumes too: both step-3 losses
  and grad norms those of one process's unbroken run.

Held: every rank's losses equal, rank 0's losses and grad norms within
1e-5 of one process's (a replicated gradient summed twice over a tensor
axis, or a split one's shards counted once in the clip's norm, shows in
the grad norm) and its gathered parameters within 1e-4 absolute, a tenth
of one Adam step at lr 1e-3 (Adam amplifies the summation order of
near-zero gradients; a wrong leaf moves by whole steps). fp32 throughout,
the distillation teacher too."""

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
from tpufw_torch.mesh import MeshConfig
from tpufw_torch.models import LLAMA_CONFIGS, MIXTRAL_CONFIGS
from tpufw_torch.models import model_for_config
from tpufw_torch.parallel import LocalTensorGroup
from tpufw_torch.parallel.pipeline import (
    PipelineConfig,
    init_pipeline_params,
    tree_leaves,
)
from tpufw_torch.train import (
    ContrastiveConfig,
    DistillConfig,
    DistillTrainer,
    DPOConfig,
    DPOTrainer,
    EmbeddingTrainer,
    GRPOConfig,
    GRPOTrainer,
    PipelineTrainer,
    TrainerConfig,
)
from tpufw_torch.workloads.rl import resolve_reward

WORLD = 4
TINY = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
MOE = dataclasses.replace(MIXTRAL_CONFIGS["mixtral_tiny"],
                          dtype=torch.float32, capacity_factor=2.0)
SEQ, STEPS = 17, 2
KW = dict(batch_size=8, seq_len=SEQ, total_steps=STEPS, lr=1e-3,
          warmup_steps=0, loss_chunk_size=8, loss_chunk_dtype="float32",
          handle_preemption=False, log_every=1)
POST_MESH = {"data": 1, "fsdp": 2, "tensor": 2}
DISTILL = dict(teacher_dtype="float32")
GRPO = dict(group_size=4, max_new_tokens=6, kl_beta=0.1, ref_dtype="float32")
PROMPTS = [[7, 8, 9, 10], [11, 12, 13]]
# name: (model config, PipelineConfig kwargs, the gang's mesh).
PIPES = {
    "pptp_gpipe": (dataclasses.replace(TINY, n_layers=4),
                   dict(n_stages=2, n_microbatches=4),
                   {"data": 1, "pipe": 2, "fsdp": 1, "tensor": 2}),
    "pptp_1f1b": (dataclasses.replace(TINY, n_layers=4),
                  dict(n_stages=2, n_microbatches=4, schedule="1f1b"),
                  {"data": 1, "pipe": 2, "fsdp": 1, "tensor": 2}),
    "ppep_mixtral": (MOE, dict(n_stages=2, n_microbatches=2),
                     {"data": 1, "pipe": 2, "fsdp": 1, "expert": 2}),
}


def _split():
    return (LocalTensorGroup(2),)


def _lm_run(trainer, batches):
    """(losses, grad norms, whole params) of one process's run."""
    rec = [trainer.train_step(b) for b in batches]
    return ([float(m["loss"]) for m in rec],
            [float(m["grad_norm"]) for m in rec], trainer.whole_state())


def _one_process(data, dpo_data, teacher_state, embed_data):
    """The references: each case in this process over its local
    groups."""
    out = {}
    tr = DPOTrainer(TINY, TrainerConfig(**KW), device="cpu",
                    dpo=DPOConfig(ref_dtype="float32"), groups=_split())
    tr.init_state(seed=0)
    out["dpo"] = _lm_run(tr, dpo_data)
    tr = DistillTrainer(TINY, TrainerConfig(**KW), device="cpu",
                        distill=DistillConfig(**DISTILL), groups=_split())
    tr.init_state(seed=0)
    teacher = model_for_config(TINY, device="cpu")
    teacher.load_state_dict(teacher_state)
    tr.set_teacher(teacher)
    out["distill"] = _lm_run(tr, data)
    tr = EmbeddingTrainer(TINY, TrainerConfig(**KW), device="cpu",
                          contrastive=ContrastiveConfig(pooling="last"),
                          groups=_split())
    tr.init_state(seed=0)
    out["embed"] = _lm_run(tr, embed_data)
    tr = GRPOTrainer(TINY, TrainerConfig(**dict(KW, seq_len=24)),
                     device="cpu", grpo=GRPOConfig(**GRPO), groups=_split())
    tr.init_state(seed=0)
    hist = tr.run_rl(PROMPTS, resolve_reward("low_token", TINY.vocab_size,
                                             GRPO["max_new_tokens"]), seed=0)
    out["grpo"] = ([h["loss"] for h in hist], [h["grad_norm"] for h in hist],
                   tr.whole_state())
    for name, (cfg, pipe, mesh) in PIPES.items():
        tr = PipelineTrainer(cfg, PipelineConfig(**pipe),
                             TrainerConfig(**KW),
                             MeshConfig(**dict(mesh, pipe=pipe["n_stages"])),
                             device="cpu")
        tr.init_state(params=_pipe_state(cfg, pipe))
        rec = [tr.train_step(b) for b in data]
        out[name] = ([float(m["loss"]) for m in rec],
                     [float(m["grad_norm"]) for m in rec],
                     dict(tree_leaves(tr.whole_params())))
    return out


def _pipe_state(cfg, pipe):
    return init_pipeline_params(cfg, PipelineConfig(**pipe), seed=0,
                                device="cpu")


def _resume_runs(tmp, data3):
    """(the unbroken one-process run's (losses, grad norms) over the 3
    batches, one process's step 3 resumed from the gang's checkpoint)."""
    cfg, pipe, mesh = PIPES["pptp_gpipe"]

    def trainer(total, ckpt=None):
        return PipelineTrainer(cfg, PipelineConfig(**pipe), TrainerConfig(
            **dict(KW, total_steps=total, checkpoint_dir=ckpt)),
            MeshConfig(**mesh), device="cpu")

    tr = trainer(3)
    tr.init_state(params=_pipe_state(cfg, pipe))
    rec = [tr.train_step(b) for b in data3]
    again = trainer(3, str(tmp / "ck"))
    assert again.maybe_restore() and again.step == 2
    m = again.train_step(data3[2])
    return (([float(r["loss"]) for r in rec],
             [float(r["grad_norm"]) for r in rec]),
            (float(m["loss"]), float(m["grad_norm"])))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_gang_post")
    data = global_batches(8, SEQ, STEPS)
    dpo_data = global_batches(8, SEQ, STEPS, seed=5, dpo=True)
    embed_data = [{"tokens": b["tokens"],
                   "segment_ids": np.ones_like(b["tokens"])}
                  for b in global_batches(8, SEQ, STEPS, seed=6)]
    state = model_for_config(TINY, device="cpu", seed=0).state_dict()
    teacher = model_for_config(TINY, device="cpu", seed=1).state_dict()
    paths = {
        "dpo": write_case(tmp / "dpo.pt", "dpo", TINY, KW, POST_MESH, state,
                          dpo_data, kind="dpo",
                          dpo={"ref_dtype": "float32"}),
        "distill": write_case(tmp / "distill.pt", "distill", TINY, KW,
                              POST_MESH, state, data, kind="distill",
                              teacher_cfg=TINY, teacher_state=teacher,
                              distill=DISTILL),
        "embed": write_case(tmp / "embed.pt", "embed", TINY, KW, POST_MESH,
                            state, embed_data, kind="embed",
                            contrastive={"pooling": "last"}),
        "grpo": write_case(tmp / "grpo.pt", "grpo", TINY,
                           dict(KW, seq_len=24), POST_MESH, {}, [],
                           kind="grpo", grpo=GRPO, seed=0, prompts=PROMPTS),
    }
    for name, (cfg, pipe, mesh) in PIPES.items():
        paths[name] = write_case(tmp / f"{name}.pt", name, cfg, KW, mesh,
                                 _pipe_state(cfg, pipe), data,
                                 kind="pipeline", pipe=pipe)
    data3 = global_batches(8, SEQ, 3)
    cfg, pipe, mesh = PIPES["pptp_gpipe"]
    ck = dict(KW, checkpoint_dir=str(tmp / "ck"), checkpoint_every=2)
    # Both runs on the 3-step schedule: the first stops when its 2 batches
    # end, after the save at step 2.
    resume = [write_case(tmp / f"{name}.pt", name, cfg,
                         dict(ck, total_steps=3), mesh,
                         _pipe_state(cfg, pipe), batches, kind="pipeline",
                         pipe=pipe, resume=again)
              for name, again, batches in (("pptp_save", False, data3[:2]),
                                           ("pptp_resume", True, data3[2:]))]
    procs = start_gang([WORKER, *paths.values(), *resume], world=WORLD,
                       one_host=True)
    try:
        one = _one_process(data, dpo_data, teacher, embed_data)
    finally:
        finish(procs, timeout=300)
    return ({name: read_outputs(p, WORLD) for name, p in paths.items()}, one,
            [read_outputs(p, WORLD) for p in resume],
            _resume_runs(tmp, data3))


def _gang_numbers(name, outs):
    """(losses, grad norms, params) of rank 0, and every rank's losses."""
    o = outs[0]
    if name in ("dpo", "distill"):
        return (o["losses"], o["grad_norms"], o["params"],
                [r["losses"] for r in outs])
    if name == "embed":
        def get(k):
            return [m[k] for m in o["metrics"]]
        return (get("loss"), get("grad_norm"), o["params"],
                [[m["loss"] for m in r["metrics"]] for r in outs])
    if name == "grpo":
        return ([h["loss"] for h in o["history"]],
                [h["grad_norm"] for h in o["history"]], o["params"],
                [[h["loss"] for h in r["history"]] for r in outs])
    return (o["losses"], o["grad_norms"], dict(tree_leaves(o["params"])),
            [r["losses"] for r in outs])


@pytest.mark.parametrize("name", ["dpo", "distill", "embed", "grpo",
                                  *PIPES])
def test_gang_equals_one_process(gang, name):
    outs, one = gang[:2]
    losses, norms, params, every = _gang_numbers(name, outs[name])
    want_l, want_n, want_p = one[name]
    assert all(r == losses for r in every), every
    assert len(losses) == STEPS
    # GRPO's loss is rounding noise at a ratio of 1: absolute there.
    np.testing.assert_allclose(losses, want_l, rtol=1e-5,
                               atol=1e-6 if name == "grpo" else 0)
    np.testing.assert_allclose(norms, want_n, rtol=1e-5)
    assert params.keys() == want_p.keys()
    for k, v in want_p.items():
        np.testing.assert_allclose(params[k].numpy(), v.detach().numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


def test_pptp_checkpoint_resumes_in_the_gang_and_in_one_process(gang):
    """The gang's step-2 checkpoint holds the split stage leaves whole:
    the gang resumed from it (cut again) and one process resumed from it
    both train step 3 as one process's unbroken run does."""
    (saved, resumed), ((want_l, want_n), one_resumed) = gang[2], gang[3]
    np.testing.assert_allclose(saved[0]["losses"], want_l[:2], rtol=1e-5)
    assert all(r["losses"] == resumed[0]["losses"] for r in resumed)
    np.testing.assert_allclose(
        [resumed[0]["losses"][0], resumed[0]["grad_norms"][0]],
        [want_l[2], want_n[2]], rtol=1e-5)
    np.testing.assert_allclose(one_resumed, [want_l[2], want_n[2]],
                               rtol=1e-5)
