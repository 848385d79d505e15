"""GRPO as a gang of one host's GPUs: a 2-process gloo gang told its ranks
as a per-GPU launcher tells them (``TPUFW_NUM_PROCESSES=1``,
``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE=2``), 2 steps of ``run_rl`` against
the port's one-process run from the same seed.

Every rank rolls out the whole global batch from the step's generator on
the gathered policy, so its rollout tokens are one process's; it trains
its half of the rows, whose completion-token counts differ (an EOS
picked so that they do), through the sharded model, the loss being the
global token mean. Held, within 1e-5 of one process: losses, grad norms,
KL and the parameters, for a full fine-tune with a frozen reference copy
and for LoRA (adapters alone moved, the reference the bypassed base);
every step's mean ratio within 1e-6 of 1; the gang's checkpoint resumes
in one process; ``python -m tpufw_torch.workloads.rl`` runs as the same
gang and refuses more than one host with ``tpufw``'s words."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.torch_gang import (
    WORKER,
    finish,
    read_outputs,
    start_gang,
    write_case,
)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_parity import workload_env
from tpufw_torch.models import LLAMA_CONFIGS
from tpufw_torch.models.lora import is_lora_name
from tpufw_torch.train import GRPOConfig, GRPOTrainer, TrainerConfig
from tpufw_torch.train.grpo import step_generator
from tpufw_torch.workloads.rl import resolve_reward

TINY = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32)
PROMPTS = [[7, 8, 9, 10], [11, 12, 13]]
# No warm-up: step 1 moves the policy, so step 2's rollout samples the
# gathered, updated weights.
KW = dict(batch_size=8, seq_len=24, total_steps=2, lr=1e-3, warmup_steps=0,
          loss_chunk_size=8, loss_chunk_dtype="float32",
          handle_preemption=False)
GRPO = dict(group_size=4, max_new_tokens=8, kl_beta=0.1,
            ref_dtype="float32")
# name: (model config, checkpointed).
CASES = {"full": (TINY, True),
         "lora": (dataclasses.replace(TINY, lora_rank=4), False)}


def _trainer(cfg, grpo, **kw):
    return GRPOTrainer(cfg, TrainerConfig(**{**KW, **kw}), device="cpu",
                       grpo=GRPOConfig(**grpo))


def _reward(grpo):
    return resolve_reward("low_token", TINY.vocab_size,
                          grpo["max_new_tokens"])


def _pick_eos() -> int:
    """A token whose first place in step 0's completions (sampled without
    an EOS: stopping does not change a row's earlier draws) leaves the
    gang's two halves of the rows different completion-token counts."""
    tr = _trainer(TINY, GRPO)
    tr.init_state(seed=0)
    batch, _ = tr.rollout(PROMPTS, _reward(GRPO),
                          step_generator(tr.device, 0, 0))
    n = GRPO["max_new_tokens"]
    comps = [row[len(p):len(p) + n].tolist() for row, p in
             zip(batch["tokens"], [p for p in PROMPTS for _ in range(4)])]
    for eos in sorted({t for c in comps for t in c}):
        lens = [c.index(eos) + 1 if eos in c else n for c in comps]
        if sum(lens[:4]) != sum(lens[4:]) and min(lens) < n:
            return eos
    raise AssertionError("no token splits the halves' counts")


def _one_process(cfg, grpo, ckpt=None, resume=False):
    """(history, completions a step, gathered params) of one process."""
    tr = _trainer(cfg, grpo, **({"checkpoint_dir": ckpt} if ckpt else {}))
    tr.init_state(seed=0)
    if resume:
        assert tr.maybe_restore() and tr.step == 1
    import tpufw_torch.infer

    completions, generate = [], tpufw_torch.infer.generate

    def recorded(*a, **k):
        completions.append(generate(*a, **k).clone())
        return completions[-1]

    tpufw_torch.infer.generate = recorded
    try:
        history = tr.run_rl(PROMPTS, _reward(grpo), seed=0)
    finally:
        tpufw_torch.infer.generate = generate
    return history, completions, tr.model.state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang_grpo")
    grpo = dict(GRPO, eos_id=_pick_eos())
    paths, ckpt = {}, str(tmp / "ckpt")
    for name, (cfg, checkpointed) in CASES.items():
        trainer = dict(KW, **({"checkpoint_dir": ckpt, "checkpoint_every": 1}
                              if checkpointed else {}))
        paths[name] = write_case(
            tmp / f"{name}.pt", name, cfg, trainer, {"data": 1, "fsdp": 2},
            {}, [], kind="grpo", grpo=grpo, seed=0, prompts=PROMPTS)
    workload = write_case(
        tmp / "workload.pt", "workload", None, {}, {}, {}, [],
        kind="workload", module="rl", env=dict(
            DEVICE="cpu", MODEL="llama3_tiny", BATCH_SIZE=8, SEQ_LEN=24,
            LOSS_CHUNK_SIZE=8, TOTAL_STEPS=2, GRPO_GROUP=4,
            GRPO_MAX_NEW=6, MESH_FSDP=2))
    procs = start_gang([WORKER, *paths.values(), workload], one_host=True)
    try:
        one = {name: _one_process(cfg, grpo)
               for name, (cfg, _) in CASES.items()}
        init = _trainer(CASES["lora"][0], grpo)
        init = {k: v.clone() for k, v in
                init.init_state(seed=0).state_dict().items()}
    finally:
        outs = finish(procs)
    got = {name: read_outputs(p) for name, p in paths.items()}
    # The gang's step-1 checkpoint, resumed in one process for step 2.
    resumed = str(tmp / "resumed")
    shutil.copytree(ckpt, resumed)
    shutil.rmtree(os.path.join(resumed, "2"))
    again = _one_process(TINY, grpo, resumed, resume=True)
    return got, one, init, again, [out for out, _ in outs]


def test_every_rank_rolls_out_one_process_tokens(runs):
    got, one, _, _, _ = runs
    for name in CASES:
        want = one[name][1]
        assert len(want) == 2
        for rank in got[name]:
            assert len(rank["completions"]) == 2
            for g, w in zip(rank["completions"], want):
                assert torch.equal(g, w), name


def test_ranks_train_their_rows_with_different_completion_counts(runs):
    """Each rank's rows are its half of the rollout (prompt, then the
    completion up to its EOS), and the halves' completion-token counts
    differ: there the mean of the ranks' means is not the global one."""
    got, one, _, _, _ = runs
    ranks = got["full"]
    assert [r["shard"] for r in ranks] == [(0, 2), (1, 2)]
    counts = [float(r["rows"][0]["loss_mask"].sum()) for r in ranks]
    assert counts[0] != counts[1]
    tiled = [p for p in PROMPTS for _ in range(GRPO["group_size"])]
    for step, comp in enumerate(one["full"][1]):
        rows = np.concatenate([r["rows"][step]["tokens"] for r in ranks])
        mask = np.concatenate([r["rows"][step]["loss_mask"] for r in ranks])
        for i, p in enumerate(tiled):
            n = int(mask[i].sum())
            assert rows[i, :len(p)].tolist() == p
            assert rows[i, len(p):len(p) + n].tolist() == \
                comp[i, :n].tolist()


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_params_match_one_process(runs, name):
    got, one, _, _, _ = runs
    history, _, params = one[name]
    keys = ("loss", "grad_norm", "kl", "mean_ratio", "clip_frac",
            "reward_mean", "completion_len_mean")
    for rank in got[name]:
        for k in keys:
            np.testing.assert_allclose([h[k] for h in rank["history"]],
                                       [h[k] for h in history], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert all(abs(h["mean_ratio"] - 1.0) <= 1e-6
                   for h in rank["history"])
    gathered = got[name][0]["params"]
    assert gathered.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(gathered[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_lora_gang_moves_adapters_only(runs):
    got, _, init, _, _ = runs
    params = got["lora"][0]["params"]
    moved = [k for k, v in params.items() if not torch.equal(v, init[k])]
    assert moved and all(is_lora_name(k) for k in moved)
    assert {k for k in params if is_lora_name(k)} == set(moved)


def test_gang_checkpoint_resumes_in_one_process(runs):
    """Step 1's checkpoint of the gang (written whole by rank 0) resumes
    in one process, whose step 2 is the gang's and the unbroken one's."""
    got, one, _, again, _ = runs
    history, completions, _ = again
    assert len(history) == 1 and history[0]["step"] == 2
    assert torch.equal(completions[0], one["full"][1][1])
    for want in (got["full"][0]["history"][1], one["full"][0][1]):
        np.testing.assert_allclose(history[0]["loss"], want["loss"],
                                   rtol=1e-5, atol=1e-6)


def test_rl_workload_runs_as_a_one_host_gang(runs):
    outs = runs[4]
    entries = []
    for rank, out in enumerate(outs):
        assert f"rank {rank}/2" in out and "'fsdp': 2" in out
        assert "RL OK: 2 steps" in out
        steps = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"reward_mean"')]
        assert [s["step"] for s in steps] == [1, 2]
        entries.append([(s["reward_mean"], s["loss"], s["kl"])
                        for s in steps])
    assert entries[0] == entries[1]


def test_rl_workload_refuses_more_than_one_host(monkeypatch):
    from tpufw_torch.workloads import rl

    workload_env(monkeypatch, dict(
        DEVICE="cpu", COORDINATOR="127.0.0.1:1", NUM_PROCESSES="2",
        PROCESS_ID="0"))
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match=(
            r"^the RL workload is single-process for now: rollouts are "
            r"host-driven; shard prompts across independent Jobs "
            r"instead$")):
        rl.main()
