"""A training gang of the port on one host's GPUs, one process per GPU,
against one process on the same global batches.

    python3 scripts/gang_check_torch.py [--world 4] [--cpu] [--model NAME]
        [--batch 16] [--seq 2049] [--steps 3] [--tol 1e-3]
        [--suite lm|post|tensor|pptp|seqtp|all] [--telemetry DIR]

The parent builds the CUDA kernels, then starts ``--world`` ranks of this
script on one host, told their rank as a per-GPU launcher tells them
(``TPUFW_COORDINATOR`` on a free localhost port, ``TPUFW_NUM_PROCESSES=1``,
``TPUFW_PROCESS_ID=0``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``): NCCL on
``cuda:<rank>``, or gloo with ``--cpu``. Each rank trains ``--model``
(default ``llama3_600m_bench`` at full size) through the sharded
``Trainer`` on the rows of its batch shard of every global batch, over
each mesh: every rank on ``fsdp``, then ``data=2`` by ``fsdp=world/2``,
once as it is and once with ``grad_accum=2``, then ``fsdp=world/2`` by
``sequence=2`` with ring attention (ring-flash on the GPUs; each rank
trains half of every row's ``--seq`` − 1 positions, so 2 must divide
them). Then the gang's stop:
the last rank alone request()s a stop after step 1, every rank leaves at
step 1 and rank 0 writes the forced checkpoint. Then the pipelines
(``PipelineTrainer``, one stage a rank over the mesh's ``pipe``):
``pipe=2`` by ``data=world/2`` GPipe (4 microbatches), and at
``--world 4`` ``pipe=4`` 1F1B (8 microbatches; the model's layers rounded
down to a multiple of 4, at least 4: 14 -> 12 for ``llama3_600m_bench``).
After the gang, the
parent trains the same steps in one process on the global batches
(unsharded, at each run's ``grad_accum``; a pipeline on a
``LocalPipeGroup`` holding every stage), holds each run's losses and
grad norms to it within ``--tol`` relative, and resumes the gang's checkpoint in one process:
its step-2 loss within ``--tol`` of the unbroken run's. That is the
``lm`` suite. The ``post`` suite trains the objectives over the whole
batch, every rank on ``fsdp``, each against one process within
``--tol``: E5 (``EmbeddingTrainer``, causal, last-token pooling) on
``--model``, 32 pairs of 256 tokens, the pooled vectors gathered over
the gang; GRPO (``run_rl``) on ``--model``, 2 prompts x group 8, 32 new
tokens, 2 steps, every rank rolling out all rows (the ranks' tokens
equal at every step, step 1's those of one process; later steps' share
of one process's tokens is printed); ResNet-50 at batch 256
(``MeshConfig()``), BatchNorm's statistics over the gang. With
``--cpu`` the post suite runs tiny sizes (a rehearsal of its code
paths). The ``tensor`` suite (``--world 4``) trains over the model-parallel
axes, each rank holding its shards of the split parameters, against one
process within ``--tol``: ``tensor=2`` by ``fsdp=2`` on
``llama3_600m_bench`` (16 rows of 2049 tokens), and ``expert=2`` by
``tensor=2`` on ``deepseek_v2_lite_train_slice`` (V2-Lite at full width,
3 layers; 2 rows of 2048, every rank feeding both); with ``--cpu`` on
``llama3_tiny`` and ``deepseek_moe_tiny``; then the post-trainers on
``llama3_600m_bench`` at ``tensor=2`` by ``fsdp=2`` (DPO on 8 pairs of
1024 tokens against a frozen copy cut as the policy is, its two steps
before the first update, distillation of 16 rows of 1024 from a
``llama3_600m_bench`` teacher of seed 1, E5 on 128 pairs of 128, the
pooled vectors gathered over the two batch-shard ranks of each tensor
coordinate, and GRPO, 2 prompts x group 8, 32 new tokens, 2 steps),
against one unsplit process. The ``pptp`` suite
(``--world 4``) trains ``llama3_600m_bench`` through GPipe and 1F1B on
``pipe=2`` by ``tensor=2`` (each rank one stage's tensor shard; 4
microbatches of the global batch) against one process holding both
stages unsplit. The ``seqtp`` suite (``--world 4``) trains the model
axes on the last paths, each against one unsplit process within
``--tol``: ``sequence=2`` by ``tensor=2`` on ``llama3_600m_bench``
(ring-flash, each rank half the heads and half of 8 rows of 2048 trained
positions), ``sequence=2`` by ``expert=2`` on the V2-Lite slice (3
layers, 2 rows), LoRA at ``tensor=2`` by ``fsdp=2`` on the Llama-3-8B
LoRA slice's widths at 4 layers (4 rows of 2048), and ViT-B/16 at
``tensor=2`` by ``fsdp=2`` (64 images of 224 px; losses only: its
optimizer reports no norm); with ``--cpu`` on ``llama3_tiny``,
``deepseek_moe_tiny`` and a tiny ViT. ``--suite all`` runs ``lm`` and
``post``, ``lm`` (the default) the first alone. ``--telemetry DIR`` turns the telemetry on in
the ``lm`` suite's runs: each run writes under ``DIR/<run>/`` every rank's
``events[-p<N>].jsonl``, trace, goodput, programs and metrics files, and
its skew monitor gathers the ranks' window times at every sync; the
parent checks each rank's events and prints the skew gauges and any
straggler (``telemetry_*`` lines). DIR is kept.
One JSON line per result, then (on GPUs) each card's name and power
limit from ``nvidia-smi``, ``{"ok": true, ...}`` last; exits nonzero
when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _setup(args):
    """(model config, TrainerConfig, the global batches)."""
    import dataclasses

    import torch

    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.train import TrainerConfig, synthetic_batches

    cfg = resolve_model_preset(args.model)
    # The CPU computes in fp32 throughout (the tests' precision).
    if args.cpu:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    tcfg = TrainerConfig(batch_size=args.batch, seq_len=args.seq,
                         total_steps=args.steps, warmup_steps=1,
                         log_every=1, loss_chunk_size=min(512, args.seq // 2),
                         loss_chunk_dtype="float32" if args.cpu
                         else "bfloat16", handle_preemption=False)
    it = synthetic_batches(args.batch, args.seq, cfg.vocab_size, seed=16)
    return cfg, tcfg, [next(it) for _ in range(args.steps)]


def _run(trainer, batches, **kw):
    """([(loss, grad_norm)] a step, step ms, peak GB) of ``trainer.run``."""
    import torch

    rec, step = [], trainer.train_step
    trainer.train_step = lambda b: rec.append(step(b)) or rec[-1]
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(trainer.device)
    hist = trainer.run(iter(batches), model_flops_per_token=1.0, **kw)
    pairs = [(float(m["loss"]), float(m["grad_norm"])) for m in rec]
    peak = torch.cuda.max_memory_allocated(trainer.device) / 1e9 if cuda \
        else None
    return pairs, [1e3 * m.step_time_s for m in hist], peak


def _pipelines(world: int) -> dict:
    """name: (stages, microbatches, schedule, data) of the pipeline runs
    a ``world``-rank gang makes."""
    runs = {}
    if world % 2 == 0:
        runs[f"pipe2_data{world // 2}_gpipe"] = (2, 4, "gpipe", world // 2)
    if world == 4:
        runs["pipe4_1f1b"] = (4, 8, "1f1b", 1)
    return runs


def _pipeline_trainer(cfg, tcfg, stages, micro, schedule, data, dev,
                      gang: bool):
    """A ``PipelineTrainer`` of one pipeline run: over the gang's mesh, or
    (``gang`` False) in one process holding every stage."""
    import dataclasses

    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer

    if cfg.n_layers % stages:
        cfg = dataclasses.replace(cfg, n_layers=max(
            stages, cfg.n_layers // stages * stages))
    mesh = MeshConfig(data=data, pipe=stages, fsdp=1) if gang else None
    return PipelineTrainer(cfg, PipelineConfig(stages, micro, schedule),
                           tcfg, mesh, device=dev)


# The post suite's sizes: (E5 pairs, E5 tokens a row, GRPO prompt
# lengths, group, new tokens, ResNet batch, image size, ResNet stages,
# width), on GPUs and in the CPU rehearsal.
POST_SIZES = {"gpu": (32, 256, (100, 150), 8, 32, 256, 224, (3, 4, 6, 3), 64),
              "cpu": (8, 32, (5, 7), 4, 8, 16, 32, (1, 1), 8)}
POST_STEPS = {"e5": 3, "grpo": 2, "resnet50": 3}


def _post_runs(args, dev) -> dict:
    """Each whole-batch objective's numbers on ``dev``: sharded over
    every rank on ``fsdp`` when a process group is up (each rank its
    batch shard's rows), else in one process on the global batch."""
    import dataclasses

    import numpy as np
    import torch

    import tpufw_torch.infer
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.models import ResNetConfig
    from tpufw_torch.train import (
        ContrastiveConfig,
        EmbeddingTrainer,
        GRPOConfig,
        GRPOTrainer,
        TrainerConfig,
        VisionTrainer,
        VisionTrainerConfig,
        synthetic_images,
    )
    from tpufw_torch.train.vision import batch_rows
    from tpufw_torch.workloads.rl import resolve_reward

    pairs, tokens, prompt_lens, group, new, images, size, stages, width = \
        POST_SIZES["cpu" if args.cpu else "gpu"]
    cfg = resolve_model_preset(args.model)
    if args.cpu:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cuda = dev.type == "cuda"
    out = {}

    def measured(name, run):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        out[name] = run()
        if cuda:
            out[name]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    def e5():
        rng = np.random.default_rng(17)
        tr = EmbeddingTrainer(
            cfg, TrainerConfig(batch_size=2 * pairs, seq_len=tokens,
                               total_steps=POST_STEPS["e5"], warmup_steps=1,
                               lr=2e-5, log_every=1, handle_preemption=False),
            device=dev, contrastive=ContrastiveConfig(pooling="last",
                                                      temperature=0.02))
        tr.init_state(seed=0)
        shard, n = tr.batch_shard()
        rows = 2 * pairs // n
        rec, step_ms = [], []
        for _ in range(POST_STEPS["e5"]):
            lens = rng.integers(tokens // 4, tokens + 1, 2 * pairs)
            seg = (np.arange(tokens) < lens[:, None]).astype(np.int32)
            toks = rng.integers(1, cfg.vocab_size, (2 * pairs, tokens)) * seg
            part = slice(shard * rows, (shard + 1) * rows)
            t0 = time.perf_counter()
            rec.append({k: float(v) for k, v in tr.train_step(
                {"tokens": toks[part].astype(np.int32),
                 "segment_ids": seg[part]}).items()})
            step_ms.append(1e3 * (time.perf_counter() - t0))
        return {"losses": [m["loss"] for m in rec],
                "grad_norms": [m["grad_norm"] for m in rec],
                "accuracy": [m["accuracy"] for m in rec],
                "step_ms": step_ms}

    def grpo():
        rng = np.random.default_rng(18)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in prompt_lens]
        tr = GRPOTrainer(
            cfg, TrainerConfig(batch_size=len(prompts) * group,
                               seq_len=max(prompt_lens) + new,
                               total_steps=POST_STEPS["grpo"], lr=1e-5,
                               warmup_steps=0, log_every=1,
                               loss_chunk_size=64, handle_preemption=False),
            device=dev, grpo=GRPOConfig(group_size=group, max_new_tokens=new,
                                        kl_beta=0.02))
        tr.init_state(seed=0)
        completions, generate = [], tpufw_torch.infer.generate

        def recorded(*a, **k):
            toks = generate(*a, **k)
            completions.append(toks.cpu().tolist())
            return toks

        tpufw_torch.infer.generate = recorded
        try:
            hist = tr.run_rl(prompts, resolve_reward(
                "low_token", cfg.vocab_size, new), seed=0)
        finally:
            tpufw_torch.infer.generate = generate
        return {"losses": [h["loss"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist],
                "kl": [h["kl"] for h in hist],
                "mean_ratio": [h["mean_ratio"] for h in hist],
                "completions": completions,
                "step_ms": [1e3 * (h["rollout_s"] + h["update_s"])
                            for h in hist]}

    def resnet():
        mcfg = ResNetConfig(stage_sizes=stages, width=width,
                            norm_dtype=torch.bfloat16,
                            **({"dtype": torch.float32} if args.cpu else {}))
        tr = VisionTrainer(mcfg, VisionTrainerConfig(
            batch_size=images, image_size=size, num_classes=1000,
            total_steps=POST_STEPS["resnet50"], lr=0.1,
            handle_preemption=False), device=dev)
        tr.init_state(seed=0)
        data = synthetic_images(images, size, 1000, device=dev)
        hist = tr.run(batch_rows(data, *tr.batch_shard()),
                      flops_per_image=mcfg.flops_per_image(size))
        stats = {k: v.float().cpu() for k, v in tr.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return {"losses": [m.loss for m in hist], "bn_stats": stats,
                "step_ms": [1e3 * m.step_time_s for m in hist]}

    for name, run in (("e5", e5), ("grpo", grpo), ("resnet50", resnet)):
        measured(name, run)
    return out


def _post_checks(args, ranks: list, single: dict) -> bool:
    """One JSON line per whole-batch objective: the gang's ranks agree,
    and rank 0 is within ``--tol`` of one process (relative above 1,
    absolute below: GRPO's loss is rounding noise at a ratio of 1; its
    rollout tokens equal); True when every check holds."""
    def diff(a, b):
        return max((abs(x - y) / max(abs(y), 1.0) for x, y in zip(a, b)),
                   default=0.0)

    ok = True
    for name, want in single.items():
        got = ranks[0][name]
        keys = [k for k in ("losses", "grad_norms", "kl", "accuracy")
                if k in want]
        diffs = {k: diff(got[k], want[k]) for k in keys}
        same = all(r[name]["losses"] == got["losses"] for r in ranks)
        line = {"check": f"gang_{name}_vs_one_process", "world": args.world,
                "ranks_equal": same, "max_diff": diffs, "tol": args.tol,
                **{f"{k}_gang": got[k] for k in keys},
                **{f"{k}_one_process": want[k] for k in keys},
                "step_ms_gang_rank0": got.get("step_ms"),
                "step_ms_one_process": want.get("step_ms"),
                "peak_gb_gang_rank0": got.get("peak_gb"),
                "peak_gb_one_process": want.get("peak_gb")}
        good = same and len(got["losses"]) == POST_STEPS[name] and \
            max(diffs.values()) <= args.tol
        if name == "grpo":
            # Every rank samples the same tokens at every step (the
            # replicated rollout), step 1's those of one process (the same
            # weights). After an update a gang's weights are one process's
            # only up to the rounding of each rank's bf16 weight-gradient
            # sum, which can flip a sample: later steps' agreement with
            # one process is reported, not gated.
            line["tokens_equal_across_ranks"] = all(
                r[name]["completions"] == got["completions"] for r in ranks)
            line["tokens_equal_one_process_share"] = [
                sum(a == b for ga, wa in zip(g, w) for a, b in zip(ga, wa))
                / sum(len(wa) for wa in w)
                for g, w in zip(got["completions"], want["completions"])]
            line["mean_ratio_gang"] = got["mean_ratio"]
            good &= (line["tokens_equal_across_ranks"]
                     and len(got["completions"]) == POST_STEPS[name]
                     and line["tokens_equal_one_process_share"][0] == 1.0
                     and all(abs(x - 1.0) <= 1e-6
                             for x in got["mean_ratio"]))
        if name == "resnet50":
            line["max_diff_bn_stats"] = max(
                float((got["bn_stats"][k] - v).abs().max())
                / max(float(v.abs().max()), 1.0)
                for k, v in want["bn_stats"].items())
            good &= line["max_diff_bn_stats"] <= args.tol
        line["ok"] = good
        ok &= good
        emit(line)
    return ok


# The tensor suite: name: (model on GPUs, model with --cpu, mesh, global
# batch, seq) (the CPU rehearsal at 4 rows of 33 tokens).
TENSOR_RUNS = {
    "tensor2_fsdp2": ("llama3_600m_bench", "llama3_tiny",
                      dict(data=1, fsdp=2, tensor=2), 16, 2049),
    "expert2_tensor2": ("deepseek_v2_lite_train_slice", "deepseek_moe_tiny",
                        dict(data=1, fsdp=1, expert=2, tensor=2), 2, 2048),
}


def _tensor_setup(args, name):
    """(model config, TrainerConfig, the global batches) of a tensor-suite
    run."""
    gpu_model, cpu_model, _, batch, seq = TENSOR_RUNS[name]
    if args.cpu:
        batch, seq = 4, 33
    return _setup(argparse.Namespace(**dict(
        vars(args), model=cpu_model if args.cpu else gpu_model,
        batch=batch, seq=seq)))


def _tensor_runs(args, dev) -> dict:
    """Each tensor-suite run's numbers over its mesh (a rank's)."""
    import torch

    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import Trainer

    out = {}
    for name, (_, _, mesh, _, _) in TENSOR_RUNS.items():
        cfg, tcfg, batches = _tensor_setup(args, name)
        trainer = Trainer(cfg, tcfg, MeshConfig(**mesh), device=dev)
        trainer.init_state(seed=0)
        pairs, step_ms, peak = _run(trainer, _rows(trainer, batches))
        out[name] = {"losses": [p[0] for p in pairs],
                     "grad_norms": [p[1] for p in pairs],
                     "step_ms": step_ms, "peak_gb": peak,
                     "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                                      trainer.mesh.shape))}
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _tensor_checks(args, ranks: list, dev) -> bool:
    """One JSON line per tensor-suite run: the ranks agree, and rank 0's
    losses and grad norms are within ``--tol`` of one process's."""
    import torch

    from tpufw_torch.train import Trainer

    ok = True
    for name, run in ranks[0].items():
        cfg, tcfg, batches = _tensor_setup(args, name)
        one = Trainer(cfg, tcfg, device=dev)
        one.init_state(seed=0)
        want, one_ms, one_peak = _run(one, batches)
        del one
        if dev == "cuda":
            torch.cuda.empty_cache()
        same = all(r[name]["losses"] == run["losses"] for r in ranks)
        d_loss = _rel(run["losses"], [w[0] for w in want])
        d_norm = _rel(run["grad_norms"], [w[1] for w in want])
        good = same and len(run["losses"]) == args.steps and \
            max(d_loss, d_norm) <= args.tol
        ok &= good
        emit({"check": f"gang_{name}_vs_one_process", "ok": good,
              "world": args.world, "mesh": run["mesh"],
              "model": TENSOR_RUNS[name][1 if args.cpu else 0],
              "global_batch": tcfg.batch_size, "seq_len": tcfg.seq_len,
              "ranks_equal": same, "losses_gang": run["losses"],
              "losses_one_process": [w[0] for w in want],
              "grad_norms_gang": run["grad_norms"],
              "grad_norms_one_process": [w[1] for w in want],
              "max_rel_diff_loss": d_loss, "max_rel_diff_grad_norm": d_norm,
              "tol": args.tol, "step_ms_gang_rank0": run["step_ms"],
              "peak_gb_gang_rank0": run["peak_gb"],
              "step_ms_one_process": one_ms,
              "peak_gb_one_process": one_peak})
    return ok


# The tensor suite's post-trainers: name: (rows, seq, steps) on GPUs (the
# CPU rehearsal at 8 rows of 33 tokens; GRPO's seq is its prompts' and
# new tokens'), over TENSOR_POST_MESH. DPO runs the two steps before its
# first update (step 0's rate is the warm-up's 0): after an update its
# margin over the fixed reference is the rounding of the weights' bf16
# casts, not 1e-3 apart between any two runs (chip_smoke.py phase 19);
# E5 takes 128 pairs, whose mean averages the bf16 rounding that its
# temperature scales by 50 (phase 19: 16 pairs read 2.9e-3 from one
# process's loss, 128 pairs 6.7e-4).
TENSOR_POST = {"dpo": (16, 1024, 2), "distill": (16, 1024, 3),
               "e5": (256, 128, 3), "grpo": (16, None, 2)}
TENSOR_POST_MESH = dict(data=1, fsdp=2, tensor=2)
# GRPO's prompt lengths and new tokens on GPUs and on the CPU.
GRPO_SIZES = {"gpu": ((64, 96), 8, 32), "cpu": ((5, 7), 4, 6)}


def _post_batches(cfg, name, rows, seq, steps) -> list:
    """``steps`` global batches of a tensor-suite post-trainer, drawn
    with numpy from seed 21: DPO pairs (the second half of each row the
    response), LM rows, or right-padded query/document pairs."""
    import numpy as np

    rng = np.random.default_rng(21)
    out = []
    for _ in range(steps):
        toks = rng.integers(1, cfg.vocab_size, (rows, seq))
        seg = np.ones_like(toks)
        if name == "e5":
            lens = rng.integers(seq // 4, seq + 1, rows)
            seg = (np.arange(seq) < lens[:, None]).astype(np.int32)
            toks = toks * seg
        b = {"tokens": toks.astype(np.int32),
             "segment_ids": seg.astype(np.int32)}
        if name == "dpo":
            b["loss_mask"] = np.broadcast_to(
                np.arange(seq) >= seq // 2, toks.shape).astype(
                    np.float32).copy()
        out.append(b)
    return out


def _tensor_post_run(args, dev, name, mesh) -> dict:
    """A tensor-suite post-trainer's numbers on ``dev``: over ``mesh`` (a
    MeshConfig, each rank its batch shard's rows) in the gang, unsplit
    in one process (``mesh`` None)."""
    import dataclasses

    import numpy as np
    import torch

    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train import (
        ContrastiveConfig,
        DistillTrainer,
        DPOConfig,
        DPOTrainer,
        EmbeddingTrainer,
        GRPOConfig,
        GRPOTrainer,
        TrainerConfig,
    )
    from tpufw_torch.workloads.rl import resolve_reward

    cfg = resolve_model_preset("llama3_tiny" if args.cpu
                               else "llama3_600m_bench")
    if args.cpu:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    rows, seq, steps = TENSOR_POST[name]
    prompts, group, new = GRPO_SIZES["cpu" if args.cpu else "gpu"]
    if args.cpu:
        rows, seq = 8, 33
    if name == "grpo":
        seq = max(prompts) + new
    tcfg = TrainerConfig(batch_size=rows, seq_len=seq, total_steps=steps,
                         warmup_steps=1, log_every=1,
                         lr=2e-5 if name == "e5" else 1e-5,
                         loss_chunk_size=min(512, seq),
                         loss_chunk_dtype="float32" if args.cpu
                         else "bfloat16", handle_preemption=False)
    kw = dict(device=dev)
    trainer = {
        "dpo": lambda: DPOTrainer(cfg, tcfg, mesh, dpo=DPOConfig(
            ref_dtype="float32"), **kw),
        "distill": lambda: DistillTrainer(cfg, tcfg, mesh, **kw),
        "e5": lambda: EmbeddingTrainer(cfg, tcfg, mesh, contrastive=(
            ContrastiveConfig(pooling="last", temperature=0.02)), **kw),
        "grpo": lambda: GRPOTrainer(cfg, tcfg, mesh, grpo=GRPOConfig(
            group_size=group, max_new_tokens=new, kl_beta=0.02), **kw),
    }[name]()
    trainer.init_state(seed=0)
    if name == "distill":
        trainer.set_teacher(model_for_config(cfg, device=dev, seed=1))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    if name == "grpo":
        rng = np.random.default_rng(21)
        hist = trainer.run_rl(
            [rng.integers(1, cfg.vocab_size, n).tolist() for n in prompts],
            resolve_reward("low_token", cfg.vocab_size, new), seed=0)
        pairs = [(h["loss"], h["grad_norm"]) for h in hist]
        step_ms = [1e3 * (h["rollout_s"] + h["update_s"]) for h in hist]
    else:
        batches = _post_batches(cfg, name, rows, seq, steps)
        pairs, step_ms, _ = _run(trainer, _rows(trainer, batches))
    out = {"losses": [p[0] for p in pairs],
           "grad_norms": [p[1] for p in pairs], "step_ms": step_ms,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                       else None),
           "mesh": (dict(zip(trainer.mesh.mesh_dim_names,
                             trainer.mesh.shape)) if trainer.gang else {}),
           "rows": rows, "seq_len": seq}
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    return out


def _post_tensor_checks(args, ranks: list, dev) -> bool:
    """One JSON line per tensor-suite post-trainer: the ranks agree, and
    rank 0's losses and grad norms are within ``--tol`` of one unsplit
    process's (relative above 1, absolute below: GRPO's loss is rounding
    noise at a ratio of 1)."""
    import torch

    def diff(a, b):
        return max((abs(x - y) / max(abs(y), 1.0) for x, y in zip(a, b)),
                   default=0.0)

    ok = True
    for name in TENSOR_POST:
        run = ranks[0][name]
        want = _tensor_post_run(args, torch.device(dev), name, None)
        same = all(r[name]["losses"] == run["losses"] for r in ranks)
        d_loss = diff(run["losses"], want["losses"])
        d_norm = diff(run["grad_norms"], want["grad_norms"])
        good = same and len(run["losses"]) == TENSOR_POST[name][2] and \
            max(d_loss, d_norm) <= args.tol
        ok &= good
        emit({"check": f"gang_{name}_tensor2_fsdp2_vs_one_process",
              "ok": good, "world": args.world, "mesh": run["mesh"],
              "model": "llama3_tiny" if args.cpu else "llama3_600m_bench",
              "rows": run["rows"], "seq_len": run["seq_len"],
              "ranks_equal": same, "losses_gang": run["losses"],
              "losses_one_process": want["losses"],
              "grad_norms_gang": run["grad_norms"],
              "grad_norms_one_process": want["grad_norms"],
              "max_diff_loss": d_loss, "max_diff_grad_norm": d_norm,
              "tol": args.tol, "step_ms_gang_rank0": run["step_ms"],
              "peak_gb_gang_rank0": run["peak_gb"],
              "step_ms_one_process": want["step_ms"],
              "peak_gb_one_process": want["peak_gb"]})
    return ok


# The pptp suite: name: (schedule, microbatches), on pipe=2 x tensor=2.
PPTP_RUNS = {"pipe2_tensor2_gpipe": ("gpipe", 4),
             "pipe2_tensor2_1f1b": ("1f1b", 4)}


def _pptp_runs(args, dev, gang: bool) -> dict:
    """Each pptp run's numbers: over ``pipe=2 x tensor=2`` in the gang
    (a rank's), or in one process holding both stages unsplit."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer

    cfg, tcfg, batches = _setup(args)
    out = {}
    for name, (schedule, micro) in PPTP_RUNS.items():
        mesh = (MeshConfig(data=1, pipe=2, fsdp=1, tensor=2) if gang
                else None)
        trainer = PipelineTrainer(cfg, PipelineConfig(2, micro, schedule),
                                  tcfg, mesh, device=dev)
        trainer.init_state(seed=0)
        pairs, step_ms, peak = _run(trainer, _rows(trainer, batches))
        out[name] = {"losses": [p[0] for p in pairs],
                     "grad_norms": [p[1] for p in pairs],
                     "step_ms": step_ms, "peak_gb": peak,
                     "mesh": (dict(zip(trainer.mesh.mesh_dim_names,
                                       trainer.mesh.shape))
                              if trainer.mesh is not None else {"pipe": 2})}
        del trainer
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    return out


def _pptp_checks(args, ranks: list, dev) -> bool:
    """One JSON line per pptp run: the ranks agree, and rank 0's losses
    and grad norms are within ``--tol`` of one process's."""
    import torch

    ok = True
    single = _pptp_runs(args, torch.device(dev), gang=False)
    for name, run in ranks[0].items():
        want = single[name]
        same = all(r[name]["losses"] == run["losses"] for r in ranks)
        d_loss = _rel(run["losses"], want["losses"])
        d_norm = _rel(run["grad_norms"], want["grad_norms"])
        good = same and len(run["losses"]) == args.steps and \
            max(d_loss, d_norm) <= args.tol
        ok &= good
        emit({"check": f"gang_{name}_vs_one_process", "ok": good,
              "world": args.world, "mesh": run["mesh"], "model": args.model,
              "global_batch": args.batch, "seq_len": args.seq,
              "schedule": PPTP_RUNS[name][0], "ranks_equal": same,
              "losses_gang": run["losses"],
              "losses_one_process": want["losses"],
              "grad_norms_gang": run["grad_norms"],
              "grad_norms_one_process": want["grad_norms"],
              "max_rel_diff_loss": d_loss, "max_rel_diff_grad_norm": d_norm,
              "tol": args.tol, "step_ms_gang_rank0": run["step_ms"],
              "peak_gb_gang_rank0": run["peak_gb"],
              "step_ms_one_process": want["step_ms"],
              "peak_gb_one_process": want["peak_gb"]})
    return ok


# The seqtp suite (``--world 4``): name: (model on GPUs, its layers or
# None, model with --cpu, mesh, global batch, seq, attention backend); the
# CPU rehearsal at 4 rows of 33 tokens, the LoRA run at rank 4.
SEQTP_RUNS = {
    "sequence2_tensor2": ("llama3_600m_bench", None, "llama3_tiny",
                          dict(data=1, fsdp=1, sequence=2, tensor=2), 8,
                          2049, "ring"),
    "sequence2_expert2": ("deepseek_v2_lite_train_slice", 3,
                          "deepseek_moe_tiny",
                          dict(data=1, fsdp=1, sequence=2, expert=2), 2,
                          2049, "ring"),
    "lora_tensor2_fsdp2": ("llama3_8b_lora_train_slice", 4, "llama3_tiny",
                           dict(data=1, fsdp=2, tensor=2), 4, 2048,
                           "flash"),
}
# ViT-B/16 at tensor=2 x fsdp=2: (name, mesh, images, image size) on GPUs
# (a tiny ViT of 32 px, 8 images, with --cpu).
SEQTP_VIT = ("vit_tensor2_fsdp2", dict(data=1, fsdp=2, tensor=2), 64, 224)


def _seqtp_setup(args, name):
    """(model config, TrainerConfig, the global batches) of a seqtp LM
    run."""
    import dataclasses

    gpu_model, layers, cpu_model, _, batch, seq, backend = SEQTP_RUNS[name]
    if args.cpu:
        batch, seq = 4, 33
    cfg, tcfg, batches = _setup(argparse.Namespace(**dict(
        vars(args), model=cpu_model if args.cpu else gpu_model,
        batch=batch, seq=seq)))
    over = {"attention_backend": backend}
    if layers is not None and not args.cpu:
        over["n_layers"] = layers
    if name.startswith("lora") and args.cpu:
        over["lora_rank"] = 4
    return dataclasses.replace(cfg, **over), tcfg, batches


def _seqtp_vit(args, dev, mesh) -> dict:
    """ViT-B/16 (a tiny ViT with --cpu) through ``VisionTrainer`` over
    ``mesh`` (a MeshConfig; None: one process, unsplit) for ``--steps``
    steps (one warm-up), each rank its batch shard's rows of the same
    images."""
    import dataclasses
    import itertools

    import torch

    from tpufw_torch.models import VIT_CONFIGS
    from tpufw_torch.train import (
        VisionTrainer,
        VisionTrainerConfig,
        synthetic_images,
    )
    from tpufw_torch.train.vision import batch_rows

    _, _, images, size = SEQTP_VIT
    cfg = VIT_CONFIGS["vit_b16"]
    if args.cpu:
        images, size = 8, 32
        cfg = dataclasses.replace(cfg, image_size=size, patch_size=8,
                                  d_model=64, n_layers=2, n_heads=4,
                                  d_ff=128, dtype=torch.float32)
    from tpufw_torch.train.vision import vision_model

    # Seed 0's weights with the class head drawn at std 0.02: a zero head
    # passes the blocks no gradient, and the first steps would not see
    # them.
    state = vision_model(cfg, dev, seed=0).state_dict()
    state["head.weight"].normal_(0.0, 0.02, generator=torch.Generator(
        device=dev).manual_seed(21))
    tr = VisionTrainer(cfg, VisionTrainerConfig(
        batch_size=images, image_size=size, num_classes=1000,
        total_steps=args.steps, lr=1e-3, warmup_steps=1,
        handle_preemption=False), mesh, device=dev)
    tr.init_state(state_dict=state)
    del state
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    data = synthetic_images(images, size, 1000, seed=21, device=dev)
    hist = tr.run(batch_rows(itertools.islice(data, args.steps),
                             *tr.batch_shard()),
                  flops_per_image=cfg.flops_per_image(size))
    return {"losses": [m.loss for m in hist], "grad_norms": [],
            "step_ms": [1e3 * m.step_time_s for m in hist],
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                        else None),
            "mesh": (dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape))
                     if tr.gang else {}),
            "images": images, "image_size": size}


def _seqtp_runs(args, dev, gang: bool) -> dict:
    """Each seqtp run's numbers: over its mesh in the gang (a rank's), or
    in one process unsplit."""
    import torch

    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import Trainer

    out = {}
    for name, (_, _, _, mesh, _, _, _) in SEQTP_RUNS.items():
        cfg, tcfg, batches = _seqtp_setup(args, name)
        trainer = Trainer(cfg, tcfg, MeshConfig(**mesh) if gang else None,
                          device=dev)
        trainer.init_state(seed=0)
        pairs, step_ms, peak = _run(trainer, _rows(trainer, batches))
        out[name] = {"losses": [p[0] for p in pairs],
                     "grad_norms": [p[1] for p in pairs],
                     "step_ms": step_ms, "peak_gb": peak,
                     "mesh": (dict(zip(trainer.mesh.mesh_dim_names,
                                       trainer.mesh.shape))
                              if trainer.gang else {}),
                     "global_batch": tcfg.batch_size,
                     "seq_len": tcfg.seq_len}
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    name, mesh, _, _ = SEQTP_VIT
    out[name] = _seqtp_vit(args, dev, MeshConfig(**mesh) if gang else None)
    return out


def _seqtp_checks(args, ranks: list, dev) -> bool:
    """One JSON line per seqtp run: the ranks agree, and rank 0's losses
    and grad norms (ViT: losses) are within ``--tol`` of one unsplit
    process's."""
    import torch

    ok = True
    single = _seqtp_runs(args, torch.device(dev), gang=False)
    for name, run in ranks[0].items():
        want = single[name]
        same = all(r[name]["losses"] == run["losses"] for r in ranks)
        d_loss = _rel(run["losses"], want["losses"])
        d_norm = (_rel(run["grad_norms"], want["grad_norms"])
                  if want["grad_norms"] else 0.0)
        good = same and len(run["losses"]) == args.steps and \
            max(d_loss, d_norm) <= args.tol
        ok &= good
        model = (SEQTP_RUNS[name][2 if args.cpu else 0]
                 if name in SEQTP_RUNS else "vit_b16")
        emit({"check": f"gang_{name}_vs_one_process", "ok": good,
              "world": args.world, "mesh": run["mesh"], "model": model,
              **{k: run[k] for k in ("global_batch", "seq_len", "images",
                                     "image_size") if k in run},
              "ranks_equal": same, "losses_gang": run["losses"],
              "losses_one_process": want["losses"],
              "grad_norms_gang": run["grad_norms"],
              "grad_norms_one_process": want["grad_norms"],
              "max_rel_diff_loss": d_loss, "max_rel_diff_grad_norm": d_norm,
              "tol": args.tol, "step_ms_gang_rank0": run["step_ms"],
              "peak_gb_gang_rank0": run["peak_gb"],
              "step_ms_one_process": want["step_ms"],
              "peak_gb_one_process": want["peak_gb"]})
    return ok


def _rows(trainer, batches) -> list:
    """This rank's rows of each global batch: its batch shard's."""
    shard, n_shards = trainer.batch_shard()
    rows = len(batches[0]["tokens"]) // n_shards
    return [{k: v[shard * rows:(shard + 1) * rows] for k, v in b.items()}
            for b in batches]


def rank_main(args) -> int:
    import dataclasses

    import torch
    import torch.distributed as dist

    from tpufw_torch.cluster import initialize_cluster, local_device
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import Trainer
    from tpufw_torch.train.preemption import GracefulShutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    cluster = initialize_cluster(device="cpu" if args.cpu else None,
                                 timeout_s=120)
    rank, world = cluster.rank, cluster.world_size
    dev = local_device(cluster, "cpu" if args.cpu else None)
    if args.suite in ("all", "post"):
        post = _post_runs(args, dev)
        torch.save(post, os.path.join(args.out, f"rank{rank}_post.pt"))
    if args.suite == "tensor":
        tensor = _tensor_runs(args, dev)
        for name in TENSOR_POST:
            tensor[name] = _tensor_post_run(args, dev, name, MeshConfig(
                **TENSOR_POST_MESH))
        with open(os.path.join(args.out, f"rank{rank}_tensor.json"),
                  "w") as f:
            json.dump(tensor, f)
    if args.suite == "pptp":
        with open(os.path.join(args.out, f"rank{rank}_pptp.json"),
                  "w") as f:
            json.dump(_pptp_runs(args, dev, gang=True), f)
    if args.suite == "seqtp":
        with open(os.path.join(args.out, f"rank{rank}_seqtp.json"),
                  "w") as f:
            json.dump(_seqtp_runs(args, dev, gang=True), f)
    if args.suite in ("post", "tensor", "pptp", "seqtp"):
        dist.destroy_process_group()
        return 0
    cfg, tcfg, batches = _setup(args)

    def local(trainer):
        return _rows(trainer, batches)

    # name: (mesh, grad_accum, attention backend or None).
    meshes = {f"fsdp{world}": (MeshConfig(data=1, fsdp=world), 1, None)}
    if world > 2 and world % 2 == 0:
        hsdp = MeshConfig(data=2, fsdp=world // 2)
        meshes[f"data2_fsdp{world // 2}"] = (hsdp, 1, None)
        meshes[f"data2_fsdp{world // 2}_accum2"] = (hsdp, 2, None)
        meshes[f"fsdp{world // 2}_sequence2_ring"] = (
            MeshConfig(data=1, fsdp=world // 2, sequence=2), 1, "ring")
    out = {"rank": rank, "world": world, "device": str(dev), "runs": {}}

    def telemetry(name):
        return dataclasses.replace(tcfg, telemetry_dir=os.path.join(
            args.telemetry, name) if args.telemetry else None)

    for name, (mesh, accum, backend) in meshes.items():
        run_cfg = cfg if backend is None else dataclasses.replace(
            cfg, attention_backend=backend)
        trainer = Trainer(run_cfg, dataclasses.replace(
            telemetry(name), grad_accum=accum), mesh, device=dev)
        trainer.init_state(seed=0)
        pairs, step_ms, peak = _run(trainer, local(trainer))
        out["runs"][name] = {"losses": [p[0] for p in pairs],
                             "grad_norms": [p[1] for p in pairs],
                             "step_ms": step_ms, "peak_gb": peak,
                             "grad_accum": accum,
                             "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                                              trainer.mesh.shape))}
        del trainer
    for name, run in _pipelines(world).items():
        trainer = _pipeline_trainer(cfg, telemetry(name), *run, dev,
                                    gang=True)
        trainer.init_state(seed=0)
        pairs, step_ms, peak = _run(trainer, local(trainer))
        out["runs"][name] = {"losses": [p[0] for p in pairs],
                             "grad_norms": [p[1] for p in pairs],
                             "step_ms": step_ms, "peak_gb": peak,
                             "grad_accum": 1, "pipeline": run,
                             "held": list(trainer.group.indices),
                             "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                                              trainer.mesh.shape))}
        del trainer
    # The gang's stop: the last rank alone asks after step 1.
    stopped = Trainer(cfg, dataclasses.replace(
        tcfg, checkpoint_dir=args.ckpt, checkpoint_every=1000),
        MeshConfig(data=1, fsdp=world), device=dev)
    stopped.init_state(seed=0)
    sd = GracefulShutdown(signals=())

    def ask(m):
        if rank == world - 1:
            sd.request()

    _run(stopped, local(stopped), on_metrics=ask, shutdown=sd)
    out["stop"] = {"preempted": stopped.preempted, "step": stopped.step}
    dist.destroy_process_group()
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _telemetry_checks(args, names) -> bool:
    """One ``telemetry_<run>`` line a run of the gang: each rank's event
    log (schema-valid, run_start .. run_end, goodput, one step event a
    sync), its files, and rank 0's skew gauges, straggler counter and
    the straggler events of any rank."""
    from tpufw_torch.obs import events as events_mod
    from tpufw_torch.obs import promtext

    ok = True
    for name in names:
        d = os.path.join(args.telemetry, name)
        ranks, flagged, good = [], [], True
        for r in range(args.world):
            tag = "" if r == 0 else f"-p{r}"
            path = os.path.join(d, f"events{tag}.jsonl")
            events = events_mod.read_events(path) if os.path.exists(
                path) else []
            try:
                for ev in events:
                    events_mod.validate(ev)
            except ValueError:
                good = False
            kinds = [e["kind"] for e in events]
            files = [f"{stem}{tag}.{ext}" for stem, ext in (
                ("trace", "json"), ("goodput", "json"), ("programs", "json"),
                ("metrics", "prom"))]
            missing = [f for f in files if not os.path.exists(
                os.path.join(d, f))]
            good &= (kinds[:1] == ["run_start"] and kinds[-2:] == [
                "run_end", "goodput"] and kinds.count("step") >= 2
                and not missing)
            flagged += [e for e in events if e["kind"] ==
                        "straggler_detected"]
            with open(os.path.join(d, f"goodput{tag}.json")) as f:
                gp = json.load(f)
            ranks.append({"rank": r, "events": {k: kinds.count(k)
                                                for k in sorted(set(kinds))},
                          "missing_files": missing,
                          "goodput_ratio": gp["goodput_ratio"],
                          "step_time_s": [e["step_time_s"] for e in events
                                          if e["kind"] == "step"]})
        with open(os.path.join(d, "metrics.prom")) as f:
            flat = promtext.flatten(f.read())
        ok &= good
        emit({"check": f"telemetry_{name}", "ok": good, "world": args.world,
              "ranks": ranks,
              "host_window_s": {k: v for k, v in flat.items() if k.startswith(
                  "tpufw_train_host_window_seconds")},
              "host_data_wait_s": {k: v for k, v in flat.items()
                                   if k.startswith(
                                       "tpufw_train_host_data_wait_seconds")},
              "stragglers_total": flat.get("tpufw_train_stragglers_total"),
              "straggler_events": [{k: e[k] for k in (
                  "process", "step", "straggler_hosts", "host_window_s",
                  "median_s")} for e in flagged],
              "dir": d})
    return ok


def _rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def parent_main(args) -> int:
    import dataclasses

    if not args.cpu:
        from tpufw_torch.ops import _build

        _build.build()
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build-torch")
                           if os.path.isdir(os.path.join(ROOT, "build-torch"))
                           else None)
    args.out, args.ckpt = tmp, os.path.join(tmp, "ckpt")
    port = _free_port()
    argv = [sys.executable, os.path.abspath(__file__), "--rank-of-gang",
            "--out", args.out, "--ckpt", args.ckpt, "--model", args.model,
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--steps", str(args.steps), "--suite", args.suite] + (
                ["--cpu"] if args.cpu else []) + (
                ["--telemetry", args.telemetry] if args.telemetry else [])
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    env |= {"TPUFW_COORDINATOR": f"127.0.0.1:{port}",
            "TPUFW_NUM_PROCESSES": "1", "TPUFW_PROCESS_ID": "0",
            "LOCAL_WORLD_SIZE": str(args.world), "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=env | {"LOCAL_RANK": str(r)})
             for r in range(args.world)]
    try:
        rcs = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gang_s = time.perf_counter() - t0
    if any(rcs):
        emit({"gang_failed": rcs})
        return 1

    import torch

    from tpufw_torch.train import Trainer
    from tpufw_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cpu" if args.cpu else "cuda"
    ok = True
    if args.suite in ("all", "post"):
        ok &= _post_checks(args, [
            torch.load(os.path.join(args.out, f"rank{r}_post.pt"),
                       weights_only=False) for r in range(args.world)],
            _post_runs(args, torch.device(dev)))
    if args.suite in ("tensor", "pptp", "seqtp"):
        ranks = []
        for r in range(args.world):
            with open(os.path.join(args.out,
                                   f"rank{r}_{args.suite}.json")) as f:
                ranks.append(json.load(f))
        if args.suite == "tensor":
            ok &= _tensor_checks(args, [{k: v for k, v in r.items()
                                         if k in TENSOR_RUNS}
                                        for r in ranks], dev)
            ok &= _post_tensor_checks(args, ranks, dev)
        elif args.suite == "seqtp":
            ok &= _seqtp_checks(args, ranks, dev)
        else:
            ok &= _pptp_checks(args, ranks, dev)
    if args.suite in ("post", "tensor", "pptp", "seqtp"):
        return _finish(args, ok, gang_s, tmp)
    ranks = []
    for r in range(args.world):
        with open(os.path.join(args.out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    cfg, tcfg, batches = _setup(args)
    # One process at each grad_accum of the gang's runs.
    single = {}
    for accum in sorted({r["grad_accum"] for r in ranks[0]["runs"].values()}):
        one = Trainer(cfg, dataclasses.replace(tcfg, grad_accum=accum),
                      device=dev)
        one.init_state(seed=0)
        single[accum] = _run(one, batches)
        del one
    for name, run in _pipelines(args.world).items():
        one = _pipeline_trainer(cfg, tcfg, *run, dev, gang=False)
        one.init_state(seed=0)
        single[name] = _run(one, batches)
        del one
    for name, run in ranks[0]["runs"].items():
        want, one_ms, one_peak = single[name if "pipeline" in run
                                        else run["grad_accum"]]
        # A pipeline's ranks report the same global loss; its stages
        # hold different params, so its ranks' step times differ.
        same = all(r["runs"][name]["losses"] == run["losses"]
                   for r in ranks)
        d_loss = _rel(run["losses"], [w[0] for w in want])
        d_norm = _rel(run["grad_norms"], [w[1] for w in want])
        good = same and len(run["losses"]) == args.steps and \
            max(d_loss, d_norm) <= args.tol
        ok &= good
        emit({"check": f"gang_{name}_vs_one_process", "ok": good,
              "world": args.world, "mesh": run["mesh"],
              "ranks_equal": same, "losses_gang": run["losses"],
              "losses_one_process": [w[0] for w in want],
              "grad_norms_gang": run["grad_norms"],
              "grad_norms_one_process": [w[1] for w in want],
              "max_rel_diff_loss": d_loss, "max_rel_diff_grad_norm": d_norm,
              "tol": args.tol,
              "step_ms_gang_rank0": run["step_ms"],
              "peak_gb_gang_rank0": run["peak_gb"],
              "step_ms_one_process": one_ms, "peak_gb_one_process": one_peak,
              "global_batch": args.batch, "seq_len": args.seq,
              "grad_accum": run["grad_accum"], "model": args.model,
              "pipeline": run.get("pipeline")})
    if args.telemetry:
        ok &= _telemetry_checks(args, list(ranks[0]["runs"]))
    want = single[1][0]
    # The gang's checkpoint resumes in one process.
    stops = [r["stop"] for r in ranks]
    steps = CheckpointManager(args.ckpt).all_steps()
    resumed = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=args.ckpt),
                      device=dev)
    restored = resumed.maybe_restore()
    after, _, _ = _run(resumed, batches[1:2])
    d = _rel([after[0][0]], [want[1][0]]) if after else float("inf")
    good = (restored and steps == [1] and d <= args.tol
            and all(s == {"preempted": True, "step": 1} for s in stops))
    ok &= good
    emit({"check": "gang_stop_and_one_process_resume", "ok": good,
          "stops": stops, "checkpoints": steps, "restored": restored,
          "resumed_loss": after[0][0] if after else None,
          "unbroken_loss": want[1][0], "rel_diff": d, "tol": args.tol})
    return _finish(args, ok, gang_s, tmp)


def _finish(args, ok: bool, gang_s: float, tmp: str) -> int:
    import torch

    shutil.rmtree(tmp, ignore_errors=True)
    kind = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    if not args.cpu:
        # Each card's name and power limit, beside the numbers above.
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip(), flush=True)
    emit({"ok": bool(ok), "world": args.world, "device": kind,
          "gang_s": gang_s})
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="llama3_600m_bench")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=2049)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--suite", choices=("lm", "post", "tensor", "pptp",
                                        "seqtp", "all"),
                    default="lm",
                    help="lm: the LM meshes, pipelines and stop; post: E5, "
                    "GRPO and ResNet-50 over the whole batch; tensor: the "
                    "tensor and expert axes and the post-trainers over "
                    "them (--world 4); pptp: pipelines over pipe=2 x "
                    "tensor=2 (--world 4); seqtp: tensor and expert beside "
                    "a sequence ring, LoRA and ViT over tensor (--world "
                    "4); all: lm and post")
    ap.add_argument("--telemetry", metavar="DIR",
                    help="lm suite: the runs' telemetry under DIR/<run>/ "
                    "(every rank's events, traces, goodput, skew), checked "
                    "and kept")
    ap.add_argument("--rank-of-gang", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.telemetry:
        args.telemetry = os.path.abspath(args.telemetry)
        if args.suite not in ("lm", "all"):
            ap.error("--telemetry instruments the lm suite's runs")
    if args.suite in ("tensor", "pptp", "seqtp") and args.world != 4:
        ap.error(f"--suite {args.suite} runs meshes of four ranks (tensor=2 "
                 "x fsdp=2, expert=2 x tensor=2, pipe=2 x tensor=2, "
                 "sequence=2 x tensor=2): it needs --world 4")
    if args.batch % args.world:
        ap.error(f"--batch {args.batch} must divide over --world "
                 f"{args.world}")
    if args.world > 2 and (args.seq - 1) % 2:
        ap.error(f"--seq {args.seq}: the sequence=2 run needs an even "
                 f"number of trained positions, --seq - 1")
    return rank_main(args) if args.rank_of_gang else parent_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
