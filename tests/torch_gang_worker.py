"""One rank of a tpufw_torch training gang on the CPU (gloo), for the gang
tests. Imports no JAX: the test process hands each case over as a file.

    python tests/torch_gang_worker.py <case.pt> [<case.pt> ...]
    python tests/torch_gang_worker.py --workload
    python tests/torch_gang_worker.py --pipeline-workload <out>

The rank comes from ``TPUFW_COORDINATOR`` / ``TPUFW_NUM_PROCESSES`` /
``TPUFW_PROCESS_ID`` (``tpufw_torch.cluster``). Each case file holds
{"name", "model_cfg", "trainer": TrainerConfig kwargs, "mesh": MeshConfig
kwargs, "state": the initial state dict, "batches": the GLOBAL batches (numpy
dicts)}; optionally "kind" ("lm", "dpo" with "dpo" DPOConfig kwargs,
"distill" with "teacher_cfg", "teacher_state" and optionally "distill"
DistillConfig kwargs, "disagree": each rank
on its own checkpoint directory of "dirs", ``run_disagree``, or
"attention": the sequence-parallel attention calls of "calls" on the
whole-sequence "inputs", ``run_attention``), "resume" (the trainer
resumes from its checkpoint directory before it runs), "grads" (after
the run, rank 0 also writes every parameter's whole gradient of one
more step's objective on the first global batch: ``objective_grads``)
and "signal_rank"/
"signal_at" (that rank sends itself SIGTERM after that step: the gang's
stop test). The rank trains on the rows of its batch shard of each
global batch through ``Trainer.run`` (under a ``sequence`` axis the
trainer takes the rank's chunk of the positions) and writes
``<case>.out<rank>.pt``: per-step losses and grad norms, whether it was
preempted and at which step, and on rank 0 the gathered parameters.

``--workload`` runs ``tpufw_torch.workloads.train_llama``'s ``main`` with
the tiny Llama presets computing in fp32 (the tests' precision);
``--pipeline-workload <out>`` runs ``train_pipeline``'s ``main`` so and
writes ``<out>.out<rank>.pt``: the rank's held stages and params.

A case of "kind" "pipeline" ("pipe": PipelineConfig kwargs, "state" a
whole pipeline param tree, optionally "resume" as above) trains a
``PipelineTrainer`` over the mesh (each rank its stage and shards,
``data``/``fsdp`` ranks batch shards) and writes
the per-step losses and grad norms and, on every rank, the whole params
(gathered over the pipe).

The objectives over the whole batch: "embed" (an ``EmbeddingTrainer``,
"contrastive" its ContrastiveConfig kwargs, on the rank's pairs of the
GLOBAL "batches"), "grpo" (a ``GRPOTrainer`` from "seed", "grpo" its
GRPOConfig kwargs, ``run_rl`` over "prompts" with the ``low_token``
reward: every rank's whole rollouts, its rows, history and the gathered
params) and "vision" (a ``VisionTrainer`` over "mesh" (the default mesh
when empty), "vision_trainer" its config kwargs, on its rows of the
global image "batches", "signal_rank" as above). A "workload" case runs
``tpufw_torch.workloads.<module>``'s ``main`` with "env" (``TPUFW_*``
names without the prefix) and the tiny Llama presets in fp32; its
``main`` ends the process group, so it comes last.
"""

import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def run_disagree(case: dict, path: str, rank: int) -> None:
    """Each rank on its own checkpoint directory, ``case["dirs"][rank]``:
    the error (or None) of a Trainer's ``maybe_restore`` there, then of a
    forced ``CheckpointManager.save`` of step ``case["save_step"]``."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import Trainer, TrainerConfig
    from tpufw_torch.train.checkpoint import CheckpointManager

    out = {}
    directory = case["dirs"][rank]
    trainer = Trainer(case["model_cfg"], TrainerConfig(
        **case["trainer"], checkpoint_dir=directory),
        MeshConfig(**case["mesh"]), device="cpu")
    mgr = CheckpointManager(directory)
    for what, call in (
            ("restore", trainer.maybe_restore),
            ("save", lambda: mgr.save(case["save_step"],
                                      {"x": torch.zeros(2)}, force=True))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    mgr.close()
    torch.save(out, f"{path}.out{rank}.pt")


def run_attention(case: dict, path: str, rank: int, world: int) -> None:
    """Each of ``case["calls"]`` ({name: (backend, kwargs)}, backend
    "ring" with kwargs' ``impl`` or "ulysses") on this rank's chunk of
    the sequence of ``case["inputs"]`` (numpy q, k, v, do and segment
    ids) over the ``sequence`` dim of ``case["mesh"]``'s ``DeviceMesh``:
    {name: (out, dq, dk, dv)} of sum(out * do), this rank's chunk."""
    from tpufw_torch.mesh import MeshConfig, build_mesh
    from tpufw_torch.parallel import (
        ring_attention,
        sequence_group,
        ulysses_attention,
    )

    mesh = build_mesh(MeshConfig(**case["mesh"]), world, "cpu")
    group = sequence_group(mesh)
    x = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    n = x["q"].shape[1] // group.size
    chunk = {k: v[:, group.rank * n:(group.rank + 1) * n].contiguous()
             for k, v in x.items()}
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    for name, (backend, kw) in case["calls"].items():
        qkv = [chunk[k].clone().requires_grad_() for k in "qkv"]
        o = fns[backend](*qkv, mesh=mesh, segment_ids=chunk.get("seg"), **kw)
        (o * chunk["do"]).sum().backward()
        out[name] = [o.detach(), *(t.grad for t in qkv)]
    torch.save(out, f"{path}.out{rank}.pt")


def run_pipeline(case: dict, path: str, rank: int) -> None:
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer, TrainerConfig

    tcfg = TrainerConfig(**case["trainer"])
    trainer = PipelineTrainer(case["model_cfg"], PipelineConfig(
        **case["pipe"]), tcfg, MeshConfig(**case["mesh"]), device="cpu")
    trainer.init_state(params=case["state"])
    if case.get("resume"):
        trainer.maybe_restore()
    shard, n_shards = trainer.batch_shard()
    rows = tcfg.batch_size // n_shards
    local = [{k: v[shard * rows:(shard + 1) * rows] for k, v in b.items()}
             for b in case["batches"]]
    recorded = []
    step_fn = trainer.train_step
    trainer.train_step = lambda b: recorded.append(step_fn(b)) or recorded[-1]
    trainer.run(iter(local), model_flops_per_token=1.0)
    torch.save({"losses": [float(m["loss"]) for m in recorded],
                "grad_norms": [float(m["grad_norm"]) for m in recorded],
                "held": trainer.group.indices,
                "params": trainer.whole_params()}, f"{path}.out{rank}.pt")


def _params(trainer, rank: int):
    """The whole state dict of ``trainer``'s model on rank 0 (a
    collective: sharded and split tensors gathered), None elsewhere."""
    from tpufw_torch.train.sharding import full_state_dict

    params = (trainer.whole_state() if hasattr(trainer, "whole_state")
              else full_state_dict(trainer.model.state_dict()))
    return params if rank == 0 else None


def run_embed(case: dict, path: str, rank: int) -> None:
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import (
        ContrastiveConfig,
        EmbeddingTrainer,
        TrainerConfig,
    )

    trainer = EmbeddingTrainer(
        case["model_cfg"], TrainerConfig(**case["trainer"]),
        MeshConfig(**case["mesh"]), device="cpu",
        contrastive=ContrastiveConfig(**case["contrastive"]))
    trainer.init_state(state_dict=case["state"])
    shard, n = trainer.batch_shard()
    metrics = []
    for b in case["batches"]:
        rows = len(b["tokens"]) // n
        m = trainer.train_step({k: v[shard * rows:(shard + 1) * rows]
                                for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    try:
        trainer.embed(case["batches"][0]["tokens"][:2],
                      case["batches"][0]["segment_ids"][:2])
        refusal = None
    except NotImplementedError as e:
        refusal = str(e)
    torch.save({"metrics": metrics, "embed_refusal": refusal,
                "params": _params(trainer, rank)},
               f"{path}.out{rank}.pt")


def run_grpo(case: dict, path: str, rank: int) -> None:
    import tpufw_torch.infer
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import GRPOConfig, GRPOTrainer, TrainerConfig
    from tpufw_torch.workloads.rl import resolve_reward

    grpo = GRPOConfig(**case["grpo"])
    trainer = GRPOTrainer(case["model_cfg"], TrainerConfig(**case["trainer"]),
                          MeshConfig(**case["mesh"]), device="cpu", grpo=grpo)
    trainer.init_state(seed=case["seed"])
    completions, batches = [], []
    generate = tpufw_torch.infer.generate

    def recorded(*a, **k):
        completions.append(generate(*a, **k).clone())
        return completions[-1]

    tpufw_torch.infer.generate = recorded
    step = trainer.train_step
    trainer.train_step = lambda b: batches.append(b) or step(b)
    history = trainer.run_rl(
        case["prompts"], resolve_reward("low_token",
                                        case["model_cfg"].vocab_size,
                                        grpo.max_new_tokens),
        seed=case["seed"])
    keys = ("loss", "grad_norm", "kl", "mean_ratio", "clip_frac",
            "reward_mean", "completion_len_mean")
    torch.save({"history": [{k: h[k] for k in keys} for h in history],
                "completions": completions,
                "rows": [{k: b[k] for k in ("tokens", "loss_mask")}
                         for b in batches],
                "shard": trainer.batch_shard(),
                "params": _params(trainer, rank)},
               f"{path}.out{rank}.pt")


def run_vision(case: dict, path: str, rank: int) -> None:
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import VisionTrainer, VisionTrainerConfig
    from tpufw_torch.train.vision import batch_rows

    trainer = VisionTrainer(case["model_cfg"], VisionTrainerConfig(
        **case["vision_trainer"]),
        MeshConfig(**case["mesh"]) if case["mesh"] else None, device="cpu")
    trainer.init_state(state_dict=case["state"])
    signal_rank = case.get("signal_rank")

    def on_metrics(m):
        if rank == signal_rank and m.step >= case["signal_at"]:
            os.kill(os.getpid(), signal.SIGTERM)

    history = trainer.run(batch_rows(iter(case["batches"]),
                                     *trainer.batch_shard()),
                          flops_per_image=1.0, on_metrics=on_metrics)
    torch.save({"losses": [m.loss for m in history],
                "preempted": trainer.preempted, "step": trainer.step,
                "params": _params(trainer, rank)},
               f"{path}.out{rank}.pt")


def run_workload(case: dict) -> None:
    import dataclasses
    import importlib

    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS

    for name in ("llama3_tiny",):
        PRESETS[name] = LLAMA_CONFIGS[name] = dataclasses.replace(
            LLAMA_CONFIGS[name], dtype=torch.float32)
    os.environ.update({f"TPUFW_{k}": str(v) for k, v in case["env"].items()})
    mod = importlib.import_module(f"tpufw_torch.workloads.{case['module']}")
    if mod.main() != 0:
        raise SystemExit(f"{case['module']}.main() failed")


def objective_grads(trainer, batch: dict) -> dict:
    """Every parameter's whole gradient (a collective: split and sharded
    ones gathered) of ``trainer``'s objective on this rank's rows of the
    global ``batch``, without an update (None for a frozen one)."""
    from tpufw_torch.train import sharding
    from tpufw_torch.train.trainer import batch_loss, batch_to_device, on_mesh

    shard, n_shards = trainer.batch_shard()
    rows = len(batch["tokens"]) // n_shards
    local = {k: v[shard * rows:(shard + 1) * rows] for k, v in batch.items()}

    @on_mesh
    def run(tr):
        tr.optimizer.zero_grad()
        loss, n = batch_loss(tr.model, batch_to_device(local, tr.device),
                             tr.cfg.loss_chunk_size, tr.cfg.loss_chunk_dtype)
        sharding.backward_global_mean(loss, n)
        return {k: None if p.grad is None else sharding.full_tensor(
            sharding.SplitPart(p.grad, tr.splits[k], tr.groups)
            if k in tr.splits else p.grad)
            for k, p in tr.model.named_parameters()}

    return run(trainer)


def run_case(path: str, rank: int, world: int) -> None:
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train import (
        DistillConfig,
        DistillTrainer,
        DPOConfig,
        DPOTrainer,
        Trainer,
        TrainerConfig,
    )
    from tpufw_torch.train.sharding import full_state_dict

    case = torch.load(path, weights_only=False)
    if case.get("kind") == "disagree":
        return run_disagree(case, path, rank)
    if case.get("kind") == "attention":
        return run_attention(case, path, rank, world)
    if case.get("kind") == "pipeline":
        return run_pipeline(case, path, rank)
    if case.get("kind") == "embed":
        return run_embed(case, path, rank)
    if case.get("kind") == "grpo":
        return run_grpo(case, path, rank)
    if case.get("kind") == "vision":
        return run_vision(case, path, rank)
    if case.get("kind") == "workload":
        return run_workload(case)
    tcfg = TrainerConfig(**case["trainer"])
    args = (case["model_cfg"], tcfg, MeshConfig(**case["mesh"]))
    kind = case.get("kind", "lm")
    if kind == "dpo":
        trainer = DPOTrainer(*args, device="cpu",
                             dpo=DPOConfig(**case.get("dpo", {})))
    elif kind == "distill":
        trainer = DistillTrainer(*args, device="cpu", distill=DistillConfig(
            **case.get("distill", {})))
    else:
        trainer = Trainer(*args, device="cpu")
    trainer.init_state(state_dict=case["state"])
    if case.get("resume"):
        trainer.maybe_restore()
    if kind == "distill":
        teacher = model_for_config(case["teacher_cfg"], device="cpu")
        teacher.load_state_dict(case["teacher_state"])
        trainer.set_teacher(teacher)
    shard, n_shards = trainer.batch_shard()
    rows = tcfg.batch_size // n_shards
    local = [{k: v[shard * rows:(shard + 1) * rows] for k, v in b.items()}
             for b in case["batches"]]
    recorded = []
    step_fn = trainer.train_step

    def train_step(batch):
        m = step_fn(batch)
        recorded.append((float(m["loss"]), float(m["grad_norm"])))
        return m

    trainer.train_step = train_step
    signal_rank = case.get("signal_rank")

    def on_metrics(m):
        if rank == signal_rank and m.step >= case["signal_at"]:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.run(iter(local), model_flops_per_token=1.0, on_metrics=on_metrics)
    out = {"losses": [r[0] for r in recorded],
           "grad_norms": [r[1] for r in recorded],
           "preempted": trainer.preempted, "step": trainer.step}
    # The trainer's state holds whole tensors once gathered (a tensor- or
    # expert-parallel gang's split ones too).
    params = full_state_dict(trainer.state_dict()["model"])
    if rank == 0:
        out["params"] = params
    if case.get("grads"):
        grads = objective_grads(trainer, case["batches"][0])
        if rank == 0:
            out["grads"] = grads
    torch.save(out, f"{path}.out{rank}.pt")


def workload() -> int:
    import dataclasses

    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
    from tpufw_torch.workloads import train_llama

    for name in ("llama3_tiny",):
        PRESETS[name] = LLAMA_CONFIGS[name] = dataclasses.replace(
            LLAMA_CONFIGS[name], dtype=torch.float32)
    return train_llama.main()


def pipeline_workload(out: str) -> int:
    import dataclasses

    import torch.distributed as dist

    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
    from tpufw_torch.train import PipelineTrainer
    from tpufw_torch.workloads import train_pipeline

    PRESETS["llama3_tiny"] = dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], n_layers=4, dtype=torch.float32)
    trainers = []
    run = PipelineTrainer.run

    def kept(self, *a, **k):
        trainers.append(self)
        return run(self, *a, **k)

    PipelineTrainer.run = kept
    destroy = dist.destroy_process_group
    # Save before main's own teardown of the group.
    dist.destroy_process_group = lambda: None
    rc = train_pipeline.main()
    tr = trainers[0]
    torch.save({"held": tr.group.indices, "step": tr.step,
                "params": tr.whole_params()},
               f"{out}.out{dist.get_rank()}.pt")
    destroy()
    return rc


def main() -> int:
    torch.set_num_threads(1)
    if sys.argv[1:] == ["--workload"]:
        return workload()
    if sys.argv[1:2] == ["--pipeline-workload"]:
        return pipeline_workload(sys.argv[2])
    from tpufw_torch.cluster import initialize_cluster

    cluster = initialize_cluster(device="cpu", timeout_s=60)
    for path in sys.argv[1:]:
        run_case(path, cluster.rank, cluster.world_size)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
