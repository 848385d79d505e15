"""One rank of a tpufw_torch training gang on the CPU (gloo), for the gang
tests. Imports no JAX: the test process hands each case over as a file.

    python tests/torch_gang_worker.py <case.pt> [<case.pt> ...]
    python tests/torch_gang_worker.py --workload

The rank comes from ``TPUFW_COORDINATOR`` / ``TPUFW_NUM_PROCESSES`` /
``TPUFW_PROCESS_ID`` (``tpufw_torch.cluster``). Each case file holds
{"name", "model_cfg", "trainer": TrainerConfig kwargs, "mesh": MeshConfig
kwargs, "state": the initial state dict, "batches": the GLOBAL batches (numpy
dicts)}; optionally "kind" ("lm", "dpo" with "dpo" DPOConfig kwargs,
"distill" with "teacher_cfg" and "teacher_state", "disagree": each rank
on its own checkpoint directory of "dirs", ``run_disagree``, or
"attention": the sequence-parallel attention calls of "calls" on the
whole-sequence "inputs", ``run_attention``) and "signal_rank"/
"signal_at" (that rank sends itself SIGTERM after that step: the gang's
stop test). The rank trains on the rows of its batch shard of each
global batch through ``Trainer.run`` (under a ``sequence`` axis the
trainer takes the rank's chunk of the positions) and writes
``<case>.out<rank>.pt``: per-step losses and grad norms, whether it was
preempted and at which step, and on rank 0 the gathered parameters.

``--workload`` runs ``tpufw_torch.workloads.train_llama``'s ``main`` with
the tiny Llama presets computing in fp32 (the tests' precision).
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


def run_case(path: str, rank: int, world: int) -> None:
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train import (
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
    tcfg = TrainerConfig(**case["trainer"])
    args = (case["model_cfg"], tcfg, MeshConfig(**case["mesh"]))
    kind = case.get("kind", "lm")
    if kind == "dpo":
        trainer = DPOTrainer(*args, device="cpu",
                             dpo=DPOConfig(**case.get("dpo", {})))
    elif kind == "distill":
        trainer = DistillTrainer(*args, device="cpu")
    else:
        trainer = Trainer(*args, device="cpu")
    trainer.init_state(state_dict=case["state"])
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
    params = full_state_dict(trainer.model.state_dict())
    if rank == 0:
        out["params"] = params
    torch.save(out, f"{path}.out{rank}.pt")


def workload() -> int:
    import dataclasses

    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
    from tpufw_torch.workloads import train_llama

    for name in ("llama3_tiny",):
        PRESETS[name] = LLAMA_CONFIGS[name] = dataclasses.replace(
            LLAMA_CONFIGS[name], dtype=torch.float32)
    return train_llama.main()


def main() -> int:
    torch.set_num_threads(1)
    if sys.argv[1:] == ["--workload"]:
        return workload()
    from tpufw_torch.cluster import initialize_cluster

    cluster = initialize_cluster(device="cpu", timeout_s=60)
    for path in sys.argv[1:]:
        run_case(path, cluster.rank, cluster.world_size)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
