"""Spawning the port's CPU training gangs for the tests: N processes of a
script or module, each told its rank through ``tpufw``'s explicit cluster
variables (``TPUFW_COORDINATOR`` on a free localhost port,
``TPUFW_NUM_PROCESSES``, ``TPUFW_PROCESS_ID``), one torch thread each."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_gang_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_gang(argv: list, world: int = 2, env: dict | None = None,
               one_host: bool = False) -> list:
    """Start ``world`` processes of ``argv`` (after the interpreter) as one
    gang; returns the Popen objects (stdout and stderr piped). ``one_host``:
    told their rank as a per-GPU launcher on one host tells them (one
    process in ``tpufw``'s count, ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``)."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith("TPUFW_")}
    base |= {"OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT,
             "TPUFW_COORDINATOR": f"127.0.0.1:{port}", **(env or {})}

    def rank_env(rank):
        if one_host:
            return {"TPUFW_NUM_PROCESSES": "1", "TPUFW_PROCESS_ID": "0",
                    "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}
        return {"TPUFW_NUM_PROCESSES": str(world),
                "TPUFW_PROCESS_ID": str(rank)}

    return [
        subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=base | rank_env(rank))
        for rank in range(world)
    ]


def finish(procs: list, timeout: float = 120.0) -> list:
    """Wait for every process; (stdout, stderr) of each, asserting each
    exited 0."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out}\n{err}"
    return outs


def write_case(path, name, model_cfg, trainer: dict, mesh: dict, state: dict,
               batches: list, **extra) -> str:
    """A case file of ``torch_gang_worker.py``."""
    torch.save({"name": name, "model_cfg": model_cfg, "trainer": trainer,
                "mesh": mesh, "state": state, "batches": batches, **extra},
               str(path))
    return str(path)


def read_outputs(path, world: int = 2) -> list:
    """Each rank's output of the case at ``path``."""
    return [torch.load(f"{path}.out{r}.pt", weights_only=False)
            for r in range(world)]


def global_batches(batch: int, seq: int, steps: int, seed: int = 3,
                   dpo: bool = False) -> list:
    """``steps`` synthetic global batches (vocab 256); ``dpo``: rows are
    (chosen, rejected) pairs whose response is the second half of each
    row (a loss mask)."""
    from tpufw_torch.train import synthetic_batches

    it = synthetic_batches(batch, seq, 256, seed=seed)
    out = [next(it) for _ in range(steps)]
    if dpo:
        for b in out:
            b["loss_mask"] = np.broadcast_to(
                np.arange(seq) >= seq // 2, (batch, seq)).astype(
                    np.int32).copy()
    return out
