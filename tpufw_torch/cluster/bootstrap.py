"""Multi-process bootstrap: pod environment -> ``torch.distributed``
(port of ``tpufw.cluster.bootstrap``).

Each worker derives (coordinator address, number of processes, process
id) from its environment, in ``tpufw``'s order, first match wins:

1. Explicit ``TPUFW_COORDINATOR`` / ``TPUFW_NUM_PROCESSES`` /
   ``TPUFW_PROCESS_ID`` (tests, bare metal).
2. JobSet + headless Service: ``JOBSET_NAME``, ``REPLICATED_JOB_NAME``,
   ``JOB_COMPLETION_INDEX``, ``TPUFW_WORKERS_PER_SLICE``,
   ``TPUFW_COORDINATOR_SVC`` / ``TPUFW_COORDINATOR_PORT``.
3. The GKE worker convention: ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``
   (worker 0 coordinates).
4. Single process: no process group.

Processes and GPUs. A ``tpufw`` process is a host that owns all its
chips. A ``tpufw_torch`` process owns ONE GPU. When a per-GPU launcher
starts several processes on a host, it sets ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (``torchrun`` does), and the sources above count
hosts: the rank is ``process_id * local_world_size + local_rank`` and
the world ``num_processes * local_world_size``. Without them each
process is one GPU (``local_rank`` 0 of 1) and the sources count GPUs.

``initialize_cluster`` then starts the process group on a ``TCPStore`` at
the coordinator's address: NCCL on ``cuda:<local_rank>`` by default,
gloo only when the caller asks for the CPU. A machine with GPUs never
falls back to gloo, and a gang with no GPU and no ``device="cpu"``
raises. Worker identity is an index the controller assigns, never a
hostname hash, so a restarted pod rejoins with the same rank.
"""

from __future__ import annotations

# tpulint: disable-file=TPU004 — this module reads through an
# injectable ``env: Mapping`` (tests and gang workers pass dicts), and
# its resolution order mixes the TPUFW_* escape hatches with JobSet, GKE
# and per-GPU launcher variables (LOCAL_RANK) the typed helpers don't
# model. The knobs are cataloged in docs/torch/ENV.md; the helper
# round-trip stops at this process-bootstrap boundary.

import dataclasses
import os
import time
from datetime import timedelta
from typing import Mapping, Optional

DEFAULT_COORDINATOR_PORT = 8476


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    coordinator_address: Optional[str]  # None => single-process
    num_processes: int = 1
    process_id: int = 0
    source: str = "single"
    # Per-GPU processes on one host (LOCAL_RANK / LOCAL_WORLD_SIZE).
    local_rank: int = 0
    local_world_size: int = 1

    @property
    def rank(self) -> int:
        return self.process_id * self.local_world_size + self.local_rank

    @property
    def world_size(self) -> int:
        return self.num_processes * self.local_world_size

    @property
    def is_distributed(self) -> bool:
        return self.coordinator_address is not None and self.world_size > 1


def _local(env: Mapping[str, str]) -> dict:
    """LOCAL_RANK / LOCAL_WORLD_SIZE of a per-GPU launcher, if set."""
    if "LOCAL_RANK" not in env:
        return {}
    return {"local_rank": int(env["LOCAL_RANK"]),
            "local_world_size": int(env.get("LOCAL_WORLD_SIZE", "1"))}


def resolve_cluster_env(
    env: Optional[Mapping[str, str]] = None,
) -> ClusterConfig:
    env = os.environ if env is None else env
    local = _local(env)

    if "TPUFW_COORDINATOR" in env:
        if "TPUFW_NUM_PROCESSES" not in env:
            # A coordinator with a defaulted process count of 1 would
            # silently split the gang into single-process runs.
            raise ValueError(
                "TPUFW_COORDINATOR is set but TPUFW_NUM_PROCESSES is "
                "missing — set it to the gang size (and TPUFW_PROCESS_ID "
                "per worker)"
            )
        return ClusterConfig(
            coordinator_address=env["TPUFW_COORDINATOR"],
            num_processes=int(env["TPUFW_NUM_PROCESSES"]),
            process_id=int(env.get("TPUFW_PROCESS_ID", "0")),
            source="explicit",
            **local,
        )

    if "JOBSET_NAME" in env and "JOB_COMPLETION_INDEX" in env:
        if "TPUFW_WORKERS_PER_SLICE" not in env:
            raise ValueError(
                "JobSet environment detected (JOBSET_NAME set) but "
                "TPUFW_WORKERS_PER_SLICE is missing — set it to the "
                "replicated job's worker count (deploy/ manifests do)"
            )
        num = int(env["TPUFW_WORKERS_PER_SLICE"])
        pid = int(env["JOB_COMPLETION_INDEX"])
        svc = env.get("TPUFW_COORDINATOR_SVC")
        if svc is None:
            # Headless-Service DNS of pod 0 of the replicated job.
            job = env.get("REPLICATED_JOB_NAME", "worker")
            svc = f"{env['JOBSET_NAME']}-{job}-0-0.{env['JOBSET_NAME']}"
        port = int(env.get("TPUFW_COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT))
        return ClusterConfig(
            coordinator_address=f"{svc}:{port}",
            num_processes=num,
            process_id=pid,
            source="jobset",
            **local,
        )

    if "TPU_WORKER_ID" in env and "TPU_WORKER_HOSTNAMES" in env:
        hosts = [h.strip() for h in env["TPU_WORKER_HOSTNAMES"].split(",")
                 if h.strip()]
        if not hosts:
            raise ValueError(
                "TPU_WORKER_HOSTNAMES is set but contains no hostnames"
            )
        port = int(env.get("TPUFW_COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT))
        return ClusterConfig(
            coordinator_address=f"{hosts[0]}:{port}",
            num_processes=len(hosts),
            process_id=int(env["TPU_WORKER_ID"]),
            source="gke_tpu",
            **local,
        )

    return ClusterConfig(coordinator_address=None)


def local_device(config: ClusterConfig, device=None):
    """The device of this process: ``cuda:<local_rank>`` unless ``device``
    says ``cpu``. Raises when CUDA is asked for and there is none."""
    import torch

    from tpufw_torch.utils.hardware import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", config.local_rank)
    return dev


def init_process_group(coordinator_address: str, world_size: int, rank: int,
                       device, timeout_s: float = 300.0) -> None:
    """``torch.distributed.init_process_group`` on a ``TCPStore`` at
    ``coordinator_address`` (``host:port``; rank 0 serves it): NCCL bound
    to ``device`` when it is a CUDA device, gloo for the CPU."""
    import torch
    import torch.distributed as dist

    host, port = coordinator_address.rsplit(":", 1)
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world_size, rank == 0,
                          timeout=timeout)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world_size, timeout=timeout,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size, timeout=timeout)


def initialize_cluster(
    config: Optional[ClusterConfig] = None,
    timeout_s: float = 300.0,
    device=None,
) -> ClusterConfig:
    """Idempotent process-group start from the resolved env (see the
    module docstring for the backend and device). Single-process configs
    no-op, so workloads call this unconditionally. The rendezvous is
    retried until ``timeout_s``: during a gang (re)start the coordinator
    may come up last."""
    import torch.distributed as dist

    config = config or resolve_cluster_env()
    if not config.is_distributed:
        return config
    if dist.is_initialized():
        return config
    if config.process_id >= config.num_processes or config.process_id < 0:
        raise ValueError(
            f"process_id {config.process_id} out of range for "
            f"{config.num_processes} processes"
        )
    if not 0 <= config.local_rank < config.local_world_size:
        raise ValueError(
            f"local_rank {config.local_rank} out of range for "
            f"{config.local_world_size} processes a host"
        )
    dev = local_device(config, device)
    deadline = time.monotonic() + timeout_s
    last_err: Exception | None = None
    while time.monotonic() < deadline:
        try:
            init_process_group(config.coordinator_address, config.world_size,
                               config.rank, dev,
                               max(1.0, deadline - time.monotonic()))
            return config
        except Exception as e:  # connection errors surface as various types
            last_err = e
            if dist.is_initialized():
                return config
            time.sleep(min(5.0, max(0.5, deadline - time.monotonic())))
    raise TimeoutError(
        f"torch.distributed init failed for {config}: {last_err}"
    )
