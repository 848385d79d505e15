"""The port's cluster bootstrap against ``tpufw.cluster``: the six cases of
``tests/test_cluster.py`` through both packages' ``resolve_cluster_env``
(equal fields, or the same error), then what only the port has: one
process per GPU (``LOCAL_RANK``/``LOCAL_WORLD_SIZE``), the rank's device,
and the refusals of ``initialize_cluster``."""

import dataclasses

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.cluster import ClusterConfig as JClusterConfig
from tpufw.cluster import initialize_cluster as j_initialize_cluster
from tpufw.cluster import resolve_cluster_env as j_resolve
from tpufw_torch.cluster import (
    ClusterConfig,
    initialize_cluster,
    local_device,
    resolve_cluster_env,
)

ENVS = {
    "single": {},
    "explicit_wins": {"TPUFW_COORDINATOR": "10.0.0.1:8476",
                      "TPUFW_NUM_PROCESSES": "4", "TPUFW_PROCESS_ID": "2",
                      "JOBSET_NAME": "ignored", "JOB_COMPLETION_INDEX": "9"},
    "jobset": {"JOBSET_NAME": "llama16", "REPLICATED_JOB_NAME": "workers",
               "JOB_COMPLETION_INDEX": "3", "TPUFW_WORKERS_PER_SLICE": "4"},
    "jobset_svc": {"JOBSET_NAME": "j", "JOB_COMPLETION_INDEX": "0",
                   "TPUFW_WORKERS_PER_SLICE": "2",
                   "TPUFW_COORDINATOR_SVC": "coord.default.svc",
                   "TPUFW_COORDINATOR_PORT": "9000"},
    "gke": {"TPU_WORKER_ID": "1",
            "TPU_WORKER_HOSTNAMES": "host-0,host-1,host-2,host-3"},
}
BAD = {
    "coordinator_without_count": {"TPUFW_COORDINATOR": "x:1"},
    "jobset_without_workers": {"JOBSET_NAME": "j",
                               "JOB_COMPLETION_INDEX": "0"},
    "gke_no_hosts": {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": " , "},
}
FIELDS = ("coordinator_address", "num_processes", "process_id", "source")


@pytest.mark.parametrize("name", sorted(ENVS))
def test_resolution_equals_tpufw(name):
    got, want = resolve_cluster_env(ENVS[name]), j_resolve(ENVS[name])
    assert {f: getattr(got, f) for f in FIELDS} == {
        f: getattr(want, f) for f in FIELDS}
    assert got.is_distributed == want.is_distributed
    assert (got.rank, got.world_size) == (want.process_id,
                                          want.num_processes)


@pytest.mark.parametrize("name", sorted(BAD))
def test_errors_equal_tpufw(name):
    with pytest.raises(ValueError) as want:
        j_resolve(BAD[name])
    with pytest.raises(ValueError) as got:
        resolve_cluster_env(BAD[name])
    assert str(got.value) == str(want.value)


def test_single_process_is_a_no_op():
    import torch.distributed as dist

    cfg = resolve_cluster_env({})
    assert initialize_cluster(cfg) is cfg
    assert not dist.is_initialized()
    assert j_initialize_cluster(j_resolve({})).coordinator_address is None


def test_bad_process_id_rejected():
    with pytest.raises(ValueError, match="out of range") as want:
        j_initialize_cluster(JClusterConfig("x:1", num_processes=2,
                                            process_id=5))
    with pytest.raises(ValueError, match="out of range") as got:
        initialize_cluster(ClusterConfig("x:1", num_processes=2,
                                         process_id=5), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="out of range"):
        initialize_cluster(ClusterConfig("x:1", num_processes=2,
                                         local_rank=4, local_world_size=4),
                           device="cpu")


def test_one_process_per_gpu_maps_the_rank():
    """A per-GPU launcher's LOCAL_RANK / LOCAL_WORLD_SIZE under any
    source: the sources count hosts, the rank counts GPUs."""
    env = dict(ENVS["jobset"], LOCAL_RANK="3", LOCAL_WORLD_SIZE="8")
    cfg = resolve_cluster_env(env)
    assert (cfg.process_id, cfg.num_processes) == (3, 4)
    assert (cfg.rank, cfg.world_size) == (3 * 8 + 3, 32)
    assert cfg.is_distributed
    plain = resolve_cluster_env(ENVS["explicit_wins"])
    assert (plain.local_rank, plain.local_world_size) == (0, 1)
    assert (plain.rank, plain.world_size) == (2, 4)
    # torchrun on one host: one process id, a rank per GPU.
    one = dataclasses.replace(plain, num_processes=1, process_id=0,
                              local_rank=5, local_world_size=8)
    assert (one.rank, one.world_size, one.is_distributed) == (5, 8, True)


def test_the_ranks_device():
    cfg = resolve_cluster_env(dict(ENVS["explicit_wins"], LOCAL_RANK="1",
                                   LOCAL_WORLD_SIZE="2"))
    assert local_device(cfg, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_device(cfg)
    else:
        assert local_device(cfg) == torch.device("cuda", 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_a_gang_without_gpu_or_cpu_request_raises():
    """No GPU and no device="cpu": no silent gloo."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_cluster(resolve_cluster_env(ENVS["explicit_wins"]),
                           timeout_s=1.0)
    assert not dist.is_initialized()
