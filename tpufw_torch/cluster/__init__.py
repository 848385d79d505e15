"""Cluster plumbing (port of ``tpufw.cluster``): the multi-process
bootstrap of a training gang, and replica discovery for the
disaggregated-serving router."""

from tpufw_torch.cluster.bootstrap import (  # noqa: F401
    ClusterConfig,
    init_process_group,
    initialize_cluster,
    local_device,
    resolve_cluster_env,
)
from tpufw_torch.cluster.discovery import discover_replicas  # noqa: F401
