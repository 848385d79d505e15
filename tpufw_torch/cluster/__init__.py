"""Cluster plumbing (port of ``tpufw.cluster``): replica discovery for the
disaggregated-serving router. The multi-GPU bootstrap is ROADMAP.md
Queue 1 item 12."""

from tpufw_torch.cluster.discovery import discover_replicas  # noqa: F401
