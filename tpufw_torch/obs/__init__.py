"""Observability (port of ``tpufw.obs``): the metrics registry the HTTP
server renders ``/metrics`` from. Events, traces, goodput, health and the
fleet modules are ROADMAP.md Queue 1 item 13."""

from tpufw_torch.obs.registry import (  # noqa: F401
    CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
