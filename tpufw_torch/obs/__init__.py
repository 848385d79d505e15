"""Observability (port of ``tpufw.obs``): the metrics registry the HTTP
server renders ``/metrics`` from, and the disaggregated roles' and
router's event log (``events``), span tracer (``trace``), request trace
context (``reqtrace``) and SLO tracker (``slo``). Goodput, health, skew
and the fleet modules are ROADMAP.md Queue 1 item 13."""

from tpufw_torch.obs.registry import (  # noqa: F401
    CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
