"""Multi-host skew monitor: per-host window timings + straggler events
(port of ``tpufw.obs.skew``).

"Exploring the limits of Concurrency in ML Training on Google TPUs"
(PAPERS.md) observes that pod-scale regressions are dominated by
per-host skew and input stalls that fleet-averaged step times hide: in
a synchronous SPMD program one slow host IS the step time, and the
average tells you nothing about which host to go look at. This monitor
piggybacks on the sync window the trainers already pay for — once per
window (not per step) each host contributes its window wall-time and
data-wait to an allgather, every host publishes the per-host gauges,
and a ``straggler_detected`` event fires when some host's window time
exceeds the fleet median by a configurable factor.

A "host" here is a rank of the gang's ``torch.distributed`` group (one
process per GPU), indexed by its global rank. The gather is injectable
so the detection logic is testable in one process with synthetic
skewed timings; the default all-gathers each rank's two numbers over
the default process group (one float64 pair on the gang's device, the
collective every rank reaches at the same sync window) only when a
group of more than one rank is up.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from tpufw_torch.obs import events as events_mod
from tpufw_torch.obs.registry import Registry

# Per-host gauges published on every host (labels, not per-host metric
# names: one dashboard query fans out over the fleet).
HOST_WINDOW_GAUGE = "tpufw_train_host_window_seconds"
HOST_WAIT_GAUGE = "tpufw_train_host_data_wait_seconds"
STRAGGLER_COUNTER = "tpufw_train_stragglers_total"

GatherFn = Callable[[Sequence[float]], List[Sequence[float]]]


def _default_gather(row: Sequence[float]) -> List[Sequence[float]]:
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or (
        dist.get_world_size() == 1
    ):
        return [row]
    from tpufw_torch.train.sharding import gang_device

    mine = torch.tensor(row, dtype=torch.float64, device=gang_device())
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    return [list(map(float, r.tolist())) for r in rows]


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class SkewMonitor:
    """Record per-host window timings; emit straggler events.

    factor:    a host is a straggler when its window time exceeds
               ``factor * median`` across hosts.
    min_gap_s: AND exceeds the median by this many seconds — tiny
               windows (compile-cache-warm CPU smoke runs) would
               otherwise flag scheduler noise as stragglers.
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        events=None,
        factor: float = 2.0,
        min_gap_s: float = 0.05,
        gather: Optional[GatherFn] = None,
    ):
        if factor <= 1.0:
            raise ValueError(f"straggler factor must be > 1, got {factor}")
        self.registry = registry
        self.events = events if events is not None else events_mod.NULL
        self.factor = factor
        self.min_gap_s = min_gap_s
        self._gather = gather or _default_gather

    def record(
        self, step: int, window_time_s: float, data_wait_s: float
    ) -> List[int]:
        """Contribute this host's window to the fleet view; returns
        the straggler host indices (empty when healthy). Collective:
        in multi-host runs every process must call this at the same
        step, which the sync-window call site guarantees."""
        rows = self._gather((float(window_time_s), float(data_wait_s)))
        times = [r[0] for r in rows]
        waits = [r[1] for r in rows]
        if self.registry is not None:
            wg = self.registry.gauge(
                HOST_WINDOW_GAUGE, "per-host sync-window wall time"
            )
            dg = self.registry.gauge(
                HOST_WAIT_GAUGE, "per-host per-step input-pipeline wait"
            )
            for h, (t, w) in enumerate(zip(times, waits)):
                wg.set(t, host=h)
                dg.set(w, host=h)
        med = _median(times)
        cut = max(med * self.factor, med + self.min_gap_s)
        stragglers = [h for h, t in enumerate(times) if t > cut]
        if stragglers:
            if self.registry is not None:
                self.registry.counter(
                    STRAGGLER_COUNTER,
                    "windows in which at least one host straggled",
                ).inc()
            self.events.emit(
                "straggler_detected",
                level="warn",
                step=step,
                straggler_hosts=stragglers,
                host_window_s=[round(t, 6) for t in times],
                host_data_wait_s=[round(w, 6) for w in waits],
                median_s=round(med, 6),
                factor=self.factor,
            )
        return stragglers
