"""Per-tenant serving SLO tracking: TTFT and per-token latency
against configurable targets, with sliding-window attainment and
multi-window burn rates (a copy of ``tpufw.obs.slo``).

The two SLIs are the ones production LLM serving is judged on:

- **TTFT** — router-observed time to first usable token
  (queue_wait + admit + prefill round trip + splice; the decomposition
  is tpufw_torch.obs.reqtrace's job, this module only judges the total);
- **per-token latency** — (total − ttft) / (n_tokens − 1), the steady
  decode rate a streaming client experiences.

A request is "good" when the SLI is within target. Attainment over a
sliding window is good/total; the **burn rate** for error budget
``1 − goal`` over window W is ``(1 − attainment(W)) / (1 − goal)`` —
1.0 means the budget burns exactly at the sustainable rate, 14.4 on
the short window is the classic page-now threshold. Multi-window
evaluation (default 60s/300s/3600s) lets alerting distinguish a blip
from a sustained regression.

Targets come from ``TPUFW_SLO_TTFT_MS`` / ``TPUFW_SLO_TOK_MS`` with
per-tenant overrides in ``TPUFW_SLO_TENANTS``
(``tenant:ttft_ms:tok_ms,...`` — same spirit as the router's tenant
weight spec). Everything lands in the shared Registry as
``tpufw_slo_*`` series labeled by tenant, plus a schema'd
``slo_violation`` event per missed target (documented in
docs/OBSERVABILITY.md).

Stdlib only — lives in the router process, which never loads torch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from tpufw_torch.workloads.env import env_float, env_str

from .events import NULL as NULL_EVENTS
from .registry import Registry

#: Default sliding windows (seconds): blip / sustained / budget-scale.
DEFAULT_WINDOWS = (60.0, 300.0, 3600.0)

#: Buckets sized for TTFT (tens of ms .. tens of s) and per-token
#: latency (ms .. s) on the same scale.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def parse_tenant_targets(spec: str) -> Dict[str, Tuple[float, float]]:
    """``"vip:500:50, batch:10000:1000"`` -> {tenant: (ttft_ms,
    tok_ms)}. Malformed entries are skipped, like the router's weight
    parser — a bad knob must not take down the front door."""
    out: Dict[str, Tuple[float, float]] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 3:
            continue
        try:
            out[parts[0].strip()] = (float(parts[1]), float(parts[2]))
        except ValueError:
            continue
    return out


class SloTracker:
    """Sliding-window SLO accounting for one router process.

    ``observe()`` is called once per completed request off the device
    path; all state lives behind one lock (deques are per-tenant and
    pruned to the longest window on every observe, so memory is
    bounded by request rate × max(windows))."""

    def __init__(
        self,
        registry: Registry,
        events=None,
        *,
        ttft_ms: float = 2000.0,
        tok_ms: float = 200.0,
        tenants: Optional[Dict[str, Tuple[float, float]]] = None,
        goal: float = 0.99,
        windows: Sequence[float] = DEFAULT_WINDOWS,
        clock=time.monotonic,
    ):
        if not 0.0 < goal < 1.0:
            raise ValueError(f"SLO goal must be in (0, 1), got {goal}")
        self.registry = registry
        self.events = events if events is not None else NULL_EVENTS
        self.ttft_ms = float(ttft_ms)
        self.tok_ms = float(tok_ms)
        self.tenants = dict(tenants or {})
        self.goal = float(goal)
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows or self.windows[0] <= 0:
            raise ValueError(f"bad SLO windows {windows!r}")
        self._clock = clock
        self._lock = threading.Lock()
        # Load-observatory phase label (e.g. "rung-2", "burst") —
        # stamped onto slo_violation events so a sweep's violations
        # attribute to their rung. Events-only on purpose: a metric
        # label would churn the fleet deriver's key space (TPU018).
        self._phase = ""
        # tenant -> deque of (t, ttft_ok, tok_ok); tok_ok is None for
        # single-token requests (no steady-state decode to judge).
        self._obs: Dict[str, deque] = {}
        r = registry
        self._h_ttft = r.histogram(
            "tpufw_slo_ttft_seconds",
            "router-observed time to first token",
            buckets=LATENCY_BUCKETS,
        )
        self._h_tok = r.histogram(
            "tpufw_slo_tok_seconds",
            "per-token decode latency after the first token",
            buckets=LATENCY_BUCKETS,
        )
        self._c_requests = r.counter(
            "tpufw_slo_requests_total", "requests judged against the SLO"
        )
        self._c_violations = r.counter(
            "tpufw_slo_violations_total",
            "requests that missed a target, by metric",
        )
        self._g_ttft_att = r.gauge(
            "tpufw_slo_ttft_attainment",
            "fraction of requests meeting the TTFT target "
            "(longest window)",
        )
        self._g_tok_att = r.gauge(
            "tpufw_slo_tok_attainment",
            "fraction of requests meeting the per-token target "
            "(longest window)",
        )
        self._g_burn = r.gauge(
            "tpufw_slo_burn_rate",
            "error-budget burn rate by metric and window "
            "(1.0 = sustainable)",
        )

    # ------------------------------------------------------ targets

    def targets_for(self, tenant: str) -> Tuple[float, float]:
        """(ttft_ms, tok_ms) for a tenant — override or defaults."""
        return self.tenants.get(tenant, (self.ttft_ms, self.tok_ms))

    def set_phase(self, phase: str) -> None:
        """Stamp subsequent slo_violation events with a load phase
        ("" clears). The sweep runner calls this at rung boundaries."""
        with self._lock:
            self._phase = str(phase)

    # ------------------------------------------------------ observe

    def observe(
        self,
        tenant: str,
        ttft_s: float,
        tok_s: Optional[float] = None,
        trace: str = "",
    ) -> None:
        """Judge one completed request and refresh that tenant's
        gauges. ``tok_s`` is None for requests that produced <= 1
        token."""
        tenant = tenant or "default"
        ttft_tgt, tok_tgt = self.targets_for(tenant)
        ttft_ok = ttft_s * 1e3 <= ttft_tgt
        tok_ok = None if tok_s is None else (tok_s * 1e3 <= tok_tgt)
        now = self._clock()
        with self._lock:
            phase = self._phase
        extra = {"phase": phase} if phase else {}
        self._h_ttft.observe(ttft_s, tenant=tenant)
        if tok_s is not None:
            self._h_tok.observe(tok_s, tenant=tenant)
        self._c_requests.inc(tenant=tenant)
        if not ttft_ok:
            self._c_violations.inc(tenant=tenant, metric="ttft")
            self.events.emit(
                "slo_violation", level="warn", tenant=tenant,
                metric="ttft", value_ms=round(ttft_s * 1e3, 3),
                target_ms=ttft_tgt, trace=trace, **extra,
            )
        if tok_ok is False:
            self._c_violations.inc(tenant=tenant, metric="tok")
            self.events.emit(
                "slo_violation", level="warn", tenant=tenant,
                metric="tok", value_ms=round((tok_s or 0.0) * 1e3, 3),
                target_ms=tok_tgt, trace=trace, **extra,
            )
        with self._lock:
            q = self._obs.get(tenant)
            if q is None:
                q = self._obs[tenant] = deque()
            q.append((now, ttft_ok, tok_ok))
            horizon = now - self.windows[-1]
            while q and q[0][0] < horizon:
                q.popleft()
            self._refresh_locked(tenant, now)

    # ---------------------------------------------------- computing

    def _window_stats_locked(self, tenant: str, window: float, now: float):
        """(ttft_attainment, tok_attainment, n) over the window;
        attainment is 1.0 with no traffic (an empty window has burned
        no budget)."""
        q = self._obs.get(tenant) or ()
        cutoff = now - window
        n = ttft_good = tok_n = tok_good = 0
        for t, ttft_ok, tok_ok in q:
            if t < cutoff:
                continue
            n += 1
            ttft_good += ttft_ok
            if tok_ok is not None:
                tok_n += 1
                tok_good += tok_ok
        ttft_att = ttft_good / n if n else 1.0
        tok_att = tok_good / tok_n if tok_n else 1.0
        return ttft_att, tok_att, n

    def _refresh_locked(self, tenant: str, now: float) -> None:
        budget = 1.0 - self.goal
        for w in self.windows:
            ttft_att, tok_att, _n = self._window_stats_locked(
                tenant, w, now
            )
            wl = f"{int(w)}s"
            self._g_burn.set(
                (1.0 - ttft_att) / budget,
                tenant=tenant, metric="ttft", window=wl,
            )
            self._g_burn.set(
                (1.0 - tok_att) / budget,
                tenant=tenant, metric="tok", window=wl,
            )
        # Headline attainment gauges read the LONGEST window — the
        # most stable number, and the one the smoke scrape asserts.
        ttft_att, tok_att, _n = self._window_stats_locked(
            tenant, self.windows[-1], now
        )
        self._g_ttft_att.set(ttft_att, tenant=tenant)
        self._g_tok_att.set(tok_att, tenant=tenant)

    def attainment(
        self, tenant: str, metric: str = "ttft",
        window: Optional[float] = None,
    ) -> float:
        tenant = tenant or "default"
        w = float(window) if window is not None else self.windows[-1]
        with self._lock:
            ttft_att, tok_att, _n = self._window_stats_locked(
                tenant, w, self._clock()
            )
        return ttft_att if metric == "ttft" else tok_att

    def burn_rate(
        self, tenant: str, metric: str = "ttft",
        window: Optional[float] = None,
    ) -> float:
        return (1.0 - self.attainment(tenant, metric, window)) / (
            1.0 - self.goal
        )

    def max_burn(self, window: Optional[str] = None) -> float:
        """Worst burn rate across every (tenant, metric) pair over
        one window — the executor's recovery signal. ``window`` is
        the gauge's label string ("60s"); None means the fastest
        window. Tenant list is snapshotted under the lock, burn math
        runs outside it (burn_rate re-acquires)."""
        if window is None:
            w = self.windows[0]
        else:
            w = float(str(window).rstrip("s"))
        with self._lock:
            tenants = list(self._obs)
        worst = 0.0
        for tenant in tenants:
            for metric in ("ttft", "tok"):
                worst = max(worst, self.burn_rate(tenant, metric, w))
        return worst

    # --------------------------------------------------------- env

    @classmethod
    def from_env(cls, registry: Registry, events=None) -> "SloTracker":
        """Build from TPUFW_SLO_* knobs (documented in docs/ENV.md)."""
        windows = tuple(
            float(w)
            for w in env_str("slo_windows_s", "60,300,3600").split(",")
            if w.strip()
        )
        return cls(
            registry,
            events,
            ttft_ms=env_float("slo_ttft_ms", 2000.0),
            tok_ms=env_float("slo_tok_ms", 200.0),
            tenants=parse_tenant_targets(env_str("slo_tenants", "")),
            goal=env_float("slo_goal", 0.99),
            windows=windows or DEFAULT_WINDOWS,
        )
