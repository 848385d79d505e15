"""Fleet observatory (a copy of ``tpufw.obs.fleet``): cross-replica
scrape -> bounded time-series -> derived fleet signals -> burn-rate
alerts -> checkable scaling recommendations.

Every other observability layer here is instantaneous and per-process
— gauges exist at scrape time, in one replica, and vanish with it.
This module is the fleet's flight recorder and its brain stem:

- **FleetCollector** scrapes every replica on an interval — router
  ``/metrics`` exposition through the tolerant parser
  (``tpufw_torch.obs.promtext``), prefill/decode replicas through their
  framed-TCP ``signals()`` probe, plus the router's ``/healthz``
  per-replica detail — and appends one record per target per sweep
  into a **SeriesStore** (``fleet-series.jsonl``): size-bounded,
  ring-compacted by decimation (older samples thin out, every kept
  record stays a *genuine* snapshot so counter rate math survives),
  torn-tail-tolerant on read like the event log.
- **Derived fleet series** (``tpufw_fleet_*``) re-aggregate the
  per-replica truth: tokens/s, queue depth, page occupancy across
  arenas, piggyback fraction, spec accept rate, and per-tenant SLO
  attainment + multi-window burn rates across routers.
- A declarative **alert-rule engine** (threshold+for-duration rules
  and fast/slow burn-rate pairs) emits schema'd ``fleet_alert``
  events on firing/resolution.
- A **ScalingRecommender** maps sustained alerts to independent
  prefill-vs-decode replica-count deltas and writes each decision as
  a JobSet-manifest-shaped artifact (the base manifest with the
  ``replicas:`` counts patched) that the repo's deploy lint
  (``python -m tpufw.analysis --layer deploy --manifest <artifact>``)
  verifies *before* anything acts on it.
- A **retrospective query CLI** (``python -m tpufw_torch.obs.fleet
  query --at/--window``) reconstructs fleet state at any past instant
  from the store + the ``events-fleet.jsonl`` alert history.

Stdlib only (plus the port's own torch-free obs modules): the
collector runs in the router process, which never loads torch, a CI
runner, or a laptop reading a copied series dir. File names, record
layout, event kinds and series names are ``tpufw``'s, so either
package's readers read the other's files. Knobs:
``TPUFW_FLEET_SCRAPE_S`` (unset/0 = everything off), ``TPUFW_FLEET_DIR``,
``TPUFW_FLEET_MAX_RECORDS``, ``TPUFW_FLEET_MANIFEST``,
``TPUFW_FLEET_COOLDOWN_S``, ``TPUFW_FLEET_MAX_REPLICAS`` — see
docs/ENV.md.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import re
import threading
import time
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from tpufw_torch.obs import events as obs_events
from tpufw_torch.obs import promtext
from tpufw_torch.obs.registry import Registry
from tpufw_torch.workloads.env import env_float, env_int, env_str

SERIES_FILENAME = "fleet-series.jsonl"
EVENTS_FILENAME = "events-fleet.jsonl"

# ------------------------------------------------------- series store


def read_series(path: str) -> List[dict]:
    """Parse a fleet-series JSONL file (blank lines skipped, torn or
    garbage lines dropped — the reader half of the EventLog contract:
    a collector killed mid-write must not take the queries with it)."""
    out: List[dict] = []
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail on an unclean shutdown
            if isinstance(rec, dict) and "ts" in rec and "replica" in rec:
                out.append(rec)
    return out


def _decimate(records: List[dict]) -> List[dict]:
    """Per-replica decimation, anchored at the newest sample: keep the
    later of each adjacent same-replica pair (walking back from the
    end, keep one / drop one). Kept records are untouched genuine
    snapshots — never averaged — so counter deltas between survivors
    still mean what they meant, just over a coarser grid."""
    by_replica: Dict[str, List[int]] = {}
    for i, rec in enumerate(records):
        by_replica.setdefault(str(rec.get("replica")), []).append(i)
    keep = set()
    for positions in by_replica.values():
        n = len(positions)
        for pos, idx in enumerate(positions):
            if (n - 1 - pos) % 2 == 0:
                keep.add(idx)
    return [rec for i, rec in enumerate(records) if i in keep]


class SeriesStore:
    """Append-only, size-bounded fleet time-series (JSONL, one record
    per target per sweep). Past ``max_records`` the file is ring-
    compacted: the newest half is kept verbatim, the older half is
    decimated per replica, and the result replaces the file via
    tmp + atomic rename (a reader or a crash mid-compaction sees
    either the old file or the new one, never a hybrid)."""

    def __init__(
        self,
        path: str,
        *,
        max_records: int = 4096,
        clock: Callable[[], float] = time.time,
    ):
        # resource: acquires file-handle
        self.path = path
        self.max_records = max(16, int(max_records))
        self._clock = clock
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._count = len(read_series(path)) if os.path.exists(path) else 0
        self._f = open(path, "a", encoding="utf-8")  # noqa: SIM115  # resource: acquires file-handle
        try:
            # A predecessor killed mid-write leaves an unterminated
            # tail; appending straight after it would glue the first
            # new record onto the torn line and lose BOTH. Terminate
            # it first.
            torn = False
            try:
                with open(path, "rb") as fh:
                    fh.seek(0, os.SEEK_END)
                    if fh.tell() > 0:
                        fh.seek(-1, os.SEEK_END)
                        torn = fh.read(1) != b"\n"
            except OSError:
                pass
            if torn:
                self._f.write("\n")
                self._f.flush()
        except BaseException:
            # A half-built store must not strand the append handle
            # (TPU019): if the torn-tail repair raises, the caller
            # never gets an object to close().
            self._f.close()
            raise

    def append(
        self,
        replica: str,
        role: str,
        series: Mapping[str, float],
        *,
        ts: Optional[float] = None,
        stale: bool = False,
    ) -> dict:
        rec: Dict[str, Any] = {
            "ts": round(
                float(ts if ts is not None else self._clock()), 6
            ),
            "replica": str(replica),
            "role": str(role),
            "series": {k: float(v) for k, v in series.items()},
        }
        if stale:
            rec["stale"] = True
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f is None:
                return rec
            self._f.write(line + "\n")
            self._f.flush()
            self._count += 1
            if self._count > self.max_records:
                self._compact_locked()
        return rec

    def _compact_locked(self) -> None:
        records = read_series(self.path)
        keep_tail = max(1, self.max_records // 2)
        head, tail = records[:-keep_tail], records[-keep_tail:]
        kept = _decimate(head) + tail
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in kept:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.close()
        # Park in the closed state append() tolerates: if the rename
        # or reopen below raises, _f must not point at a closed
        # handle every later append() would crash on.
        self._f = None
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")  # noqa: SIM115
        self._count = len(kept)

    def read(
        self,
        since: Optional[float] = None,
        until: Optional[float] = None,
    ) -> List[dict]:
        with self._lock:
            records = read_series(self.path)
        if since is not None:
            records = [r for r in records if r["ts"] >= since]
        if until is not None:
            records = [r for r in records if r["ts"] <= until]
        return records

    def close(self) -> None:
        # resource: releases file-handle
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------- scrape targets


class Target:
    """One scrapeable endpoint. ``scrape()`` returns Prometheus
    exposition text (a ``/metrics`` endpoint or an in-process
    ``Registry.render``) or a signals dict (a framed-TCP replica's
    ``{"signals": true}`` probe) — the collector handles both."""

    def __init__(
        self, name: str, role: str, scrape: Callable[[], Any]
    ):
        self.name = name
        self.role = role
        self.scrape = scrape


def http_target(
    name: str, url: str, role: str = "router", timeout_s: float = 2.0
) -> Target:
    def scrape() -> str:
        import urllib.request

        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8")

    return Target(name, role, scrape)


def signals_target(
    name: str, host: str, port: int, role: str, timeout_s: float = 2.0
) -> Target:
    """Framed-TCP signals probe — how prefill/decode replicas (which
    expose no HTTP) are scraped, the same control frame the router's
    health probes use."""

    def scrape() -> Dict[str, Any]:
        from tpufw_torch.serve import transport

        reply, _rtt = transport.rpc(
            host, int(port), json.dumps({"signals": True}).encode()
        )
        return json.loads(reply.decode("utf-8"))

    return Target(name, role, scrape)


def http_health_fn(
    base_url: str, timeout_s: float = 2.0
) -> Callable[[], dict]:
    """``/healthz`` poller for a remote router — the per-replica
    detail backfills occupancy for replicas the collector cannot
    reach directly."""

    def fetch() -> dict:
        import urllib.request

        with urllib.request.urlopen(
            base_url.rstrip("/") + "/healthz", timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    return fetch


#: Numeric replica-signal fields -> the per-replica series they record
#: as. One row per field in the docs/OBSERVABILITY.md series catalog.
SIGNAL_SERIES: Tuple[Tuple[str, str], ...] = (
    ("pages_total", "tpufw_fleet_replica_pages_total"),
    ("pages_in_use", "tpufw_fleet_replica_pages_in_use"),
    ("slots_total", "tpufw_fleet_replica_slots_total"),
    ("slots_active", "tpufw_fleet_replica_slots_active"),
    ("migrations", "tpufw_fleet_replica_migrations"),
    ("spec_k", "tpufw_fleet_replica_spec_k"),
    ("spec_passes", "tpufw_fleet_replica_spec_passes"),
    ("prefill_chunk_pages", "tpufw_fleet_replica_prefill_chunk_pages"),
    ("prefill_inflight", "tpufw_fleet_replica_prefill_inflight"),
    ("prefill_chunks", "tpufw_fleet_replica_prefill_chunks"),
    ("piggyback_waterline", "tpufw_fleet_replica_piggyback_waterline"),
    # KV fabric: drain state, prefix-cache hit counters, and spill-
    # tier occupancy/lifetime totals. prefix_digests (the one list-
    # valued signal) is intentionally absent — series are numeric.
    ("draining", "tpufw_fleet_replica_draining"),
    ("sessions_drained", "tpufw_fleet_replica_sessions_drained"),
    ("sessions_resumed", "tpufw_fleet_replica_sessions_resumed"),
    ("prefix_hits", "tpufw_fleet_replica_prefix_hits"),
    ("prefix_misses", "tpufw_fleet_replica_prefix_misses"),
    ("spill_ram_pages", "tpufw_fleet_replica_spill_ram_pages"),
    ("spill_dir_pages", "tpufw_fleet_replica_spill_dir_pages"),
    ("spill_pages_total", "tpufw_fleet_replica_spill_pages_total"),
    (
        "spill_restored_total",
        "tpufw_fleet_replica_spill_restored_total",
    ),
)


def series_from_signals(sig: Mapping[str, Any]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for field, series in SIGNAL_SERIES:
        v = sig.get(field)
        if isinstance(v, (int, float)):
            out[series] = float(v)
    return out


# ---------------------------------------------------- derived series


def _key(name: str, **labels: str) -> str:
    return promtext.sample_key(name, labels)


class _Deriver:
    """Turns one sweep's per-replica records into the
    ``tpufw_fleet_*`` derived series, holding the previous sweep's
    snapshot per replica for counter rate math."""

    #: Counter series summed into the fleet token rate.
    TOKEN_COUNTERS = (
        "tpufw_router_tokens_total",
        "tpufw_serve_tokens_generated_total",
    )
    REQUEST_COUNTER = "tpufw_router_requests_total"
    PIGGYBACK_COUNTER = "tpufw_router_piggyback_total"

    def __init__(self):
        self._prev: Dict[str, Tuple[float, Dict[str, float]]] = {}

    def _rate(
        self, rec: dict, names: Sequence[str]
    ) -> Tuple[float, float]:
        """(delta, dt) of the summed counters vs this replica's
        previous record; (0, 0) without a usable previous sample.
        Negative deltas (replica restart) clamp to zero."""
        prev = self._prev.get(rec["replica"])
        if prev is None:
            return 0.0, 0.0
        prev_ts, prev_series = prev
        dt = rec["ts"] - prev_ts
        if dt <= 0:
            return 0.0, 0.0
        cur = sum(rec["series"].get(n, 0.0) for n in names)
        was = sum(prev_series.get(n, 0.0) for n in names)
        return max(0.0, cur - was), dt

    def derive(self, records: List[dict]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        live = [r for r in records if not r.get("stale")]
        roles: Dict[str, int] = {}
        for rec in live:
            roles[rec["role"]] = roles.get(rec["role"], 0) + 1
        for role, n in sorted(roles.items()):
            out[_key("tpufw_fleet_replicas", role=role)] = float(n)
        out["tpufw_fleet_replicas_unhealthy"] = float(
            sum(1 for r in records if r.get("stale"))
        )

        def total(series_name: str) -> float:
            return sum(
                r["series"].get(series_name, 0.0) for r in live
            )

        out["tpufw_fleet_queue_depth"] = total(
            "tpufw_router_queue_depth"
        )
        pages_in_use = total("tpufw_fleet_replica_pages_in_use")
        pages_total = total("tpufw_fleet_replica_pages_total")
        out["tpufw_fleet_pages_in_use"] = pages_in_use
        out["tpufw_fleet_pages_total"] = pages_total
        if pages_total > 0:
            out["tpufw_fleet_page_occupancy"] = (
                pages_in_use / pages_total
            )
        # KV fabric: pages parked outside HBM (hot host RAM + the
        # directory tier) fleet-wide, replicas mid-drain, and the
        # cross-replica prefix hit ratio — THE number the affinity
        # router is supposed to hold invariant as the pool scales.
        out["tpufw_fleet_spill_pages"] = total(
            "tpufw_fleet_replica_spill_ram_pages"
        ) + total("tpufw_fleet_replica_spill_dir_pages")
        out["tpufw_fleet_draining_replicas"] = total(
            "tpufw_fleet_replica_draining"
        )
        ph = total("tpufw_fleet_replica_prefix_hits")
        pm = total("tpufw_fleet_replica_prefix_misses")
        if ph + pm > 0:
            out["tpufw_fleet_prefix_hit_ratio"] = ph / (ph + pm)

        tok_delta = tok_dt = req_delta = req_dt = pig_delta = 0.0
        for rec in live:
            d, dt = self._rate(rec, self.TOKEN_COUNTERS)
            tok_delta += d
            tok_dt = max(tok_dt, dt)
            d, dt = self._rate(rec, (self.REQUEST_COUNTER,))
            req_delta += d
            req_dt = max(req_dt, dt)
            d, _ = self._rate(rec, (self.PIGGYBACK_COUNTER,))
            pig_delta += d
        if tok_dt > 0:
            out["tpufw_fleet_tokens_per_s"] = tok_delta / tok_dt
        if req_dt > 0:
            out["tpufw_fleet_requests_per_s"] = req_delta / req_dt
        if req_delta > 0:
            out["tpufw_fleet_piggyback_fraction"] = (
                pig_delta / req_delta
            )
        else:
            # No traffic this window: fall back to the cumulative
            # ratio so the series stays defined once requests exist.
            reqs = total(self.REQUEST_COUNTER)
            if reqs > 0:
                out["tpufw_fleet_piggyback_fraction"] = (
                    total(self.PIGGYBACK_COUNTER) / reqs
                )

        accept = [
            r["series"]["tpufw_spec_accept_rate"]
            for r in live
            if "tpufw_spec_accept_rate" in r["series"]
        ]
        if accept:
            out["tpufw_fleet_spec_accept_rate"] = sum(accept) / len(
                accept
            )

        # Per-tenant SLO re-aggregation across routers: attainment and
        # burn rate are already windowed ratios, so the fleet view is
        # their mean across the routers reporting that tenant (one
        # router in every current deployment — the mean is identity).
        slo: Dict[str, List[float]] = {}
        for rec in live:
            for skey, v in rec["series"].items():
                name, labels = promtext.parse_sample_key(skey)
                if name == "tpufw_slo_ttft_attainment" and labels:
                    k = _key(
                        "tpufw_fleet_slo_attainment",
                        metric="ttft",
                        tenant=labels.get("tenant", ""),
                    )
                elif name == "tpufw_slo_tok_attainment" and labels:
                    k = _key(
                        "tpufw_fleet_slo_attainment",
                        metric="tok",
                        tenant=labels.get("tenant", ""),
                    )
                elif name == "tpufw_slo_burn_rate" and labels:
                    k = _key(
                        "tpufw_fleet_slo_burn_rate",
                        metric=labels.get("metric", ""),
                        tenant=labels.get("tenant", ""),
                        window=labels.get("window", ""),
                    )
                else:
                    continue
                slo.setdefault(k, []).append(v)
        for k, vals in slo.items():
            out[k] = sum(vals) / len(vals)

        for rec in live:
            self._prev[rec["replica"]] = (rec["ts"], rec["series"])
        return out


# ------------------------------------------------------- alert rules


@dataclass(frozen=True)
class AlertRule:
    """Threshold + for-duration rule over one derived series (matched
    by series *name*; labeled series alert per label set). ``scale``
    optionally names the scaling hint a sustained firing feeds the
    recommender: ``"prefill:+1"``, ``"decode:-1"``, ..."""

    name: str
    series: str
    op: str = ">"
    threshold: float = 0.0
    for_s: float = 60.0
    severity: str = "warn"
    scale: str = ""


@dataclass(frozen=True)
class BurnRateRule:
    """Classic fast/slow multi-window burn-rate pair over the
    re-aggregated ``tpufw_fleet_slo_burn_rate`` series: fire when the
    fast window says "burning NOW" and the slow window confirms it is
    not a blip. One alert instance per tenant."""

    name: str
    metric: str  # "ttft" | "tok"
    fast_window: str = "60s"
    slow_window: str = "300s"
    fast_threshold: float = 14.4
    slow_threshold: float = 6.0
    for_s: float = 0.0
    severity: str = "page"
    scale: str = ""


#: The registered rule catalog (documented in docs/OBSERVABILITY.md —
#: every series name referenced here is in the series catalog there).
DEFAULT_ALERT_RULES: Tuple[Any, ...] = (
    BurnRateRule(
        name="fleet_ttft_burn",
        metric="ttft",
        severity="page",
        scale="prefill:+1",
    ),
    BurnRateRule(
        name="fleet_tok_burn",
        metric="tok",
        severity="page",
        scale="decode:+1",
    ),
    AlertRule(
        name="fleet_queue_backlog",
        series="tpufw_fleet_queue_depth",
        op=">",
        threshold=8.0,
        for_s=30.0,
        severity="warn",
        scale="prefill:+1",
    ),
    AlertRule(
        name="fleet_pages_pressure",
        series="tpufw_fleet_page_occupancy",
        op=">",
        threshold=0.85,
        for_s=60.0,
        severity="warn",
        scale="decode:+1",
    ),
    AlertRule(
        name="fleet_idle_capacity",
        series="tpufw_fleet_page_occupancy",
        op="<",
        threshold=0.10,
        for_s=600.0,
        severity="info",
        scale="decode:-1",
    ),
    AlertRule(
        name="fleet_replica_down",
        series="tpufw_fleet_replicas_unhealthy",
        op=">",
        threshold=0.0,
        for_s=10.0,
        severity="page",
    ),
)


class AlertEngine:
    """Evaluates the rule catalog against each sweep's derived series.
    Pure state machine over an injectable clock (tests drive it with a
    fake): condition holds -> pending; held ``for_s`` -> firing (one
    ``fleet_alert`` event); condition clears -> resolved (one more)."""

    def __init__(
        self,
        rules: Sequence[Any] = DEFAULT_ALERT_RULES,
        *,
        events=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rules = tuple(rules)
        self._events = events if events is not None else obs_events.NULL
        self._clock = clock
        # instance id -> {"since": pending-start, "firing": bool}
        self._state: Dict[str, Dict[str, Any]] = {}

    def _instances(
        self, rule: Any, derived: Mapping[str, float]
    ) -> List[Tuple[str, str, float, float]]:
        """(instance_id, series_key, value, threshold) rows whose
        condition currently holds, plus held-but-absent handling via
        the caller's state sweep."""
        rows: List[Tuple[str, str, float, float]] = []
        if isinstance(rule, BurnRateRule):
            fast: Dict[str, Tuple[str, float]] = {}
            slow: Dict[str, float] = {}
            for skey, v in derived.items():
                name, labels = promtext.parse_sample_key(skey)
                if (
                    name != "tpufw_fleet_slo_burn_rate"
                    or labels.get("metric") != rule.metric
                ):
                    continue
                tenant = labels.get("tenant", "")
                if labels.get("window") == rule.fast_window:
                    fast[tenant] = (skey, v)
                elif labels.get("window") == rule.slow_window:
                    slow[tenant] = v
            for tenant, (skey, v) in fast.items():
                if (
                    v > rule.fast_threshold
                    and slow.get(tenant, 0.0) > rule.slow_threshold
                ):
                    rows.append(
                        (
                            f"{rule.name}:{tenant}",
                            skey,
                            v,
                            rule.fast_threshold,
                        )
                    )
            return rows
        for skey, v in derived.items():
            name, _labels = promtext.parse_sample_key(skey)
            if name != rule.series:
                continue
            hit = v > rule.threshold if rule.op == ">" else (
                v < rule.threshold
            )
            if hit:
                rows.append(
                    (f"{rule.name}:{skey}", skey, v, rule.threshold)
                )
        return rows

    def evaluate(
        self,
        derived: Mapping[str, float],
        now: Optional[float] = None,
    ) -> List[dict]:
        """Advance every rule's state machine; returns the list of
        currently-firing alert dicts (rule catalog entry + instance
        detail), having emitted events for each transition."""
        now = self._clock() if now is None else float(now)
        firing: List[dict] = []
        seen: set = set()
        for rule in self.rules:
            for inst, skey, value, threshold in self._instances(
                rule, derived
            ):
                seen.add(inst)
                st = self._state.setdefault(
                    inst, {"since": now, "firing": False}
                )
                if not st["firing"] and now - st["since"] >= rule.for_s:
                    st["firing"] = True
                    st["fired_at"] = now
                    self._events.emit(
                        "fleet_alert",
                        level="warn",
                        rule=rule.name,
                        state="firing",
                        series=skey,
                        value=round(value, 6),
                        threshold=threshold,
                        severity=rule.severity,
                    )
                if st["firing"]:
                    firing.append(
                        {
                            "rule": rule,
                            "name": rule.name,
                            "instance": inst,
                            "series": skey,
                            "value": value,
                            "threshold": threshold,
                            "severity": rule.severity,
                            "scale": rule.scale,
                            "firing_for_s": now
                            - st.get("fired_at", now),
                        }
                    )
            # resolve instances whose condition no longer holds
            for inst in [
                i
                for i in self._state
                if i.startswith(rule.name + ":") and i not in seen
            ]:
                st = self._state.pop(inst)
                if st["firing"]:
                    self._events.emit(
                        "fleet_alert",
                        level="info",
                        rule=rule.name,
                        state="resolved",
                        series=inst.partition(":")[2],
                        value=0.0,
                        severity=rule.severity,
                    )
        return firing


# ------------------------------------------------ scaling recommender


_REPLICAS_RE = re.compile(r"replicas:\s*(\d+)\s*$")
_JOB_NAME_RE = re.compile(r"- name:\s*([A-Za-z0-9_-]+)\s*$")


def read_manifest_replicas(text: str) -> Dict[str, int]:
    """Replica counts of the replicatedJobs in a JobSet manifest,
    read with the same line discipline ``patch_manifest_replicas``
    writes with."""
    counts: Dict[str, int] = {}
    pending: Optional[str] = None
    in_jobs = False
    for line in text.split("\n"):
        stripped = line.strip()
        if stripped.startswith("#"):
            continue
        if stripped == "replicatedJobs:":
            in_jobs = True
            pending = None
            continue
        if stripped.startswith("---"):
            in_jobs = False
            pending = None
            continue
        if not in_jobs:
            continue
        if pending is not None:
            m = _REPLICAS_RE.match(stripped)
            if m:
                counts[pending] = int(m.group(1))
            pending = None  # one-shot: replicas must be the next line
            continue
        m = _JOB_NAME_RE.match(stripped)
        if m:
            pending = m.group(1)
    return counts


def patch_manifest_replicas(
    text: str, replicas: Mapping[str, int]
) -> str:
    """Return ``text`` with each named replicatedJob's ``replicas:``
    count rewritten. Pure line surgery (no yaml dependency in the
    collector container): a job's ``replicas:`` line must directly
    follow its ``- name:`` line, which is the convention every
    deploy/ JobSet here uses — container ``- name:`` lines never
    qualify because their next line is ``image:``."""
    lines = text.split("\n")
    pending: Optional[str] = None
    in_jobs = False
    for i, line in enumerate(lines):
        stripped = line.strip()
        if stripped.startswith("#"):
            continue
        if stripped == "replicatedJobs:":
            in_jobs = True
            pending = None
            continue
        if stripped.startswith("---"):
            in_jobs = False
            pending = None
            continue
        if not in_jobs:
            continue
        if pending is not None:
            if _REPLICAS_RE.match(stripped):
                indent = line[: len(line) - len(line.lstrip())]
                lines[i] = f"{indent}replicas: {replicas[pending]}"
            pending = None
            continue
        m = _JOB_NAME_RE.match(stripped)
        if m and m.group(1) in replicas:
            pending = m.group(1)
    return "\n".join(lines)


def _parse_scale(spec: str) -> Optional[Tuple[str, int]]:
    pool, sep, delta = spec.partition(":")
    if not sep:
        return None
    try:
        return pool.strip(), int(delta)
    except ValueError:
        return None


class ScalingRecommender:
    """Maps sustained firing alerts to independent per-pool replica
    deltas and writes each decision as (a) a JobSet-manifest-shaped
    YAML artifact — the base manifest with ``replicas:`` patched and a
    decision header comment — that the deploy lint layer verifies via
    ``tpulint --layer deploy --manifest <artifact>``, and (b) a JSON
    sidecar decision record. Per-pool cooldown keeps one incident
    from ratcheting the fleet."""

    def __init__(
        self,
        out_dir: str,
        base_manifest: str,
        *,
        cooldown_s: float = 300.0,
        min_replicas: int = 1,
        max_replicas: int = 8,
        events=None,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.out_dir = out_dir
        self.base_manifest = base_manifest
        self.cooldown_s = float(cooldown_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._events = events if events is not None else obs_events.NULL
        self._clock = clock
        self._wall = wall_clock
        os.makedirs(out_dir, exist_ok=True)
        with open(base_manifest, encoding="utf-8") as f:
            self._base_text = f.read()
        self.current = read_manifest_replicas(self._base_text)
        self._last_change: Dict[str, float] = {}
        self._seq = len(
            _glob.glob(os.path.join(out_dir, "fleet-rec-*.json"))
        )
        #: Decision subscribers (e.g. tpufw_torch.load.GangExecutor) — each
        #: called with the decision record after it is written and
        #: emitted. Same contract as EventLog.listeners: snapshot
        #: iteration, a raising subscriber is swallowed so it can
        #: never block the decision from landing on disk.
        self.listeners: List[Callable[[dict], None]] = []

    def consider(
        self, firing: Sequence[dict], now: Optional[float] = None
    ) -> Optional[dict]:
        """One sustained-alert sweep -> at most one decision. Returns
        the decision record (also written to disk + event log) or
        None when nothing changes."""
        now = self._clock() if now is None else float(now)
        deltas: Dict[str, int] = {}
        reasons: Dict[str, List[str]] = {}
        seen_rules: set = set()
        for alert in firing:
            if alert["name"] in seen_rules:
                continue  # one vote per rule, however many instances
            seen_rules.add(alert["name"])
            hint = _parse_scale(alert.get("scale", ""))
            if hint is None:
                continue
            pool, delta = hint
            deltas[pool] = deltas.get(pool, 0) + delta
            reasons.setdefault(pool, []).append(alert["name"])
        changes: Dict[str, Dict[str, int]] = {}
        for pool, delta in deltas.items():
            if pool not in self.current:
                continue
            if now - self._last_change.get(pool, -1e18) < self.cooldown_s:
                continue
            delta = max(-1, min(1, delta))  # one step per decision
            target = max(
                self.min_replicas,
                min(self.max_replicas, self.current[pool] + delta),
            )
            if target != self.current[pool]:
                changes[pool] = {
                    "from": self.current[pool],
                    "to": target,
                }
        if not changes:
            return None
        self._seq += 1
        stem = f"fleet-rec-{self._seq:04d}"
        new_counts = dict(self.current)
        for pool, ch in changes.items():
            new_counts[pool] = ch["to"]
        decision = {
            "ts": round(self._wall(), 6),
            "pools": changes,
            "replicas": new_counts,
            "reason": sorted(
                {r for pool in changes for r in reasons.get(pool, [])}
            ),
            "base_manifest": self.base_manifest,
            "artifact": stem + ".yaml",
        }
        patched = patch_manifest_replicas(self._base_text, new_counts)
        header = (
            f"# fleet-recommendation: {json.dumps(decision, sort_keys=True)}\n"
            "# Emitted by tpufw_torch.obs.fleet.ScalingRecommender — verify with\n"
            "#   python -m tpufw.analysis --layer deploy "
            "--manifest <this file>\n"
        )
        yaml_path = os.path.join(self.out_dir, stem + ".yaml")
        json_path = os.path.join(self.out_dir, stem + ".json")
        with open(yaml_path, "w", encoding="utf-8") as f:
            f.write(header + patched)
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(decision, f, indent=2, sort_keys=True)
            f.write("\n")
        for pool, ch in changes.items():
            self.current[pool] = ch["to"]
            self._last_change[pool] = now
        self._events.emit(
            "fleet_recommendation",
            pools=changes,
            reason=decision["reason"],
            artifact=yaml_path,
            replicas=new_counts,
        )
        for fn in tuple(self.listeners):
            try:
                fn(decision)
            except Exception:
                pass
        return decision


# --------------------------------------------------------- collector


class FleetCollector:
    """Scrape every target once per sweep, append per-target records
    + one derived ``fleet`` record, evaluate alerts, feed sustained
    ones to the recommender. A target that dies mid-scrape is stale-
    marked (its record says so; the fleet keeps flying)."""

    def __init__(
        self,
        targets: Sequence[Target],
        store: SeriesStore,
        *,
        events=None,
        registry: Optional[Registry] = None,
        rules: Sequence[Any] = DEFAULT_ALERT_RULES,
        recommender: Optional[ScalingRecommender] = None,
        health_fn: Optional[Callable[[], dict]] = None,
        clock: Callable[[], float] = time.time,
        mono: Callable[[], float] = time.monotonic,
    ):
        # resource: transfers file-handle — the collector owns the
        # store from here on; FleetCollector.stop() closes it.
        self.targets = list(targets)
        self.store = store
        self.events = events if events is not None else obs_events.NULL
        #: The collector's own registry: derived series re-exported as
        #: gauges so the observatory is itself scrapeable.
        self.registry = registry if registry is not None else Registry()
        self.recommender = recommender
        self._health_fn = health_fn
        self._clock = clock
        self._mono = mono
        self._deriver = _Deriver()
        self.alerts = AlertEngine(rules, events=self.events, clock=mono)
        self.busy_s = 0.0
        #: CPU seconds the collector thread itself burned — the honest
        #: overhead-on-serving number. ``busy_s`` (wall) also counts
        #: time blocked on an engine's lock, which steals nothing from
        #: the request path; this doesn't.
        self.busy_cpu_s = 0.0
        self.scrapes = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._c_sweeps = self.registry.counter(
            "tpufw_fleet_scrapes_total", "collector sweeps completed"
        )
        self._c_busy = self.registry.counter(
            "tpufw_fleet_scrape_seconds_total",
            "wall seconds the collector spent scraping + deriving",
        )
        self._c_busy_cpu = self.registry.counter(
            "tpufw_fleet_scrape_cpu_seconds_total",
            "CPU seconds the collector thread spent scraping + "
            "deriving (excludes time blocked on replica locks)",
        )

    def scrape_once(self) -> Dict[str, float]:
        """One sweep. Returns the derived series dict (also appended
        to the store under the ``fleet`` pseudo-replica)."""
        t0 = self._mono()
        t0_cpu = time.thread_time()
        now = self._clock()
        records: List[dict] = []
        direct = set()
        for target in self.targets:
            try:
                raw = target.scrape()
            except Exception:  # noqa: BLE001 — replica died mid-scrape
                records.append(
                    self.store.append(
                        target.name, target.role, {}, ts=now, stale=True
                    )
                )
                direct.add(target.name)
                continue
            if isinstance(raw, str):
                series = promtext.flatten(raw)
            elif isinstance(raw, dict):
                series = series_from_signals(raw)
            else:
                series = {}
            records.append(
                self.store.append(target.name, target.role, series, ts=now)
            )
            direct.add(target.name)
        if self._health_fn is not None:
            try:
                health = self._health_fn()
            except Exception:  # noqa: BLE001 — router gone ≠ collector gone
                health = {}
            for name, detail in (health.get("replicas") or {}).items():
                if name in direct or not isinstance(detail, dict):
                    continue
                records.append(
                    self.store.append(
                        name,
                        str(detail.get("role", "replica")),
                        series_from_signals(detail),
                        ts=now,
                        stale=not detail.get("healthy", False),
                    )
                )
        derived = self._deriver.derive(records)
        self.store.append("fleet", "fleet", derived, ts=now)
        for skey, v in derived.items():
            name, labels = promtext.parse_sample_key(skey)
            self.registry.gauge(name).set(v, **labels)
        firing = self.alerts.evaluate(derived)
        if self.recommender is not None:
            self.recommender.consider(firing)
        self.scrapes += 1
        self._c_sweeps.inc()
        spent = self._mono() - t0
        self.busy_s += spent
        self._c_busy.inc(spent)
        spent_cpu = time.thread_time() - t0_cpu
        self.busy_cpu_s += spent_cpu
        self._c_busy_cpu.inc(spent_cpu)
        return derived

    def run(
        self,
        interval_s: float,
        *,
        stop: Optional[threading.Event] = None,
        max_scrapes: Optional[int] = None,
    ) -> int:
        stop = stop if stop is not None else self._stop
        while not stop.is_set():
            self.scrape_once()
            if max_scrapes is not None and self.scrapes >= max_scrapes:
                break
            stop.wait(interval_s)
        return self.scrapes

    def start(self, interval_s: float) -> "FleetCollector":
        """Run the sweep loop from a daemon thread; ``stop()`` ends
        it. Returns self for one-line attach."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run,
            args=(float(interval_s),),
            kwargs={"stop": self._stop},
            daemon=True,
            name="fleet-collector",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.store.close()


def collector_from_env(
    targets: Sequence[Target],
    *,
    health_fn: Optional[Callable[[], dict]] = None,
    default_dir: str = "",
) -> Optional[FleetCollector]:
    """Build + start a collector from the TPUFW_FLEET_* knobs, or
    return None when TPUFW_FLEET_SCRAPE_S is unset/0 — the disabled
    path creates no files, no threads, and no collector object."""
    scrape_s = env_float("fleet_scrape_s", 0.0)
    if scrape_s <= 0:
        return None
    fleet_dir = env_str("fleet_dir", default_dir or ".")
    os.makedirs(fleet_dir, exist_ok=True)
    store = SeriesStore(
        os.path.join(fleet_dir, SERIES_FILENAME),
        max_records=env_int("fleet_max_records", 4096),
    )
    try:
        events = obs_events.EventLog(
            os.path.join(fleet_dir, EVENTS_FILENAME)
        )
        recommender = None
        manifest = env_str("fleet_manifest", "")
        if manifest and os.path.exists(manifest):
            recommender = ScalingRecommender(
                fleet_dir,
                manifest,
                cooldown_s=env_float("fleet_cooldown_s", 300.0),
                max_replicas=env_int("fleet_max_replicas", 8),
                events=events,
            )
        collector = FleetCollector(
            targets,
            store,
            events=events,
            recommender=recommender,
            health_fn=health_fn,
        )
    except BaseException:
        # Anything between the open and the ownership handoff to the
        # collector raising would strand the series handle (TPU019).
        store.close()
        raise
    return collector.start(scrape_s)


# ----------------------------------------------- retrospective query


def load_alert_history(path: str) -> List[dict]:
    try:
        return [
            e
            for e in obs_events.read_events(path)
            if e.get("kind") in ("fleet_alert", "fleet_recommendation")
        ]
    except OSError:
        return []


def alerts_firing_at(history: Sequence[dict], at: float) -> List[dict]:
    """Replay fleet_alert transitions up to ``at``; return the events
    of instances still firing then."""
    state: Dict[Tuple[str, str], dict] = {}
    for ev in history:
        if ev.get("kind") != "fleet_alert" or ev.get("ts", 0) > at:
            continue
        ikey = (str(ev.get("rule")), str(ev.get("series")))
        if ev.get("state") == "firing":
            state[ikey] = ev
        elif ev.get("state") == "resolved":
            state.pop(ikey, None)
    return list(state.values())


def state_at(
    records: Sequence[dict],
    history: Sequence[dict],
    at: float,
    *,
    horizon_s: float = 600.0,
) -> dict:
    """Reconstruct fleet state at instant ``at``: the latest record
    per replica at or before ``at`` (within ``horizon_s`` — older
    means the replica was already gone), the derived series then, and
    the alerts firing then."""
    latest: Dict[str, dict] = {}
    for rec in records:
        if rec["ts"] <= at and at - rec["ts"] <= horizon_s:
            prev = latest.get(rec["replica"])
            if prev is None or rec["ts"] >= prev["ts"]:
                latest[rec["replica"]] = rec
    derived = latest.pop("fleet", None)
    return {
        "at": at,
        "replicas": {
            name: {
                "ts": rec["ts"],
                "role": rec.get("role", ""),
                "stale": bool(rec.get("stale")),
                "series": rec.get("series", {}),
            }
            for name, rec in sorted(latest.items())
        },
        "derived": (derived or {}).get("series", {}),
        "derived_ts": (derived or {}).get("ts"),
        "alerts_firing": alerts_firing_at(history, at),
    }


def window_stats(
    records: Sequence[dict], start: float, end: float
) -> Dict[str, Dict[str, float]]:
    """min/mean/max/n per derived series over [start, end] — the
    last-window table the digest and the query CLI print."""
    acc: Dict[str, List[float]] = {}
    for rec in records:
        if rec.get("replica") != "fleet":
            continue
        if not (start <= rec["ts"] <= end):
            continue
        for skey, v in rec.get("series", {}).items():
            acc.setdefault(skey, []).append(float(v))
    return {
        skey: {
            "min": min(vals),
            "mean": sum(vals) / len(vals),
            "max": max(vals),
            "n": float(len(vals)),
        }
        for skey, vals in sorted(acc.items())
    }


# --------------------------------------------------------------- CLI


def _cmd_query(args: argparse.Namespace) -> int:
    series_path = os.path.join(args.dir, SERIES_FILENAME)
    records = read_series(series_path)
    if not records:
        print(f"no fleet series at {series_path}")
        return 1
    history = load_alert_history(
        os.path.join(args.dir, EVENTS_FILENAME)
    )
    at = args.at if args.at is not None else records[-1]["ts"]
    out = state_at(records, history, at)
    if args.window:
        out["window_s"] = args.window
        out["window"] = window_stats(records, at - args.window, at)
    if args.json:
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    print(f"== fleet state @ {at:.3f} ==")
    for name, rec in out["replicas"].items():
        mark = " STALE" if rec["stale"] else ""
        print(f"  {name} ({rec['role']}) ts={rec['ts']:.3f}{mark}")
    print("derived:")
    for skey, v in sorted(out["derived"].items()):
        print(f"  {skey} = {promtext.format_value(v)}")
    if out["alerts_firing"]:
        print("alerts firing:")
        for ev in out["alerts_firing"]:
            print(
                f"  {ev.get('rule')} [{ev.get('severity', '?')}] "
                f"{ev.get('series')} = {ev.get('value')}"
            )
    else:
        print("alerts firing: none")
    if args.window:
        print(f"window ({args.window:.0f}s): min / mean / max")
        for skey, st in out["window"].items():
            print(
                f"  {skey}: {st['min']:.4g} / {st['mean']:.4g} / "
                f"{st['max']:.4g}  (n={int(st['n'])})"
            )
    return 0


def _cmd_collect(args: argparse.Namespace) -> int:
    targets: List[Target] = []
    health_fn = None
    if args.router:
        base = args.router.rstrip("/")
        targets.append(
            http_target("router", base + "/metrics", role="router")
        )
        health_fn = http_health_fn(base)
    for spec in args.target or []:
        # role=name=host:port (signals probe) or role=name=http://...
        try:
            role, name, addr = spec.split("=", 2)
        except ValueError:
            print(f"bad --target {spec!r} (role=name=addr)")
            return 2
        if addr.startswith("http://") or addr.startswith("https://"):
            targets.append(http_target(name, addr, role=role))
        else:
            host, _, port = addr.rpartition(":")
            targets.append(
                signals_target(name, host, int(port), role)
            )
    if not targets:
        print("no targets: pass --router and/or --target")
        return 2
    os.makedirs(args.dir, exist_ok=True)
    store = SeriesStore(
        os.path.join(args.dir, SERIES_FILENAME),
        max_records=args.max_records,
    )
    events = None
    # Everything from here to the scrape loop runs under the close
    # guarantee: a raise while wiring the collector must not strand
    # the series handle the store just opened (TPU019).
    try:
        events = obs_events.EventLog(
            os.path.join(args.dir, EVENTS_FILENAME)
        )
        recommender = None
        if args.manifest:
            recommender = ScalingRecommender(
                args.dir,
                args.manifest,
                cooldown_s=args.cooldown_s,
                events=events,
            )
        collector = FleetCollector(
            targets,
            store,
            events=events,
            recommender=recommender,
            health_fn=health_fn,
        )
        stop = threading.Event()
        deadline = (
            time.monotonic() + args.duration if args.duration else None
        )
        try:
            while not stop.is_set():
                collector.scrape_once()
                if (
                    deadline is not None
                    and time.monotonic() >= deadline
                ):
                    break
                stop.wait(args.interval)
        except KeyboardInterrupt:
            pass
    finally:
        store.close()
        if events is not None:
            events.close()
    print(
        json.dumps(
            {
                "scrapes": collector.scrapes,
                "busy_s": round(collector.busy_s, 6),
                "series": store.path,
            }
        )
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpufw_torch.obs.fleet",
        description="fleet observatory: collect / query",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser(
        "query", help="reconstruct fleet state from a series dir"
    )
    q.add_argument("--dir", required=True, help="fleet series dir")
    q.add_argument(
        "--at", type=float, default=None,
        help="unix timestamp to reconstruct (default: latest record)",
    )
    q.add_argument(
        "--window", type=float, default=0.0,
        help="also aggregate derived series over the trailing window",
    )
    q.add_argument("--json", action="store_true")
    c = sub.add_parser("collect", help="run the collector loop")
    c.add_argument("--dir", required=True)
    c.add_argument("--interval", type=float, default=5.0)
    c.add_argument(
        "--router", default="",
        help="router base URL (scrapes /metrics + /healthz)",
    )
    c.add_argument(
        "--target", action="append",
        help="extra target, role=name=host:port (framed-TCP signals) "
        "or role=name=http://... (/metrics)",
    )
    c.add_argument("--duration", type=float, default=0.0)
    c.add_argument("--max-records", type=int, default=4096)
    c.add_argument(
        "--manifest", default="",
        help="base JobSet manifest enabling the scaling recommender",
    )
    c.add_argument("--cooldown-s", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.cmd == "query":
        return _cmd_query(args)
    return _cmd_collect(args)


if __name__ == "__main__":
    raise SystemExit(main())
