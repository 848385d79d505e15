"""Structured JSONL event log — the machine-readable replacement for
the trainer stack's ad-hoc ``print`` telemetry (a copy of
``tpufw.obs.events``; the port's serving roles and router emit it).

One file per host (``events.jsonl`` on process 0, ``events-p<N>.jsonl``
elsewhere — hosts share nothing, so per-host files need no cross-host
locking), one JSON object per line, every line carrying ``ts`` (unix
seconds), ``kind``, ``level``, ``host``, and ``process``. Kinds are
schema'd: ``emit`` raises on an unknown kind or a missing required
field, so producer drift is caught by the tests instead of by a
grep-shaped dashboard breaking three weeks later. Extra fields beyond
the required set are allowed — schemas here are a floor, not a ceiling.

Stdlib only; importable from signal handlers (``preemption.py`` emits
from its SIGTERM latch) and from bare CI containers.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Dict, FrozenSet, List, Optional

LEVELS = ("debug", "info", "warn", "error")

# kind -> required fields (beyond the envelope ts/kind/level/host/
# process added by emit). Floor, not ceiling.
SCHEMA: Dict[str, FrozenSet[str]] = {
    "run_start": frozenset({"workload"}),
    "run_end": frozenset({"steps"}),
    "step": frozenset({"step", "loss", "step_time_s", "data_wait_s"}),
    "eval": frozenset({"step"}),
    "checkpoint_save": frozenset({"step"}),
    "checkpoint_restore": frozenset({"step"}),
    "preemption_signal": frozenset({"signum"}),
    "preemption_stop": frozenset({"step"}),
    "tune_trial": frozenset({"trial", "status"}),
    "tune_result": frozenset({"mode", "cache_hit"}),
    "compile_cache": frozenset({"dir", "warm"}),
    "straggler_detected": frozenset(
        {"step", "straggler_hosts", "median_s", "factor"}
    ),
    "serve_request": frozenset({"rows", "new_tokens", "latency_s"}),
    "serve_pool_switch": frozenset({"cache_len", "slots"}),
    "serve_prefix": frozenset({"hit", "shared_pages", "prompt_tokens"}),
    "serve_migration": frozenset({"pages", "bytes", "wall_s"}),
    "serve_spec": frozenset({"k", "mode"}),
    "serve_prefill_chunk": frozenset(
        {"prompt_tokens", "cursor", "final"}
    ),
    # KV fabric (tpufw.infer.spill + tpufw.serve.bundle.attach_spill):
    # one record per movement across the HBM/host-RAM boundary.
    # ``entry`` is "trie" (one prefix page) or "session" (a drained
    # slot's bundle); ``direction`` is "out" (spill) or "in" (restore).
    # Page/byte/wall fields ride along where the mover knows them.
    "serve_spill": frozenset({"entry", "direction"}),
    "router_request": frozenset({"tenant", "replica", "latency_s"}),
    "router_reject": frozenset({"tenant", "reason"}),
    # A drained replica's sticky session resumed on a survivor from
    # the shared spill store (zero-divergence re-home).
    "router_rehome": frozenset({"session", "replica"}),
    "slo_violation": frozenset(
        {"tenant", "metric", "value_ms", "target_ms"}
    ),
    "goodput": frozenset({"wall_s", "goodput_ratio"}),
    "hang": frozenset({"timeout_s", "armed_for_s"}),
    # Fleet observatory (tpufw.obs.fleet): alert-rule transitions and
    # the scaling decisions sustained alerts turn into.
    "fleet_alert": frozenset({"rule", "state", "series", "value"}),
    "fleet_recommendation": frozenset({"pools", "reason", "artifact"}),
    # Load observatory (tpufw.load): executor action applying a
    # scaling decision (add/remove/skipped/recovered/error), and a
    # sweep/smoke phase boundary (rung-N, burst, idle, done).
    "scale_action": frozenset({"pool", "action", "replica"}),
    "load_phase": frozenset({"phase"}),
}


def validate(event: dict) -> None:
    """Raise ValueError unless ``event`` is a well-formed logged line
    (envelope + per-kind required fields). Used by emit on the way
    out and by tests/readers on the way in."""
    for field in ("ts", "kind", "level", "host", "process"):
        if field not in event:
            raise ValueError(f"event missing envelope field {field!r}")
    kind = event["kind"]
    if kind not in SCHEMA:
        raise ValueError(f"unknown event kind {kind!r}")
    if event["level"] not in LEVELS:
        raise ValueError(f"unknown event level {event['level']!r}")
    missing = SCHEMA[kind] - event.keys()
    if missing:
        raise ValueError(
            f"event kind {kind!r} missing fields {sorted(missing)}"
        )


def log_path(telemetry_dir: str, process: int = 0) -> str:
    name = "events.jsonl" if process == 0 else f"events-p{process}.jsonl"
    return os.path.join(telemetry_dir, name)


class EventLog:
    """Append-only JSONL writer. Thread-safe; lines are flushed per
    emit so a preempted host's last events survive the SIGKILL that
    follows the grace window."""

    def __init__(
        self,
        path: str,
        host: int = 0,
        process: int = 0,
        min_level: str = "info",
    ):
        if min_level not in LEVELS:
            raise ValueError(f"unknown level {min_level!r}")
        self.path = path
        self.host = host
        self.process = process
        self._min = LEVELS.index(min_level)
        # Observers called with the full event dict after each write
        # (goodput ledger, flight-recorder ring). List mutation is
        # wiring-time only; iteration takes a snapshot so a listener
        # can never see a half-registered peer.
        self.listeners: List = []
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: Optional[io.TextIOWrapper] = open(  # noqa: SIM115
            path, "a", encoding="utf-8"
        )

    def emit(self, kind: str, level: str = "info", **fields) -> None:
        if LEVELS.index(level) < self._min:
            return
        event = {
            "ts": round(time.time(), 6),
            "kind": kind,
            "level": level,
            "host": self.host,
            "process": self.process,
            **fields,
        }
        validate(event)
        line = json.dumps(event, sort_keys=True, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()
        # Outside the write lock: listeners may be invoked from signal
        # handlers (preemption_signal) and must not be able to deadlock
        # the log; they take their own (reentrant) locks.
        for fn in tuple(self.listeners):
            try:
                fn(event)
            except Exception:
                pass  # observability must never take down the run

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullEventLog:
    """Disabled-telemetry stand-in: emit is a constant-time no-op so
    call sites never branch."""

    path = None

    def emit(self, kind: str, level: str = "info", **fields) -> None:
        pass

    def close(self) -> None:
        pass


NULL = NullEventLog()


def read_events(path: str) -> List[dict]:
    """Parse an events JSONL file back into dicts (blank lines
    skipped). Does not validate — readers digesting partial logs
    (e.g. scripts/obs_summary.py mid-run) shouldn't crash on a
    truncated final line; they get whatever parses."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line on an unclean shutdown
    return out
