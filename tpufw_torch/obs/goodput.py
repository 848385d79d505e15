"""Goodput/badput ledger: every second of run wall-clock attributed
to exactly one category (a copy of ``tpufw.obs.goodput``).

At pod scale the dominant losses are not slow steps but *non-step
time* — compile, restart replay, checkpoint stalls, data starvation —
so the first question after any run is "what fraction of wall-clock
was productive training?". The ledger answers it by riding the
telemetry the loop already produces: Tracer span completions map to
categories through a per-workload table (``TRAIN_SPAN_CATEGORIES`` /
``SERVE_SPAN_CATEGORIES``), EventLog events drive replay detection,
and explicit ``add()`` covers phases with no span (the serve
scheduler's busy/wasted-slot split). Whatever is not attributed is
``idle`` by construction, so the categories always sum to the run's
wall-clock exactly.

Replay: after a non-graceful restart the trainer re-trains steps it
already paid for (everything past the last checkpoint). The ledger
scans the previous run's events (the JSONL file is opened append-mode,
so a restart into the same telemetry dir sees its predecessor's
``step`` events) for the max step reached; if this run resumes from a
checkpoint *behind* that high-water mark, productive time is booked
as ``replay`` until the run passes it. A graceful preemption
(checkpoint at the stop step) replays nothing.

Exposed three ways: ``tpufw_goodput_ratio`` gauge +
``tpufw_badput_seconds_total{category=...}`` counter on the shared
registry, a ``goodput`` event at close, and a per-run
``goodput.json`` rollup in the telemetry dir.

Stdlib only; all methods are safe to call from span/event listeners,
including listeners invoked inside signal handlers (the lock is
reentrant for that reason — a SIGTERM can land while the victim
thread holds it via a span completion).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, Mapping, Optional

# Trainer-loop spans -> ledger categories. The trainer's spans do not
# nest (each loop phase closes before the next opens), so summing
# their durations never double-counts. ``checkpoint_wait`` /
# ``checkpoint_restore`` come from CheckpointManager itself (the
# async-save drain and the resume restore are not wrapped by the
# loop's own ``checkpoint`` span).
TRAIN_SPAN_CATEGORIES: Dict[str, str] = {
    "tune": "compile",
    "data_fetch": "data_wait",
    "step_dispatch": "productive",
    "host_sync": "productive",
    "eval": "eval",
    "checkpoint": "checkpoint",
    "checkpoint_wait": "checkpoint",
    "checkpoint_restore": "checkpoint",
    "preemption_sync": "preemption",
}

# Serve spans -> categories. ``serve_admit`` is deliberately ABSENT:
# it nests ``serve_prefill`` inside itself, so counting both would
# double-book the prefill seconds. ``serve_decode_chunk`` is also
# absent — the scheduler splits each chunk into busy/wasted_slot
# explicitly via ``add()`` using the live-token fraction, which a
# name->category table cannot express.
SERVE_SPAN_CATEGORIES: Dict[str, str] = {
    "serve_pool_build": "compile",
    "serve_prefill": "busy",
}

# Categories counted as goodput (numerator of tpufw_goodput_ratio).
TRAIN_PRODUCTIVE = ("productive",)
SERVE_PRODUCTIVE = ("busy",)


def rollup_path(telemetry_dir: str, process: int = 0) -> str:
    name = "goodput.json" if process == 0 else f"goodput-p{process}.json"
    return os.path.join(telemetry_dir, name)


def _prior_max_step(events_path: Optional[str]) -> int:
    """High-water ``step`` from a previous run's events in the same
    file (append-mode survivors). 0 when there is no history."""
    if not events_path or not os.path.exists(events_path):
        return 0
    from tpufw_torch.obs.events import read_events

    best = 0
    try:
        for ev in read_events(events_path):
            if ev.get("kind") == "step":
                try:
                    best = max(best, int(ev.get("step", 0)))
                except (TypeError, ValueError):
                    continue
    except OSError:
        return 0
    return best


class GoodputLedger:
    """Attributes run wall-clock to exclusive categories; see module
    docstring. One instance per process, owned by ``Telemetry``."""

    def __init__(
        self,
        registry=None,
        events=None,
        span_categories: Optional[Mapping[str, str]] = None,
        productive: Iterable[str] = TRAIN_PRODUCTIVE,
        out_path: Optional[str] = None,
        prior_events_path: Optional[str] = None,
    ):
        self._registry = registry
        self._events = events
        self._span_cats = dict(
            TRAIN_SPAN_CATEGORIES if span_categories is None
            else span_categories
        )
        self._productive = frozenset(productive)
        self._out_path = out_path
        # RLock: listeners run inside EventLog.emit, and emit can
        # happen from a signal handler that interrupted a thread
        # already inside the ledger (span completion). A plain Lock
        # would deadlock that thread against itself.
        self._lock = threading.RLock()
        self._t0 = time.monotonic()
        self._wall0 = time.time()
        self._seconds: Dict[str, float] = {}
        self._published: Dict[str, float] = {}
        self._closed = False
        # Replay detection state (module docstring): armed by the
        # run_start event only when this run resumes mid-history.
        self._prior_max = _prior_max_step(prior_events_path)
        self._replay_until = 0
        self._last_step = 0

    # -- attribution ---------------------------------------------------

    def add(self, category: str, seconds: float) -> None:
        """Book ``seconds`` of wall-clock to ``category``. The direct
        entry point for phases with no span (serve chunk splits)."""
        if seconds <= 0:
            return
        with self._lock:
            if self._closed:
                return
            self._seconds[category] = (
                self._seconds.get(category, 0.0) + seconds
            )

    def on_span(self, name: str, dur_s: float, args=None) -> None:
        """Tracer listener: span completion -> category."""
        cat = self._span_cats.get(name)
        if cat is None:
            return
        if cat in self._productive and self._last_step < self._replay_until:
            # Still re-training steps a previous incarnation already
            # paid for: productive only in the thermodynamic sense.
            cat = "replay"
        self.add(cat, dur_s)

    def on_event(self, event: dict) -> None:
        """EventLog listener: step progress + replay arming."""
        kind = event.get("kind")
        if kind == "step":
            try:
                step = int(event.get("step", 0))
            except (TypeError, ValueError):
                return
            with self._lock:
                self._last_step = max(self._last_step, step)
        elif kind == "run_start":
            try:
                start = int(event.get("start_step", 0) or 0)
            except (TypeError, ValueError):
                start = 0
            with self._lock:
                # start_step == 0 is a fresh run reusing the dir, not
                # a restart — its steps are first-time work even if
                # an older run got further.
                if start > 0 and self._prior_max > start:
                    self._replay_until = self._prior_max
                self._last_step = max(self._last_step, start)

    # -- reporting -----------------------------------------------------

    def rollup(self) -> dict:
        """Point-in-time rollup; ``idle`` absorbs the unattributed
        remainder so categories sum to ``wall_s`` exactly (unless
        attribution overlapped, in which case idle floors at 0)."""
        with self._lock:
            wall = time.monotonic() - self._t0
            cats = dict(self._seconds)
        attributed = sum(cats.values())
        cats["idle"] = max(0.0, wall - attributed)
        good = sum(v for k, v in cats.items() if k in self._productive)
        return {
            "wall_s": round(wall, 6),
            "start_ts": round(self._wall0, 6),
            "goodput_ratio": round(good / wall, 6) if wall > 0 else 0.0,
            "categories": {k: round(v, 6) for k, v in sorted(cats.items())},
            "replay_until_step": self._replay_until,
            "last_step": self._last_step,
        }

    def publish(self) -> dict:
        """Push the current rollup into the registry. Counters only
        move forward, so each category's *delta* since the last
        publish is inc'd (idle can shrink retroactively when a long
        span closes; that delta clamps at 0 and catches up later).
        Returns the rollup it published."""
        roll = self.rollup()
        if self._registry is not None:
            self._registry.gauge(
                "tpufw_goodput_ratio",
                "fraction of run wall-clock spent in productive work",
            ).set(roll["goodput_ratio"])
            badput = self._registry.counter(
                "tpufw_badput_seconds_total",
                "wall-clock seconds lost to non-productive categories",
            )
            with self._lock:
                for cat, secs in roll["categories"].items():
                    if cat in self._productive:
                        continue
                    delta = secs - self._published.get(cat, 0.0)
                    if delta > 0:
                        badput.inc(delta, category=cat)
                        self._published[cat] = secs
        return roll

    def close(self, extra: Optional[dict] = None) -> dict:
        """Final publish + ``goodput`` event + ``goodput.json``.
        Idempotent; returns the final rollup. ``extra`` (e.g. the perf
        observatory's end-of-run MFU attribution) is merged into both
        the event and the JSON rollup — utilization next to the
        goodput ratio is the one-line answer to "was the run slow
        because of badput or because of the program"."""
        with self._lock:
            if self._closed:
                return self.rollup()
        roll = self.publish()
        if extra:
            roll.update(extra)
        with self._lock:
            self._closed = True
        if self._events is not None:
            try:
                self._events.emit(
                    "goodput",
                    wall_s=roll["wall_s"],
                    goodput_ratio=roll["goodput_ratio"],
                    categories=roll["categories"],
                    **(extra or {}),
                )
            except Exception:
                pass  # closing telemetry must not mask the run's exit
        if self._out_path:
            try:
                os.makedirs(
                    os.path.dirname(self._out_path) or ".", exist_ok=True
                )
                tmp = self._out_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(roll, f, indent=2, sort_keys=True)
                os.replace(tmp, self._out_path)
            except OSError:
                pass
        return roll


class NullGoodputLedger:
    """Disabled stand-in: every method a constant-time no-op so the
    instrumented call sites never branch."""

    def add(self, category: str, seconds: float) -> None:
        pass

    def on_span(self, name: str, dur_s: float, args=None) -> None:
        pass

    def on_event(self, event: dict) -> None:
        pass

    def rollup(self) -> dict:
        return {}

    def publish(self) -> dict:
        return {}

    def close(self, extra=None) -> dict:
        return {}


NULL = NullGoodputLedger()
