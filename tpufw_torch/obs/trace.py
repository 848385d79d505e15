"""Span tracing with Chrome trace-event JSON export (a copy of
``tpufw.obs.trace``).

Context-manager spans around the trainer's phases (data-fetch,
step-dispatch, host-sync, checkpoint, tune-candidate) collected
in-memory and dumped as Chrome trace-event JSON (the ``traceEvents``
``"ph": "X"`` complete-event form) on close — drag the file into
https://ui.perfetto.dev or chrome://tracing and the step loop reads
like a flame chart. This is the microscope for WHERE a window's time
went; ``torch.profiler`` stays the microscope for what the device did
inside the step.

Disabled tracing must be free enough to leave the instrumentation
in the loop unconditionally: ``NullTracer.span`` returns one shared
no-op context manager — no allocation, no clock read (the <1%
per-step overhead budget is asserted in ``tpufw``'s tests/test_obs.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional


class _Span:
    """Reusable-shape span context manager; one allocation per enter
    (cheap relative to the phases traced, which are >=100us)."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._tracer._push(self.name)
        return self

    def __exit__(self, *exc):
        self._tracer._pop(self.name)
        self._tracer._record(self.name, self._t0, time.perf_counter(), self.args)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects complete events; ``close()`` writes Perfetto-loadable
    JSON. Timestamps are microseconds on the process-local
    ``perf_counter`` clock (Chrome trace epochs are arbitrary); the
    wall-clock anchor is recorded in ``otherData`` for cross-host
    alignment."""

    def __init__(
        self,
        path: str,
        pid: int = 0,
        process_name: str = "",
        max_events: Optional[int] = None,
    ):
        self.path = path
        self.pid = pid
        self._name = process_name
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._closed = False
        # Long-running processes (the serving scheduler) trace hot
        # per-chunk spans forever: cap the buffer so memory stays
        # bounded — the trace keeps the RUN'S HEAD (startup + first
        # traffic, where compile stalls and admission bugs live) and
        # counts what it dropped.
        self._max = max_events
        self._dropped = 0
        # Observers called (name, dur_s, args) after each complete
        # span — the goodput ledger rides these instead of re-timing
        # the loop. Wiring-time mutation only.
        self.listeners: List = []
        # Open spans per thread, for the hang watchdog's "where was
        # the run wedged" dump. perf_counter start kept so the dump
        # can say how long each frame has been open.
        self._live: dict = {}

    enabled = True

    def _ts(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def _push(self, name: str) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._live.setdefault(tid, []).append((name, time.perf_counter()))

    def _pop(self, name: str) -> None:
        tid = threading.get_ident()
        with self._lock:
            stack = self._live.get(tid)
            if stack and stack[-1][0] == name:
                stack.pop()
            if not stack:
                self._live.pop(tid, None)

    def live_spans(self) -> dict:
        """Snapshot of currently-open spans: thread ident ->
        [(name, open_for_s), ...] innermost last. The watchdog dumps
        this so a hang report names the wedged phase, not just the
        wedged line."""
        now = time.perf_counter()
        with self._lock:
            return {
                tid: [(name, round(now - t0, 3)) for name, t0 in stack]
                for tid, stack in self._live.items()
            }

    def _record(
        self, name: str, t0: float, t1: float, args: Optional[dict]
    ) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._ts(t0),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": self.pid,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if self._closed:
                return
            if self._max is not None and len(self._events) >= self._max:
                self._dropped += 1
            else:
                self._events.append(ev)
        # Listeners fire even past the buffer cap (ledger accounting
        # must not stop when the trace fills) and outside the lock.
        for fn in tuple(self.listeners):
            try:
                fn(name, t1 - t0, args)
            except Exception:
                pass  # observability must never take down the run

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def complete(self, name: str, dur_s: float, **args) -> None:
        """Record a span that just ENDED, ``dur_s`` long — for phases
        whose duration is measured elsewhere (e.g. ``timed_batches``
        already times the data wait; re-timing it would double-count
        the clock reads)."""
        t1 = time.perf_counter()
        self._record(name, t1 - dur_s, t1, args or None)

    def instant(self, name: str, **args) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "p",
            "ts": self._ts(time.perf_counter()),
            "pid": self.pid,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if self._closed:
                return
            if self._max is not None and len(self._events) >= self._max:
                self._dropped += 1
                return
            self._events.append(ev)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            events = self._events
        if self._name:
            events = [
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self.pid,
                    "args": {"name": self._name},
                }
            ] + events
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_epoch_s": self._wall0,
                "dropped_events": self._dropped,
            },
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullTracer:
    """Disabled stand-in. ``span`` hands back one shared no-op context
    manager — the hot-loop cost of leaving spans in place is two
    attribute lookups and a call."""

    path = None
    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name: str, dur_s: float, **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def live_spans(self) -> dict:
        return {}

    def close(self) -> None:
        pass


NULL = NullTracer()
