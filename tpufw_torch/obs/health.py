"""Run-health primitives: hang watchdog + crash flight recorder (port of
``tpufw.obs.health``).

Two failure modes leave today's telemetry blind: a *wedge* (a
collective waiting on a dead peer, a stuck host callback — the run
stops emitting anything, forever) and an *abnormal exit* (unhandled
exception, SIGTERM past the grace window, segfault) that takes the
evidence down with the process. Both are exactly when the telemetry
dir matters most, so both get dedicated machinery:

``HangWatchdog`` — a daemon thread armed around each step
dispatch/host sync. If no ``arm()``/``beat()``/``disarm()`` arrives
within the timeout, it dumps every Python thread's stack, the
tracer's live span stack, and the flight-recorder ring to
``hang-p{proc}-{n}.json``, emits a ``hang`` event, and (opt-in)
SIGABRTs so a supervisor restarts the pod instead of burning the
reservation. It fires at most once per stall: re-arming re-enables
it, so a healthy-but-slow run that keeps making progress is never
killed.

``FlightRecorder`` — a bounded ring of recent events plus
``sys.excepthook`` / ``faulthandler`` / SIGTERM hooks that flush a
self-contained ``crash-bundle-p{proc}/`` (ring dump, thread stacks,
run config, env-knob snapshot, last metrics render) on abnormal
exit. The SIGTERM hook *flushes and chains*; whether it then
terminates is a policy knob — under a trainer, ``GracefulShutdown``
owns the exit (flush must not pre-empt the grace-window checkpoint),
while a standalone server restores the default disposition and
re-raises so SIGTERM still kills it.

Stdlib only; every hook chains to whatever it replaced and never
raises into the host program.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

# Non-TPUFW env vars worth keeping in a crash bundle: the CUDA, NCCL
# and torch switches that change which device a process drives and how
# its kernels and collectives run, and the per-GPU launcher's ranks.
_ENV_EXTRA = (
    "CUDA_VISIBLE_DEVICES",
    "CUDA_LAUNCH_BLOCKING",
    "PYTORCH_CUDA_ALLOC_CONF",
    "NCCL_DEBUG",
    "TORCH_NCCL_ASYNC_ERROR_HANDLING",
    "LOCAL_RANK",
    "LOCAL_WORLD_SIZE",
)


def format_thread_stacks(tracer=None) -> str:
    """Every Python thread's stack (idents resolved to thread names),
    plus the tracer's open spans — the combined "where is everyone"
    view both the watchdog and the recorder dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    frames = sys._current_frames()
    for tid, frame in sorted(frames.items()):
        lines.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        lines.extend(
            ln.rstrip("\n") for ln in traceback.format_stack(frame)
        )
        lines.append("")
    if tracer is not None:
        live = tracer.live_spans()
        if live:
            lines.append("--- open trace spans (innermost last) ---")
            for tid, stack in sorted(live.items()):
                span_s = ", ".join(
                    f"{name} ({open_s}s)" for name, open_s in stack
                )
                lines.append(
                    f"thread {names.get(tid, '?')} (ident {tid}): {span_s}"
                )
            lines.append("")
    return "\n".join(lines)


def env_snapshot() -> Dict[str, str]:
    """The knobs that shaped this run: every TPUFW_* plus the JAX/XLA
    switches in ``_ENV_EXTRA``."""
    out = {}
    for k, v in os.environ.items():
        if k.startswith("TPUFW_") or k in _ENV_EXTRA:
            out[k] = v
    return out


class HangWatchdog:
    """Arms around each step dispatch/host sync; see module docstring.

    The loop contract: ``arm()`` right before dispatching work that
    must finish within ``timeout_s``; ``beat()`` (== re-arm) on any
    sign of progress inside a long phase; ``disarm()`` when entering
    phases with no progress guarantee (eval, checkpoint drain, the
    forced preemption save). A fire disarms until the next ``arm()``,
    so one stall produces one dump, and recovery re-protects the run.
    """

    enabled = True

    def __init__(
        self,
        timeout_s: float,
        out_dir: str,
        proc: int = 0,
        tracer=None,
        events=None,
        recorder=None,
        abort: bool = False,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.out_dir = out_dir
        self.proc = proc
        self._tracer = tracer
        self._events = events
        self._recorder = recorder
        self._abort = abort
        self._cv = threading.Condition()
        self._deadline: Optional[float] = None  # monotonic; None=disarmed
        self._armed_at: Optional[float] = None
        self._stopped = False
        self.fired = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpufw-watchdog"
        )
        self._thread.start()

    def arm(self) -> None:
        now = time.monotonic()
        with self._cv:
            if self._deadline is None:
                self._armed_at = now
            self._deadline = now + self.timeout_s
            self._cv.notify()

    def beat(self) -> None:
        """Progress heartbeat: pushes the deadline out without
        resetting ``armed_at`` — a slow-but-progressing phase stays
        protected and never trips the alarm."""
        with self._cv:
            if self._deadline is not None:
                self._deadline = time.monotonic() + self.timeout_s
                self._cv.notify()

    def disarm(self) -> None:
        with self._cv:
            self._deadline = None
            self._armed_at = None
            # Wake the watchdog out of its stale timed wait so it
            # parks on the untimed disarmed wait immediately instead
            # of burning one spurious wakeup at the old deadline.
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._deadline = None
            self._cv.notify()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._stopped:
                    return
                if self._deadline is None:
                    self._cv.wait()
                    continue
                now = time.monotonic()
                if now < self._deadline:
                    self._cv.wait(self._deadline - now)
                    continue
                armed_for = now - (self._armed_at or now)
                # One dump per stall: stay disarmed until the loop
                # proves liveness by arming again. This thread is the
                # only waiter on _cv, so the self-disarm notifies nobody.
                self._deadline = None
                self._armed_at = None
                self.fired += 1
                n = self.fired
            self._dump(armed_for, n)

    def _dump(self, armed_for: float, n: int) -> None:
        path = os.path.join(
            self.out_dir, f"hang-p{self.proc}-{n}.json"
        )
        doc = {
            "ts": time.time(),
            "timeout_s": self.timeout_s,
            "armed_for_s": round(armed_for, 3),
            "stacks": format_thread_stacks(self._tracer),
            "live_spans": {
                str(tid): stack
                for tid, stack in (
                    self._tracer.live_spans() if self._tracer else {}
                ).items()
            },
            "recent_events": (
                self._recorder.ring_tail()
                if self._recorder is not None
                else []
            ),
        }
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, default=str)
            os.replace(tmp, path)
        except OSError:
            path = None
        if self._events is not None:
            try:
                self._events.emit(
                    "hang",
                    level="error",
                    timeout_s=self.timeout_s,
                    armed_for_s=round(armed_for, 3),
                    dump=path,
                )
            except Exception:
                pass  # a broken log must not stop the abort below
        if self._abort:
            # SIGABRT, not sys.exit: the wedged main thread is stuck
            # in a collective and will never see an exception; the
            # supervisor's restart is the only way out.
            os.kill(os.getpid(), signal.SIGABRT)


class NullHangWatchdog:
    """Disabled stand-in so loop call sites never branch; the arm/
    disarm pair costs two attribute lookups and a no-op call."""

    enabled = False
    fired = 0

    def arm(self) -> None:
        pass

    def beat(self) -> None:
        pass

    def disarm(self) -> None:
        pass

    def stop(self) -> None:
        pass


NULL_WATCHDOG = NullHangWatchdog()


class FlightRecorder:
    """Bounded ring of recent events + abnormal-exit hooks; flushes a
    self-contained ``crash-bundle-p{proc}/``. See module docstring."""

    def __init__(
        self,
        out_dir: str,
        proc: int = 0,
        ring_size: int = 256,
        registry=None,
        tracer=None,
        terminate_on_sigterm: bool = False,
    ):
        self.out_dir = out_dir
        self.proc = proc
        # deque.append is atomic under the GIL — the ring takes no
        # lock, so feeding it from the event listener (including from
        # inside signal handlers) can't deadlock.
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self.context: Dict[str, object] = {}
        self._registry = registry
        self._tracer = tracer
        self._terminate = terminate_on_sigterm
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._exc_handler = None
        self._sigterm_handler = None
        self._sigterm_installed = False
        self._fault_file = None  # we enabled faulthandler iff not None
        self._installed = False
        self.reasons: List[str] = []
        self._exc_text: Optional[str] = None

    # -- feeds ---------------------------------------------------------

    def on_event(self, event: dict) -> None:
        self.ring.append(event)

    def ring_tail(self, n: Optional[int] = None) -> List[dict]:
        tail = list(self.ring)
        return tail if n is None else tail[-n:]

    def record_config(self, config: Dict[str, object]) -> None:
        """Merge run configuration into the bundle's ``config.json``
        (trainer config, run_info labels, mesh shape...)."""
        self.context.update(config)

    # -- hooks ---------------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        # Capture the bound methods ONCE: each attribute access builds
        # a fresh bound-method object, so uninstall's are-we-still-
        # installed identity checks need these exact objects.
        self._exc_handler = self._on_exception
        self._sigterm_handler = self._on_sigterm
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._exc_handler
        # faulthandler gives the C-level last word (SIGSEGV/SIGBUS
        # kill the interpreter before any Python hook runs). Only
        # take it over when nobody else did (pytest enables its own).
        if not faulthandler.is_enabled():
            try:
                os.makedirs(self.out_dir, exist_ok=True)
                self._fault_file = open(  # noqa: SIM115 — held open
                    os.path.join(self.out_dir, f"fault-p{self.proc}.log"),
                    "w",
                    encoding="utf-8",
                )
                faulthandler.enable(file=self._fault_file)
            except OSError:
                self._fault_file = None
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._sigterm_handler
            )
            self._sigterm_installed = True
        except ValueError:
            # Not the main thread; excepthook/faulthandler still work.
            self._sigterm_installed = False

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if sys.excepthook is self._exc_handler:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._sigterm_installed:
            try:
                if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                    signal.signal(
                        signal.SIGTERM,
                        self._prev_sigterm
                        if self._prev_sigterm is not None
                        else signal.SIG_DFL,
                    )
            except (ValueError, TypeError):
                pass
            self._sigterm_installed = False
        if self._fault_file is not None:
            fault_path = self._fault_file.name
            try:
                faulthandler.disable()
                self._fault_file.close()
                # A clean exit leaves an empty fault log; drop it.
                if os.path.getsize(fault_path) == 0:
                    os.remove(fault_path)
            except OSError:
                pass
            self._fault_file = None

    def _on_exception(self, etype, value, tb) -> None:
        try:
            self._exc_text = "".join(
                traceback.format_exception(etype, value, tb)
            )
            self.flush("exception")
        except Exception:
            pass  # the original traceback must still print below
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, value, tb)

    def _on_sigterm(self, signum, frame) -> None:
        try:
            self.flush("sigterm")
        except Exception:
            pass  # termination semantics below matter more
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif self._terminate:
            # Standalone process (no GracefulShutdown above us):
            # restore the default disposition and re-raise so SIGTERM
            # still terminates — the recorder observes, never saves.
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
            os.kill(os.getpid(), signal.SIGTERM)

    # -- the bundle ----------------------------------------------------

    def bundle_dir(self) -> str:
        return os.path.join(self.out_dir, f"crash-bundle-p{self.proc}")

    def flush(self, reason: str) -> Optional[str]:
        """Write (or rewrite, on a second trigger) the crash bundle.
        The manifest goes last via rename, so a bundle with a
        parseable manifest is complete. Returns the bundle dir, or
        None if even mkdir failed (disk gone — nothing to do)."""
        bundle = self.bundle_dir()
        try:
            os.makedirs(bundle, exist_ok=True)
        except OSError:
            return None
        self.reasons.append(reason)
        files = []

        def _write(name: str, text: str) -> None:
            try:
                with open(
                    os.path.join(bundle, name), "w", encoding="utf-8"
                ) as f:
                    f.write(text)
                files.append(name)
            except OSError:
                pass

        _write(
            "ring.jsonl",
            "\n".join(
                json.dumps(ev, sort_keys=True, default=str)
                for ev in self.ring_tail()
            )
            + "\n",
        )
        _write("stacks.txt", format_thread_stacks(self._tracer))
        _write(
            "config.json",
            json.dumps(self.context, indent=2, sort_keys=True, default=str),
        )
        _write(
            "env.json",
            json.dumps(env_snapshot(), indent=2, sort_keys=True),
        )
        if self._registry is not None:
            try:
                _write("metrics.prom", self._registry.render())
            except Exception:
                pass
        if self._exc_text:
            _write("exception.txt", self._exc_text)
        manifest = {
            "ts": time.time(),
            "pid": os.getpid(),
            "process": self.proc,
            "reasons": list(self.reasons),
            "files": files,
        }
        try:
            tmp = os.path.join(bundle, "manifest.json.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            os.replace(tmp, os.path.join(bundle, "manifest.json"))
        except OSError:
            return None
        return bundle
