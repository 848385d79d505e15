"""SIGTERM -> forced checkpoint -> clean exit (port of
``tpufw.train.preemption``).

Kubernetes ends a pod with SIGTERM and a grace window before SIGKILL; the
trainer turns that window into a checkpoint of the current step, so the
restarted run resumes there and not at the last periodic save.

The stop decision is the gang's: with a ``torch.distributed`` process
group initialized, ``should_stop`` is ``any`` of every rank's flag (an
all-reduce MAX of an int32 on the rank's device, CUDA under NCCL), so the
ranks leave the loop at one step even when only one was signalled.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class GracefulShutdown:
    """Latches termination signals into a per-step stop decision.

    Usage::

        shutdown = GracefulShutdown()          # installs the SIGTERM handler
        for step, batch in enumerate(data):
            train(batch)
            if shutdown.should_stop():
                ckpt.save(step, state, force=True)
                break

    Handlers chain: a handler installed before still runs after the flag
    is set. Off the main thread, where CPython forbids ``signal.signal``,
    nothing is installed and ``request()`` is the only trigger.
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,), sync_every: int = 1,
                 events=None):
        self._flag = threading.Event()
        # An obs event log (or None): the signal itself is logged, so the
        # gap between SIGTERM and the gang's agreed stop step shows.
        self.events = events
        self._prev: dict = {}
        self._signals = tuple(signals)
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self._sync_every = sync_every
        self._calls = 0
        self._stop_latched = False
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:
                self._prev.pop(sig, None)

    def _handle(self, signum, frame):
        self._flag.set()
        if self.events is not None:
            try:
                self.events.emit(
                    "preemption_signal", level="warn", signum=int(signum)
                )
            except Exception:  # noqa: BLE001 — never die in a handler
                pass
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def request(self) -> None:
        """Set the stop flag as the signal does."""
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def should_stop(self) -> bool:
        """True once any rank's flag is seen at a sync call; stays True.
        Only every ``sync_every``-th call reads the flags (a collective
        under a process group: every rank must call this the same number
        of times, once a step); the others return the last decision."""
        if self._stop_latched:
            return True
        self._calls += 1
        if (self._calls - 1) % self._sync_every:
            return False
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            self._stop_latched = self._flag.is_set()
            return self._stop_latched
        import torch

        from tpufw_torch.train.sharding import gang_device

        flag = torch.tensor([int(self._flag.is_set())], dtype=torch.int32,
                            device=gang_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        self._stop_latched = bool(flag.item())
        return self._stop_latched

    def uninstall(self) -> None:
        """Put the previous handlers back (a handler installed from C,
        which Python reports as None, cannot be; ours stays, inert)."""
        for sig, prev in self._prev.items():
            if prev is None:
                continue
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()

    def __enter__(self) -> "GracefulShutdown":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.uninstall()
        return None


def owned_shutdown(
    shutdown: Optional[GracefulShutdown], enabled: bool, sync_every: int,
    events=None,
) -> tuple[Optional[GracefulShutdown], bool]:
    """A ``GracefulShutdown`` made here when the caller passed none and
    the config enables handling: (shutdown, owns). The owner must
    ``uninstall()`` it in the run loop's ``finally``."""
    if shutdown is not None or not enabled:
        return shutdown, False
    return GracefulShutdown(sync_every=sync_every, events=events), True


def checkpoint_stop(
    shutdown: Optional[GracefulShutdown], ckpt, step: int, state,
    watchdog=None,
) -> bool:
    """The per-step stop block of the train loop: on stop, a forced
    checkpoint of ``step`` (when there is a manager; ``state`` may be a
    callable that makes it). True when the loop should break.
    ``watchdog`` (an obs ``HangWatchdog``) is disarmed before the forced
    save: it races the SIGKILL grace window with no bounded duration,
    so it must not read as a hang."""
    if shutdown is None or not shutdown.should_stop():
        return False
    if watchdog is not None:
        watchdog.disarm()
    if ckpt is not None:
        ckpt.save(step, state, force=True)
    return True
