"""Unified telemetry (port of ``tpufw.obs``): metrics registry + event
log + span tracing + skew monitoring + run health + program costs
behind one handle.

- :mod:`tpufw_torch.obs.registry` — thread-safe counters/gauges/
  histograms, Prometheus text exposition, stdlib HTTP endpoint
  (``TPUFW_METRICS_PORT`` for trainers; ``serve.py``'s ``/metrics``
  renders the same registry).
- :mod:`tpufw_torch.obs.events` — schema'd JSONL event log, per process.
- :mod:`tpufw_torch.obs.trace` — context-manager spans, Chrome
  trace-event JSON (Perfetto-loadable).
- :mod:`tpufw_torch.obs.skew` — per-rank window gauges + straggler
  events, piggybacked on the sync window.
- :mod:`tpufw_torch.obs.goodput`, :mod:`tpufw_torch.obs.health` — the
  goodput ledger, the hang watchdog and the crash flight recorder.
- :mod:`tpufw_torch.obs.perf`, :mod:`tpufw_torch.obs.roofline` —
  counted step costs, MFU and roofline gauges, the on-demand profiler.
- :mod:`tpufw_torch.obs.reqtrace`, :mod:`tpufw_torch.obs.slo`,
  :mod:`tpufw_torch.obs.promtext` — the router's request traces and SLO
  tracker, the exposition parser.

``Telemetry.create(...)`` wires them from TrainerConfig /
``TPUFW_TELEMETRY_DIR`` / ``TPUFW_METRICS_PORT``; ``Telemetry.disabled()``
hands back one shared object of null components cheap enough to leave
the instrumentation in the hot loop unconditionally. The file names,
event kinds and ``tpufw_*`` series are ``tpufw``'s, so a scrape or
``scripts/obs_summary.py`` reads either package's output. This package
imports no torch at import time (the router, which has none, uses it).
The fleet observatory (``tpufw.obs.fleet``) is ROADMAP.md item 13b.
"""

from __future__ import annotations

import os
from typing import Optional

from tpufw_torch.obs import events as events_mod
from tpufw_torch.obs import goodput as goodput_mod
from tpufw_torch.obs import perf as perf_mod
from tpufw_torch.obs import trace as trace_mod
from tpufw_torch.obs.health import (
    NULL_WATCHDOG,
    FlightRecorder,
    HangWatchdog,
)
from tpufw_torch.obs.registry import (  # noqa: F401
    CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    Registry,
    start_http_server,
)
from tpufw_torch.obs.skew import SkewMonitor

__all__ = [
    "FlightRecorder",
    "HangWatchdog",
    "Registry",
    "SkewMonitor",
    "Telemetry",
    "start_http_server",
]


def _gang_ids():
    """(global rank, world size) of the ``torch.distributed`` group
    when one is up; (0, 1) otherwise (torch is imported only when it
    already is: a process without a group has none to ask)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 — a group torn down mid-query
        pass
    return 0, 1


class Telemetry:
    """One handle bundling registry/events/tracer/skew. Components
    degrade independently: a metrics port without a telemetry dir
    serves scrapes but writes no files, and vice versa."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        events=None,
        tracer=None,
        skew: Optional[SkewMonitor] = None,
        server=None,
        out_dir: Optional[str] = None,
        goodput=None,
        watchdog=None,
        recorder: Optional[FlightRecorder] = None,
        perf=None,
        profiler=None,
        proc: int = 0,
    ):
        self.registry = registry
        self.events = events if events is not None else events_mod.NULL
        self.tracer = tracer if tracer is not None else trace_mod.NULL
        self.skew = skew
        self.server = server
        self.out_dir = out_dir
        self.goodput = goodput if goodput is not None else goodput_mod.NULL
        self.watchdog = watchdog if watchdog is not None else NULL_WATCHDOG
        self.recorder = recorder
        self.perf = perf if perf is not None else perf_mod.NULL
        self.profiler = profiler
        # The rank whose files these are (``-p<N>`` names above 0).
        self.proc = proc
        self._closed = False

    @property
    def enabled(self) -> bool:
        return self.registry is not None

    @property
    def bound_port(self) -> Optional[int]:
        """Actual metrics port (resolves port 0 to the ephemeral bind)."""
        return None if self.server is None else self.server.server_address[1]

    @staticmethod
    def disabled() -> "Telemetry":
        return _NULL

    @staticmethod
    def create(
        telemetry_dir: Optional[str] = None,
        metrics_port: Optional[int] = None,
        straggler_factor: float = 2.0,
        role: str = "train",
        gather=None,
        registry: Optional[Registry] = None,
        trace_name: Optional[str] = None,
        trace_max_events: Optional[int] = None,
        device=None,
    ) -> "Telemetry":
        """Build telemetry from config knobs. All-None knobs return
        the shared disabled singleton. ``metrics_port=0`` binds an
        ephemeral port (tests); None means no server. A gang's ranks on
        one host would collide on a fixed port, so rank r binds
        ``metrics_port + LOCAL_RANK``. ``role`` prefixes the
        trace/process naming, selects the span->goodput-category
        table, and decides whether the flight recorder's SIGTERM hook
        terminates (serve: yes — nothing above it handles the signal;
        train: no — GracefulShutdown owns the grace-window exit). Pass
        ``registry`` to mount the telemetry on an existing registry
        (serve's ``/metrics`` renders its own); ``trace_name``/
        ``trace_max_events`` override the per-process defaults;
        ``device`` is the one the perf observatory's peaks and memory
        readings describe (default: the current CUDA device).

        The run-health layer rides along when a telemetry dir is
        given: a goodput ledger (always), a flight recorder
        (``TPUFW_CRASH_BUNDLE``, default on), a hang watchdog
        (``TPUFW_HANG_TIMEOUT_S`` > 0) and the perf observatory
        (``TPUFW_PERF_OBS``, default on)."""
        if telemetry_dir is None and metrics_port is None:
            return _NULL
        from tpufw_torch.workloads.env import (
            env_bool,
            env_float,
            env_int,
        )

        proc, nprocs = _gang_ids()
        if registry is None:
            registry = Registry()
        events = events_mod.NULL
        tracer = trace_mod.NULL
        ledger = None
        watchdog = None
        recorder = None
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            events_path = events_mod.log_path(telemetry_dir, proc)
            # Ledger first, so it reads the PREVIOUS run's step
            # high-water mark out of the append-mode events file
            # (replay detection) before this run writes anything.
            serve = role == "serve"
            ledger = goodput_mod.GoodputLedger(
                registry=registry,
                span_categories=(
                    goodput_mod.SERVE_SPAN_CATEGORIES
                    if serve
                    else goodput_mod.TRAIN_SPAN_CATEGORIES
                ),
                productive=(
                    goodput_mod.SERVE_PRODUCTIVE
                    if serve
                    else goodput_mod.TRAIN_PRODUCTIVE
                ),
                out_path=goodput_mod.rollup_path(telemetry_dir, proc),
                prior_events_path=events_path,
            )
            events = events_mod.EventLog(
                events_path, host=proc, process=proc
            )
            ledger._events = events
            if trace_name is None:
                trace_name = (
                    "trace.json" if proc == 0 else f"trace-p{proc}.json"
                )
            tracer = trace_mod.Tracer(
                os.path.join(telemetry_dir, trace_name),
                pid=proc,
                process_name=f"{role}:p{proc}/{nprocs}",
                max_events=trace_max_events,
            )
            tracer.listeners.append(ledger.on_span)
            events.listeners.append(ledger.on_event)
            if env_bool("crash_bundle", True):
                recorder = FlightRecorder(
                    telemetry_dir,
                    proc=proc,
                    ring_size=max(1, env_int("flight_ring", 256)),
                    registry=registry,
                    tracer=tracer,
                    terminate_on_sigterm=serve,
                )
                events.listeners.append(recorder.on_event)
                recorder.install()
            hang_timeout = env_float("hang_timeout_s", 0.0)
            if hang_timeout > 0:
                watchdog = HangWatchdog(
                    hang_timeout,
                    telemetry_dir,
                    proc=proc,
                    tracer=tracer,
                    events=events,
                    recorder=recorder,
                    abort=env_bool("hang_abort", False),
                )
        skew = SkewMonitor(
            registry=registry,
            events=events,
            factor=straggler_factor,
            gather=gather,
        )
        # Perf observatory (TPUFW_PERF_OBS, default on): gated on a
        # telemetry dir — without one there is nowhere for
        # programs.json or the profiler traces to land.
        perf = None
        profiler = None
        if telemetry_dir and env_bool("perf_obs", True):
            perf = perf_mod.PerfObservatory(
                registry=registry, out_dir=telemetry_dir, device=device,
                proc=proc,
            )
            profiler = perf_mod.ProfileTrigger(
                os.path.join(telemetry_dir, "profile")
            )
        server = None
        if metrics_port is not None:
            if metrics_port:
                metrics_port += int(os.environ.get("LOCAL_RANK", "0") or 0)
            server = start_http_server(
                registry, metrics_port, profiler=profiler
            )
        tel = Telemetry(
            registry=registry,
            events=events,
            tracer=tracer,
            skew=skew,
            server=server,
            out_dir=telemetry_dir,
            goodput=ledger,
            watchdog=watchdog,
            recorder=recorder,
            perf=perf,
            profiler=profiler,
            proc=proc,
        )
        _emit_compile_cache_event(events)
        return tel

    def set_run_info(self, **labels) -> None:
        """Publish the ``tpufw_run_info`` identity gauge (value always
        1; the information is in the labels) so every scrape is
        joinable to a build: the port's and torch's versions are added
        here, callers pass backend/mesh/model. Also lands in the crash
        bundle's config.json."""
        if self.registry is None:
            return
        info = {}
        try:
            import tpufw_torch

            info["tpufw_version"] = str(tpufw_torch.__version__)
        except Exception:  # noqa: BLE001
            pass
        try:
            import torch

            info["torch_version"] = str(torch.__version__)
        except Exception:  # noqa: BLE001
            pass
        info.update({k: str(v) for k, v in labels.items()})
        self.registry.gauge(
            "tpufw_run_info",
            "run identity (value is always 1; labels carry the info)",
        ).set(1, **info)
        if self.recorder is not None:
            self.recorder.record_config({"run_info": info})

    def record_config(self, config: dict) -> None:
        """Stash run configuration into the flight recorder so a
        crash bundle is self-describing. No-op when disabled."""
        if self.recorder is not None:
            self.recorder.record_config(config)

    def snapshot_metrics(self) -> Optional[str]:
        """Dump the registry's current exposition text to
        ``<out_dir>/metrics.prom`` (``metrics-p<N>.prom`` on rank N > 0;
        the final flush for runs nothing ever scraped — obs_summary reads
        counter totals from it)."""
        if self.registry is None or not self.out_dir:
            return None
        name = ("metrics.prom" if self.proc == 0
                else f"metrics-p{self.proc}.prom")
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.registry.render())
        os.replace(tmp, path)
        return path

    def _goodput_extra(self) -> dict:
        """End-of-run utilization merged into the goodput closing
        event/JSON: the perf observatory's headline-program MFU and
        roofline attribution when counted, else the Meter's last
        published ``tpufw_train_mfu`` gauge."""
        extra: dict = {}
        try:
            a = self.perf.attrib()
            if "measured_mfu" in a:
                extra["mfu"] = a["measured_mfu"]
                extra["mfu_program"] = a["program"]
            if "roofline_bound" in a:
                extra["roofline_bound"] = a["roofline_bound"]
            if "hbm_headroom_bytes" in a:
                extra["hbm_headroom_bytes"] = a["hbm_headroom_bytes"]
            # Peek, don't get-or-create: the fallback must not mint an
            # empty train gauge on a serve registry.
            meter_mfu = (
                self.registry._metrics.get("tpufw_train_mfu")
                if self.registry is not None
                else None
            )
            if "mfu" not in extra and meter_mfu is not None:
                mfu = meter_mfu.value()
                if mfu > 0:
                    extra["mfu"] = round(mfu, 4)
        except Exception:  # noqa: BLE001 — close must stay best-effort
            pass
        return extra

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Order: watchdog first (a clean shutdown must not fire it),
        # then the goodput rollup (it emits an event + publishes
        # metrics, so it must precede the metrics snapshot and the
        # event-log close), then the files, then the hooks (the
        # recorder stays armed until the very end — an exception
        # inside close itself still gets a bundle).
        self.watchdog.stop()
        try:
            self.goodput.close(extra=self._goodput_extra())
        finally:
            try:
                self.perf.close()
                self.snapshot_metrics()
            finally:
                self.tracer.close()
                self.events.close()
                if self.server is not None:
                    self.server.shutdown()
                    self.server.server_close()
                if self.recorder is not None:
                    self.recorder.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _emit_compile_cache_event(events) -> None:
    """Record whether this run starts against a warm kernel build cache
    (``TPUFW_COMPILE_CACHE_DIR``): warm when every library is already
    built there — the cold-start headline is mostly this bit."""
    try:
        from tpufw_torch.utils.profiling import compile_cache_state

        state = compile_cache_state()
    except Exception:  # noqa: BLE001
        return
    if state is not None:
        events.emit("compile_cache", dir=state[0], warm=state[1])


# Shared disabled singleton: null events/tracer, no registry. close()
# is a no-op because _closed starts True — a workload closing the
# shared instance must not poison later users.
_NULL = Telemetry()
_NULL._closed = True
