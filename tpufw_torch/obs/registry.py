"""Thread-safe metrics registry with Prometheus text exposition (port of
``tpufw.obs.registry``, by copy: stdlib only).

The serving stack renders its ``/metrics`` endpoint from here. Counters,
gauges and fixed-bucket histograms only, the subset Prometheus' text
format can express without a client library. The exposition is byte for
byte the JAX package's, so an existing scrape reads the port unchanged:

- values render via ``repr``, not ``%g`` (``%g`` rounds to 6 significant
  digits, which stalls large counters);
- counters can be pre-registered at 0 so alerts on ``increase(...)`` see
  a real 0-valued series before the first increment, not an absent one.

Gauges additionally accept a callback (``set_function``) evaluated at
scrape time. ``start_http_server`` is the trainer's standalone
``/metrics`` endpoint (``TPUFW_METRICS_PORT``), with ``/debug/profile``
when a ``ProfileTrigger`` is mounted.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence, Tuple

# Prometheus text exposition content type (version pinned by spec).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Default buckets for time-in-seconds histograms.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _fmt(v: float) -> str:
    return str(int(v)) if v == int(v) else repr(v)


def escape_help(s: str) -> str:
    """HELP-line escaping per the text-format spec: backslash and
    newline only (quotes are legal verbatim in HELP text)."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(s: str) -> str:
    """Label-value escaping per the text-format spec: backslash,
    double-quote, newline."""
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{escape_label_value(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base: one named metric, possibly with labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _header(self) -> list:
        lines = []
        if self.help:
            lines.append(
                f"# HELP {self.name} {escape_help(self.help)}"
            )
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def render(self) -> list:
        with self._lock:
            values = dict(self._values)
        lines = self._header()
        for key in sorted(values):
            lines.append(
                f"{self.name}{_label_str(key)} {_fmt(values[key])}"
            )
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        # Pre-initialized unlabeled series; labeled children appear on
        # first inc.
        self._values[()] = 0.0

    def inc(self, v: float = 1.0, **labels) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative inc {v}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def reset(self, **labels) -> None:
        """Zero a series, for work that must be invisible to scrapes
        (serve warmup runs before the listener binds)."""
        with self._lock:
            self._values[_label_key(labels)] = 0.0


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate ``fn`` at scrape time (point-in-time values with
        one source of truth elsewhere, e.g. queue depth)."""
        with self._lock:
            self._fn = fn

    def render(self) -> list:
        with self._lock:
            values = dict(self._values)
            fn = self._fn
        if fn is not None:
            try:
                values[()] = float(fn())
            except Exception:  # noqa: BLE001 — scrape must not 500
                pass
        lines = self._header()
        for key in sorted(values):
            lines.append(
                f"{self.name}{_label_str(key)} {_fmt(values[key])}"
            )
        return lines


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` buckets + ``_sum`` /
    ``_count``), the shape Prometheus' histogram_quantile expects."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: empty buckets")
        self._bucket_counts: Dict[LabelKey, list] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._counts: Dict[LabelKey, int] = {}

    def observe(self, v: float, n: int = 1, **labels) -> None:
        """Record ``v``; ``n > 1`` records it n times in one locked
        update."""
        key = _label_key(labels)
        with self._lock:
            counts = self._bucket_counts.get(key)
            if counts is None:
                counts = [0] * (len(self.buckets) + 1)  # +Inf last
                self._bucket_counts[key] = counts
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += n
                    break
            else:
                counts[len(self.buckets)] += n
            self._sums[key] = self._sums.get(key, 0.0) + v * n
            self._counts[key] = self._counts.get(key, 0) + n

    def value(self, **labels) -> float:
        """Histogram 'value' is its observation count."""
        with self._lock:
            return float(self._counts.get(_label_key(labels), 0))

    def reset(self, **labels) -> None:
        """Drop a series: buckets, sum and count all return to zero."""
        key = _label_key(labels)
        with self._lock:
            self._bucket_counts.pop(key, None)
            self._sums.pop(key, None)
            self._counts.pop(key, None)

    def render(self) -> list:
        with self._lock:
            bucket_counts = {
                k: list(v) for k, v in self._bucket_counts.items()
            }
            sums = dict(self._sums)
            counts = dict(self._counts)
        lines = self._header()
        for key in sorted(counts):
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += bucket_counts[key][i]
                le = _label_str(key, f'le="{_fmt(ub)}"')
                lines.append(f"{self.name}_bucket{le} {cum}")
            cum += bucket_counts[key][len(self.buckets)]
            le = _label_str(key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{le} {cum}")
            lines.append(
                f"{self.name}_sum{_label_str(key)} {_fmt(sums[key])}"
            )
            lines.append(f"{self.name}_count{_label_str(key)} {cum}")
        return lines


class Registry:
    """Named metrics, one instance per kind; get-or-create accessors
    so call sites never coordinate creation order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for _, m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: Registry  # set on the server class by start_http_server

    def do_GET(self):  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path.rstrip("/") == "/debug/profile":
            self._handle_profile(query)
            return
        if path not in ("/metrics", "/metrics/"):
            self.send_error(404)
            return
        body = self.server.registry.render().encode()  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _handle_profile(self, query: str) -> None:
        """``GET /debug/profile?seconds=N``: start a time-bounded
        ``torch.profiler`` capture through the mounted ProfileTrigger
        (``tpufw_torch.obs.perf``); 404 when no trigger is mounted (no
        telemetry dir to drop the trace into), 409 while one is already
        running."""
        import json
        from urllib.parse import parse_qs

        trigger = getattr(self.server, "profiler", None)
        if trigger is None:
            self.send_error(404)
            return
        try:
            seconds = float(
                parse_qs(query).get("seconds", ["2.0"])[0]
            )
        except ValueError:
            seconds = 2.0
        result = trigger.trigger(seconds)
        body = json.dumps(result).encode()
        self.send_response(409 if "error" in result else 200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes are not log events
        pass


def start_http_server(
    registry: Registry, port: int, host: str = "0.0.0.0", profiler=None
) -> ThreadingHTTPServer:
    """Serve ``registry`` at ``/metrics`` on ``port`` (0 = ephemeral;
    bound port is ``server.server_address[1]``) from a daemon thread.
    Caller owns shutdown(). ``profiler`` (a tpufw_torch.obs.perf
    ProfileTrigger) additionally mounts ``/debug/profile``."""
    httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
    httpd.registry = registry  # type: ignore[attr-defined]
    httpd.profiler = profiler  # type: ignore[attr-defined]
    threading.Thread(
        target=httpd.serve_forever, daemon=True, name="obs-metrics"
    ).start()
    return httpd
