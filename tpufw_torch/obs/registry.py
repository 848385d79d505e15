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
scrape time. The JAX module's standalone ``/metrics`` HTTP server (the
trainer's ``TPUFW_METRICS_PORT``) is not ported: the trainer's telemetry
is ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import threading
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
