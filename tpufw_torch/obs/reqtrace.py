"""Request-scoped trace context for disaggregated serving (a copy of
``tpufw.obs.reqtrace``).

One request through the front door touches three processes — router,
prefill replica, decode replica — each with its own Tracer writing its
own Chrome-trace file. A :class:`TraceContext` (128-bit ``trace_id`` +
per-hop ``span_id``) is minted at the router, propagated over the
``X-TPUFW-Trace`` HTTP header / the ``trace`` field of JSON control
frames / the page bundle's header meta, and stamped into every
per-stage span's ``args`` — so ``scripts/trace_merge.py`` can join the
three files by ``trace_id`` into one per-request flame row on the
wall-clock-aligned timeline.

The per-stage span vocabulary (each role emits the subset it owns):

======================  ====================================================
``req_queue_wait``      router: WFQ admission wait; prefill: engine lock wait
``req_admit``           router: replica pick; prefill: page acquire + trie
``req_prefill_compute`` prefill: prefill_shared / prefill_row device work
``req_page_export``     prefill: export_slot + bundle encode
``req_prefill_rpc``     router: whole prefill round trip (compute ⊂ rpc)
``req_wire``            router: rpc wall minus the engine-reported wall
``req_splice``          decode: bundle parse + page alloc + splice
``req_decode_chunk``    decode: one shared chunk advancing this request
``req_first_token``     decode: splice end → first decode-chunk flush
``req_decode_rpc``      router: whole decode round trip
======================  ====================================================

Disabled tracing must stay effectively free: :func:`stage` is a no-op
when the tracer is disabled and no context rides the request (the <1%%
request-path overhead budget is asserted in tests/test_reqtrace.py).

Stdlib only — the router imports this and never loads torch.
"""

from __future__ import annotations

import os
import re
from typing import Optional

#: HTTP request/response header carrying the wire form of a context.
HEADER = "X-TPUFW-Trace"

_WIRE_RE = re.compile(
    r"^([0-9a-f]{16,32})-([0-9a-f]{8,16})(?:-([A-Za-z0-9_.:-]{0,64}))?$"
)


def _hex(n_bytes: int) -> str:
    return os.urandom(n_bytes).hex()


class TraceContext:
    """Immutable (trace_id, span_id, tenant) triple plus the parent
    span id this hop descended from. ``trace_id`` is the join key
    across processes; ``span_id`` names this hop's spans."""

    __slots__ = ("trace_id", "span_id", "tenant", "parent")

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        tenant: str = "",
        parent: str = "",
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.tenant = tenant
        self.parent = parent

    def child(self) -> "TraceContext":
        """New span id under the same trace — each role/hop re-spans
        so its stages are attributable to the hop, not the minting
        router."""
        return TraceContext(
            self.trace_id, _hex(4), self.tenant, parent=self.span_id
        )

    def wire(self) -> str:
        """``trace_id-span_id[-tenant]`` — the header / control-frame
        form. The parent link is process-local and does not travel."""
        base = f"{self.trace_id}-{self.span_id}"
        return f"{base}-{self.tenant}" if self.tenant else base

    def meta(self) -> dict:
        """Bundle-header form (rides the page bundle's JSON header
        next to the page geometry)."""
        out = {"id": self.trace_id, "span": self.span_id}
        if self.tenant:
            out["tenant"] = self.tenant
        return out

    def args(self, **extra) -> dict:
        """Span ``args`` carrying the correlation keys trace_merge
        joins on."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.tenant:
            out["tenant"] = self.tenant
        if self.parent:
            out["parent"] = self.parent
        out.update(extra)
        return out

    def __repr__(self) -> str:  # debugging/log readability only
        return f"TraceContext({self.wire()!r})"


def mint(tenant: str = "") -> TraceContext:
    """Fresh context — the router calls this for requests arriving
    without an ``X-TPUFW-Trace`` header."""
    return TraceContext(_hex(8), _hex(4), tenant)


def parse(value) -> Optional[TraceContext]:
    """Wire/meta form back into a context; tolerant — a malformed or
    absent value returns None (a bad header must never 500 the front
    door, and an old peer that sends nothing is fine)."""
    if isinstance(value, TraceContext):
        return value
    if isinstance(value, dict):  # bundle-header meta form
        tid, span = value.get("id"), value.get("span")
        if isinstance(tid, str) and isinstance(span, str) and tid and span:
            return TraceContext(tid, span, str(value.get("tenant") or ""))
        return None
    if not isinstance(value, str):
        return None
    m = _WIRE_RE.match(value.strip())
    if m is None:
        return None
    return TraceContext(m.group(1), m.group(2), m.group(3) or "")


def stage(
    tracer, ctx: Optional[TraceContext], name: str, dur_s: float, **extra
) -> None:
    """Emit one per-stage span (a complete event ending now, ``dur_s``
    long) carrying the trace correlation args. No-op-cheap on the
    disabled path: one attribute read when the tracer is the shared
    NullTracer."""
    if not getattr(tracer, "enabled", False):
        return
    if ctx is not None:
        tracer.complete(name, dur_s, **ctx.args(**extra))
    else:
        tracer.complete(name, dur_s, **extra)
