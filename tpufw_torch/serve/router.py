"""Front-door router for disaggregated serving: one HTTP endpoint in
front of replicated prefill/decode pools (a copy of
``tpufw.serve.router``).

The router holds no model state — it imports neither torch nor a model
module, so a router container needs no CUDA. Per request it

1. stamps the request into a per-tenant weighted-fair queue (virtual
   finish times: a tenant with weight 2 drains twice as fast as a
   weight-1 tenant under contention, and an idle tenant's backlog
   never starves others),
2. runs admission control against the DECODE pools' page arenas — the
   scarce resource in disaggregated serving is decode residency, so a
   request whose page footprint fits no replica is rejected up front
   with 429 + Retry-After instead of queueing into a stall,
3. picks replicas: sticky session→decode-replica affinity (a session's
   later turns land where its prefix pages already live), least-loaded
   otherwise, and forwards prompt → prefill → page bundle → decode.

Replica load signals are the ones the replicas already export —
pages_in_use / pages_total and slots_active / slots_total from the
arena, plus whatever goodput/MFU/HBM-headroom gauges ride in the
signals dict (``ReplicaState.score`` folds them in when present).
Snapshots refresh from every decode response and from explicit signal
probes, so the policy always ranks against recent truth without a
polling thread.

``RouterPolicy`` and ``WeightedFairQueue`` are pure (no sockets, no
clocks) — tests/test_torch_router.py drives them directly.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpufw_torch.obs import events as obs_events
from tpufw_torch.obs import reqtrace
from tpufw_torch.obs import slo as obs_slo
from tpufw_torch.obs import trace as obs_trace
from tpufw_torch.obs.registry import Registry as ObsRegistry
from tpufw_torch.serve import transport
from tpufw_torch.serve.bundle import (
    MAGIC,
    chunk_digests,
    drop_session,
    load_session,
    peek_trace,
)
from tpufw_torch.workloads.env import env_float, env_int, env_str

DEFAULT_ROUTER_PORT = 8478


#: Signal-dict keys copied verbatim into a ReplicaState snapshot.
_SIGNAL_KEYS = (
    "pages_total", "pages_in_use", "slots_total", "slots_active",
    "migrations", "goodput_ratio", "mfu", "hbm_headroom_bytes",
    "spec_k", "spec_passes",
    "prefill_chunk_pages", "prefill_inflight", "prefill_chunks",
    "piggyback_waterline",
    # KV fabric: drain state, prefix-cache hit counters, spill-tier
    # occupancy, and the advertised trie digests the affinity hash
    # steers on (the one non-numeric signal — fleet's numeric-only
    # series collection skips it by type).
    "draining", "sessions_drained", "sessions_resumed",
    "prefix_hits", "prefix_misses",
    "spill_ram_pages", "spill_dir_pages",
    "spill_pages_total", "spill_restored_total",
    "prefix_digests",
)


@dataclass
class ReplicaState:
    """Point-in-time load snapshot of one replica, as the policy sees
    it. Page/slot occupancy is the primary signal; the optional
    goodput/MFU fields break ties when present."""

    name: str
    role: str
    pages_total: int = 0
    pages_in_use: int = 0
    slots_total: int = 0
    slots_active: int = 0
    migrations: int = 0
    goodput_ratio: Optional[float] = None
    mfu: Optional[float] = None
    hbm_headroom_bytes: Optional[float] = None
    # Speculative decode replicas advertise their draft depth and pass
    # count; health() surfaces both so an operator can see which pool
    # is speculating (and that its verify passes are advancing).
    spec_k: int = 0
    spec_passes: int = 0
    # Chunked-prefill replicas advertise their chunk size and in-
    # flight chunked admissions; piggyback-capable decode replicas
    # additionally advertise their spare-capacity waterline. The
    # policy steers between the dedicated-prefill and piggyback paths
    # on these (score() and piggyback_fits()).
    prefill_chunk_pages: int = 0
    prefill_inflight: int = 0
    prefill_chunks: int = 0
    piggyback_waterline: float = 0.0
    # KV fabric: a draining replica (SIGTERM / scale-in) refuses new
    # work and is leaving rotation; prefix_digests is its advertised
    # resident-or-spilled trie coverage (cumulative chunk digests,
    # serve.bundle.chunk_digests) the affinity hash steers on.
    draining: int = 0
    sessions_drained: int = 0
    sessions_resumed: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    spill_ram_pages: int = 0
    spill_dir_pages: int = 0
    spill_pages_total: int = 0
    spill_restored_total: int = 0
    prefix_digests: Tuple[str, ...] = ()
    healthy: bool = True
    last_seen: float = 0.0

    @property
    def free_pages(self) -> int:
        return max(0, self.pages_total - self.pages_in_use)

    @property
    def load(self) -> float:
        return self.pages_in_use / max(1, self.pages_total)

    def score(self) -> float:
        """Lower is better. Page occupancy dominates; a replica
        burning slots on wasted work (low goodput) or out of HBM
        headroom ranks behind an equally-occupied healthy one."""
        s = self.load + 0.1 * (self.slots_active / max(1, self.slots_total))
        # Prefill-chunk occupancy: each in-flight chunked prefill is a
        # whole prompt's worth of pending compute that page occupancy
        # does not yet show (chunked admission grabs pages lazily).
        s += 0.02 * self.prefill_inflight
        if self.goodput_ratio is not None:
            s += 0.05 * (1.0 - min(1.0, max(0.0, self.goodput_ratio)))
        if self.hbm_headroom_bytes is not None and self.hbm_headroom_bytes <= 0:
            s += 1.0
        return s

    def update(self, signals: Dict[str, Any], now: float = 0.0) -> None:
        role = signals.get("role")
        if role is not None and role != self.role:
            # A replica answering with the wrong role means this
            # address points at the wrong pool (mis-wired discovery
            # or a swapped port): routing to it would splice bundles
            # into the wrong arena. Take it out of rotation instead
            # of folding its numbers into the policy.
            self.healthy = False
            self.last_seen = now
            return
        for k in _SIGNAL_KEYS:
            # goodput_ratio / mfu / hbm_headroom_bytes: no replica
            # exports them yet, but the policy folds them in the moment
            # one does (score() above).
            v = signals.get(k)
            if v is not None:
                setattr(self, k, v)
        self.healthy = True
        self.last_seen = now


class WeightedFairQueue:
    """Virtual-time weighted fair queueing over tenants.

    ``push`` stamps an item with a virtual finish time
    ``max(global_vt, tenant_last_finish) + cost / weight``; ``pop``
    returns the earliest finish and advances global virtual time to
    it. Equal-cost streams from tenants with weights 2:1 therefore
    drain 2:1 under contention, and a tenant that went idle re-enters
    at the current virtual time instead of burning its saved-up
    backlog ahead of everyone."""

    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
    ):
        self._weights = dict(weights or {})
        self._default = float(default_weight)
        self._vt = 0.0
        self._finish: Dict[str, float] = {}
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._seq = 0
        # Per-tenant queued count. Entries persist at 0 after a tenant
        # drains so its gauge series keeps reporting 0 instead of
        # vanishing (absent-series vs zero, same rationale as the
        # pre-initialized counters in tpufw_torch.obs.registry).
        self._depth: Dict[str, int] = {}

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(self._weights.get(tenant, self._default)))

    def push(self, tenant: str, cost: float, item: Any) -> float:
        start = max(self._vt, self._finish.get(tenant, 0.0))
        fin = start + float(cost) / self.weight(tenant)
        self._finish[tenant] = fin
        heapq.heappush(self._heap, (fin, self._seq, tenant, item))
        self._seq += 1
        self._depth[tenant] = self._depth.get(tenant, 0) + 1
        return fin

    def pop(self) -> Any:
        fin, _, tenant, item = heapq.heappop(self._heap)
        self._vt = max(self._vt, fin)
        self._depth[tenant] = max(0, self._depth.get(tenant, 1) - 1)
        return item

    def depths(self) -> Dict[str, int]:
        """Per-tenant queued counts (drained tenants stay at 0)."""
        return dict(self._depth)

    def __len__(self) -> int:
        return len(self._heap)


class RouterPolicy:
    """Pure routing decisions: WFQ ordering, replica choice, and
    admission. Holds the session→decode-replica affinity map but no
    I/O — the server layer feeds it snapshots and forwards bytes."""

    def __init__(
        self,
        *,
        tenant_weights: Optional[Dict[str, float]] = None,
        saturation: float = 0.95,
        retry_after_s: int = 5,
        affinity_k: int = 0,
    ):
        self.queue = WeightedFairQueue(tenant_weights)
        self.saturation = float(saturation)
        self.retry_after_s = int(retry_after_s)
        #: Prefix-affinity depth: hash the first k page-aligned chunks
        #: of each prompt (serve.bundle.chunk_digests) and steer
        #: to the replica already advertising them. 0 = occupancy only.
        self.affinity_k = max(0, int(affinity_k))
        #: Picks won by a nonzero digest match (the server mirrors the
        #: delta into tpufw_router_prefix_affinity_hits_total).
        self.affinity_hits = 0
        self._affinity: Dict[str, str] = {}

    # ---- replica choice -------------------------------------------

    @staticmethod
    def affinity_depth(
        r: ReplicaState, digests: Sequence[str]
    ) -> int:
        """Deepest chunk index (1-based) of ``digests`` this replica
        advertises. Digests are cumulative (digest i covers chunks
        0..i), so the deepest match is exactly the prefix the replica
        can serve from its trie or spill tier without recompute."""
        if not digests or not r.prefix_digests:
            return 0
        have = set(r.prefix_digests)
        depth = 0
        for i, d in enumerate(digests):
            if d in have:
                depth = i + 1
        return depth

    def pick_prefill(
        self,
        replicas: Sequence[ReplicaState],
        digests: Sequence[str] = (),
    ) -> Optional[str]:
        ok = [r for r in replicas if r.healthy and not r.draining]
        if not ok:
            return None
        best = min(
            ok,
            key=lambda r: (
                -self.affinity_depth(r, digests), r.score(), r.name
            ),
        )
        if self.affinity_depth(best, digests) > 0:
            self.affinity_hits += 1
        return best.name

    def decode_fits(self, r: ReplicaState, n_pages: int) -> bool:
        """Can this decode replica take a bundle of ``n_pages`` now —
        a free slot, the pages themselves, and room under the
        saturation waterline (the headroom that keeps in-flight rows'
        decode growth from hitting a full arena)."""
        if not r.healthy or r.draining:
            return False
        if r.slots_active >= max(1, r.slots_total):
            return False
        if n_pages > r.free_pages:
            return False
        return (r.pages_in_use + n_pages) <= self.saturation * max(
            1, r.pages_total
        )

    def pick_decode(
        self,
        session: str,
        replicas: Sequence[ReplicaState],
        n_pages: int,
        digests: Sequence[str] = (),
    ) -> Tuple[Optional[str], str]:
        """(replica_name, "") or (None, reject_reason). A session
        sticks to its previous decode replica while that replica can
        still take it — its earlier turns' pages (and any prefix
        reuse downstream) live there — and is re-homed, not failed,
        when the replica is gone or full. Session stickiness beats
        prefix affinity (the session's OWN pages out-rank a shared
        prefix); among the rest, the deepest digest match wins and
        occupancy score breaks ties."""
        by_name = {r.name: r for r in replicas}
        if session:
            pinned = self._affinity.get(session)
            if pinned is not None:
                r = by_name.get(pinned)
                if r is not None and self.decode_fits(r, n_pages):
                    return pinned, ""
        fits = [r for r in replicas if self.decode_fits(r, n_pages)]
        if not fits:
            return None, "saturated"
        best = min(
            fits,
            key=lambda r: (
                -self.affinity_depth(r, digests), r.score(), r.name
            ),
        )
        if self.affinity_depth(best, digests) > 0:
            self.affinity_hits += 1
        name = best.name
        if session:
            self._affinity[session] = name
        return name, ""

    def piggyback_fits(self, r: ReplicaState, n_pages: int) -> bool:
        """Can this decode replica take a RAW prompt of ``n_pages``
        (prompt + budget) chunk-by-chunk right now — chunked prefill
        enabled, a free slot, and spare pages still clearing its
        advertised waterline AFTER this row's full need. Mirrors the
        replica's own ``submit_raw`` admission test (minus the
        in-flight piggyback deficits only the replica can see — it
        re-checks and refuses, and the router falls back)."""
        if not r.healthy or r.draining or r.role != "decode":
            return False
        if not (r.prefill_chunk_pages and r.piggyback_waterline > 0):
            return False
        if r.slots_active >= max(1, r.slots_total):
            return False
        return (
            r.free_pages - n_pages
            >= r.piggyback_waterline * max(1, r.pages_total)
        )

    def pick_piggyback(
        self,
        replicas: Sequence[ReplicaState],
        n_pages: int,
        max_chunks: Optional[int] = None,
        digests: Sequence[str] = (),
    ) -> Optional[str]:
        """Least-loaded decode replica with piggyback headroom, or
        None when no replica clears its waterline.

        ``max_chunks`` bounds how much prefill work piggybacking may
        divert: with a healthy dedicated prefill pool the router only
        piggybacks prompts a decode replica can absorb in that many
        spare-capacity chunk passes (long prompts would turn the
        decode replica into a worse prefill replica and starve its
        decode slots). With NO dedicated path (``None``) any size
        that clears the waterline goes — fungibility is then the only
        way to serve at all."""
        fits = [
            r for r in replicas
            if self.piggyback_fits(r, n_pages)
            and (
                max_chunks is None
                or n_pages <= r.prefill_chunk_pages * max_chunks
            )
        ]
        if not fits:
            return None
        best = min(
            fits,
            key=lambda r: (
                -self.affinity_depth(r, digests), r.score(), r.name
            ),
        )
        if self.affinity_depth(best, digests) > 0:
            self.affinity_hits += 1
        return best.name

    def pin_session(self, session: str, name: str) -> None:
        """Record decode affinity for a replica chosen outside
        ``pick_decode`` (the piggyback path)."""
        if session:
            self._affinity[session] = name

    def forget_session(self, session: str) -> None:
        self._affinity.pop(session, None)


class _Metrics:
    """Router metrics on the shared ``tpufw_torch.obs`` registry — same
    wrapper shape as the serving endpoint's (short names at call
    sites, prefix applied here, counters pre-initialized to 0 so
    increase() alerts see a real zero series)."""

    PREFIX = "tpufw_router_"

    def __init__(self, registry: Optional[ObsRegistry] = None):
        self.registry = registry if registry is not None else ObsRegistry()
        self.register(
            "requests_total",
            "rejects_total",
            "proxy_errors_total",
            "request_seconds_total",
            "piggyback_total",
            "deferred_total",
            "tokens_total",
            "prefix_affinity_hits_total",
            "session_rehomes_total",
            "replica_changes_total",
        )

    def inc(self, name: str, v: float = 1.0, **labels) -> None:
        self.registry.counter(self.PREFIX + name).inc(v, **labels)

    def register(self, *names: str) -> None:
        for name in names:
            self.registry.counter(self.PREFIX + name)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.registry.gauge(self.PREFIX + name).set(float(v), **labels)

    def render(self, gauges: Dict[str, float]) -> str:
        for name, v in gauges.items():
            self.registry.gauge(self.PREFIX + name).set(float(v))
        return self.registry.render()


# ---------------------------------------------------- replica clients

class LocalReplica:
    """In-process replica client wrapping an engine directly — CI
    gangs one prefill + one decode + the router in a single process
    through these."""

    def __init__(self, name: str, engine):
        self.name = name
        self._engine = engine

    def signals(self) -> Dict[str, Any]:
        return self._engine.signals()

    def prefill(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> bytes:
        return self._engine.prefill(
            prompt, max_new, trace=trace, session=session
        )

    def decode(self, bundle: bytes) -> Dict[str, Any]:
        slot = self._engine.submit(bundle)
        out = self._engine.collect_ex(slot)
        return {**out, **self._engine.signals()}

    def decode_raw(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> Dict[str, Any]:
        slot = self._engine.submit_raw(
            prompt, max_new, trace=trace, session=session
        )
        out = self._engine.collect_ex(slot)
        return {**out, **self._engine.signals()}

    def drain(self) -> Dict[str, Any]:
        """Session-safe scale-in, same contract as TcpReplica.drain —
        the executor drains through the client so LocalReplica and
        TcpReplica gangs scale in identically."""
        fn = getattr(self._engine, "drain", None)
        if callable(fn):
            return fn()
        return {"draining": True, "exported": [], "dropped": 0}


class TcpReplica:
    """Framed-TCP replica client (one connection per call — replica
    RPCs are one-in-one-out and rare relative to their cost)."""

    def __init__(self, name: str, host: str, port: int, role: str,
                 timeout: float = 600.0):
        self.name = name
        self.role = role
        self._addr = (host, int(port))
        #: Seconds each call may wait on its socket.
        self.timeout = float(timeout)
        #: Round-trip wall of the most recent _call — request tracing
        #: subtracts the replica's self-reported engine wall from it
        #: to expose pure serialization + wire time.
        self.last_rtt_s = 0.0

    def _call(self, payload: bytes) -> bytes:
        reply, self.last_rtt_s = transport.rpc(*self._addr, payload,
                                               timeout=self.timeout)
        return reply

    def signals(self) -> Dict[str, Any]:
        reply = self._call(json.dumps({"signals": True}).encode())
        return json.loads(reply.decode("utf-8"))

    def drain(self) -> Dict[str, Any]:
        """Ask the replica to export its live sessions to the spill
        store and refuse new work — the programmatic scale-in hook
        (manifest 13's preStop runs exactly this against localhost)."""
        reply = self._call(json.dumps({"drain": True}).encode())
        return json.loads(reply.decode("utf-8"))

    def prefill(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> bytes:
        req = {"prompt": list(prompt), "max_new": int(max_new)}
        if trace:
            req["trace"] = str(trace)
        if session:
            req["session"] = str(session)
        reply = self._call(json.dumps(req).encode())
        if reply[:4] != MAGIC:
            err = json.loads(reply.decode("utf-8"))
            raise RuntimeError(f"prefill {self.name}: {err.get('error')}")
        return reply

    def decode(self, bundle: bytes) -> Dict[str, Any]:
        out = json.loads(self._call(bundle).decode("utf-8"))
        if "error" in out:
            raise RuntimeError(f"decode {self.name}: {out['error']}")
        return out

    def decode_raw(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> Dict[str, Any]:
        req = {"prompt": list(prompt), "max_new": int(max_new)}
        if trace:
            req["trace"] = str(trace)
        if session:
            req["session"] = str(session)
        out = json.loads(
            self._call(json.dumps(req).encode()).decode("utf-8")
        )
        if "error" in out:
            raise RuntimeError(f"decode {self.name}: {out['error']}")
        return out


# ------------------------------------------------------- HTTP server

class RouterServer:
    """The front door: POST /generate, GET /healthz, GET /metrics.

    Dispatch order is the WFQ's; ``max_inflight`` requests proxy
    concurrently and completions pump the queue. Decode snapshots
    refresh from every decode response, so saturation decisions track
    the arenas without a polling loop."""

    def __init__(
        self,
        prefill: Sequence[Any],
        decode: Sequence[Any],
        *,
        policy: Optional[RouterPolicy] = None,
        port: int = 0,
        page: int = 16,
        max_inflight: int = 4,
        events=None,
        registry: Optional[ObsRegistry] = None,
        tracer=None,
        slo=None,
        spill_dir: str = "",
    ):
        self._prefill = list(prefill)
        self._decode = list(decode)
        self.policy = policy if policy is not None else RouterPolicy()
        self.page = max(1, int(page))
        self.max_inflight = max(1, int(max_inflight))
        #: Shared session store (TPUFW_KV_SPILL_DIR): when a decode
        #: replica drains mid-request, its exported session bundles
        #: land here and the router re-homes the request to a
        #: surviving replica instead of failing it.
        self.spill_dir = str(spill_dir or "")
        self._metrics = _Metrics(registry)
        self._events = events if events is not None else obs_events.NULL
        self._tracer = tracer if tracer is not None else obs_trace.NULL
        # SLO accounting always rides the request path (the judging is
        # a few clock reads); the tpufw_slo_* series land in the same
        # registry /metrics renders.
        self.slo = (
            slo
            if slo is not None
            else obs_slo.SloTracker.from_env(
                self._metrics.registry, self._events
            )
        )
        self._lock = threading.Lock()
        self._inflight = 0
        self._last_reprobe = time.monotonic()
        self._states: Dict[str, ReplicaState] = {}
        for client in self._prefill:
            self._states[client.name] = ReplicaState(client.name, "prefill")
        for client in self._decode:
            self._states[client.name] = ReplicaState(client.name, "decode")
        self._refresh_all()

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _reply(self, code: int, obj: dict, headers=()):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.health())
                elif self.path == "/metrics":
                    text = server.render_metrics().encode("utf-8")
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path not in ("/generate", "/replicas"):
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n).decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if self.path == "/replicas":
                    code, obj = server.replicas_api(req)
                    self._reply(code, obj)
                    return
                code, obj, headers = server.generate(
                    req,
                    trace_header=self.headers.get(reqtrace.HEADER, ""),
                )
                self._reply(code, obj, headers)

        self.httpd = ThreadingHTTPServer(("0.0.0.0", int(port)), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        ).start()

    # ---- state ----------------------------------------------------

    def _refresh_all(self) -> None:
        for client in self._prefill + self._decode:
            try:
                sig = client.signals()
            except Exception:  # noqa: BLE001 — probe failure = unhealthy
                self._states[client.name].healthy = False
                continue
            self._states[client.name].update(sig, now=time.monotonic())

    #: Seconds between opportunistic re-probes of unhealthy replicas.
    REPROBE_INTERVAL_S = 2.0

    def _reprobe_unhealthy(self, force: bool = False) -> None:
        """Second chance for replicas a failed call took out of
        rotation: a live ``signals()`` probe puts them back. Without
        this, one transient error removes a replica forever. Runs at
        most once per interval unless forced (no pickable replica
        left, so a probe is cheaper than a spurious 429/503)."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_reprobe < self.REPROBE_INTERVAL_S:
                return
            self._last_reprobe = now
            down = [
                c for c in self._prefill + self._decode
                if not self._states[c.name].healthy
            ]
        for client in down:
            try:
                sig = client.signals()
            except Exception:  # noqa: BLE001 — still down
                continue
            with self._lock:
                self._states[client.name].update(sig, now=time.monotonic())

    def _snapshot(self, role: str) -> List[ReplicaState]:
        with self._lock:
            return [
                ReplicaState(**vars(r))
                for r in self._states.values()
                if r.role == role
            ]

    # ---- elastic membership ---------------------------------------

    def add_replica(self, client, role: str) -> dict:
        """Register a replica client into a pool at runtime — the
        scale-out half of the closed loop (the POST /replicas surface
        lands here). The probe
        runs outside the lock; a replica that cannot answer signals
        still registers, just unhealthy (the reprobe path gives it
        its second chance, same as a startup straggler)."""
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        sig = None
        try:
            sig = client.signals()
        except Exception:  # noqa: BLE001 — probe failure = unhealthy
            pass
        with self._lock:
            if client.name in self._states:
                raise ValueError(
                    f"replica name {client.name!r} already registered"
                )
            pool = self._prefill if role == "prefill" else self._decode
            pool.append(client)
            state = ReplicaState(client.name, role)
            self._states[client.name] = state
            if sig is None:
                state.healthy = False
            else:
                state.update(sig, now=time.monotonic())
        self._metrics.inc("replica_changes_total", role=role, op="add")
        return {"name": client.name, "role": role,
                "healthy": sig is not None}

    def remove_replica(self, name: str, *, drain: bool = True) -> dict:
        """Deregister a replica — session-safe scale-in. The drain
        call (exports live sessions to the spill store) runs
        BEFORE the membership change and outside the lock, so
        in-flight requests on other threads still see the replica
        while it exports; the last replica of a role is refused, the
        door stays open."""
        with self._lock:
            state = self._states.get(name)
            if state is None:
                raise KeyError(f"no replica named {name!r}")
            role = state.role
            pool = self._prefill if role == "prefill" else self._decode
            if sum(1 for s in self._states.values()
                   if s.role == role) <= 1:
                raise ValueError(
                    f"refusing to remove last {role} replica {name!r}"
                )
            client = next(c for c in pool if c.name == name)
            # Draining replicas stop winning _pick while the export
            # runs; membership is surgically removed after.
            state.draining = 1
        drained: dict = {}
        if drain:
            fn = getattr(client, "drain", None)
            if callable(fn):
                try:
                    drained = fn()
                except Exception as e:  # noqa: BLE001
                    drained = {"error": f"{type(e).__name__}: {e}"}
        with self._lock:
            pool = self._prefill if role == "prefill" else self._decode
            if client in pool:
                pool.remove(client)
            self._states.pop(name, None)
        self._metrics.inc(
            "replica_changes_total", role=role, op="remove"
        )
        return {"name": name, "role": role, "drained": drained}

    def replicas_api(self, req: dict) -> Tuple[int, dict]:
        """POST /replicas — the out-of-process executor surface.
        ``{"op": "add", "name", "host", "port", "role"}`` joins a
        framed-TCP replica; ``{"op": "remove", "name"}`` drains and
        deregisters. Returns (code, body) like generate()."""
        op = req.get("op")
        if op == "add":
            missing = [
                k for k in ("name", "host", "port", "role")
                if not req.get(k)
            ]
            if missing:
                return 400, {"error": f"missing fields {missing}"}
            try:
                client = TcpReplica(
                    str(req["name"]), str(req["host"]),
                    int(req["port"]), str(req["role"]),
                )
                return 200, self.add_replica(client, str(req["role"]))
            except (ValueError, TypeError) as e:
                return 400, {"error": str(e)}
        if op == "remove":
            if not req.get("name"):
                return 400, {"error": "missing fields ['name']"}
            try:
                return 200, self.remove_replica(
                    str(req["name"]),
                    drain=bool(req.get("drain", True)),
                )
            except (KeyError, ValueError) as e:
                return 400, {"error": str(e)}
        return 400, {"error": f"unknown op {op!r}"}

    def n_pages_for(self, prompt_len: int, max_new: int) -> int:
        need = max(1, prompt_len + max_new - 1)
        return -(-need // self.page)

    def health(self) -> dict:
        """Per-replica detail, not a bare status — a JobSet probe (or
        a human with curl) can tell WHICH replica is out of rotation,
        how stale its last signals are, and how the policy currently
        ranks it."""
        now = time.monotonic()
        with self._lock:
            replicas = {
                name: {
                    "name": name,
                    "role": r.role,
                    "healthy": r.healthy,
                    # None = never successfully probed since startup.
                    "last_probe_age_s": (
                        round(now - r.last_seen, 3)
                        if r.last_seen else None
                    ),
                    "score": round(r.score(), 4),
                    "pages_in_use": r.pages_in_use,
                    "pages_total": r.pages_total,
                    "slots_active": r.slots_active,
                    "slots_total": r.slots_total,
                    **(
                        {"spec_k": r.spec_k,
                         "spec_passes": r.spec_passes}
                        if r.spec_k else {}
                    ),
                    **(
                        {"prefill_chunk_pages": r.prefill_chunk_pages,
                         "prefill_inflight": r.prefill_inflight,
                         "prefill_chunks": r.prefill_chunks}
                        if r.prefill_chunk_pages else {}
                    ),
                    **(
                        {"piggyback_waterline": r.piggyback_waterline}
                        if r.piggyback_waterline else {}
                    ),
                    **({"draining": True} if r.draining else {}),
                }
                for name, r in self._states.items()
            }
            return {
                "ok": all(r["healthy"] for r in replicas.values())
                or bool(
                    # Degraded-but-serving: healthy coverage of both
                    # roles keeps the door open.
                    any(
                        r["healthy"] and r["role"] == "prefill"
                        for r in replicas.values()
                    )
                    and any(
                        r["healthy"] and r["role"] == "decode"
                        for r in replicas.values()
                    )
                ),
                "queue_depth": len(self.policy.queue),
                "inflight": self._inflight,
                "replicas": replicas,
            }

    def render_metrics(self) -> str:
        with self._lock:
            depth = len(self.policy.queue)
            depths = self.policy.queue.depths()
            decode_free = sum(
                r.free_pages
                for r in self._states.values()
                if r.role == "decode" and r.healthy
            )
        # Per-tenant WFQ depth rides as labeled children next to the
        # unlabeled total — queue pressure visible per tenant before
        # it becomes TTFT (drained tenants keep a 0 series).
        for tenant, n in depths.items():
            self._metrics.set_gauge("queue_depth", n, tenant=tenant)
        return self._metrics.render(
            {
                "queue_depth": depth,
                "inflight": self._inflight,
                "decode_pages_free": decode_free,
            }
        )

    # ---- WFQ dispatch ---------------------------------------------

    def _pump_locked(self) -> None:
        while self._inflight < self.max_inflight and len(self.policy.queue):
            ev = self.policy.queue.pop()
            if getattr(ev, "abandoned", False):
                # The waiter timed out and left; granting its slot
                # would leak it (nobody would _release). Skip.
                continue
            self._inflight += 1
            ev.set()

    def _admit(self, tenant: str, cost: float, timeout: float) -> bool:
        ev = threading.Event()
        ev.abandoned = False
        with self._lock:
            self.policy.queue.push(tenant, cost, ev)
            self._pump_locked()
            deferred = not ev.is_set()
        if deferred:
            # Admission was not immediate: the request sat behind the
            # inflight cap. The counter is the alert-friendly
            # companion of the queue-depth gauge (a scrape can miss a
            # transient queue; it cannot miss a counter increment).
            self._metrics.inc("deferred_total", tenant=tenant)
        if ev.wait(timeout):
            return True
        with self._lock:
            if ev.is_set():
                # A pump granted the slot between the wait timing out
                # and us taking the lock — the slot is ours after all.
                return True
            ev.abandoned = True
        return False

    def _release(self) -> None:
        with self._lock:
            self._inflight -= 1
            self._pump_locked()

    # ---- the proxy path -------------------------------------------

    def _pick(
        self, session: str, n_pages: int, digests: Sequence[str] = ()
    ) -> Tuple[Optional[str], Optional[str], str]:
        """(decode_name, prefill_name, reject_reason) under the lock."""
        with self._lock:
            h0 = self.policy.affinity_hits
            name, reason = self.policy.pick_decode(
                session,
                [r for r in self._states.values() if r.role == "decode"],
                n_pages,
                digests,
            )
            pname = self.policy.pick_prefill(
                [r for r in self._states.values() if r.role == "prefill"],
                digests,
            )
            dh = self.policy.affinity_hits - h0
        if dh:
            self._metrics.inc("prefix_affinity_hits_total", dh)
        return name, pname, reason

    def _rehome(
        self, session: str, exclude: set, n_pages: int, ctx
    ) -> Tuple[Optional[Dict[str, Any]], str]:
        """Resume a drained session on a surviving decode replica.

        The draining replica exported the session's slot (prompt +
        every emitted token + its KV pages) to the shared spill
        directory before refusing further work; the router reads that
        bundle back and re-dispatches it through the NORMAL decode
        path — the survivor splices the pages and continues sampling
        from the exact KV state, so the resumed token stream cannot
        diverge. Returns (decode_reply, replica) or (None, "")."""
        if not (self.spill_dir and session):
            return None, ""
        data = load_session(self.spill_dir, session)
        if data is None:
            return None, ""
        with self._lock:
            fits = [
                r for r in self._states.values()
                if r.role == "decode" and r.name not in exclude
                and self.policy.decode_fits(r, n_pages)
            ]
            target = (
                min(fits, key=lambda r: (r.score(), r.name)).name
                if fits else ""
            )
        if not target:
            return None, ""
        dclient = next(c for c in self._decode if c.name == target)
        try:
            out = dclient.decode(data)
        except Exception:  # noqa: BLE001 — proxy boundary
            self._metrics.inc("proxy_errors_total")
            with self._lock:
                self._states[target].healthy = False
            return None, ""
        with self._lock:
            self._states[target].update(out, now=time.monotonic())
            self.policy.pin_session(session, target)
        drop_session(self.spill_dir, session)
        self._metrics.inc("session_rehomes_total")
        self._events.emit(
            "router_rehome", session=session, replica=target,
            pages=n_pages, trace=ctx.trace_id,
        )
        return out, target

    def _piggyback(
        self,
        pig: str,
        prompt: List[int],
        max_new: int,
        ctx,
        tenant: str,
        session: str,
        queue_s: float,
        admit_s: float,
        n_pages: int,
        trace_hdr: tuple,
        t0: float,
    ) -> Tuple[int, dict, tuple]:
        """Forward a RAW prompt to decode replica ``pig`` (one RPC
        does prefill-by-chunks + decode in place). TTFT decomposes
        additively from the replica's self-reported chunk timings:
        ``first_flush_s = prefill_queue_s + prefill_s`` by
        construction, so

            ttft = queue_wait + admit + prefill_queue_chunks
                 + prefill_compute
        """
        dclient = next(c for c in self._decode if c.name == pig)
        tp0 = time.perf_counter()
        resumed = False
        err = ""
        try:
            out = dclient.decode_raw(
                prompt, max_new, trace=ctx.wire(), session=session or None,
            )
        except Exception as e:  # noqa: BLE001 — proxy boundary
            self._metrics.inc("proxy_errors_total")
            with self._lock:
                self._states[pig].healthy = False
            out, err = None, f"{type(e).__name__}: {e}"
        if out is not None and out.get("drained"):
            with self._lock:
                self._states[pig].update(out, now=time.monotonic())
            # The drained reply names the session the replica actually
            # exported — prefer it for the spill-store lookup (the
            # replica's id is authoritative for its own bundle).
            session = str(out.get("session") or "") or session
            out, err = None, "decode replica draining"
        if out is None:
            # Same recovery as the splice path: the drained replica
            # exported this session's slot before exiting; a survivor
            # resumes it from the shared spill store.
            out, rname = self._rehome(session, {pig}, n_pages, ctx)
            if out is None:
                self.policy.forget_session(session)
                return 502, {"error": err}, trace_hdr
            pig, resumed = rname, True
        rpc_s = time.perf_counter() - tp0
        reqtrace.stage(
            self._tracer, ctx, "req_piggyback_rpc", rpc_s, replica=pig,
        )
        with self._lock:
            self._states[pig].update(out, now=time.monotonic())
            self.policy.pin_session(session, pig)
        pq_s = float(out.get("prefill_queue_s", 0.0))
        pf_s = float(out.get("prefill_s", 0.0))
        stages = {
            "queue_wait": round(queue_s, 6),
            "admit": round(admit_s, 6),
            "prefill_queue_chunks": round(pq_s, 6),
            "prefill_compute": round(pf_s, 6),
            # No migration happened: no splice, and the first token
            # is host-visible the moment the final chunk samples it.
            "splice": 0.0,
            "first_decode": round(float(out.get("first_flush_s", 0.0)), 6),
        }
        ttft = queue_s + admit_s + pq_s + pf_s
        latency = time.monotonic() - t0
        tokens = out.get("tokens") or []
        tok_s = (
            (latency - ttft) / (len(tokens) - 1)
            if len(tokens) > 1 else None
        )
        self.slo.observe(tenant, ttft, tok_s=tok_s, trace=ctx.trace_id)
        self._metrics.inc("requests_total")
        self._metrics.inc("piggyback_total")
        self._metrics.inc("request_seconds_total", latency)
        self._metrics.inc("tokens_total", len(tokens))
        self._events.emit(
            "router_request", tenant=tenant, replica=pig,
            latency_s=round(latency, 6),
            prefill_replica=pig, pages=n_pages, piggyback=True,
            prefill_chunks=int(out.get("prefill_chunks", 0)),
            trace=ctx.trace_id, ttft_s=round(ttft, 6),
            n_tokens=len(tokens), stages=stages,
        )
        return (
            200,
            {
                "tokens": tokens,
                "replica": pig,
                "prefill_replica": pig,
                "piggyback": bool(out.get("piggyback", True)),
                "migration_pages": 0,
                "trace": ctx.trace_id,
                "ttft_s": round(ttft, 6),
                "stages": stages,
                "resumed": resumed,
            },
            trace_hdr,
        )

    def generate(
        self, req: dict, trace_header: str = ""
    ) -> Tuple[int, dict, tuple]:
        """One request through WFQ → admission → prefill → migrate →
        decode. Returns (status, body, extra_headers).

        The request joins (or mints) a trace context from the
        X-TPUFW-Trace header and carries it through both hops; the
        router-observed TTFT is decomposed additively — each stage is
        a local duration, so no cross-process clock agreement is
        needed:

            ttft = queue_wait + admit + prefill_rtt + splice
            prefill_rtt = prefill_queue + prefill_admit
                        + prefill_compute + page_export + wire

        where ``wire`` is defined as the rpc wall minus the engine's
        self-reported wall (serialization + transport, by
        construction)."""
        t0 = time.monotonic()
        prompt = req.get("prompt")
        if not (
            isinstance(prompt, list)
            and prompt
            and all(isinstance(t, int) for t in prompt)
        ):
            return 400, {"error": "prompt must be a non-empty [int]"}, ()
        max_new = int(req.get("max_new", 16))
        tenant = str(req.get("tenant", "") or "default")
        session = str(req.get("session", "") or "")
        ctx = reqtrace.parse(trace_header or req.get("trace"))
        if ctx is None:
            ctx = reqtrace.mint(tenant)
        elif not ctx.tenant:
            ctx = reqtrace.TraceContext(
                ctx.trace_id, ctx.span_id, tenant, parent=ctx.parent
            )
        trace_hdr = ((reqtrace.HEADER, ctx.wire()),)
        n_pages = self.n_pages_for(len(prompt), max_new)
        # Prefix-affinity digests: torch-free, same page-granular
        # chunking as the replicas' radix tries, computed once per
        # request and matched against every pick's advertised set.
        digs = (
            chunk_digests(prompt, self.page, self.policy.affinity_k)
            if self.policy.affinity_k else ()
        )
        cost = len(prompt) + max_new
        tq0 = time.perf_counter()
        if not self._admit(tenant, cost, timeout=600.0):
            return 503, {"error": "queue wait timed out"}, trace_hdr
        try:
            # Everything after a granted credit runs under the
            # release-guaranteeing try: a raise in even the trace
            # plumbing would otherwise strand the inflight slot and
            # shrink the router's effective cap forever (TPU019).
            queue_s = time.perf_counter() - tq0
            reqtrace.stage(
                self._tracer, ctx, "req_queue_wait", queue_s,
                role="router",
            )
            ta0 = time.perf_counter()
            self._reprobe_unhealthy()
            name, pname, reason = self._pick(session, n_pages, digs)
            if name is None or pname is None:
                # Everything pickable may just be marked unhealthy
                # from a transient failure — force a probe and retry
                # once before turning traffic away.
                self._reprobe_unhealthy(force=True)
                name, pname, reason = self._pick(session, n_pages, digs)
            admit_s = time.perf_counter() - ta0
            if name is None:
                # Tenant-labeled so rejected load attributes per
                # tenant in the capacity curves — a 429 is offered
                # load the SLO did not serve.
                self._metrics.inc("rejects_total", tenant=tenant)
                self._events.emit(
                    "router_reject", tenant=tenant, reason=reason,
                    trace=ctx.trace_id,
                )
                return (
                    429,
                    {"error": f"decode pools {reason}; retry later"},
                    (("Retry-After", str(self.policy.retry_after_s)),)
                    + trace_hdr,
                )
            # Prefill/decode fungibility: when no prefill replica is
            # healthy, or the best one is already busy chunking other
            # prompts (load skew), steer the raw prompt straight at a
            # decode replica with spare chunk capacity — it prefills
            # chunk-by-chunk inside its own decode passes, skipping
            # the migration hop entirely.
            pig = None
            with self._lock:
                h0 = self.policy.affinity_hits
                pstate = self._states.get(pname) if pname else None
                if pname is None or (
                    pstate is not None and pstate.prefill_inflight > 0
                ):
                    pig = self.policy.pick_piggyback(
                        [
                            r for r in self._states.values()
                            if r.role == "decode"
                        ],
                        n_pages,
                        max_chunks=None if pname is None else 1,
                        digests=digs,
                    )
                dh = self.policy.affinity_hits - h0
            if dh:
                self._metrics.inc("prefix_affinity_hits_total", dh)
            if pig is not None:
                return self._piggyback(
                    pig, prompt, max_new, ctx, tenant, session,
                    queue_s, admit_s, n_pages, trace_hdr, t0,
                )
            if pname is None:
                self._metrics.inc("rejects_total", tenant=tenant)
                self._events.emit(
                    "router_reject", tenant=tenant, reason="no_prefill",
                    trace=ctx.trace_id,
                )
                return (
                    503, {"error": "no healthy prefill replica"},
                    trace_hdr,
                )
            reqtrace.stage(
                self._tracer, ctx, "req_admit", admit_s,
                replica=name, prefill_replica=pname,
            )
            pclient = next(c for c in self._prefill if c.name == pname)
            dclient = next(c for c in self._decode if c.name == name)
            # Mark the replica whose call actually raised — blaming
            # the decode replica for a prefill failure takes a healthy
            # replica out of rotation while the broken one keeps
            # receiving traffic.
            tp0 = time.perf_counter()
            # Router-observed prefill occupancy: prefill replies are
            # raw bundles (no signals piggyback like decode replies),
            # so a healthy replica's advertised prefill_inflight is
            # the startup-probe snapshot forever. The router counts
            # its own outstanding RPCs instead — that is exactly the
            # "busy chunking other prompts" signal the piggyback
            # steering and score() need, and it is live.
            with self._lock:
                self._states[pname].prefill_inflight += 1
            try:
                bundle = pclient.prefill(
                    prompt, max_new, trace=ctx.wire(),
                    session=session or None,
                )
            except Exception as e:  # noqa: BLE001 — proxy boundary
                self._metrics.inc("proxy_errors_total")
                with self._lock:
                    self._states[pname].healthy = False
                return 502, {"error": f"{type(e).__name__}: {e}"}, trace_hdr
            finally:
                with self._lock:
                    pst = self._states.get(pname)
                    if pst is not None:
                        pst.prefill_inflight = max(
                            0, pst.prefill_inflight - 1
                        )
            prefill_rtt = time.perf_counter() - tp0
            reqtrace.stage(
                self._tracer, ctx, "req_prefill_rpc", prefill_rtt,
                replica=pname,
            )
            stages: Dict[str, float] = {
                "queue_wait": round(queue_s, 6),
                "admit": round(admit_s, 6),
            }
            tmeta = peek_trace(bundle)
            engine_stages = (tmeta or {}).get("stages") or {}
            if engine_stages:
                for src, dst in (
                    ("queue", "prefill_queue"),
                    ("admit", "prefill_admit"),
                    ("compute", "prefill_compute"),
                    ("export", "page_export"),
                ):
                    stages[dst] = round(float(engine_stages.get(src, 0.0)), 6)
                if "queue_chunks" in engine_stages:
                    # Chunked prefill engine: time spent BETWEEN
                    # chunks (lock re-acquires + arena stalls) is its
                    # own TTFT term, so prefill_queue keeps meaning
                    # the FIRST lock wait. Additivity holds — the
                    # engine's wall_s is the literal five-stage sum.
                    stages["prefill_queue_chunks"] = round(
                        float(engine_stages["queue_chunks"]), 6
                    )
                wire_s = max(
                    0.0, prefill_rtt - float((tmeta or {}).get("wall_s", 0.0))
                )
            else:
                # Pre-trace prefill peer: no decomposition, the whole
                # rtt is one stage and wire is indistinguishable.
                stages["prefill_compute"] = round(prefill_rtt, 6)
                wire_s = 0.0
            stages["wire"] = round(wire_s, 6)
            reqtrace.stage(self._tracer, ctx, "req_wire", wire_s)
            td0 = time.perf_counter()
            resumed = False
            err = ""
            try:
                out = dclient.decode(bundle)
            except Exception as e:  # noqa: BLE001 — proxy boundary
                self._metrics.inc("proxy_errors_total")
                with self._lock:
                    self._states[name].healthy = False
                out, err = None, f"{type(e).__name__}: {e}"
            if out is not None and out.get("drained"):
                # The replica drained (SIGTERM / scale-in) while this
                # request was decoding: its reply carries partial
                # tokens and its exported session sits in the spill
                # store. Fold its final signals in, then re-home —
                # under the session id the reply names (authoritative
                # for the replica's own export).
                with self._lock:
                    self._states[name].update(out, now=time.monotonic())
                session = str(out.get("session") or "") or session
                out, err = None, "decode replica draining"
            if out is None:
                out, rname = self._rehome(session, {name}, n_pages, ctx)
                if out is None:
                    self.policy.forget_session(session)
                    return 502, {"error": err}, trace_hdr
                name, resumed = rname, True
            decode_rtt = time.perf_counter() - td0
            reqtrace.stage(
                self._tracer, ctx, "req_decode_rpc", decode_rtt,
                replica=name,
            )
            with self._lock:
                self._states[name].update(out, now=time.monotonic())
            splice_s = float(out.get("splice_s", 0.0))
            stages["splice"] = round(splice_s, 6)
            stages["first_decode"] = round(
                float(out.get("first_flush_s", 0.0)), 6
            )
            # First token usable on the decode side = the splice
            # landing; decode chunks after that are steady-state.
            ttft = queue_s + admit_s + prefill_rtt + splice_s
            latency = time.monotonic() - t0
            tokens = out["tokens"]
            tok_s = (
                (latency - ttft) / (len(tokens) - 1)
                if len(tokens) > 1 else None
            )
            self.slo.observe(
                tenant, ttft, tok_s=tok_s, trace=ctx.trace_id
            )
            self._metrics.inc("requests_total")
            self._metrics.inc("request_seconds_total", latency)
            self._metrics.inc("tokens_total", len(tokens))
            self._events.emit(
                "router_request", tenant=tenant, replica=name,
                latency_s=round(latency, 6),
                prefill_replica=pname, pages=n_pages,
                trace=ctx.trace_id, ttft_s=round(ttft, 6),
                n_tokens=len(tokens), stages=stages,
            )
            return (
                200,
                {
                    "tokens": tokens,
                    "replica": name,
                    "prefill_replica": pname,
                    "migration_pages": n_pages,
                    "trace": ctx.trace_id,
                    "ttft_s": round(ttft, 6),
                    "stages": stages,
                    "resumed": resumed,
                },
                trace_hdr,
            )
        finally:
            self._release()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


# --------------------------------------------------- role entrypoint

def _parse_weights(spec: str) -> Dict[str, float]:
    """"tenant:weight,tenant:weight" → dict; malformed entries are
    skipped (a bad knob must not take the front door down)."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, w = part.rpartition(":")
        try:
            out[name.strip()] = float(w)
        except ValueError:
            continue
    return out


def _parse_addrs(spec: str) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def main_router() -> int:
    """Container entrypoint for TPUFW_SERVE_ROLE=router. Replica
    addresses come from the discovery contract (explicit env lists or
    JobSet DNS — tpufw_torch.cluster.discovery)."""
    import os

    from tpufw_torch.cluster.discovery import discover_replicas

    if env_float("fleet_scrape_s", 0.0) > 0:
        raise NotImplementedError(
            "TPUFW_FLEET_SCRAPE_S: the fleet observatory is not ported to "
            "tpufw_torch yet (ROADMAP.md Queue 1 item 13)"
        )
    prefill_addrs, decode_addrs = discover_replicas()
    prefill = [
        TcpReplica(f"prefill-{i}", h, p, "prefill")
        for i, (h, p) in enumerate(prefill_addrs)
    ]
    decode = [
        TcpReplica(f"decode-{i}", h, p, "decode")
        for i, (h, p) in enumerate(decode_addrs)
    ]
    policy = RouterPolicy(
        tenant_weights=_parse_weights(
            env_str("router_tenant_weights", "")
        ),
        saturation=env_float("router_saturation", 0.95),
        retry_after_s=env_int("router_retry_after_s", 5),
        affinity_k=env_int("router_prefix_affinity", 0),
    )
    events = obs_events.NULL
    tracer = obs_trace.NULL
    tdir = env_str("telemetry_dir", "")
    if tdir:
        os.makedirs(tdir, exist_ok=True)
        events = obs_events.EventLog(
            os.path.join(tdir, "events-router.jsonl")
        )
        tracer = obs_trace.Tracer(
            os.path.join(tdir, "trace-router.json"),
            process_name="router", max_events=200_000,
        )
    server = RouterServer(
        prefill,
        decode,
        policy=policy,
        port=env_int("router_port", DEFAULT_ROUTER_PORT),
        page=env_int("serve_page", 16),
        max_inflight=env_int("router_inflight", 4),
        events=events,
        tracer=tracer,
        spill_dir=env_str("kv_spill_dir", ""),
    )
    print(json.dumps(
        {
            "serving_role": "router",
            "port": server.port,
            "prefill": len(prefill),
            "decode": len(decode),
        }
    ), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.close()
        tracer.close()
        events.close()
    return 0
