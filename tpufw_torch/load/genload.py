"""Deterministic traffic-replay generation for the load observatory (a
copy of ``tpufw.load.genload``).

Everything the serving stack gets judged against starts here: a
seeded, fully deterministic **offered-load schedule** — who asks,
when, with what prompt — that a thread-pool replay client then drives
through the router's real HTTP surface. Determinism is the whole
point: the same ``MixConfig`` (seed included) produces a byte-
identical arrival schedule and prompt set on every machine, so two
bench rungs, or the same rung before and after a code change, compare
A/B on *identical* traffic instead of on two different draws from the
same distribution.

The generator models the traffic shapes production LLM serving
actually sees:

- **arrival processes** — open-loop (arrivals do not wait for
  completions, so an overloaded server falls behind instead of
  silently throttling the benchmark): homogeneous Poisson, a
  two-state MMPP (Markov-modulated Poisson — calm/burst regimes with
  exponential dwell times), and a compressed diurnal envelope (one
  "day" of sinusoidal rate modulation squeezed into the run, sampled
  by thinning);
- **heavy-tailed lengths** — bounded Pareto prompt and output
  lengths (most requests short, a fat tail of long ones — the mix
  that makes naive FCFS scheduling fall over);
- **prefix sharing** — a configurable fraction of prompts open with
  one of a small pool of shared system-prompt prefixes, page-aligned
  so the radix tries and affinity router downstream see real reuse;
- **multi-tenant weight mixes** — tenants drawn by weight, so SLO
  attainment curves decompose per tenant;
- **sticky multi-turn sessions** — a fraction of requests continue
  an open session (same ``session`` id, previous turn's prompt
  extended), exercising the router's session→replica affinity.

The ``ReplayClient`` half records every request's lifecycle —
offered time, send, first token, done — as one schema'd record in
``load-trace.jsonl`` (``LOAD_TRACE_REQUIRED`` below; the reader is
torn-tolerant like every JSONL reader here). Stdlib only, like the
router it drives: the same ``MixConfig`` gives the same schedule, and
the same ``schedule_digest``, in either package.
"""

# http: claims

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpufw_torch.workloads.env import env_float, env_int, env_str

#: Arrival processes ``MixConfig.process`` accepts.
ARRIVAL_PROCESSES = ("poisson", "mmpp", "diurnal")

#: Fields every load-trace record must carry (envelope included).
#: Extra fields (stages, trace, replica, error, ...) are allowed —
#: floor, not ceiling, same contract as the event log's SCHEMA.
LOAD_TRACE_REQUIRED = frozenset(
    {
        "ts_offered",
        "ts_sent",
        "ts_done",
        "tenant",
        "status",
        "rung",
        "offered_rps",
        "n_prompt",
        "max_new",
    }
)


def parse_tenant_weights(spec: str) -> Tuple[Tuple[str, float], ...]:
    """``"vip:3,batch:1"`` -> (("vip", 3.0), ("batch", 1.0)).
    Malformed entries are skipped (bad knob ≠ dead harness)."""
    out: List[Tuple[str, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.rpartition(":")
        if not sep:
            out.append((part, 1.0))
            continue
        try:
            out.append((name.strip(), float(w)))
        except ValueError:
            continue
    return tuple(out) or (("default", 1.0),)


@dataclasses.dataclass(frozen=True)
class MixConfig:
    """One reproducible traffic mix. Frozen: the config IS the
    traffic — hash it, log it, replay it."""

    seed: int = 0
    process: str = "poisson"  # poisson | mmpp | diurnal
    rate_rps: float = 4.0
    duration_s: float = 10.0
    #: (tenant, weight) pairs — tuple-of-tuples so the config stays
    #: hashable/frozen; order matters for determinism.
    tenants: Tuple[Tuple[str, float], ...] = (("default", 1.0),)
    #: Bounded-Pareto prompt lengths: len = min(cap, base * pareto(α)).
    prompt_len_base: int = 24
    prompt_len_alpha: float = 2.2
    prompt_len_cap: int = 96
    max_new_base: int = 6
    max_new_alpha: float = 2.2
    max_new_cap: int = 24
    vocab: int = 256
    #: Fraction of prompts opening with a shared prefix, drawn from a
    #: pool of ``n_prefixes`` fixed ``prefix_len``-token prefixes.
    prefix_ratio: float = 0.5
    prefix_len: int = 32
    n_prefixes: int = 4
    #: Fraction of requests that ride a sticky multi-turn session.
    session_ratio: float = 0.25
    session_turns: int = 3
    # MMPP: burst-state rate multiplier and mean state dwell time.
    mmpp_burst_factor: float = 6.0
    mmpp_dwell_s: float = 2.0
    # Diurnal: rate(t) = rate_rps * (1 + amp * sin(2πt/duration)).
    diurnal_amplitude: float = 0.8

    def __post_init__(self) -> None:
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r} "
                f"(one of {ARRIVAL_PROCESSES})"
            )
        if self.rate_rps <= 0 or self.duration_s <= 0:
            raise ValueError("rate_rps and duration_s must be > 0")

    @classmethod
    def from_env(cls) -> "MixConfig":
        """Build from the TPUFW_LOAD_* knobs (docs/ENV.md)."""
        return cls(
            seed=env_int("load_seed", 0),
            process=env_str("load_process", "poisson"),
            rate_rps=env_float("load_rate_rps", 4.0),
            duration_s=env_float("load_duration_s", 10.0),
            tenants=parse_tenant_weights(
                env_str("load_tenants", "default:1")
            ),
            prefix_ratio=env_float("load_prefix_ratio", 0.5),
            session_ratio=env_float("load_session_ratio", 0.25),
        )


@dataclasses.dataclass(frozen=True)
class Offered:
    """One offered request: WHEN (seconds from schedule start), WHO,
    and WHAT. ``session`` is "" for one-shot requests."""

    t: float
    tenant: str
    session: str
    prompt: Tuple[int, ...]
    max_new: int


# ------------------------------------------------- arrival processes


def _arrivals(cfg: MixConfig, rng: random.Random) -> List[float]:
    """Offered-time offsets in [0, duration_s), per ``cfg.process``.
    Open-loop by construction: times depend only on the seed, never
    on service behavior."""
    out: List[float] = []
    if cfg.process == "poisson":
        t = rng.expovariate(cfg.rate_rps)
        while t < cfg.duration_s:
            out.append(t)
            t += rng.expovariate(cfg.rate_rps)
        return out
    if cfg.process == "mmpp":
        # Two-state MMPP: exponential dwell in each state; arrivals
        # within a state are Poisson at that state's rate. The
        # exponential's memorylessness makes "re-draw at the state
        # boundary" exact, not an approximation.
        t, burst = 0.0, False
        state_end = rng.expovariate(1.0 / cfg.mmpp_dwell_s)
        while t < cfg.duration_s:
            rate = cfg.rate_rps * (
                cfg.mmpp_burst_factor if burst else 1.0
            )
            nxt = t + rng.expovariate(rate)
            if nxt >= state_end:
                t, burst = state_end, not burst
                state_end = t + rng.expovariate(1.0 / cfg.mmpp_dwell_s)
                continue
            t = nxt
            if t < cfg.duration_s:
                out.append(t)
        return out
    # diurnal: nonhomogeneous Poisson by thinning against the
    # envelope's peak rate — one compressed "day" per run.
    amp = max(0.0, min(1.0, cfg.diurnal_amplitude))
    peak = cfg.rate_rps * (1.0 + amp)
    t = rng.expovariate(peak)
    while t < cfg.duration_s:
        envelope = cfg.rate_rps * (
            1.0 + amp * math.sin(2.0 * math.pi * t / cfg.duration_s)
        )
        if rng.random() < envelope / peak:
            out.append(t)
        t += rng.expovariate(peak)
    return out


# --------------------------------------------------- prompt assembly


class _SessionBook:
    """Open sticky sessions per tenant. A continued turn reuses the
    session id and extends the previous turn's prompt — the shape the
    router's session affinity and the KV fabric's re-home path are
    built for."""

    def __init__(self, turns: int):
        self._turns = max(1, turns)
        self._open: Dict[str, List[Tuple[str, int, Tuple[int, ...]]]] = {}
        self._seq = 0

    def next_turn(
        self,
        tenant: str,
        rng: random.Random,
        fresh_prompt: Tuple[int, ...],
        vocab: int,
        cap: int,
    ) -> Tuple[str, Tuple[int, ...]]:
        book = self._open.setdefault(tenant, [])
        if book and rng.random() < 0.7:
            i = rng.randrange(len(book))
            sid, left, prior = book[i]
            grown = prior + tuple(
                rng.randrange(1, vocab) for _ in range(4)
            )
            grown = grown[:cap]
            if left <= 1:
                book.pop(i)
            else:
                book[i] = (sid, left - 1, grown)
            return sid, grown
        self._seq += 1
        sid = f"s-{tenant}-{self._seq}"
        book.append((sid, self._turns - 1, fresh_prompt))
        return sid, fresh_prompt


def _bounded_pareto(
    rng: random.Random, base: int, alpha: float, cap: int
) -> int:
    return max(1, min(cap, int(base * rng.paretovariate(alpha))))


def schedule(cfg: MixConfig) -> List[Offered]:
    """The deterministic offered-load schedule for ``cfg``. One
    ``random.Random(seed)`` consumed in a fixed order: same config ⇒
    byte-identical schedule (see ``schedule_digest``)."""
    rng = random.Random(cfg.seed)
    prefixes = [
        tuple(
            rng.randrange(1, cfg.vocab) for _ in range(cfg.prefix_len)
        )
        for _ in range(max(1, cfg.n_prefixes))
    ]
    names = [t for t, _w in cfg.tenants]
    weights = [max(1e-9, w) for _t, w in cfg.tenants]
    total_w = sum(weights)
    cum: List[float] = []
    acc = 0.0
    for w in weights:
        acc += w / total_w
        cum.append(acc)
    sessions = _SessionBook(cfg.session_turns)
    out: List[Offered] = []
    for t in _arrivals(cfg, rng):
        u = rng.random()
        tenant = names[-1]
        for i, edge in enumerate(cum):
            if u <= edge:
                tenant = names[i]
                break
        n_prompt = _bounded_pareto(
            rng, cfg.prompt_len_base, cfg.prompt_len_alpha,
            cfg.prompt_len_cap,
        )
        body = tuple(
            rng.randrange(1, cfg.vocab) for _ in range(n_prompt)
        )
        if rng.random() < cfg.prefix_ratio:
            pfx = prefixes[rng.randrange(len(prefixes))]
            body = (pfx + body)[: cfg.prompt_len_cap]
        max_new = _bounded_pareto(
            rng, cfg.max_new_base, cfg.max_new_alpha, cfg.max_new_cap
        )
        session = ""
        if rng.random() < cfg.session_ratio:
            session, body = sessions.next_turn(
                tenant, rng, body, cfg.vocab, cfg.prompt_len_cap
            )
        out.append(
            Offered(
                t=round(t, 6),
                tenant=tenant,
                session=session,
                prompt=body,
                max_new=max_new,
            )
        )
    return out


def schedule_digest(reqs: Sequence[Offered]) -> str:
    """sha256 of the canonical JSON encoding — the replayability
    fingerprint two runs of the same config must agree on, and the
    one BENCH_load.json echoes so a regression bisect can prove both
    arms saw identical traffic."""
    blob = json.dumps(
        [dataclasses.asdict(r) for r in reqs], sort_keys=True
    ).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


# ------------------------------------------------------- trace file


def validate_trace_record(rec: dict) -> None:
    """Raise ValueError unless ``rec`` is a well-formed load-trace
    line — emit-side validation, same stance as the event log."""
    missing = LOAD_TRACE_REQUIRED - rec.keys()
    if missing:
        raise ValueError(
            f"load-trace record missing fields {sorted(missing)}"
        )


def read_trace(path: str) -> List[dict]:
    """Parse ``load-trace.jsonl`` back into dicts. Torn-tolerant: a
    replay killed mid-write must not take the digest with it —
    unparseable or schema-short lines are dropped, whatever parses
    flows through."""
    out: List[dict] = []
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail on an unclean shutdown
            if (
                isinstance(rec, dict)
                and not (LOAD_TRACE_REQUIRED - rec.keys())
            ):
                out.append(rec)
    return out


class TraceWriter:
    """Append-only, schema-validating ``load-trace.jsonl`` writer.
    Thread-safe — worker threads record completions concurrently —
    and flushed per record so a SIGKILLed sweep keeps everything but
    its torn final line."""

    def __init__(self, path: str):
        # resource: acquires file-handle
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: Optional[io.TextIOWrapper] = open(  # noqa: SIM115
            path, "a", encoding="utf-8"
        )

    def append(self, rec: dict) -> None:
        validate_trace_record(rec)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        # resource: releases file-handle
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ----------------------------------------------------- replay client


class ReplayClient:
    """Drives an offered-load schedule through a router's real HTTP
    surface from a thread pool, open-loop: the dispatcher sleeps to
    each request's offered time and hands it to a worker regardless
    of how far behind the server is. Every request becomes one
    load-trace record."""

    def __init__(
        self,
        base_url: str,
        trace: Optional[TraceWriter] = None,
        *,
        threads: int = 8,
        timeout_s: float = 120.0,
        rung: int = 0,
        offered_rps: float = 0.0,
    ):
        self.base = base_url.rstrip("/")
        self.trace = trace
        self.threads = max(1, int(threads))
        self.timeout_s = float(timeout_s)
        self.rung = int(rung)
        self.offered_rps = float(offered_rps)
        self.records: List[dict] = []
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, base_url: str, **kw) -> "ReplayClient":
        kw.setdefault("threads", env_int("load_threads", 8))
        return cls(base_url, **kw)

    def _one(self, r: Offered, t0_wall: float, t0_mono: float) -> dict:
        # The offered instant is schedule-relative; the dispatcher
        # already slept to it, so "sent" is now.
        ts_offered = round(t0_wall + r.t, 6)
        ts_sent = round(t0_wall + (time.monotonic() - t0_mono), 6)
        body = {
            "prompt": list(r.prompt),
            "max_new": r.max_new,
            "tenant": r.tenant,
        }
        if r.session:
            body["session"] = r.session
        req = urllib.request.Request(
            self.base + "/generate",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        reply: Dict[str, Any] = {}
        error = ""
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout_s
            ) as resp:
                status = resp.status
                reply = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            status = e.code
            try:
                reply = json.loads(e.read().decode("utf-8"))
            except (ValueError, OSError):
                reply = {}
            error = str(reply.get("error", ""))
        except (urllib.error.URLError, OSError, ValueError) as e:
            status = 0
            error = f"{type(e).__name__}: {e}"
        ts_done = round(t0_wall + (time.monotonic() - t0_mono), 6)
        rec: Dict[str, Any] = {
            "ts_offered": ts_offered,
            "ts_sent": ts_sent,
            "ts_done": ts_done,
            "tenant": r.tenant,
            "status": status,
            "rung": self.rung,
            "offered_rps": self.offered_rps,
            "n_prompt": len(r.prompt),
            "max_new": r.max_new,
        }
        if r.session:
            rec["session"] = r.session
        if status == 200:
            ttft = reply.get("ttft_s")
            tokens = reply.get("tokens") or []
            rec["n_tokens"] = len(tokens)
            rec["latency_s"] = round(ts_done - ts_sent, 6)
            if isinstance(ttft, (int, float)):
                rec["ttft_s"] = round(float(ttft), 6)
                # First token is router-observed (this client is not
                # streaming); per-token pace derives from the rest.
                rec["ts_first_token"] = round(ts_sent + float(ttft), 6)
                if len(tokens) > 1:
                    rec["tok_s"] = round(
                        (ts_done - ts_sent - float(ttft))
                        / (len(tokens) - 1),
                        6,
                    )
            if isinstance(reply.get("stages"), dict):
                rec["stages"] = reply["stages"]
            if reply.get("trace"):
                rec["trace"] = str(reply["trace"])
            if reply.get("replica"):
                rec["replica"] = str(reply["replica"])
        elif status == 429:
            rec["reason"] = "rejected"
        if error:
            rec["error"] = error
        if self.trace is not None:
            self.trace.append(rec)
        with self._lock:
            self.records.append(rec)
        return rec

    def run(self, reqs: Sequence[Offered]) -> dict:
        """Replay ``reqs`` (schedule order) open-loop; returns a
        summary dict. Blocks until every in-flight request lands."""
        t0_wall = time.time()
        t0_mono = time.monotonic()
        with ThreadPoolExecutor(max_workers=self.threads) as pool:
            futures = []
            for r in reqs:
                delay = r.t - (time.monotonic() - t0_mono)
                if delay > 0:
                    time.sleep(delay)
                futures.append(
                    pool.submit(self._one, r, t0_wall, t0_mono)
                )
            for fut in futures:
                fut.result()
        wall = time.monotonic() - t0_mono
        with self._lock:
            recs = list(self.records)
        completed = sum(1 for r in recs if r["status"] == 200)
        rejected = sum(1 for r in recs if r["status"] == 429)
        return {
            "offered": len(reqs),
            "completed": completed,
            "rejected": rejected,
            "errors": len(recs) - completed - rejected,
            "wall_s": round(wall, 6),
        }
