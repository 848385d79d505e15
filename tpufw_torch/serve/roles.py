"""Prefill / decode replica roles for disaggregated serving (port of
``tpufw.serve.roles``).

Prefill is compute-bound and bursty, decode is memory-bound and steady,
so each role gets its own device and its own page arena. The handoff is
the paged pool's arena made literal:

- :class:`PrefillEngine` runs admission (prefix-trie attach plus a suffix
  prefill, or a cold ``prefill_row``) on its replica, scatters the row
  into its arena, then EXPORTS the slot's pages (int8 codes and their
  fp32 scales raw) as a page bundle and releases the slot. Its prefix
  trie persists across requests, so shared prompts still prefill once
  per replica.
- :class:`DecodeEngine` imports bundles by allocating pages from its own
  arena and splicing them into its ``PagedSlotPool`` table. The page
  table hides the physical ids, so greedy decode is bit-equal to a
  never-migrated run of the same pool.

Unlike ``tpufw``, a pool here needs no model of its own: the cache owns
its paging (``Llama.init_paged_cache``, ``Deepseek.init_paged_cache``
for the latent arenas), so one set of weights serves the prefill and
decode arenas of a process.

Random streams follow the port's slot scheduler
(``workloads.serve.stream_generator``): a prefill draws from
(seed, 0, job index), a decode chunk from (seed, 1, chunk index), and the
decode chunk length follows the scheduler's pow-2 ladder, so a request
served alone draws the stream the single-process scheduler would draw.
Greedy pools draw nothing.

The module imports no torch at import time (the router's package loads
it); every device call imports what it needs.

``main_role`` is the container entry point behind ``TPUFW_SERVE_ROLE``:
a framed-TCP server per engine (``TPUFW_SERVE_PEER_PORT``, 8477), or the
router's HTTP front end for the router role. The engines read the
monolithic server's knobs: ``TPUFW_SERVE_PAGE`` (16),
``TPUFW_SERVE_KV_QUANT``, ``TPUFW_SERVE_SLOTS`` (8), ``TPUFW_SEED``,
``TPUFW_SERVE_PREFILL_CHUNK``, ``TPUFW_KV_SPILL`` and
``TPUFW_KV_SPILL_DIR`` (the spill tier, and the session store a draining
decode replica writes), ``TPUFW_ROUTER_PREFIX_AFFINITY`` (the digest
depth advertised to the router), ``TPUFW_TELEMETRY_DIR`` (per-role event
log and trace), and for decode ``TPUFW_SERVE_CHUNK`` (default
``TPUFW_STREAM_CHUNK``, 16), ``TPUFW_SERVE_SPEC_K``,
``TPUFW_SERVE_SPEC_MIN_ACCEPT`` (0.25), ``TPUFW_SERVE_PIGGYBACK`` and
``TPUFW_SERVE_DRAIN_GRACE_S`` (5).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from tpufw_torch.obs import events as obs_events
from tpufw_torch.obs import reqtrace
from tpufw_torch.obs import trace as obs_trace
from tpufw_torch.serve import transport
from tpufw_torch.serve.bundle import (
    BundleError,
    advertised_digests,
    attach_spill,
    decode_bundle,
    encode_bundle,
)
from tpufw_torch.workloads.env import (
    env_float,
    env_int,
    env_opt_str,
    env_str,
)

DEFAULT_PEER_PORT = 8477
ROLES = ("prefill", "decode", "router")


def _paged_pool(model, *, n_slots, page, kv_quant, arena_pages, sampling,
                eos_id, prefix_cache):
    """A ``PagedSlotPool`` over ``model``'s weights at its full sequence
    length, with an arena of ``arena_pages`` pages (default: every slot's
    full row plus the reserved page 0)."""
    from tpufw_torch.infer.pages import PagedSlotPool

    cache_len = int(model.cfg.max_seq_len)
    if page <= 0 or cache_len % page:
        raise ValueError(
            f"page={page} must be > 0 and divide max_seq_len={cache_len}"
        )
    return PagedSlotPool.create_paged(
        model, n_slots, cache_len=cache_len, page=page,
        n_pages=arena_pages or n_slots * (cache_len // page) + 1,
        kv_quant=kv_quant, sampling=sampling, eos_id=eos_id,
        prefix_cache=prefix_cache,
    )


def _stream(pool, seed_base: int, stream: int, index: int):
    """The scheduler's generator for (stream, index), or None for a
    greedy pool."""
    if not pool.sampling.temperature:
        return None
    from tpufw_torch.workloads.serve import stream_generator

    return stream_generator(pool.model.device, seed_base, stream, index)


class _ChunkTicket:
    """One in-flight chunked prefill's place in the turn queue.
    Identity-compared on purpose (no ``__eq__``): two prompts with equal
    remaining work are still distinct tickets."""

    __slots__ = ("remaining", "seq", "blocked")

    def __init__(self, remaining: int, seq: int):
        self.remaining = remaining
        self.seq = seq
        #: set while this prefill is arena-stalled, so peers that CAN
        #: make progress are not held behind it.
        self.blocked = False


def _fabric_signals(sig: Dict[str, Any], pool, spill) -> None:
    """KV-fabric numbers shared by both roles' ``signals()``: trie hit
    counters and spill-tier sizes plus lifetime totals."""
    if pool.prefix is not None:
        sig["prefix_hits"] = pool.prefix_hits
        sig["prefix_misses"] = pool.prefix_misses
    if spill is not None:
        st = spill.stats()
        sig["spill_ram_pages"] = st["ram_pages"]
        sig["spill_dir_pages"] = st["dir_pages"]
        sig["spill_pages_total"] = st["spilled_pages_total"]
        sig["spill_restored_total"] = st["restored_total"]


class PrefillEngine:
    """One prefill replica: admission + prefix cache + page export.

    Slots are transient here (a slot lives from insert to export and
    release), so the arena is sized for in-flight admissions plus what
    the prefix trie holds, not for decode residency."""

    def __init__(
        self,
        model,
        *,
        sampling,
        page: int,
        kv_quant: str = "",
        n_slots: int = 2,
        arena_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        seed_base: int = 0,
        prefix_cache: bool = True,
        prefill_chunk_pages: int = 0,
        spill=None,
        affinity_k: int = 0,
        events=None,
        tracer=None,
    ):
        self.pool = _paged_pool(
            model, n_slots=n_slots, page=page, kv_quant=kv_quant,
            arena_pages=arena_pages, sampling=sampling, eos_id=eos_id,
            prefix_cache=prefix_cache,
        )
        self.page = page
        self.n_slots = n_slots
        self._eos = eos_id
        self._seed_base = seed_base
        self._job_index = 0
        self._events = events if events is not None else obs_events.NULL
        self._tracer = tracer if tracer is not None else obs_trace.NULL
        # KV fabric: host spill tier behind the trie, and the digest set
        # the router's affinity steering reads.
        self._spill = spill
        self._affinity_k = max(0, int(affinity_k))
        self._digest_cache: Dict[str, Any] = {}
        if spill is not None:
            attach_spill(self.pool, spill)
        self._lock = threading.Lock()
        # Chunked mode: the engine lock is RELEASED between chunks and
        # around each chunk's device call, so concurrent admissions
        # interleave at chunk granularity. The condition wakes stalled
        # chunk loops when a finalize or an abandon returns pages.
        self.prefill_chunk_pages = max(0, int(prefill_chunk_pages))
        self._cv = threading.Condition(self._lock)
        #: pages promised to in-flight chunked admissions; admission
        #: blocks while the sum would pass the arena, so every admitted
        #: prefill can finish.
        self._reserved = 0
        #: chunk-turn tickets, scheduled shortest remaining prompt first
        #: (admission order on ties).
        self._rr: List[_ChunkTicket] = []
        #: True while a chunk_step runs with the mutex released: one
        #: chunk computes at a time.
        self._chunk_busy = False
        self.prefill_inflight = 0
        self.prefill_chunks = 0
        self.prefill_resumes = 0
        self.migrations = 0
        self.migration_bytes = 0

    def signals(self) -> Dict[str, Any]:
        a = self.pool.allocator
        sig = {
            "role": "prefill",
            "pages_total": a.capacity,
            "pages_in_use": a.in_use,
            "migrations": self.migrations,
        }
        if self.prefill_chunk_pages:
            sig["prefill_chunk_pages"] = self.prefill_chunk_pages
            sig["prefill_inflight"] = self.prefill_inflight
            sig["prefill_chunks"] = self.prefill_chunks
        _fabric_signals(sig, self.pool, self._spill)
        if self._affinity_k:
            sig["prefix_digests"] = advertised_digests(
                self.pool, self._spill, self._affinity_k,
                self._digest_cache,
            )
        return sig

    def _seal(self, state, stages, ctx, prompt, session) -> bytes:
        """Stage timings, trace context, prompt ids and session id into
        the bundle header (before encode: the encode and framing
        remainder shows up as the router's "wire" stage), then encode."""
        tmeta: Dict[str, Any] = {
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "wall_s": round(sum(stages.values()), 6),
        }
        if ctx is not None:
            tmeta.update(ctx.meta())
        state["trace"] = tmeta
        # The prompt ids: a speculative decode replica mines its n-gram
        # proposals from them.
        state["prompt"] = [int(t) for t in prompt]
        if session:
            # Sticky session id: the decode side carries it through drain
            # bundles so the router can re-home the session by name.
            state["session"] = str(session)
        data = encode_bundle(state)
        self.migrations += 1
        self.migration_bytes += len(data)
        return data

    def _report(self, ctx, stages, n_pages, n_bytes, t0, shared_n,
                n_prompt, n_chunks=None) -> None:
        reqtrace.stage(self._tracer, ctx, "req_queue_wait", stages["queue"],
                       role="prefill")
        reqtrace.stage(self._tracer, ctx, "req_admit", stages["admit"],
                       role="prefill", shared_pages=shared_n)
        if n_chunks is not None:
            reqtrace.stage(self._tracer, ctx, "req_queue_chunks",
                           stages["queue_chunks"], role="prefill",
                           chunks=n_chunks)
        reqtrace.stage(self._tracer, ctx, "req_prefill_compute",
                       stages["compute"], prompt_tokens=n_prompt)
        reqtrace.stage(self._tracer, ctx, "req_page_export",
                       stages["export"], pages=n_pages)
        fields = dict(
            pages=n_pages, bytes=n_bytes,
            wall_s=round(time.monotonic() - t0, 6),
            direction="export", shared_pages=shared_n,
        )
        if ctx is not None:
            fields["trace"] = ctx.trace_id
        self._events.emit("serve_migration", **fields)

    def prefill(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> bytes:
        """Admit one request, export its slot as a page bundle, free the
        slot. Returns the serialized bundle (the first sampled token
        rides inside it as the ``token`` cursor). Raises ValueError when
        the row can never fit this arena.

        ``trace`` is an optional request-trace context (wire string or
        TraceContext); the stage timings (queue: engine lock wait; admit:
        page grant + trie attach; compute; export) always ride in the
        bundle header, so the router can decompose its round trip."""
        import torch

        from tpufw_torch.infer.slots import prefill_row
        from tpufw_torch.workloads.serve import _PREFILL_STREAM

        if self.prefill_chunk_pages:
            return self._prefill_chunked(prompt, max_new, trace,
                                         session=session)
        ctx = reqtrace.parse(trace)
        ctx = ctx.child() if ctx is not None else None
        prompt = [int(t) for t in prompt]
        need = len(prompt) + max_new - 1
        if self.pool.n_pages_for(need) > self.pool.allocator.capacity:
            raise ValueError(
                f"prompt+budget needs {self.pool.n_pages_for(need)} "
                f"pages; arena capacity is {self.pool.allocator.capacity}"
            )
        t_req = time.perf_counter()
        with self._lock, torch.no_grad():
            t_lock = time.perf_counter()
            job_index = self._job_index
            self._job_index += 1
            gen = _stream(self.pool, self._seed_base, _PREFILL_STREAM,
                          job_index)
            t0 = time.monotonic()
            grant = self.pool.acquire_pages(prompt, need)
            if grant is None:
                raise RuntimeError(
                    "prefill arena exhausted — in-flight admissions plus "
                    "trie-held pages left no room"
                )
            ids, shared_n = grant
            inserted = False
            slot = 0  # transient occupancy: insert -> export -> release
            try:
                t_admit = time.perf_counter()
                if shared_n:
                    row, _f, first, _d, seen = self.pool.prefill_shared(
                        prompt, ids[:shared_n], gen
                    )
                else:
                    row, _f, first, _d, seen = prefill_row(
                        self.pool.model, prompt, gen,
                        sampling=self.pool.sampling, eos_id=self._eos,
                        pad_to=len(prompt), cache_len=self.pool.cache_len,
                    )
                self.pool.insert_paged(
                    slot, row, first, len(prompt), max_new - 1, ids,
                    shared_n, row_seen=seen,
                )
                inserted = True
                self.pool.register_prefix(prompt, ids)
                t_compute = time.perf_counter()
                state = self.pool.export_slot(slot)
            except BaseException:
                # The grant must not outlive a failed prefill or export:
                # before the insert this frame owns the pages, after it
                # the transient slot does.
                if inserted:
                    self.pool.release_slot(slot)
                else:
                    self.pool.release_pages(ids)
                raise
            self.pool.release_slot(slot)
            if self._eos is not None and first == self._eos:
                # EOS as the first token: nothing is left to decode.
                state["done"] = True
            stages = {
                "queue": t_lock - t_req,
                "admit": t_admit - t_lock,
                "compute": t_compute - t_admit,
                "export": time.perf_counter() - t_compute,
            }
            data = self._seal(state, stages, ctx, prompt, session)
            self._report(ctx, stages, state["n_pages"], len(data), t0,
                         shared_n, len(prompt))
            return data

    def _turn(self) -> Optional[_ChunkTicket]:
        """The ticket whose chunk runs next: fewest chunks left, then
        admission order. Arena-stalled tickets are skipped."""
        live = [t for t in self._rr if not t.blocked]
        if not live:
            return None
        return min(live, key=lambda t: (t.remaining, t.seq))

    @contextlib.contextmanager
    def _unlocked(self):
        """Release the engine mutex around a chunk's device call, so
        admissions and abandons (host-only bookkeeping) never wait behind
        compute; ``_chunk_busy`` keeps the compute itself exclusive."""
        self._cv.release()
        try:
            yield
        finally:
            self._cv.acquire()

    def _prefill_chunked(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> bytes:
        """Chunked admission: advance the prompt one page-aligned chunk
        per turn (shortest remaining first), with the engine mutex
        released between chunks and during each chunk's device call, so a
        short prompt overtakes a long one at the next chunk boundary. The
        bundle carries the prompt's pages only (the decode replica
        allocates the budget's tail from ``cache_index + remaining``), so
        the admission bound here is the prompt's page need.

        Stages stay additive: ``queue`` is the FIRST lock wait only; later
        waits (lock re-acquires, arena stalls) land in ``queue_chunks``,
        and ``wall_s`` is the literal sum."""
        import torch

        from tpufw_torch.workloads.serve import _PREFILL_STREAM

        ctx = reqtrace.parse(trace)
        ctx = ctx.child() if ctx is not None else None
        prompt = [int(t) for t in prompt]
        n_prompt_pages = self.pool.n_pages_for(len(prompt))
        if n_prompt_pages > self.pool.allocator.capacity:
            raise ValueError(
                f"prompt needs {n_prompt_pages} pages; arena capacity is "
                f"{self.pool.allocator.capacity} (chunked bundles are "
                "prompt-only, so the decode budget does not count against "
                "this arena)"
            )
        t_req = time.perf_counter()
        deadline = time.monotonic() + 600.0
        with self._cv:
            t_lock = time.perf_counter()
            queue_s = t_lock - t_req
            # Never promise more pages than the arena holds, so every
            # admitted prefill can finish once its peers export.
            while (self._reserved + n_prompt_pages
                   > self.pool.allocator.capacity):
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "prefill arena oversubscribed — in-flight chunked "
                        "admissions never drained"
                    )
                self._cv.wait(0.25)
            job_index = self._job_index
            self._job_index += 1
            t0 = time.monotonic()
            self._reserved += n_prompt_pages
            self.prefill_inflight += 1
            cp = None
            try:
                cp = self.pool.start_chunked(
                    prompt, len(prompt),
                    _stream(self.pool, self._seed_base, _PREFILL_STREAM,
                            job_index),
                    self.prefill_chunk_pages,
                )
                if cp.resumed:
                    self.prefill_resumes += 1
                admit_s = time.perf_counter() - t_lock
            except BaseException:
                try:
                    if cp is not None:
                        self.pool.abandon_chunked(cp)
                finally:
                    self._reserved -= n_prompt_pages
                    self.prefill_inflight -= 1
                    self._cv.notify_all()
                raise
        chunk_w = max(1, self.prefill_chunk_pages) * self.pool.page
        token = None
        try:
            token = _ChunkTicket(
                remaining=-(-(len(prompt) - cp.cursor) // chunk_w),
                seq=job_index,
            )
            queue_chunks_s = 0.0
            compute_s = 0.0
            t_mark = time.perf_counter()
            with self._cv:
                self._rr.append(token)
                self._cv.notify_all()
            while True:
                with self._cv:
                    token.blocked = False
                    while self._chunk_busy or self._turn() is not token:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                "prefill chunk turn starved — peers never "
                                "yielded the engine"
                            )
                        self._cv.wait(0.25)
                        token.blocked = False
                    t_got = time.perf_counter()
                    queue_chunks_s += t_got - t_mark
                    self._chunk_busy = True
                    try:
                        status = self.pool.chunk_step(
                            cp, unlocked=self._unlocked
                        )
                    finally:
                        self._chunk_busy = False
                    token.remaining = -(-(len(prompt) - cp.cursor)
                                        // chunk_w)
                    if status == "stalled":
                        # Trie-held pages of peers' checkpoints own the
                        # arena now: stand aside until an export or an
                        # abandon frees some.
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                "prefill arena exhausted mid-chunk — no "
                                "peer freed pages in time"
                            )
                        token.blocked = True
                        self._cv.notify_all()
                        self._cv.wait(0.25)
                        t_mark = time.perf_counter()
                        continue
                    t_chunk = time.perf_counter()
                    compute_s += t_chunk - t_got
                    self.prefill_chunks += 1
                    self._events.emit(
                        "serve_prefill_chunk",
                        prompt_tokens=len(prompt), cursor=cp.cursor,
                        final=status == "done",
                        chunk_s=round(t_chunk - t_got, 6),
                    )
                    if status == "done":
                        slot = 0  # transient: finalize -> export -> release
                        with torch.no_grad():
                            self.pool.finalize_chunked(slot, cp, max_new - 1)
                            t_compute = time.perf_counter()
                            compute_s += t_compute - t_chunk
                            state = self.pool.export_slot(
                                slot, page_ids=cp.page_ids
                            )
                            self.pool.release_slot(slot)
                        # The slot owned (and released) the pages: empty
                        # the cursor so a late failure's abandon cannot
                        # release them twice.
                        cp.page_ids = []
                        export_s = time.perf_counter() - t_compute
                        self._rr.remove(token)
                        self._cv.notify_all()
                        break
                    self._cv.notify_all()
                t_mark = time.perf_counter()
            if cp.done0:
                state["done"] = True
            stages = {
                "queue": queue_s,
                "admit": admit_s,
                "queue_chunks": queue_chunks_s,
                "compute": compute_s,
                "export": export_s,
            }
            data = self._seal(state, stages, ctx, prompt, session)
            self._report(ctx, stages, state["n_pages"], len(data), t0,
                         cp.shared_n, len(prompt), n_chunks=cp.n_chunks)
            return data
        except BaseException:
            with self._cv:
                # Abandon keeps the trie-checkpointed full pages held: a
                # resubmitted identical prompt resumes from them.
                self.pool.abandon_chunked(cp)
            raise
        finally:
            with self._cv:
                self._reserved -= n_prompt_pages
                self.prefill_inflight -= 1
                if token is not None and token in self._rr:
                    self._rr.remove(token)
                self._cv.notify_all()


class DecodeEngine:
    """One decode replica: bundle import + continuous chunked decode.

    ``submit`` splices a bundle into a free slot; ``collect`` drives
    shared decode chunks (all active slots advance together, the slot
    scheduler's continuous batching) until that slot's budget is spent,
    then frees its pages."""

    def __init__(
        self,
        model,
        *,
        sampling,
        page: int,
        kv_quant: str = "",
        n_slots: int = 4,
        arena_pages: Optional[int] = None,
        eos_id: Optional[int] = None,
        seed_base: int = 0,
        chunk: int = 4,
        spec_k: int = 0,
        spec_min_accept: float = 0.25,
        prefill_chunk_pages: int = 0,
        piggyback: float = 0.0,
        spill=None,
        affinity_k: int = 0,
        events=None,
        tracer=None,
    ):
        from tpufw_torch.infer.sampling import track_seen

        # A prefix trie on the decode side only with piggyback prefill:
        # splices never register in it, but piggybacked chunked prefills
        # checkpoint into it as a prefill replica's do.
        piggy = bool(
            max(0, int(prefill_chunk_pages)) and float(piggyback) > 0
        )
        self.pool = _paged_pool(
            model, n_slots=n_slots, page=page, kv_quant=kv_quant,
            arena_pages=arena_pages, sampling=sampling, eos_id=eos_id,
            prefix_cache=piggy,
        )
        self.page = page
        self.n_slots = n_slots
        self.chunk = max(1, chunk)
        self._eos = eos_id
        self._seed_base = seed_base
        self._chunk_index = 0
        self._job_index = 0
        # Prefill/decode fungibility: with a chunk size and a spare-slot
        # waterline, this replica accepts RAW prompts and prefills them
        # chunk by chunk inside the passes that advance its decode slots.
        self.prefill_chunk_pages = max(0, int(prefill_chunk_pages))
        self.piggyback = max(0.0, float(piggyback))
        self._events = events if events is not None else obs_events.NULL
        self._tracer = tracer if tracer is not None else obs_trace.NULL
        # KV fabric: spill tier (trie pages under piggyback, session
        # bundles at drain), affinity digests, and the drain latch.
        self._spill = spill
        self._affinity_k = max(0, int(affinity_k))
        self._digest_cache: Dict[str, Any] = {}
        if spill is not None:
            attach_spill(self.pool, spill)
        self._draining = False
        # Set lock-free by drain() BEFORE it contends for ``_cv``: the
        # collect loop holds the lock across chunks and yields at every
        # chunk boundary while this is set.
        self._drain_pending = False
        self.sessions_drained = 0
        self.sessions_resumed = 0
        # N-gram self-drafting verified in one target pass. No draft
        # model on a replica, so speculation costs no device memory.
        self.spec_k = max(0, int(spec_k))
        self._ema = None
        self.spec_passes = 0
        if self.spec_k:
            from tpufw_torch.infer.speculative import AcceptEMA

            if self.spec_k + 1 > page:
                raise ValueError(
                    f"spec_k={self.spec_k} needs spec_k+1 <= page={page} "
                    "(verify writes one block per pass)"
                )
            if track_seen(sampling):
                # Acceptance at j changes the penalized distribution at
                # j+1: speculation cannot honour the penalty.
                self._events.emit(
                    "serve_spec", level="warn", k=self.spec_k,
                    mode="plain_fallback", reason="repetition_penalty",
                )
                self.spec_k = 0
            else:
                self._ema = AcceptEMA(n_slots, min_accept=spec_min_accept)
        self._cv = threading.Condition()
        #: slot -> {"tokens", "budget", "done", ...} plus the request-trace
        #: bookkeeping collect_ex reports.
        self._jobs: Dict[int, Dict[str, Any]] = {}
        self.migrations = 0
        self.migration_bytes = 0

    # ---- router signals -------------------------------------------

    def signals(self) -> Dict[str, Any]:
        a = self.pool.allocator
        with self._cv:
            active = len(self._jobs)
            inflight = sum(
                1 for j in self._jobs.values() if j.get("cp") is not None
            )
        sig = {
            "role": "decode",
            "pages_total": a.capacity,
            "pages_in_use": a.in_use,
            "slots_total": self.n_slots,
            "slots_active": active,
            "migrations": self.migrations,
        }
        if self.spec_k:
            sig["spec_k"] = self.spec_k
            sig["spec_passes"] = self.spec_passes
        if self.prefill_chunk_pages and self.piggyback:
            sig["prefill_chunk_pages"] = self.prefill_chunk_pages
            sig["piggyback_waterline"] = self.piggyback
            sig["prefill_inflight"] = inflight
        # The router stops steering new work here the moment the drain
        # latch flips.
        sig["draining"] = 1 if self._draining else 0
        if self.sessions_drained or self.sessions_resumed:
            sig["sessions_drained"] = self.sessions_drained
            sig["sessions_resumed"] = self.sessions_resumed
        _fabric_signals(sig, self.pool, self._spill)
        if self._affinity_k and self.pool.prefix is not None:
            sig["prefix_digests"] = advertised_digests(
                self.pool, self._spill, self._affinity_k,
                self._digest_cache,
            )
        return sig

    def can_accept(self, n_pages: int) -> bool:
        with self._cv:
            if self._draining or len(self._jobs) >= self.n_slots:
                return False
            deficit = self._cp_deficit_locked()
        return n_pages + deficit <= self.pool.allocator.n_free

    def _cp_deficit_locked(self) -> int:
        """Pages still owed to in-flight piggyback prefills (caller holds
        ``_cv``); admissions that would eat into it are refused."""
        return sum(
            j["cp"].deficit for j in self._jobs.values()
            if j.get("cp") is not None
        )

    def can_piggyback(self, n_pages: int) -> bool:
        """Would ``submit_raw`` accept a raw prompt needing ``n_pages``
        now? Its pages must fit beside every in-flight chunked deficit,
        and the idle-slot fraction must clear the ``piggyback``
        waterline (a decode pass computes every slot row, so spare chunk
        capacity IS idle slots)."""
        if not (self.prefill_chunk_pages and self.piggyback):
            return False
        a = self.pool.allocator
        with self._cv:
            n_jobs = len(self._jobs)
            if self._draining or n_jobs >= self.n_slots:
                return False
            deficit = self._cp_deficit_locked()
        return (
            a.n_free - deficit - n_pages >= 0
            and self.n_slots - n_jobs >= self.piggyback * self.n_slots
        )

    def _row_pages(self, cursor: int, remaining: int) -> int:
        """Pages a row at ``cursor`` with ``remaining`` decode steps owns:
        its budget, plus the verify block's slack when speculating,
        within the row."""
        slack = self.spec_k
        return min(self.pool.per_row,
                   self.pool.n_pages_for(cursor + remaining + slack))

    def _new_job(self, tokens, budget, done, history, session, ctx,
                 splice_s=0.0, **extra) -> Dict[str, Any]:
        job = {
            "tokens": tokens,
            "budget": budget,
            "done": done,
            # Prompt ids (the n-gram self-draft mines them with the
            # generated history).
            "history": history,
            # Sticky session id: drain exports the slot under it.
            "session": session or None,
            "ctx": ctx,
            "splice_s": splice_s,
            # perf_counter at splice end: first_flush runs from here to
            # the first decode-chunk extension.
            "t_ready": time.perf_counter(),
            "first_flush_s": None,
            "n_chunks": 0,
        }
        job.update(extra)
        return job

    # ---- bundle import --------------------------------------------

    def submit(self, data: bytes) -> int:
        """Import a serialized bundle; returns the slot handle for
        ``collect``. BundleError/ValueError mean the bundle was rejected
        with the arena untouched."""
        import torch

        t0 = time.monotonic()
        t0p = time.perf_counter()
        state = decode_bundle(data)
        ctx = reqtrace.parse(state.get("trace"))
        ctx = ctx.child() if ctx is not None else None
        # A resumed session bundle (a drain export) carries the tokens
        # emitted so far: seed the list so the client receives one
        # continuous sequence, and lift the budget by them so the
        # budget_left arithmetic lands on the origin's remaining count.
        emitted = state.get("tokens")
        resumed = isinstance(emitted, list) and len(emitted) > 0
        if resumed:
            tokens0 = [int(t) for t in emitted]
            budget0 = int(state["remaining"]) + len(tokens0) - 1
        else:
            tokens0 = [int(state["token"])]
            budget0 = int(state["remaining"])
        with self._cv:
            if self._draining:
                raise RuntimeError(
                    "decode replica draining — no new admissions"
                )
            free = [s for s in range(self.n_slots) if s not in self._jobs]
            if not free:
                raise RuntimeError("decode replica: no free slot")
            slot = free[0]
            # A chunked prefill exports the prompt's pages only: the
            # decode side owns residency, so the grant covers the row's
            # whole life.
            n_alloc = max(
                int(state["n_pages"]),
                self._row_pages(int(state["cache_index"]),
                                int(state["remaining"])),
            )
            deficit = self._cp_deficit_locked()
            if deficit and self.pool.allocator.n_free - n_alloc < deficit:
                raise RuntimeError(
                    "decode replica: bundle would starve an in-flight "
                    f"piggyback prefill ({n_alloc} pages wanted, {deficit} "
                    f"owed, {self.pool.allocator.n_free} free)"
                )
            ids = self.pool.allocator.alloc(n_alloc)
            if ids is None:
                raise RuntimeError(
                    f"decode replica: arena cannot fit the bundle "
                    f"({n_alloc} pages, {self.pool.allocator.n_free} free)"
                )
            try:
                with torch.no_grad():
                    self.pool.splice_slot(slot, state, ids)
            except Exception:
                self.pool.allocator.release(ids)
                raise
            splice_s = time.perf_counter() - t0p
            job = self._new_job(
                tokens0, budget0,
                bool(state["done"]) or int(state["remaining"]) <= 0,
                [int(t) for t in (state.get("prompt") or [])],
                state.get("session"), ctx, splice_s,
            )
            self._jobs[slot] = job
            if self._ema is not None and not job["done"]:
                self._ema.occupy(slot)
            if job["done"]:
                # Prefill already finished this request (EOS first, or a
                # zero budget): no decode chunk will retire the slot, so
                # its pages go back now; the only token arrived in the
                # bundle.
                self.pool.release_slot(slot)
                job["first_flush_s"] = 0.0
            if resumed:
                self.sessions_resumed += 1
            self.migrations += 1
            self.migration_bytes += len(data)
            self._cv.notify_all()
        reqtrace.stage(self._tracer, ctx, "req_splice", splice_s,
                       pages=int(state["n_pages"]), slot=slot)
        fields = dict(
            pages=int(state["n_pages"]), bytes=len(data),
            wall_s=round(time.monotonic() - t0, 6), direction="import",
        )
        if ctx is not None:
            fields["trace"] = ctx.trace_id
        self._events.emit("serve_migration", **fields)
        return slot

    def submit_raw(
        self, prompt: Sequence[int], max_new: int, trace=None,
        session: Optional[str] = None,
    ) -> int:
        """Piggyback admission: accept a RAW prompt (no prefill hop, no
        bundle) and prefill it chunk by chunk inside the passes that
        advance the resident decode slots. Needs a free slot, the row's
        whole page need beside every in-flight deficit, and the idle-slot
        fraction above the ``piggyback`` waterline; otherwise raises
        RuntimeError and the router falls back to a prefill replica."""
        from tpufw_torch.workloads.serve import _PREFILL_STREAM

        if not (self.prefill_chunk_pages and self.piggyback):
            raise RuntimeError(
                "piggyback admission disabled — needs both "
                "TPUFW_SERVE_PREFILL_CHUNK and TPUFW_SERVE_PIGGYBACK"
            )
        ctx = reqtrace.parse(trace)
        ctx = ctx.child() if ctx is not None else None
        prompt = [int(t) for t in prompt]
        need = len(prompt) + max_new - 1 + self.spec_k
        n_total = self.pool.n_pages_for(need)
        a = self.pool.allocator
        if n_total > a.capacity:
            raise ValueError(
                f"prompt+budget needs {n_total} pages; arena capacity is "
                f"{a.capacity}"
            )
        with self._cv:
            if self._draining:
                raise RuntimeError(
                    "decode replica draining — no new admissions"
                )
            free = [s for s in range(self.n_slots) if s not in self._jobs]
            if not free:
                raise RuntimeError("decode replica: no free slot")
            deficit = self._cp_deficit_locked()
            if a.n_free - deficit - n_total < 0:
                raise RuntimeError(
                    "decode replica: arena cannot seat the row — "
                    f"{a.n_free} free minus {deficit} owed leaves less "
                    f"than the {n_total} pages wanted"
                )
            if self.n_slots - len(self._jobs) < self.piggyback * self.n_slots:
                raise RuntimeError(
                    "decode replica: piggyback waterline — "
                    f"{self.n_slots - len(self._jobs)} idle of "
                    f"{self.n_slots} slots clears less than "
                    f"{self.piggyback:.0%}"
                )
            slot = free[0]
            job_index = self._job_index
            self._job_index += 1
            # The stream a prefill replica would draw, so a piggybacked
            # request samples as a migrated one does.
            cp = self.pool.start_chunked(
                prompt, need,
                _stream(self.pool, self._seed_base, _PREFILL_STREAM,
                        job_index),
                self.prefill_chunk_pages,
            )
            self._jobs[slot] = self._new_job(
                [], max_new - 1, False, list(prompt), session, ctx,
                cp=cp, prefill_s=0.0, prefill_queue_s=0.0,
                prefill_chunks=0,
            )
            self._cv.notify_all()
        reqtrace.stage(self._tracer, ctx, "req_piggyback_admit", 0.0,
                       slot=slot, pages=n_total)
        return slot

    # ---- drain (scale-in / SIGTERM) -------------------------------

    def drain(self) -> Dict[str, Any]:
        """Turn scale-in from "drop sessions" into "migrate them": latch
        the drain flag (admissions refuse), export every live session's
        slot as a ``"session"`` bundle (with its tokens so far) into the
        spill tier, which persists it to the shared directory, release
        the slots, and mark the jobs drained so in-flight ``collect_ex``
        calls return at once with the ``drained`` flag. The router
        re-homes each session onto a surviving replica through the normal
        splice path. Sessions still in a piggyback prefill and sessionless
        jobs have nothing to resume and are dropped. Idempotent: a second
        drain finds no live jobs."""
        import torch

        t0 = time.monotonic()
        exported: List[str] = []
        dropped = 0
        self._drain_pending = True
        with self._cv, torch.no_grad():
            self._drain_pending = False
            self._draining = True
            for slot, job in list(self._jobs.items()):
                if job["done"]:
                    continue
                session = job.get("session")
                cp = job.get("cp")
                if cp is not None:
                    self.pool.abandon_chunked(cp)
                    job["cp"] = None
                    dropped += 1
                elif session and self._spill is not None:
                    # Export BEFORE release: after it the table row is
                    # zeroed and the pages may be reassigned.
                    state = self.pool.export_slot(slot)
                    state["session"] = str(session)
                    state["tokens"] = [int(t) for t in job["tokens"]]
                    if job.get("history"):
                        state["prompt"] = [int(t) for t in job["history"]]
                    data = encode_bundle(state)
                    self._spill.put("session", str(session), data,
                                    int(state["n_pages"]))
                    self.pool.release_slot(slot)
                    if self._ema is not None:
                        self._ema.vacate(slot)
                    self.sessions_drained += 1
                    exported.append(str(session))
                else:
                    self.pool.release_slot(slot)
                    if self._ema is not None:
                        self._ema.vacate(slot)
                    dropped += 1
                job["done"] = True
                job["drained"] = True
            self._cv.notify_all()
        self._events.emit(
            "serve_spill", entry="session", direction="out",
            sessions=len(exported), dropped=dropped,
            wall_s=round(time.monotonic() - t0, 6),
        )
        return {"drained": True, "sessions": exported, "dropped": dropped}

    # ---- decode loop ----------------------------------------------

    def _run_prefill_chunks_locked(self) -> bool:
        """Advance every piggybacked prefill by one chunk (caller holds
        ``_cv``). A finished prefill finalizes into its slot and joins the
        next decode pass. Returns whether any chunk ran."""
        progressed = False
        for slot, job in list(self._jobs.items()):
            cp = job.get("cp")
            if cp is None or job["done"]:
                continue
            t0 = time.perf_counter()
            status = self.pool.chunk_step(cp)
            if status == "stalled":
                continue  # retry after a peer frees pages
            dt = time.perf_counter() - t0
            progressed = True
            job["prefill_s"] += dt
            job["prefill_chunks"] += 1
            self._events.emit(
                "serve_prefill_chunk",
                prompt_tokens=len(cp.prompt), cursor=cp.cursor,
                final=status == "done", chunk_s=round(dt, 6), slot=slot,
            )
            if status != "done":
                continue
            job["cp"] = None
            job["tokens"] = [cp.first_int]
            t1 = time.perf_counter()
            job["prefill_queue_s"] = max(
                0.0, (t1 - job["t_ready"]) - job["prefill_s"]
            )
            job["first_flush_s"] = t1 - job["t_ready"]
            reqtrace.stage(self._tracer, job["ctx"], "req_first_token",
                           job["first_flush_s"], slot=slot)
            if cp.done0 or job["budget"] <= 0:
                # EOS first (or a zero budget): complete before owning a
                # slot; abandon frees every page.
                job["done"] = True
                self.pool.abandon_chunked(cp)
            else:
                self.pool.finalize_chunked(slot, cp, job["budget"])
                if self._ema is not None:
                    self._ema.occupy(slot)
        return progressed

    def _run_chunk_locked(self) -> None:
        """One shared decode chunk (caller holds ``_cv``): every active
        slot advances, retired slots free their pages. With ``spec_k`` the
        pass may run speculatively (n-gram proposals verified in one
        target pass, each slot advancing by its own accept count) while
        the acceptance EMA clears its threshold."""
        import numpy as np
        import torch

        from tpufw_torch.workloads.serve import _CHUNK_STREAM, _pow2_ceil

        progressed = self._run_prefill_chunks_locked()
        live = {
            s: j for s, j in self._jobs.items()
            if not j["done"] and j.get("cp") is None
        }
        if not live:
            if not progressed and any(
                j.get("cp") is not None for j in self._jobs.values()
            ):
                # Every piggyback prefill is stalled on pages and no
                # decode slot is live to free any: back off instead of
                # spinning.
                self._cv.wait(0.001)
            return
        use_spec = self._ema is not None and self._ema.use_spec(sorted(live))
        if use_spec:
            k = self.spec_k
        else:
            # The scheduler's pow-2 ladder on the chunk length.
            max_left = max(j["budget"] - (len(j["tokens"]) - 1)
                           for j in live.values())
            k = min(self.chunk, _pow2_ceil(max_left))
        t0 = time.perf_counter()
        chunk_index = self._chunk_index
        self._chunk_index += 1
        gen = _stream(self.pool, self._seed_base, _CHUNK_STREAM,
                      chunk_index)
        if use_spec:
            from tpufw_torch.infer.speculative import ngram_propose

            props = np.zeros((self.n_slots, k), np.int64)
            for slot, job in live.items():
                props[slot] = ngram_propose(job["history"] + job["tokens"],
                                            k)
            out, n_emit, accept = self.pool.spec_steps(props, gen)
            # One host sync for the pass.
            res = torch.cat([out, n_emit[:, None], accept[:, None]],
                            1).tolist()
            rows = {s: res[s][: res[s][k + 1]] for s in live}
            accepts = {s: res[s][k + 2] for s in live}
        else:
            out = self.pool.decode_steps(k, gen).tolist()  # one host sync
            rows = {s: out[s] for s in live}
        t1 = time.perf_counter()
        chunk_s = t1 - t0
        accept_frac = 0.0
        for slot, job in live.items():
            budget_left = job["budget"] - (len(job["tokens"]) - 1)
            row = rows[slot][:budget_left]
            if use_spec:
                self._ema.update(slot, accepts[slot] / k)
                accept_frac += accepts[slot] / k
            if self._eos is not None and self._eos in row:
                row = row[: row.index(self._eos) + 1]
            job["tokens"].extend(row)
            job["n_chunks"] += 1
            if row and job["first_flush_s"] is None:
                # The first decode tokens became host-visible: the
                # splice->flush gap is decode's share of TTFT beyond the
                # bundled first token.
                job["first_flush_s"] = t1 - job["t_ready"]
                reqtrace.stage(self._tracer, job["ctx"], "req_first_token",
                               job["first_flush_s"], slot=slot)
            reqtrace.stage(
                self._tracer, job["ctx"], "req_decode_chunk", chunk_s,
                slot=slot, chunk_index=chunk_index, new_tokens=len(row),
            )
            if len(job["tokens"]) - 1 >= job["budget"] or (
                self._eos is not None and row and row[-1] == self._eos
            ):
                job["done"] = True
                self.pool.release_slot(slot)
                if self._ema is not None:
                    self._ema.vacate(slot)
        if use_spec:
            self.spec_passes += 1
            self._events.emit(
                "serve_spec", k=k, mode="pass", rows=len(live),
                accept_rate=round(accept_frac / len(live), 4),
            )
        self._cv.notify_all()

    def collect(self, slot: int, timeout: float = 600.0) -> List[int]:
        """Block until ``slot``'s request completes; returns its full token
        list (first token included). One caller drives chunks at a time;
        the others sleep on the condition."""
        return self.collect_ex(slot, timeout)["tokens"]

    def collect_ex(self, slot: int, timeout: float = 600.0) -> Dict[str, Any]:
        """``collect`` plus the decode-side stage timings the router folds
        into its TTFT decomposition: ``splice_s`` (bundle parse + page
        alloc + splice), ``first_flush_s`` (splice end to the first decode
        chunk's flush; 0.0 when the bundled token finished the request),
        ``n_chunks``."""
        import torch

        deadline = time.monotonic() + timeout
        with self._cv, torch.no_grad():
            while True:
                job = self._jobs.get(slot)
                if job is None:
                    raise KeyError(f"no active job in slot {slot}")
                if job["done"]:
                    del self._jobs[slot]
                    out = {
                        "tokens": job["tokens"],
                        "splice_s": round(job["splice_s"], 6),
                        "first_flush_s": round(job["first_flush_s"] or 0.0,
                                               6),
                        "n_chunks": job["n_chunks"],
                    }
                    if "prefill_chunks" in job:
                        # Piggybacked: the replica did the prefill too.
                        out["piggyback"] = True
                        out["prefill_s"] = round(job["prefill_s"], 6)
                        out["prefill_queue_s"] = round(
                            job["prefill_queue_s"], 6)
                        out["prefill_chunks"] = job["prefill_chunks"]
                    if job.get("drained"):
                        # Drained mid-request: the router re-homes the
                        # session instead of returning a truncated reply.
                        out["drained"] = True
                        if job.get("session"):
                            out["session"] = job["session"]
                    return out
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"slot {slot} did not finish in {timeout}s"
                    )
                if self._drain_pending:
                    # A drain waits on this lock: yield it for a beat so
                    # the export sees the live slots.
                    self._cv.wait(0.002)
                    continue
                self._run_chunk_locked()


# -------------------------------------------------- role entrypoints

def role_telemetry(role: str):
    """(events, tracer) of a replica role from ``TPUFW_TELEMETRY_DIR``:
    per-role files (``events-<role>.jsonl`` / ``trace-<role>.json``), or
    the null implementations when the directory is unset."""
    tdir = env_opt_str("telemetry_dir")
    if not tdir:
        return obs_events.NULL, obs_trace.NULL
    os.makedirs(tdir, exist_ok=True)
    events = obs_events.EventLog(os.path.join(tdir, f"events-{role}.jsonl"))
    tracer = obs_trace.Tracer(
        os.path.join(tdir, f"trace-{role}.json"),
        process_name=role, max_events=200_000,
    )
    return events, tracer


def _build_engine(role: str):
    """(engine, restored) of a replica container, from the TPUFW_*
    contract the monolithic server reads; the model comes from
    ``workloads.serve.build_generator`` on ``TPUFW_DEVICE`` (cuda unless
    the caller asks for the CPU)."""
    from tpufw_torch.infer import SamplingConfig
    from tpufw_torch.workloads import serve

    model, _cfg, restored = serve.build_generator()
    model = serve._maybe_cast_decode(model)
    events, tracer = role_telemetry(role)
    # KV fabric: TPUFW_KV_SPILL pages of host RAM with TPUFW_KV_SPILL_DIR
    # as the overflow and session-store directory; either knob alone
    # enables the tier. The advertised digest depth matches the router's
    # TPUFW_ROUTER_PREFIX_AFFINITY so both ends hash the same chunks.
    spill_pages = max(0, env_int("kv_spill", 0))
    spill_dir = env_str("kv_spill_dir", "")
    spill = None
    if spill_pages or spill_dir:
        from tpufw_torch.infer.spill import SpillTier

        spill = SpillTier(spill_pages, spill_dir)
    common = dict(
        sampling=SamplingConfig(temperature=0.0),
        page=env_int("serve_page", 16),
        kv_quant=env_str("serve_kv_quant", ""),
        n_slots=max(1, env_int("serve_slots", 8)),
        seed_base=env_int("seed", 0),
        prefill_chunk_pages=max(0, env_int("serve_prefill_chunk", 0)),
        spill=spill,
        affinity_k=max(0, env_int("router_prefix_affinity", 0)),
        events=events, tracer=tracer,
    )
    if role == "prefill":
        return PrefillEngine(model, **common), restored
    return DecodeEngine(
        model,
        chunk=max(1, env_int("serve_chunk", 0)
                  or env_int("stream_chunk", 16)),
        spec_k=env_int("serve_spec_k", 0),
        spec_min_accept=env_float("serve_spec_min_accept", 0.25),
        piggyback=max(0.0, env_float("serve_piggyback", 0.0)),
        **common,
    ), restored


def _start(handle, port: int):
    srv, bound = transport.serve_frames(port)
    threading.Thread(
        target=transport.accept_loop, args=(srv, handle), daemon=True
    ).start()
    return srv, bound


def serve_prefill(engine: PrefillEngine, port: int):
    """Framed-TCP prefill server: JSON request in, bundle out. The
    request's optional ``trace`` field flows into the engine so its stage
    spans correlate. Returns (listening socket, bound port)."""

    def handle(frame: bytes) -> bytes:
        req = json.loads(frame.decode("utf-8"))
        if req.get("signals"):
            return json.dumps(engine.signals()).encode()
        prompt = req.get("prompt")
        max_new = req.get("max_new")
        if prompt is None or max_new is None:
            return json.dumps(
                {"error": "bad prefill frame: need prompt and max_new"}
            ).encode()
        return engine.prefill(
            [int(t) for t in prompt], int(max_new),
            trace=req.get("trace"), session=req.get("session"),
        )

    return _start(handle, port)


def serve_decode(engine: DecodeEngine, port: int):
    """Framed-TCP decode server: bundle in, JSON token list out (plus the
    decode-side stage timings and the engine's signals). JSON control
    frames ask for signals, a drain, or a raw-prompt piggyback admission.
    Returns (listening socket, bound port)."""

    def handle(frame: bytes) -> bytes:
        if frame[:1] == b"{":  # a JSON control frame (bundles open TPFB)
            req = json.loads(frame.decode("utf-8"))
            if req.get("signals"):
                return json.dumps(engine.signals()).encode()
            if req.get("drain"):
                # Scale-in hook: export live sessions, refuse new work.
                return json.dumps(engine.drain()).encode()
            if req.get("prompt") is not None:
                try:
                    slot = engine.submit_raw(
                        [int(t) for t in req["prompt"]],
                        int(req.get("max_new", 1)),
                        trace=req.get("trace"), session=req.get("session"),
                    )
                except (ValueError, RuntimeError) as e:
                    return json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode()
                out = engine.collect_ex(slot)
                return json.dumps({**out, **engine.signals()}).encode()
            return json.dumps({"error": "expected a page bundle"}).encode()
        try:
            slot = engine.submit(frame)
        except (BundleError, ValueError, RuntimeError) as e:
            return json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
        out = engine.collect_ex(slot)
        return json.dumps({**out, **engine.signals()}).encode()

    return _start(handle, port)


def install_drain_handler(engine) -> None:
    """SIGTERM -> drain: live sessions export to the session store, then
    the process lingers ``TPUFW_SERVE_DRAIN_GRACE_S`` seconds (in-flight
    replies carrying the ``drained`` flag flush to the router) and exits
    0."""
    import signal

    def _on_term(signum, frame):
        try:
            engine.drain()
            time.sleep(max(0.0, env_float("serve_drain_grace_s", 5.0)))
        finally:
            raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_term)


def main_role(role: str) -> int:
    """Container entry point for a non-empty ``TPUFW_SERVE_ROLE``. Blocks
    for the process's lifetime (the pod's lifetime is the replica's)."""
    if role not in ROLES:
        raise ValueError(
            f"unknown TPUFW_SERVE_ROLE={role!r} "
            "(want prefill|decode|router or empty)"
        )
    if role == "router":
        from tpufw_torch.serve.router import main_router

        return main_router()
    engine, restored = _build_engine(role)
    port = env_int("serve_peer_port", DEFAULT_PEER_PORT)
    if role == "prefill":
        srv, bound = serve_prefill(engine, port)
    else:
        srv, bound = serve_decode(engine, port)
        install_drain_handler(engine)
    print(json.dumps({
        "serving_role": role, "port": bound, "restored": restored,
        "device": str(engine.pool.model.device),
    }), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()
        engine._tracer.close()
        engine._events.close()
    return 0
