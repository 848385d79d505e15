"""Inference serving workload (port of ``tpufw.workloads.serve``):
``python -m tpufw_torch.workloads.serve``.

- batch mode (default): generate continuations for ``TPUFW_PROMPTS_FILE``
  (JSON: a list of token-id lists) or the built-in demo prompts, printing
  one JSON line per prompt and then a ``generate_ok`` line;
- server mode (``TPUFW_SERVE_PORT`` > 0): a stdlib ``ThreadingHTTPServer``
  with ``POST /generate`` (token-id ``prompts`` or ``texts``, JSON or an
  SSE stream), ``POST /v1/completions`` (OpenAI completions shape),
  ``GET /healthz`` and ``GET /metrics`` (Prometheus text, the same
  ``tpufw_serve_*`` series as the JAX server). Requests are served by
  ``_SlotScheduler``: continuous batching at decode-step granularity over
  a slot pool, contiguous or, with ``TPUFW_SERVE_PAGE`` > 0, paged with
  prefix sharing and optional int8 KV (``TPUFW_SERVE_KV_QUANT=int8``).

Knobs, as in the JAX workload: ``TPUFW_MODEL`` (a ``LLAMA_CONFIGS``
preset or ``llama3_600m_bench``, the default), ``TPUFW_MAX_SEQ_LEN``,
``TPUFW_SEED``, ``TPUFW_MAX_NEW_TOKENS`` (16), ``TPUFW_QUANTIZE=int8``,
``TPUFW_DECODE_DTYPE`` (e.g. ``bfloat16``), ``TPUFW_PREFILL_CHUNK``,
``TPUFW_EOS_ID``, the sampling knobs ``TPUFW_TEMPERATURE``,
``TPUFW_TOP_K``, ``TPUFW_TOP_P``, ``TPUFW_MIN_P`` and
``TPUFW_REPETITION_PENALTY``, ``TPUFW_TOKENIZER`` (``bytes``), and
``TPUFW_DEVICE`` (default ``cuda``); for the server ``TPUFW_SERVE_SLOTS``
(8), ``TPUFW_SERVE_CHUNK`` (default ``TPUFW_STREAM_CHUNK``, 16),
``TPUFW_SERVE_CACHE_FLOOR`` (128), ``TPUFW_BATCH_WAIT_MS`` (5),
``TPUFW_SERVE_PAGE``, ``TPUFW_SERVE_KV_QUANT``,
``TPUFW_SERVE_PREFIX_CACHE`` (on), ``TPUFW_SERVE_LATENCY_BREAKDOWN``,
``TPUFW_MAX_SAMPLING_CONFIGS`` (32) and ``TPUFW_WARMUP`` (on). Weights are
drawn at random from ``TPUFW_SEED``.

Not ported yet, and refused with ``NotImplementedError``: the tick batcher
(``TPUFW_SERVE_SLOTS=0``), chunked paged prefill
(``TPUFW_SERVE_PREFILL_CHUNK``), speculative decoding
(``TPUFW_SERVE_SPEC_K``, ``TPUFW_SERVE_SPEC_DRAFT``, ``TPUFW_DRAFT_MODEL``)
and the KV spill tier (``TPUFW_KV_SPILL``, ``TPUFW_KV_SPILL_DIR``), all
ROADMAP.md Queue 1 item 8; the disaggregated roles and page export
(``TPUFW_SERVE_ROLE``; item 9); telemetry (``TPUFW_TELEMETRY_DIR``, so
``GET /debug/profile`` answers 404; item 13); loading weights
(``TPUFW_CHECKPOINT_DIR``, ``TPUFW_PARAMS_CHECKPOINT``,
``TPUFW_HF_CHECKPOINT``; item 6).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional

import numpy as np
import torch

from tpufw_torch.obs.registry import Registry
from tpufw_torch.workloads.env import env_bool, env_float, env_int, env_str

_T0 = time.time()

DEMO_PROMPTS = [[1, 42, 7, 99], [1, 5], [1, 1000, 2000, 3000, 17]]


def _refuse(knob: str, what: str, item: str) -> None:
    raise NotImplementedError(
        f"TPUFW_{knob.upper()}: {what} is not ported to tpufw_torch yet "
        f"(ROADMAP.md Queue 1 item {item})"
    )


def build_generator():
    """(decode_model, model_cfg, restored) from the TPUFW_* environment.
    The weights are random, drawn from ``TPUFW_SEED`` on ``TPUFW_DEVICE``;
    ``restored`` is always False until checkpoints are ported."""
    from tpufw_torch.configs import BENCH_CONFIG_NAME, bench_model_config
    from tpufw_torch.models import LLAMA_CONFIGS, Llama

    for knob in ("hf_checkpoint", "params_checkpoint", "checkpoint_dir"):
        if env_str(knob, ""):
            _refuse(knob, "loading weights", "6")
    name = env_str("model", BENCH_CONFIG_NAME)
    if name == BENCH_CONFIG_NAME:
        model_cfg = bench_model_config()
    elif name in LLAMA_CONFIGS:
        model_cfg = LLAMA_CONFIGS[name]
    else:
        raise ValueError(
            f"unknown TPUFW_MODEL={name!r}; choose from "
            f"{[BENCH_CONFIG_NAME, *LLAMA_CONFIGS]}"
        )
    model_cfg = dataclasses.replace(
        model_cfg, max_seq_len=env_int("max_seq_len", model_cfg.max_seq_len)
    )
    model = Llama(
        model_cfg.decode_config(), device=env_str("device", "cuda"),
        seed=env_int("seed", 0),
    )
    model_cfg, model = _maybe_quantize(model_cfg, model)
    return model, model_cfg, False


def quantize_model(model):
    """The int8 twin of ``model`` (``quantized_weights=True``) on the same
    device, its weights from ``ops.quant.quantize_params``."""
    from tpufw_torch.models import Llama
    from tpufw_torch.ops.quant import quantize_params

    qcfg = dataclasses.replace(model.cfg, quantized_weights=True)
    state = quantize_params(model.state_dict())
    qmodel = Llama(qcfg, device=model.device)
    qmodel.load_state_dict(state)
    return qmodel


def _maybe_quantize(model_cfg, model):
    """TPUFW_QUANTIZE=int8: swap the model for its int8 twin."""
    mode = env_str("quantize", "")
    if not mode:
        return model_cfg, model
    if mode != "int8":
        raise ValueError(f"TPUFW_QUANTIZE={mode!r}: only 'int8' is implemented")
    qmodel = quantize_model(model)
    return dataclasses.replace(model_cfg, quantized_weights=True), qmodel


def _maybe_cast_decode(model):
    """TPUFW_DECODE_DTYPE (e.g. ``bfloat16``): the serving-precision cast
    of ``infer.cast_decode_params``, in place."""
    cast = env_str("decode_dtype", "")
    if not cast:
        return model
    from tpufw_torch.infer import cast_decode_params

    dtype = getattr(torch, cast, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"TPUFW_DECODE_DTYPE={cast!r} is not a torch dtype")
    return cast_decode_params(model, dtype)


def _pow2_ceil(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    size = floor
    while size < n:
        size *= 2
    return size


def _cache_bucket(need: int, cap: int, floor: int = 128) -> int:
    """Smallest pow-2 KV-cache length >= ``need`` (min ``floor``), capped
    at the model's ``cap``: a short request on a long-context model does
    not pay for the full cache."""
    return min(_pow2_ceil(need, floor), cap)


def text_codec():
    """(encode, decode) for text prompts, from TPUFW_TOKENIZER: only the
    dependency-free byte codec, utf-8 byte + 1 with id 0 kept for
    padding."""
    name = env_str("tokenizer", "bytes")
    if name != "bytes":
        raise NotImplementedError(
            f"TPUFW_TOKENIZER={name!r}: only 'bytes' is ported; HuggingFace "
            "tokenizers come with HF checkpoints (ROADMAP.md Queue 1 item 6)"
        )

    def encode(text: str) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(ids: list[int]) -> str:
        return bytes(t - 1 for t in ids if 0 < t <= 256).decode(
            "utf-8", errors="replace"
        )

    return encode, decode


def make_sampling(
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    min_p=0.0,
    repetition_penalty=1.0,
):
    """The sampling knobs, range-checked and quantized (temperature to
    0.01, top_p/min_p/penalty to 0.001) exactly as the JAX workload does,
    so equal requests give equal configs."""
    from tpufw_torch.infer import SamplingConfig

    t = round(float(temperature), 2)
    if t < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    kf = float(top_k or 0)
    if kf != int(kf):
        raise ValueError(f"top_k must be an integer, got {top_k}")
    k = int(kf)
    if k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    p = round(float(1.0 if top_p is None else top_p), 3)
    if p <= 0:
        raise ValueError(f"top_p must be > 0, got {top_p}")
    m = round(float(min_p or 0.0), 3)
    if not 0 <= m <= 1:
        raise ValueError(f"min_p must be in [0, 1], got {min_p}")
    r = round(
        float(1.0 if repetition_penalty is None else repetition_penalty), 3
    )
    if r <= 0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty}"
        )
    return SamplingConfig(
        temperature=t,
        top_k=k or None,
        top_p=p if p < 1.0 else None,
        min_p=m or None,
        repetition_penalty=None if r == 1.0 else r,
    )


def sampling_from_env():
    """SamplingConfig from TPUFW_* env; greedy by default."""
    return make_sampling(
        temperature=env_float("temperature", 0.0),
        top_k=env_int("top_k", 0),
        top_p=env_float("top_p", 1.0),
        min_p=env_float("min_p", 0.0),
        repetition_penalty=env_float("repetition_penalty", 1.0),
    )


def eos_from_env() -> Optional[int]:
    """TPUFW_EOS_ID: rows stop at this token (emitted, then truncated).
    Unset or negative: every row runs to max_new_tokens."""
    eos = env_int("eos_id", -1)
    return eos if eos >= 0 else None


def _pad_batch(
    prompts: list[list[int]], fill_id: int = 0
) -> tuple[list[list[int]], int]:
    """Pad the batch to a power of two rows; returns (padded, real_n).
    Filler rows hold ``fill_id`` and go in as dead rows (``live_rows``)."""
    n = len(prompts)
    return prompts + [[fill_id]] * (_pow2_ceil(n) - n), n


def generate_batch(model, prompts, max_new_tokens, sampling, eos):
    """``run_batch``'s generation on a built model: the batch padded to a
    power of two with dead filler rows, then ``generate_text``."""
    from tpufw_torch.infer import generate_text

    padded, real_n = _pad_batch(prompts, eos if eos is not None else 0)
    return generate_text(
        model,
        padded,
        max_new_tokens=max_new_tokens,
        sampling=sampling,
        eos_id=eos,
        live_rows=[i < real_n for i in range(len(padded))],
        prefill_chunk_size=env_int("prefill_chunk", 0) or None,
    )[:real_n]


def run_batch(prompts: list[list[int]], max_new_tokens: int) -> list[dict]:
    if env_str("draft_model", ""):
        _refuse("draft_model", "speculative decoding", "8")
    model, cfg, restored = build_generator()
    model = _maybe_cast_decode(model)
    outs = generate_batch(
        model, prompts, max_new_tokens, sampling_from_env(), eos_from_env()
    )
    return [
        {
            "prompt": p,
            "output": o,
            "restored_checkpoint": restored,
            "model_params": cfg.n_params(),
        }
        for p, o in zip(prompts, outs)
    ]


def _bucket(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


def _oai_to_native(req: dict) -> dict:
    """OpenAI ``/v1/completions`` request -> the native ``/generate``
    shape. Supported: ``prompt`` (string, list of strings, token list, or
    list of token lists), ``max_tokens``, ``temperature``, ``top_p``.
    Knobs that would change the semantics fail loudly with the native
    alternative named; values that request the default behaviour pass."""
    if "prompt" not in req:
        raise ValueError("prompt is required")
    if req.get("stream"):
        raise ValueError(
            "stream is not supported on /v1/completions; use "
            "/generate with \"stream\": true (SSE)"
        )
    if req.get("n") not in (None, 1):
        raise ValueError(
            "n > 1 is not supported on /v1/completions; post the "
            "prompt n times (ticks draw fresh seeds)"
        )
    defaults = {
        "logprobs": (None,),
        "echo": (None, False),
        "best_of": (None, 1),
        "presence_penalty": (None, 0, 0.0),
        "frequency_penalty": (None, 0, 0.0),
        "stop": (None, "", []),
    }
    alts = {
        "logprobs": "not supported",
        "echo": "prepend the prompt client-side",
        "best_of": "post the prompt best_of times and rank",
        "presence_penalty": "use repetition_penalty on /generate",
        "frequency_penalty": "use repetition_penalty on /generate",
        "stop": "set TPUFW_EOS_ID on the server",
    }
    for knob, ok_values in defaults.items():
        if knob in req and req[knob] not in ok_values:
            raise ValueError(
                f"{knob} is not supported on /v1/completions; "
                f"{alts[knob]}"
            )
    p = req["prompt"]
    native: dict = {"_oai_model": req.get("model", "")}
    if isinstance(p, str):
        native["texts"] = [p]
    elif isinstance(p, list) and p and all(isinstance(x, str) for x in p):
        native["texts"] = p
    elif isinstance(p, list) and p and all(isinstance(x, int) for x in p):
        native["prompts"] = [p]
    else:
        native["prompts"] = p  # [[int]]: /generate validates
    if "max_tokens" in req:
        native["max_new_tokens"] = req["max_tokens"]
    for knob in ("temperature", "top_p"):
        if knob in req:
            native[knob] = req[knob]
    return native


def _oai_response(outs, texts, prompts, max_new: int, model: str) -> dict:
    """OpenAI text_completion response shape. finish_reason: a row
    shorter than max_new ended at the server's eos ("stop"), otherwise it
    ran out of budget ("length")."""
    import uuid

    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model or "tpufw",
        "choices": [
            {
                "text": texts[i],
                "index": i,
                "logprobs": None,
                "finish_reason": (
                    "stop" if len(outs[i]) < max_new else "length"
                ),
            }
            for i in range(len(outs))
        ],
        "usage": {
            "prompt_tokens": sum(len(p) for p in prompts),
            "completion_tokens": sum(len(o) for o in outs),
            "total_tokens": sum(len(p) for p in prompts)
            + sum(len(o) for o in outs),
        },
    }


class _Pending:
    """One enqueued /generate request."""

    __slots__ = ("prompts", "max_new", "sampling", "done", "outputs",
                 "error", "batched_with", "stream_q")

    def __init__(self, prompts, max_new: int, sampling=None, stream_q=None):
        self.prompts = prompts
        self.max_new = max_new
        # None = the server's env-default SamplingConfig.
        self.sampling = sampling
        # Streaming request: per-chunk outputs go onto this queue (lists
        # of per-row new tokens), then a ("done", n)/("error", e)
        # sentinel.
        self.stream_q = stream_q
        self.done = threading.Event()
        self.outputs: list | None = None
        self.error: Exception | None = None
        self.batched_with = 1


class _Metrics:
    """Serving metrics on the port's registry: the JAX server's
    ``tpufw_serve_*`` names and text exposition. Call sites use the short
    names ("requests_total"); the prefix is applied here."""

    PREFIX = "tpufw_serve_"

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        # Pre-initialized to 0: an alert on increase(...errors_total)
        # must see a real 0-valued series before the first error.
        self.register(
            "requests_total",
            "request_errors_total",
            "request_seconds_total",
            "ticks_total",
            "tick_rows_total",
            "tokens_generated_total",
        )

    def inc(self, name: str, v: float = 1.0) -> None:
        self.registry.counter(self.PREFIX + name).inc(v)

    def register(self, *names: str) -> None:
        """Expose counters at 0 before their first increment."""
        for name in names:
            self.registry.counter(self.PREFIX + name)

    def reset(self, *names: str) -> None:
        """Zero counters that moved during work that must stay invisible
        to scrapes (warmup runs before the listener binds)."""
        for name in names:
            self.registry.counter(self.PREFIX + name).reset()

    def render(self, gauges: dict) -> str:
        """Prometheus text exposition; ``gauges`` are point-in-time
        values, refreshed into the registry at scrape time."""
        for name, v in gauges.items():
            self.registry.gauge(self.PREFIX + name).set(float(v))
        return self.registry.render()


class _SlotJob:
    """One prompt ROW moving through the slot pool: a request's rows may
    join across chunk boundaries as slots free up, and each retires at
    its own EOS or max_new."""

    __slots__ = ("req", "prompt", "p_bucket", "max_new", "cache_len",
                 "tokens", "unflushed")

    def __init__(self, req, prompt, p_bucket, max_new, cache_len):
        self.req = req
        self.prompt = prompt
        self.p_bucket = p_bucket
        self.max_new = max_new
        self.cache_len = cache_len
        self.tokens: list[int] = []
        self.unflushed: list[int] = []


class _SlotReq:
    """Request-level bookkeeping around a _Pending: the per-row jobs, the
    admission cursor (``next_job``) and completion accounting."""

    __slots__ = ("pend", "sampling", "jobs", "next_job", "rows_left",
                 "cache_len", "t_submit", "started", "error",
                 "batched_with", "overtaken")

    def __init__(self, pend, sampling):
        self.pend = pend
        self.sampling = sampling  # resolved (never None)
        # Filled by _SlotScheduler._make_req: each job points back here.
        self.jobs: list[_SlotJob] = []
        self.next_job = 0  # first not-yet-admitted job
        self.rows_left = 0
        self.cache_len = 0
        self.t_submit = time.time()
        self.started = False  # first row admitted (join latency mark)
        self.error: Exception | None = None
        self.batched_with = 1
        self.overtaken = 0  # admission rounds later arrivals ran ahead


# Random streams of the scheduler: each prefill draws from its own
# generator seeded from (seed base, _PREFILL_STREAM, job index), each
# decode chunk from (seed base, _CHUNK_STREAM, chunk index).
_PREFILL_STREAM, _CHUNK_STREAM = 0, 1


def stream_generator(device, seed_base: int, stream: int, index: int):
    """A ``torch.Generator`` on ``device`` seeded from (seed base, stream,
    index) through numpy's ``SeedSequence``: distinct triples give
    independent streams, the same triple replays the same draws."""
    seq = np.random.SeedSequence([seed_base % 2**64, stream, index])
    seed = int(seq.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


class _SlotScheduler:
    """Continuous batching at decode-STEP granularity (port of the JAX
    ``_SlotScheduler``; ``tpufw_torch.infer.slots`` and ``.pages`` hold
    the device side).

    Requests enqueue as per-row jobs; ONE worker thread
    (``tpufw-serve-sched``) admits rows into a persistent S-slot KV pool
    and advances ALL occupied slots k tokens per pass, moving the chunk's
    tokens to the host once. Rows join whenever a slot frees at a chunk
    boundary and retire at their own EOS/max_new, so a short request
    admitted next to a long one completes mid-flight, and streaming
    requests are ordinary slot occupants. HTTP handler threads touch only
    the host queue.

    The pool is keyed (cache_len, sampling), cache_len from the pow-2
    ``_cache_bucket`` ladder, and REKEYS only when it drains empty. Every
    pool decodes with the same model weights: the cache length and the
    paging belong to the pool's cache. The chunk length k is pow-2
    laddered against the largest remaining budget; greedy outputs do not
    depend on how the run is chunked.

    Fairness: FIFO within a pool key; an incompatible request is
    diverted past, but admission closes after ``n_slots`` overtakes so
    a mismatched head drains the pool instead of starving.

    Paged mode (``page`` > 0): a row acquires every page of its
    prompt + budget at admission (trie match first, then allocation with
    evictions); a row that does not fit waits, FIFO, for a retire. Prompts
    are prefilled at their exact width so their full pages line up with
    the trie's chunks.

    Sampling: each prefill and each chunk draws from its own generator
    (``stream_generator``), so the same arrival order and ``TPUFW_SEED``
    replay the same tokens; ``reset_after_warmup`` rewinds both indices.
    """

    def __init__(
        self,
        model,
        *,
        eos_id: Optional[int] = None,
        default_sampling=None,
        metrics: Optional[_Metrics] = None,
        seed_base: int = 0,
        page: Optional[int] = None,
        kv_quant: Optional[str] = None,
        prefix_cache: Optional[bool] = None,
        arena_pages: Optional[int] = None,
        page_export=None,
        spec_k: Optional[int] = None,
        spec_draft: Optional[str] = None,
        prefill_chunk_pages: Optional[int] = None,
    ):
        _refuse_unported_scheduler(
            page_export, spec_k, spec_draft, prefill_chunk_pages
        )
        self.model = model
        self._eos = eos_id
        self._default_sampling = (
            default_sampling
            if default_sampling is not None
            else sampling_from_env()
        )
        self._metrics = metrics
        self._seed_base = seed_base
        self.latency_breakdown = env_bool("serve_latency_breakdown", False)
        self.n_slots = max(1, env_int("serve_slots", 8))
        self.chunk = max(
            1, env_int("serve_chunk", 0) or env_int("stream_chunk", 16)
        )
        self.cache_floor = env_int("serve_cache_floor", 128)
        self.wait_s = env_int("batch_wait_ms", 5) / 1000.0
        self.prefill_chunk = env_int("prefill_chunk", 0) or None
        # Ctor kwargs win over the env, so one process can run several
        # modes on one model. page=0 keeps the contiguous SlotPool.
        self.page = env_int("serve_page", 0) if page is None else int(page)
        self.kv_quant = (
            env_str("serve_kv_quant", "") if kv_quant is None
            else str(kv_quant)
        )
        self.prefix_enabled = (
            env_bool("serve_prefix_cache", True) if prefix_cache is None
            else bool(prefix_cache)
        )
        self.arena_pages = arena_pages
        if self.page:
            cap = model.cfg.max_seq_len
            # Every cache-ladder rung is a pow2 >= cache_floor or the
            # model cap, so "page is pow2, page <= floor, page divides
            # cap" makes the page divide every rung.
            if self.page < 1 or self.page & (self.page - 1):
                raise ValueError(
                    f"TPUFW_SERVE_PAGE={self.page}: page size must be a "
                    "power of two"
                )
            if self.page > self.cache_floor:
                raise ValueError(
                    f"TPUFW_SERVE_PAGE={self.page} exceeds the cache floor "
                    f"({self.cache_floor}); pages must divide every "
                    "cache-ladder rung"
                )
            if cap % self.page:
                raise ValueError(
                    f"TPUFW_SERVE_PAGE={self.page} does not divide "
                    f"max_seq_len={cap}"
                )
            if self.kv_quant not in ("", "int8"):
                raise ValueError(
                    f"TPUFW_SERVE_KV_QUANT={self.kv_quant!r}: expected '' "
                    "or 'int8'"
                )
        if metrics is not None:
            metrics.register(
                "retired_rows_total",
                "wasted_slot_steps_total",
                "pool_switches_total",
            )
            if self.page:
                # Feature-gated: the contiguous exposition stays the
                # JAX server's byte for byte.
                metrics.register(
                    "prefix_hits_total",
                    "prefix_misses_total",
                    "pages_freed_total",
                )
            metrics.registry.histogram(
                "tpufw_serve_join_latency_seconds",
                "Request submit-to-first-slot-insert latency",
            )
            if self.latency_breakdown:
                metrics.registry.histogram(
                    "tpufw_serve_queue_wait_seconds",
                    "Request submit-to-admission-start latency",
                )
                metrics.registry.histogram(
                    "tpufw_serve_prefill_seconds",
                    "Per-row prefill wall-clock",
                )
        self._pool = None  # SlotPool or PagedSlotPool (lazy, keyed)
        self._pool_key: Optional[tuple] = None
        self._slots: list[Optional[_SlotJob]] = [None] * self.n_slots
        self._n_active = 0
        # Monotonic indices of the random streams; both rewound by
        # reset_after_warmup so warmup is invisible to seed replay.
        self._job_index = 0
        self._chunk_index = 0
        # Host wall time of the decode chunks (ending in the one host
        # transfer of their tokens) and the steps they ran.
        self.decode_s = 0.0
        self.decode_steps_run = 0
        self._peak_pages = 0  # of the pools already replaced
        self._queue: list[_SlotReq] = []
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tpufw-serve-sched"
        )
        self._thread.start()

    # ---- client-facing interface ----

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    @property
    def slots_total(self) -> int:
        return self.n_slots

    @property
    def slots_occupied(self) -> int:
        with self._cv:
            return self._n_active

    def _allocator(self):
        """The current pool's page allocator, or None (contiguous mode,
        or no pool yet). Scrapes read it from other threads while the
        worker may swap the pool, so the pool is read once."""
        pool = self._pool
        return pool.allocator if self.page and pool is not None else None

    @property
    def pages_total(self) -> int:
        """Arena capacity of the current pool (0 before the first build
        or in contiguous mode); page 0 is never allocatable."""
        a = self._allocator()
        return 0 if a is None else a.capacity

    @property
    def pages_in_use(self) -> int:
        a = self._allocator()
        return 0 if a is None else a.in_use

    @property
    def peak_pages_in_use(self) -> int:
        """Most arena pages in use at once, over every pool so far."""
        a = self._allocator()
        return max(self._peak_pages, 0 if a is None else a.peak_in_use)

    @property
    def pool(self):
        """The current pool (None before the first admission)."""
        return self._pool

    def submit(self, prompts, max_new: int, sampling=None):
        pend = _Pending(prompts, max_new, sampling)
        self._enqueue(pend)
        pend.done.wait()
        if pend.error is not None:
            raise pend.error
        return pend.outputs, pend.batched_with

    def submit_stream(self, prompts, max_new: int, sampling, q) -> None:
        """Enqueue a streaming request and return at once: the caller
        reads per-chunk row outputs from ``q`` until the ("done", n) or
        ("error", e) sentinel."""
        self._enqueue(_Pending(prompts, max_new, sampling, stream_q=q))

    def reset_after_warmup(self) -> None:
        """Rewind the random-stream indices so warmup prefills and chunks
        are invisible to seed replay."""
        with self._cv:
            self._job_index = 0
            self._chunk_index = 0

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker thread; queued and active requests fail."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _enqueue(self, pend: _Pending) -> None:
        req = self._make_req(pend)  # raises ValueError -> HTTP 400
        with self._cv:
            if self._closed:
                raise RuntimeError("the serving scheduler is closed")
            self._queue.append(req)
            self._cv.notify()

    def _make_req(self, pend: _Pending) -> _SlotReq:
        cap = self.model.cfg.max_seq_len
        sampling = (
            pend.sampling if pend.sampling is not None
            else self._default_sampling
        )
        jobs = []
        req = _SlotReq(pend, sampling)
        for prompt in pend.prompts:
            # Paged rows prefill at their EXACT width: padding would
            # burn pages and misalign the prompt's page chunks.
            pb = max(len(prompt), 1) if self.page else _bucket(len(prompt), 64)
            # Prefill writes pb slots, decode max_new - 1 more.
            if pb + pend.max_new - 1 > cap:
                raise ValueError(
                    f"prompt ({len(prompt)}, bucketed to {pb}) + "
                    f"max_new_tokens ({pend.max_new}) exceeds the KV cache "
                    f"(max_seq_len={cap})"
                )
            if self.page and self.arena_pages is not None:
                need = -(-(pb + pend.max_new - 1) // self.page)
                if need > self.arena_pages - 1:
                    # A row that can NEVER fit would block the FIFO.
                    raise ValueError(
                        f"row needs {need} KV pages but the arena holds "
                        f"{self.arena_pages - 1}"
                    )
            jobs.append(_SlotJob(
                req, prompt, pb, pend.max_new,
                _cache_bucket(pb + pend.max_new - 1, cap, self.cache_floor),
            ))
        req.jobs = jobs
        req.rows_left = len(jobs)
        req.cache_len = max(j.cache_len for j in jobs)
        return req

    # ---- worker loop ----

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not (self._queue or self._n_active or self._closed):
                    self._cv.wait()
                if self._closed:
                    break
                idle = self._n_active == 0
            if idle and self.wait_s > 0:
                # Coalescing window: near-simultaneous arrivals land in
                # the same first admission round.
                time.sleep(self.wait_s)
            # Autograd state is thread-local: this thread runs every
            # device call, so it turns gradients off for itself.
            with torch.no_grad():
                try:
                    self._admit()
                    if self._n_active:
                        self._run_chunk()
                except Exception as e:  # noqa: BLE001 — serving loop
                    self._fail_active(e)
        self._fail_all(RuntimeError("the serving scheduler is closed"))

    def _generator(self, stream: int, index: int):
        """The stream's generator, or None for greedy pools (they draw
        nothing)."""
        if not self._pool.sampling.temperature:
            return None
        return stream_generator(
            self.model.device, self._seed_base, stream, index
        )

    def _build_pool(self, key) -> None:
        from tpufw_torch.infer.pages import PagedSlotPool
        from tpufw_torch.infer.slots import SlotPool

        cache_len, sampling = key
        if self.page and self._pool is not None:
            self._peak_pages = max(
                self._peak_pages, self._pool.allocator.peak_in_use
            )
        # Drop the old pool first: its memory serves the new one.
        self._pool = None
        if self.page:
            self._pool = PagedSlotPool.create_paged(
                self.model,
                self.n_slots,
                cache_len=cache_len,
                page=self.page,
                # Default: n_slots full rows plus the reserved page 0,
                # the contiguous pool's memory.
                n_pages=self.arena_pages,
                kv_quant=self.kv_quant,
                sampling=sampling,
                pad_id=0,
                eos_id=self._eos,
                prefix_cache=self.prefix_enabled,
            )
        else:
            self._pool = SlotPool.create(
                self.model,
                self.n_slots,
                sampling=sampling,
                pad_id=0,
                eos_id=self._eos,
                cache_len=cache_len,
            )
        self._pool_key = key
        self._slots = [None] * self.n_slots
        self._n_active = 0
        if self._metrics is not None:
            self._metrics.inc("pool_switches_total")

    def _admit(self) -> None:
        with self._cv:
            queue = list(self._queue)
        if not queue:
            return
        # The pool rekeys ONLY when empty: the head request defines the
        # (cache_len, sampling) every later admission must match.
        if self._n_active == 0:
            head = queue[0]
            key = (head.cache_len, head.sampling)
            if self._pool is None or self._pool_key != key:
                try:
                    self._build_pool(key)
                except Exception as e:  # noqa: BLE001 — serving loop
                    self._fail_req(head, e)
                    return
        if self._pool is None:
            return
        cache_cap = self._pool.cache_len
        pool_sampling = self._pool.sampling
        free = [i for i, j in enumerate(self._slots) if j is None]
        budget_closed = False
        blocked: Optional[_SlotReq] = None
        for req in queue:
            if req.error is not None:
                continue
            if req.sampling != pool_sampling or req.cache_len > cache_cap:
                if blocked is None:
                    blocked = req
                    if req.overtaken >= self.n_slots:
                        # Fairness valve: stop feeding the pool and let
                        # it drain so the head can rekey it.
                        break
                continue
            if budget_closed:
                continue  # FIFO within a pool key: no overtaking
            if not free:
                budget_closed = True
                continue
            if self._admit_req(req, free) and blocked is not None:
                blocked.overtaken += 1
            if req.next_job < len(req.jobs) and req.error is None:
                budget_closed = True
        with self._cv:
            self._queue = [
                r for r in self._queue
                if r.error is None and r.next_job < len(r.jobs)
            ]
        # batched_with: how many distinct requests share the pool now.
        reqs = {id(j.req): j.req for j in self._slots if j is not None}
        for req in reqs.values():
            req.batched_with = max(req.batched_with, len(reqs))

    def _admit_req(self, req: _SlotReq, free: list) -> bool:
        """Admit as many of ``req``'s remaining rows as fit; True if at
        least one row was prefilled."""
        t_admit0 = time.time()
        admitted = False
        while free and req.next_job < len(req.jobs):
            job = req.jobs[req.next_job]
            grant = None
            if self.page:
                # Page-budget admission: the row needs every page of its
                # prompt + budget up front. None = arena full even after
                # trie eviction: stop and let retires free pages.
                grant = self._pool.acquire_pages(
                    job.prompt, len(job.prompt) + job.max_new - 1
                )
                if grant is None:
                    break
            try:
                used_slot = self._admit_job(req, job, free[0], grant)
            except Exception as e:  # noqa: BLE001 — isolate request
                if grant is not None:
                    self._free_pages(self._pool.release_pages(grant[0]))
                self._fail_req(req, e)
                return admitted
            req.next_job += 1
            admitted = True
            if used_slot:
                free.pop(0)
        if admitted and not req.started:
            req.started = True
            if self._metrics is not None:
                self._metrics.registry.histogram(
                    "tpufw_serve_join_latency_seconds"
                ).observe(time.time() - req.t_submit)
                if self.latency_breakdown:
                    self._metrics.registry.histogram(
                        "tpufw_serve_queue_wait_seconds"
                    ).observe(max(0.0, t_admit0 - req.t_submit))
        if admitted and req.pend.stream_q is not None:
            # First tokens reach the stream at admission.
            self._flush_stream(req)
        if req.rows_left == 0 and req.next_job == len(req.jobs):
            self._finish(req)
        return admitted

    def _admit_job(self, req: _SlotReq, job: _SlotJob, slot: int,
                   grant=None) -> bool:
        """Prefill one row and, unless it finishes at its first token,
        insert it into ``slot``. Returns True iff the slot was consumed.
        ``grant`` is paged mode's (page_ids, shared_n); this method
        releases it on the early-finish path (the caller on
        exceptions)."""
        from tpufw_torch.infer.slots import prefill_row

        with self._cv:
            job_index = self._job_index
            self._job_index += 1
        gen = self._generator(_PREFILL_STREAM, job_index)
        pool = self._pool
        if grant is not None:
            page_ids, shared_n = grant
            if self.prefix_enabled and self._metrics is not None:
                self._metrics.inc(
                    "prefix_hits_total" if shared_n
                    else "prefix_misses_total"
                )
        prefill_t0 = time.perf_counter()
        if grant is not None and shared_n > 0:
            cache, _first, first_int, _done, seen = pool.prefill_shared(
                job.prompt, page_ids[:shared_n], gen
            )
        else:
            cache, _first, first_int, _done, seen = prefill_row(
                self.model,
                job.prompt,
                gen,
                sampling=pool.sampling,
                eos_id=self._eos,
                pad_to=job.p_bucket,
                prefill_chunk_size=self.prefill_chunk,
                cache_len=pool.cache_len,
            )
        if self.latency_breakdown and self._metrics is not None:
            self._metrics.registry.histogram(
                "tpufw_serve_prefill_seconds"
            ).observe(time.perf_counter() - prefill_t0)
        job.tokens.append(first_int)
        job.unflushed.append(first_int)
        if self._metrics is not None:
            self._metrics.inc("tokens_generated_total")
        if job.max_new == 1 or (
            self._eos is not None and first_int == self._eos
        ):
            # Finished at its first token: the row never takes a slot.
            if grant is not None:
                self._free_pages(pool.release_pages(page_ids))
            if self._metrics is not None:
                self._metrics.inc("retired_rows_total")
            req.rows_left -= 1
            return False
        if grant is not None:
            pool.insert_paged(
                slot, cache, first_int, len(job.prompt), job.max_new - 1,
                page_ids, shared_n, row_seen=seen,
            )
            if self.prefix_enabled:
                # After the insert: the pages now hold the prompt's K/V.
                pool.register_prefix(job.prompt, page_ids)
        else:
            pool.insert(
                slot, cache, first_int, len(job.prompt), job.max_new - 1,
                row_seen=seen,
            )
        with self._cv:
            self._slots[slot] = job
            self._n_active += 1
        return True

    def _free_pages(self, freed: int) -> None:
        if freed and self._metrics is not None:
            self._metrics.inc("pages_freed_total", freed)

    def _retire_slot(self, slot: int, *, device: bool) -> None:
        """Vacate ``slot``. ``device=True`` also freezes the row's masks
        (error paths; natural completions froze inside the step). Paged
        pools always zero the slot's table row before its pages go back
        on the free list."""
        if self.page:
            self._free_pages(self._pool.release_slot(slot))
        elif device:
            self._pool.retire(slot)
        with self._cv:
            self._slots[slot] = None
            self._n_active -= 1

    def _run_chunk(self) -> None:
        active = [(i, j) for i, j in enumerate(self._slots) if j is not None]
        if not active:
            return
        # Pow-2 ladder on the chunk length: the tail of a nearly done
        # pool shrinks k in big steps.
        max_left = max(j.max_new - len(j.tokens) for _, j in active)
        k = min(self.chunk, _pow2_ceil(max_left))
        with self._cv:
            chunk_index = self._chunk_index
            self._chunk_index += 1
        gen = self._generator(_CHUNK_STREAM, chunk_index)
        chunk_t0 = time.perf_counter()
        out = self._pool.decode_steps(k, gen).tolist()  # one host sync
        self.decode_s += time.perf_counter() - chunk_t0
        self.decode_steps_run += k
        if self._metrics is not None:
            self._metrics.inc("ticks_total")
            self._metrics.inc("tick_rows_total", len(active))
        live_tokens = 0
        flush: list[_SlotReq] = []
        finished: list[_SlotReq] = []
        for slot, job in active:
            req = job.req
            take = min(k, job.max_new - len(job.tokens))
            row = out[slot][:take]
            if self._eos is not None and self._eos in row:
                row = row[: row.index(self._eos) + 1]
            job.tokens.extend(row)
            job.unflushed.extend(row)
            live_tokens += len(row)
            if req.pend.stream_q is not None and req not in flush:
                flush.append(req)
            if len(job.tokens) >= job.max_new or (
                self._eos is not None and row and row[-1] == self._eos
            ):
                self._retire_slot(slot, device=False)
                if self._metrics is not None:
                    self._metrics.inc("retired_rows_total")
                req.rows_left -= 1
                if req.rows_left == 0 and req.next_job == len(req.jobs):
                    finished.append(req)
        if self._metrics is not None:
            self._metrics.inc("tokens_generated_total", live_tokens)
            # S * k slot-steps ran; those not delivering a live token are
            # the batching overhead TPUFW_SERVE_SLOTS/_CHUNK trade off.
            self._metrics.inc(
                "wasted_slot_steps_total", self.n_slots * k - live_tokens
            )
        for req in flush:
            if req not in finished:
                self._flush_stream(req)
        for req in finished:
            self._finish(req)

    # ---- completion / failure ----

    def _flush_stream(self, req: _SlotReq) -> None:
        rows = [list(j.unflushed) for j in req.jobs]
        if not any(rows):
            return
        for j in req.jobs:
            j.unflushed = []
        req.pend.stream_q.put(("chunk", rows))

    def _finish(self, req: _SlotReq) -> None:
        with self._cv:
            if req in self._queue:
                self._queue.remove(req)
        pend = req.pend
        outs = [list(j.tokens[: j.max_new]) for j in req.jobs]
        if pend.stream_q is not None:
            self._flush_stream(req)
            pend.stream_q.put(("done", sum(len(o) for o in outs)))
        else:
            pend.outputs = outs
        pend.batched_with = req.batched_with
        pend.done.set()

    def _signal_error(self, req: _SlotReq, e: Exception) -> None:
        req.error = e
        with self._cv:
            if req in self._queue:
                self._queue.remove(req)
        pend = req.pend
        pend.error = e
        if pend.stream_q is not None:
            pend.stream_q.put(("error", e))
        pend.done.set()

    def _fail_req(self, req: _SlotReq, e: Exception) -> None:
        """Fail ONE request (admission-time errors): its active slots
        retire, everything else keeps running."""
        for i, job in enumerate(self._slots):
            if job is not None and job.req is req:
                self._retire_slot(i, device=True)
        self._signal_error(req, e)

    def _fail_active(self, e: Exception) -> None:
        """A decode chunk failed: every ACTIVE request shares its fate
        (their pool state is suspect), queued requests survive and the
        pool rebuilds at the next admission."""
        reqs = {id(j.req): j.req for j in self._slots if j is not None}
        with self._cv:
            self._slots = [None] * self.n_slots
            self._n_active = 0
        self._pool = None
        self._pool_key = None
        for req in reqs.values():
            self._signal_error(req, e)

    def _fail_all(self, e: Exception) -> None:
        """Shutdown: fail whatever is active or still queued."""
        self._fail_active(e)
        with self._cv:
            queue, self._queue = self._queue, []
        for req in queue:
            self._signal_error(req, e)


def _refuse_unported_scheduler(page_export, spec_k, spec_draft,
                               prefill_chunk_pages) -> None:
    """The scheduler's knobs whose modules are not ported yet."""
    if page_export is not None:
        raise NotImplementedError(
            "page_export: exporting pages to a decode replica is not "
            "ported to tpufw_torch yet (ROADMAP.md Queue 1 item 9)"
        )
    for knob, kwarg, what in (
        ("serve_prefill_chunk", prefill_chunk_pages, "chunked paged prefill"),
        ("serve_spec_k", spec_k, "speculative decoding"),
        ("serve_spec_draft", spec_draft, "speculative decoding"),
        ("kv_spill", None, "the KV spill tier"),
        ("kv_spill_dir", None, "the KV spill tier"),
    ):
        if kwarg or env_str(knob, "") not in ("", "0"):
            _refuse(knob, what, "8")


class _Server:
    """HTTP serving over the slot scheduler (port of the JAX ``_Server``).

    ``model`` serves a model the caller built (its weights are used as
    they are); otherwise ``build_generator`` builds one from the
    ``TPUFW_*`` environment and ``TPUFW_DECODE_DTYPE`` casts it."""

    def __init__(self, port: int, max_new_tokens: int, model=None):
        if env_int("serve_slots", 8) <= 0:
            _refuse("serve_slots", "the tick batcher (TPUFW_SERVE_SLOTS=0)",
                    "8")
        if env_str("draft_model", ""):
            _refuse("draft_model", "speculative decoding", "8")
        if env_str("telemetry_dir", ""):
            _refuse("telemetry_dir", "serving telemetry", "13")
        _refuse_unported_scheduler(None, None, None, None)
        self._sampling = sampling_from_env()
        if model is None:
            model, self.cfg, self.restored = build_generator()
            model = _maybe_cast_decode(model)
        else:
            self.cfg, self.restored = model.cfg, False
        self.model = model
        self.default_new = max_new_tokens
        self._eos_id = eos_from_env()
        self.metrics = _Metrics()
        self.port = port
        self.httpd = None
        self._codec = None
        # Distinct per-request sampling configs admitted so far: each
        # config keys its own pool, so their variety is capped.
        self._sampling_seen: set = set()
        self._sampling_cap = env_int("max_sampling_configs", 32)
        self._sampling_lock = threading.Lock()
        self._seed_base = env_int("seed", 0)
        self._batcher = _SlotScheduler(
            self.model,
            eos_id=self._eos_id,
            default_sampling=self._sampling,
            metrics=self.metrics,
            seed_base=self._seed_base,
        )
        if env_int("warmup", 1):
            self._warmup()

    def _warmup(self) -> None:
        """One tiny request before the listener binds, so the first live
        request does not pay for the first pool and the allocator's
        first blocks. The counters it moved and the random-stream
        indices are restored, so warmup stays invisible to scrapes and
        to seed replay."""
        import sys

        try:
            self._batcher.submit([[1]], self.default_new, None)
        except Exception as e:  # noqa: BLE001 — warmup is optional
            print(f"serve: warmup skipped: {e}", file=sys.stderr)
        finally:
            self._batcher.reset_after_warmup()
            self.metrics.reset(
                "ticks_total",
                "tick_rows_total",
                "tokens_generated_total",
                "retired_rows_total",
                "wasted_slot_steps_total",
                "pool_switches_total",
            )
            if self._batcher.page:
                # Resetting in contiguous mode would CREATE these series.
                self.metrics.reset(
                    "prefix_hits_total",
                    "prefix_misses_total",
                    "pages_freed_total",
                )
            reg = self.metrics.registry
            reg.histogram("tpufw_serve_join_latency_seconds").reset()
            if self._batcher.latency_breakdown:
                reg.histogram("tpufw_serve_queue_wait_seconds").reset()
                reg.histogram("tpufw_serve_prefill_seconds").reset()

    def admit_sampling(self, sampling) -> bool:
        """True if this non-default config is within the server's
        distinct-config budget (TPUFW_MAX_SAMPLING_CONFIGS, default 32);
        known configs are always admitted."""
        with self._sampling_lock:
            if sampling in self._sampling_seen:
                return True
            if len(self._sampling_seen) >= self._sampling_cap:
                return False
            self._sampling_seen.add(sampling)
            return True

    def codec(self):
        if self._codec is None:
            self._codec = text_codec()
        return self._codec

    def _gauge_values(self) -> dict:
        """Point-in-time gauges for /metrics, read from the scheduler at
        scrape time."""
        b = self._batcher
        g = {
            "queue_depth": float(b.queue_depth),
            "uptime_seconds": time.time() - _T0,
            "slots_occupied": float(b.slots_occupied),
            "slots_total": float(b.slots_total),
        }
        if b.page:
            g["pages_in_use"] = float(b.pages_in_use)
            g["pages_total"] = float(b.pages_total)
        return g

    def generate(self, prompts, max_new: int, sampling=None):
        """Returns (outputs, batched_with): how many requests shared the
        pool while this one ran."""
        return self._batcher.submit(prompts, max_new, sampling)

    def generate_stream(self, prompts, max_new: int, sampling=None):
        """Yields per-chunk row outputs as the scheduler produces them;
        raises the request's error if it failed."""
        import queue as _queue

        q: _queue.Queue = _queue.Queue()
        self._batcher.submit_stream(prompts, max_new, sampling, q)
        while True:
            kind, payload = q.get()
            if kind == "chunk":
                yield payload
            elif kind == "done":
                return
            else:
                raise payload

    def shutdown(self) -> None:
        """Stop the listener (if serving) and the scheduler thread."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self._batcher.close()

    def _parse_request(self, req: dict):
        """(prompts, max_new, sampling, decode or None) of a /generate
        body; raises ValueError on a bad request."""
        decode = None
        if "texts" in req:
            texts = req["texts"]
            if not isinstance(texts, list) or not texts or not all(
                isinstance(t, str) and t for t in texts
            ):
                raise ValueError(
                    "texts must be a non-empty list of non-empty strings"
                )
            encode, decode = self.codec()
            prompts = [encode(t) for t in texts]
        else:
            prompts = req["prompts"]
            if not prompts or not all(
                isinstance(p, list) and all(isinstance(t, int) for t in p)
                for p in prompts
            ):
                raise ValueError(
                    "prompts must be a non-empty list of token-id lists"
                )
        max_new = int(req.get("max_new_tokens", self.default_new))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # Per-request sampling overrides layered on the env defaults,
        # through the same make_sampling rules.
        sampling = None
        knobs = ("temperature", "top_k", "top_p", "min_p",
                 "repetition_penalty")
        if any(kb in req for kb in knobs):
            base = self._sampling
            sampling = make_sampling(
                temperature=req.get("temperature", base.temperature),
                top_k=req.get("top_k", base.top_k),
                top_p=req.get("top_p", base.top_p),
                min_p=req.get("min_p", base.min_p),
                repetition_penalty=req.get(
                    "repetition_penalty", base.repetition_penalty
                ),
            )
            if sampling == base:
                # Explicit defaults share the default pool.
                sampling = None
            elif not self.admit_sampling(sampling):
                raise ValueError(
                    "too many distinct sampling configs (each keys its own "
                    "pool); reuse an earlier configuration"
                )
        return prompts, max_new, sampling, decode

    def serve_forever(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {
                        "ok": True,
                        "restored_checkpoint": outer.restored,
                        "uptime_s": round(time.time() - _T0, 1),
                    })
                elif self.path == "/metrics":
                    body = outer.metrics.render(
                        outer._gauge_values()
                    ).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.split("?", 1)[0] == "/debug/profile":
                    # The JAX server's answer without telemetry.
                    self._reply(404, {"error": "profiler not configured"})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                oai = self.path == "/v1/completions"
                if self.path != "/generate" and not oai:
                    self._reply(404, {"error": "unknown path"})
                    return
                outer.metrics.inc("requests_total")
                t_req = time.time()
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if oai:
                        req = _oai_to_native(req)
                    prompts, max_new, sampling, decode = (
                        outer._parse_request(req)
                    )
                    if bool(req.get("stream", False)):
                        self._stream(prompts, max_new, sampling, decode)
                        return
                    outs, batched_with = outer.generate(
                        prompts, max_new, sampling
                    )
                    if oai:
                        self._reply(200, _oai_response(
                            outs,
                            [outer.codec()[1](o) for o in outs],
                            prompts,
                            max_new,
                            model=str(req.get("_oai_model", "")),
                        ))
                        return
                    payload = {"outputs": outs, "batched_with": batched_with}
                    if decode is not None:
                        payload["texts"] = [decode(o) for o in outs]
                    self._reply(200, payload)
                except Exception as e:  # noqa: BLE001 — serving loop
                    outer.metrics.inc("request_errors_total")
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    outer.metrics.inc(
                        "request_seconds_total", time.time() - t_req
                    )

            def _stream(self, prompts, max_new, sampling, decode):
                """SSE: per-chunk events of per-row NEW token ids, then a
                done event (with the full texts for "texts" requests).
                The headers are out once this starts, so every failure
                ends as an error event, never a second status line."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                dead = False

                def event(obj) -> None:
                    nonlocal dead
                    if dead:
                        return
                    try:
                        self.wfile.write(
                            b"data: " + json.dumps(obj).encode() + b"\n\n"
                        )
                        self.wfile.flush()
                    except OSError:
                        # The client left; the loop still drains the
                        # scheduler's queue.
                        dead = True

                rows_acc = [[] for _ in prompts]
                try:
                    for rows in outer.generate_stream(
                        prompts, max_new, sampling
                    ):
                        for acc, r in zip(rows_acc, rows):
                            acc.extend(r)
                        event({"outputs": rows})
                    final = {"done": True}
                    if decode is not None:
                        final["texts"] = [decode(o) for o in rows_acc]
                    event(final)
                except Exception as e:  # noqa: BLE001
                    outer.metrics.inc("request_errors_total")
                    event({"error": f"{type(e).__name__}: {e}"})

        httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = httpd.server_address[1]  # resolve port 0 -> actual
        self.httpd = httpd
        print(
            json.dumps({
                "serving": True,
                "port": self.port,
                "model_params": self.cfg.n_params(),
                "restored_checkpoint": self.restored,
                "device": str(self.model.device),
                "startup_s": round(time.time() - _T0, 1),
            }),
            flush=True,
        )
        httpd.serve_forever()


def main() -> int:
    if env_str("serve_role", ""):
        _refuse("serve_role", "disaggregated serving", "9")
    max_new = env_int("max_new_tokens", 16)
    port = env_int("serve_port", 0)
    if port:
        _Server(port, max_new).serve_forever()
        return 0
    prompts_file = env_str("prompts_file", "")
    if prompts_file:
        with open(prompts_file) as f:
            prompts = json.load(f)
    else:
        prompts = DEMO_PROMPTS
    for result in run_batch(prompts, max_new):
        print(json.dumps(result), flush=True)
    print(
        json.dumps(
            {
                "generate_ok": True,
                "n_prompts": len(prompts),
                "max_new_tokens": max_new,
                "device": env_str("device", "cuda"),
                "total_s": round(time.time() - _T0, 1),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
