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
  prefix sharing, optional int8 KV (``TPUFW_SERVE_KV_QUANT=int8``) and an
  optional host spill tier for evicted prefix pages; or, with
  ``TPUFW_SERVE_SLOTS=0``, by ``_Batcher``, which coalesces the waiting
  requests into one batched generate call per tick.

Knobs, as in the JAX workload: ``TPUFW_MODEL`` (a ``LLAMA_CONFIGS``,
``MIXTRAL_CONFIGS``, ``GEMMA_CONFIGS`` or ``DEEPSEEK_CONFIGS`` preset, e.g.
``mixtral_8x7b``, ``gemma2_9b``, ``deepseek_mla_bench`` or
``deepseek_moe_tiny``, a serve slice such as ``mixtral_8x7b_serve_slice``
or ``deepseek_v2_lite_serve_slice``, or ``llama3_600m_bench``, the
default), ``TPUFW_MAX_SEQ_LEN``,
``TPUFW_SEED``, ``TPUFW_MAX_NEW_TOKENS`` (16), ``TPUFW_QUANTIZE=int8``,
``TPUFW_DECODE_DTYPE`` (e.g. ``bfloat16``), ``TPUFW_PREFILL_CHUNK``,
``TPUFW_EOS_ID``, the sampling knobs ``TPUFW_TEMPERATURE``,
``TPUFW_TOP_K``, ``TPUFW_TOP_P``, ``TPUFW_MIN_P`` and
``TPUFW_REPETITION_PENALTY``, ``TPUFW_TOKENIZER`` (``bytes`` or a local
HuggingFace tokenizer directory, read through ``transformers``), and
``TPUFW_DEVICE`` (default ``cuda``); speculative decoding with a draft
model, ``TPUFW_DRAFT_MODEL`` (a preset of either family, weights drawn
from ``TPUFW_SEED`` + 1) and ``TPUFW_DRAFT_K`` (4), in batch mode and as
the server's draft pool (whole-batch speculation in the tick batcher);
for the server ``TPUFW_SERVE_SLOTS`` (8; 0 = the tick batcher, with
``TPUFW_BATCH_MAX_ROWS`` (64) and ``TPUFW_WARMUP_BUCKETS`` ("1")),
``TPUFW_SERVE_CHUNK`` (default ``TPUFW_STREAM_CHUNK``, 16),
``TPUFW_SERVE_CACHE_FLOOR`` (128), ``TPUFW_BATCH_WAIT_MS`` (5),
``TPUFW_SERVE_PAGE``, ``TPUFW_SERVE_KV_QUANT``,
``TPUFW_SERVE_PREFIX_CACHE`` (on), ``TPUFW_KV_SPILL`` (the spill tier's
host budget in pages) and ``TPUFW_KV_SPILL_DIR`` (its directory tier;
both need ``TPUFW_SERVE_PAGE``), ``TPUFW_SERVE_PREFILL_CHUNK`` (chunked
paged prefill, in pages per chunk; needs ``TPUFW_SERVE_PAGE``),
``TPUFW_SERVE_SPEC_K`` (speculative passes of k drafts on the slot pool),
``TPUFW_SERVE_SPEC_DRAFT`` (empty or ``ngram``: n-gram self-drafting; a
preset name: a draft pool of that model), ``TPUFW_SERVE_SPEC_MIN_ACCEPT``
(0.25), ``TPUFW_SERVE_LATENCY_BREAKDOWN``, ``TPUFW_MAX_SAMPLING_CONFIGS``
(32) and ``TPUFW_WARMUP`` (on). Weights come from
``TPUFW_HF_CHECKPOINT`` (an HF directory, which also names the
architecture), ``TPUFW_PARAMS_CHECKPOINT`` (bare params of
``TPUFW_MODEL``, ``tools.import_hf``'s output) or ``TPUFW_CHECKPOINT_DIR``
(the latest training checkpoint), else at random from ``TPUFW_SEED``; the
draft's from ``TPUFW_DRAFT_PARAMS_CHECKPOINT``. Speculation on the slot
pool does not compose with a
repetition penalty: such pools decode plainly, as in the JAX workload.

Disaggregated serving: ``TPUFW_SERVE_ROLE=prefill|decode|router`` runs
this process as one replica role or the front-door router
(``tpufw_torch.serve.roles.main_role``; knobs there and in
``tpufw_torch.serve.router``), and ``_SlotScheduler(page_export=)`` hands
every retiring paged row's exported pages to a hook.

Telemetry (``tpufw``'s knobs and files): ``TPUFW_TELEMETRY_DIR`` gives the
server an event log, a span trace (``trace-serve.json``), the goodput
tables (``goodput.json``, ``tpufw_goodput_ratio``,
``tpufw_badput_seconds_total``), ``programs.json`` (each decode chunk
length's counted costs and MFU), a crash bundle on an abnormal exit, the
``TPUFW_HANG_TIMEOUT_S`` watchdog around each scheduler pass, and
``GET /debug/profile?seconds=N`` (a ``torch.profiler`` capture of the
whole process, the scheduler thread's kernels included); without it that
route answers 404. ``TPUFW_COMPILE_CACHE_DIR`` as in ``train_llama``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from tpufw_torch.obs.registry import Registry
from tpufw_torch.utils.hardware import resolve_device
from tpufw_torch.workloads.env import (
    env_bool,
    env_float,
    env_int,
    env_str,
)

_T0 = time.time()

DEMO_PROMPTS = [[1, 42, 7, 99], [1, 5], [1, 1000, 2000, 3000, 17]]


def _model_from_state(cfg, state_dict: dict):
    """The decode model of ``cfg`` holding ``state_dict`` (already on its
    device): built on the meta device, so no random draw is thrown away."""
    from tpufw_torch.models import model_for_config

    model = model_for_config(cfg.decode_config(), device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model


def build_generator():
    """(decode_model, model_cfg, restored) from the TPUFW_* environment,
    on ``TPUFW_DEVICE``. Weights, in this order: ``TPUFW_HF_CHECKPOINT``
    (an HF directory; its config.json names the architecture and
    ``TPUFW_MODEL`` is ignored; weights in the activation dtype, no fp32
    copy), ``TPUFW_PARAMS_CHECKPOINT`` (bare params of ``TPUFW_MODEL``),
    ``TPUFW_CHECKPOINT_DIR`` (the latest training checkpoint of
    ``TPUFW_MODEL``), else random from ``TPUFW_SEED``. ``restored`` is
    True when weights were loaded; a named source that holds none raises
    rather than serving random weights."""
    from tpufw_torch.configs import BENCH_CONFIG_NAME, resolve_model_preset
    from tpufw_torch.models import model_for_config
    from tpufw_torch.train.checkpoint import (
        checkpoint_model_state,
        load_params,
    )

    device = env_str("device", "cuda")
    hf_dir = env_str("hf_checkpoint", "")
    if hf_dir:
        from tpufw_torch.tools.import_hf import config_from_hf, from_hf

        with open(os.path.join(hf_dir, "config.json")) as f:
            model_cfg = config_from_hf(json.load(f))
        model_cfg = dataclasses.replace(
            model_cfg, param_dtype=model_cfg.dtype,
            max_seq_len=env_int("max_seq_len", model_cfg.max_seq_len))
        model = _model_from_state(model_cfg, from_hf(
            hf_dir, model_cfg, device=resolve_device(device)))
        model_cfg, model = _maybe_quantize(model_cfg, model)
        return model, model_cfg, True
    model_cfg = resolve_model_preset(env_str("model", BENCH_CONFIG_NAME))
    model_cfg = dataclasses.replace(
        model_cfg, max_seq_len=env_int("max_seq_len", model_cfg.max_seq_len)
    )
    params_dir = env_str("params_checkpoint", "")
    ckpt_dir = env_str("checkpoint_dir", "")
    if params_dir:
        model = _model_from_state(model_cfg, load_params(
            params_dir, model_cfg, resolve_device(device))[1])
    elif ckpt_dir:
        model = _model_from_state(model_cfg, checkpoint_model_state(
            ckpt_dir, model_cfg, resolve_device(device)))
    else:
        model = model_for_config(
            model_cfg.decode_config(), device=device,
            seed=env_int("seed", 0),
        )
    model_cfg, model = _maybe_quantize(model_cfg, model)
    return model, model_cfg, bool(params_dir or ckpt_dir)


def quantize_model(model, release: bool = False):
    """The int8 twin of ``model`` (``quantized_weights=True``, the same
    family) on the same device, its weights from ``ops.quant``'s
    ``quantize_entry``, tensor by tensor. The twin is built on the meta
    device and takes the new tensors as they are, so the two models never
    hold a second full copy: the tensors that stay floating point are
    copied (shared with ``release``), and with ``release`` each quantized
    weight of ``model`` is freed once its codes exist, leaving ``model``
    unusable. Peak memory is then the model's plus one weight's codes."""
    from tpufw_torch.ops.quant import quantize_entry

    qcfg = dataclasses.replace(model.cfg, quantized_weights=True)
    qmodel = type(model)(qcfg, device="meta")
    want = qmodel.state_dict()
    src = model.state_dict()
    state = {}
    for key in list(src):
        val = src.pop(key)
        q = quantize_entry(key, val)
        if q is None:
            state[key] = val.to(want[key].dtype, copy=not release)
            continue
        state.update({k: v.to(want[k].dtype) for k, v in q.items()})
        if release:
            param = model.get_parameter(key)
            param.data = param.data.new_empty(0)
        del val
    qmodel.load_state_dict(state, assign=True)
    return qmodel


def _maybe_quantize(model_cfg, model):
    """TPUFW_QUANTIZE=int8: swap the model for its int8 twin (the
    floating-point weights freed as their codes are made)."""
    mode = env_str("quantize", "")
    if not mode:
        return model_cfg, model
    if mode != "int8":
        raise ValueError(f"TPUFW_QUANTIZE={mode!r}: only 'int8' is implemented")
    qmodel = quantize_model(model, release=True)
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
    """(encode, decode) for text prompts, from TPUFW_TOKENIZER: "bytes"
    (default), the dependency-free codec shared with
    ``tools.pack_corpus`` (utf-8 byte + 1, id 0 kept for padding), or a
    local HuggingFace tokenizer directory (pair it with
    TPUFW_HF_CHECKPOINT so the ids are the model's), read through
    ``transformers``, which must be installed for it. Hub names are
    refused: the port reads local files only."""
    name = env_str("tokenizer", "bytes")
    if name == "bytes":
        from tpufw_torch.tools.pack_corpus import byte_tokenizer

        def decode(ids: list[int]) -> str:
            return bytes(t - 1 for t in ids if 0 < t <= 256).decode(
                "utf-8", errors="replace"
            )

        return byte_tokenizer, decode
    from tpufw_torch.tools.pack_corpus import hf_tokenizer

    tok = hf_tokenizer(name)
    return tok.encode, tok.decode


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


def build_draft_model(name: str, device, seed: int,
                      max_seq_len: Optional[int] = None):
    """A decode model of the ``LLAMA_CONFIGS`` or ``GEMMA_CONFIGS`` preset
    ``name`` on ``device``: the draft of speculative decoding. Its weights
    are the bare params at ``TPUFW_DRAFT_PARAMS_CHECKPOINT`` when set,
    else drawn at random from ``seed``. Its ``max_seq_len`` (the longest
    cache it takes) is ``max_seq_len`` if given, else
    ``TPUFW_MAX_SEQ_LEN`` or the preset's. Random draft weights only wire
    the path up: their proposals rarely match, and the outputs stay the
    target's all the same."""
    from tpufw_torch.models import GEMMA_CONFIGS, LLAMA_CONFIGS
    from tpufw_torch.models import model_for_config

    presets = {**LLAMA_CONFIGS, **GEMMA_CONFIGS}
    if name not in presets:
        raise ValueError(
            f"unknown draft model {name!r}; choose from {[*presets]}"
        )
    base = presets[name]
    if max_seq_len is None:
        max_seq_len = env_int("max_seq_len", base.max_seq_len)
    cfg = dataclasses.replace(base, max_seq_len=max_seq_len)
    ckpt = env_str("draft_params_checkpoint", "")
    if ckpt:
        from tpufw_torch.train.checkpoint import load_params

        return _model_from_state(
            cfg, load_params(ckpt, cfg, resolve_device(device))[1])
    return model_for_config(cfg.decode_config(), device=device, seed=seed)


def build_draft_generator(max_seq_len: Optional[int] = None):
    """TPUFW_DRAFT_MODEL: (draft_model, k) for speculative decoding, the
    draft drawn from ``TPUFW_SEED`` + 1 and cast like the target
    (``TPUFW_DECODE_DTYPE``), k from ``TPUFW_DRAFT_K`` (4); None when the
    knob is unset. ``max_seq_len`` as in ``build_draft_model``."""
    name = env_str("draft_model", "")
    if not name:
        return None
    draft = build_draft_model(
        name, env_str("device", "cuda"), env_int("seed", 0) + 1, max_seq_len
    )
    return _maybe_cast_decode(draft), env_int("draft_k", 4)


def speculative_batch(draft_model, model, prompts, max_new_tokens, sampling,
                      eos, k: int):
    """``generate_batch`` with ``draft_model`` speculation
    (``infer.speculative_generate_text``): the batch padded to a power of
    two with dead filler rows, which do not hold back the batch's
    acceptance. Returns (outputs, stats)."""
    from tpufw_torch.infer import speculative_generate_text

    padded, real_n = _pad_batch(prompts, eos if eos is not None else 0)
    outs, stats = speculative_generate_text(
        draft_model,
        model,
        padded,
        max_new_tokens=max_new_tokens,
        k=k,
        eos_id=eos,
        live_rows=[i < real_n for i in range(len(padded))],
        sampling=sampling,
        prefill_chunk_size=env_int("prefill_chunk", 0) or None,
    )
    return outs[:real_n], stats


def run_batch(prompts: list[list[int]], max_new_tokens: int) -> list[dict]:
    model, cfg, restored = build_generator()
    model = _maybe_cast_decode(model)
    sampling, eos = sampling_from_env(), eos_from_env()
    draft = build_draft_generator()
    if draft is not None:
        outs, _stats = speculative_batch(
            draft[0], model, prompts, max_new_tokens, sampling, eos, draft[1]
        )
    else:
        outs = generate_batch(model, prompts, max_new_tokens, sampling, eos)
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


class _Batcher:
    """Continuous batching at request granularity: the tick batcher
    behind ``TPUFW_SERVE_SLOTS=0`` (port of the JAX ``_Batcher``).

    Requests enqueue; one worker thread drains the queue per tick,
    coalescing every waiting request into ONE batched generate call (rows
    concatenated, padded to a power of two; max_new_tokens run to the
    tick's power-of-two bucket and sliced per request). While a tick runs
    on the device, new arrivals accumulate for the next tick. A short
    coalescing window (TPUFW_BATCH_WAIT_MS, default 5) after the first
    dequeue lets near-simultaneous requests land in the same tick;
    TPUFW_BATCH_MAX_ROWS (default 64) caps rows per tick, the rest stay
    queued. Eager PyTorch compiles nothing, but the buckets are kept as
    ``tpufw`` has them: they fix a tick's rows, padding and metrics.
    """

    def __init__(
        self,
        run_tick,
        metrics: Optional[_Metrics] = None,
        run_stream=None,
    ):
        self._run_tick = run_tick
        self._run_stream = run_stream
        self._metrics = metrics
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.max_rows = env_int("batch_max_rows", 64)
        self.wait_s = env_int("batch_wait_ms", 5) / 1000.0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tpufw-serve-tick"
        )
        self._thread.start()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def _enqueue(self, pend: _Pending) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("the serving batcher is closed")
            self._queue.append(pend)
            self._cv.notify()

    def submit(self, prompts: list[list[int]], max_new: int, sampling=None):
        p = _Pending(prompts, max_new, sampling)
        self._enqueue(p)
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.outputs, p.batched_with

    def submit_stream(
        self, prompts: list[list[int]], max_new: int, sampling, q
    ) -> None:
        """Enqueue a streaming request and return at once: the caller
        reads per-chunk row outputs from ``q`` until the ("done", n) or
        ("error", e) sentinel. The stream runs as its own tick."""
        self._enqueue(_Pending(prompts, max_new, sampling, stream_q=q))

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker thread; requests still queued fail."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _take_tick(self) -> list[_Pending]:
        with self._cv:
            while not (self._queue or self._closed):
                self._cv.wait()
            if self._closed:
                return []
        time.sleep(self.wait_s)  # let near-simultaneous arrivals land
        with self._cv:
            tick: list[_Pending] = []
            rows = 0
            rest: list[_Pending] = []
            # One device call = one SamplingConfig: the head request
            # defines the tick's config and every compatible request
            # joins; mismatches keep their queue order for a later tick
            # (the head of the remainder defines the NEXT tick's config).
            # FIFO holds WITHIN a config: once a same-config request
            # misses the row budget, no later same-config request may
            # overtake it into this tick.
            budget_closed = False
            solo = False
            for nxt in self._queue:
                if not tick:
                    tick.append(nxt)
                    rows += len(nxt.prompts)
                    # A streaming head runs alone: its device work is a
                    # chunk LOOP, not one coalescible call.
                    solo = nxt.stream_q is not None
                elif solo or nxt.stream_q is not None:
                    rest.append(nxt)
                elif nxt.sampling != tick[0].sampling:
                    rest.append(nxt)
                elif (
                    budget_closed
                    or rows + len(nxt.prompts) > self.max_rows
                ):
                    budget_closed = True
                    rest.append(nxt)
                else:
                    tick.append(nxt)
                    rows += len(nxt.prompts)
            self._queue = rest
            return tick

    def _run_group(self, group: list[_Pending]) -> None:
        """Run one coalesced device call for ``group``; raises on failure
        without touching the pendings (the caller decides whether to
        isolate)."""
        if len(group) == 1 and group[0].stream_q is not None:
            pend = group[0]
            self._run_stream(pend)
            pend.batched_with = 1
            return
        all_prompts = [p for pend in group for p in pend.prompts]
        # max_new to the power-of-two bucket tpufw compiles.
        run_new = _pow2_ceil(max(p.max_new for p in group))
        outs = self._run_tick(all_prompts, run_new, group[0].sampling)
        i = 0
        for pend in group:
            rows = outs[i: i + len(pend.prompts)]
            pend.outputs = [r[: pend.max_new] for r in rows]
            pend.batched_with = len(group)
            i += len(pend.prompts)

    def _loop(self) -> None:
        while True:
            tick = self._take_tick()
            if not tick:
                break
            if self._metrics is not None:
                self._metrics.inc("ticks_total")
                self._metrics.inc(
                    "tick_rows_total", sum(len(p.prompts) for p in tick)
                )
            try:
                # Autograd state is thread-local: this thread runs every
                # device call, so it turns gradients off for itself.
                with torch.no_grad():
                    try:
                        self._run_group(tick)
                    except Exception:  # noqa: BLE001 — serving loop
                        if len(tick) == 1:
                            raise
                        # Failure isolation: one invalid request (or a
                        # combination that only overflows the KV budget
                        # together) falls back to per-request runs, so
                        # the innocent ones still succeed.
                        for pend in tick:
                            try:
                                self._run_group([pend])
                            except Exception as e:  # noqa: BLE001
                                pend.error = e
            except Exception as e:  # noqa: BLE001 — serving loop
                for pend in tick:
                    pend.error = e
                    if pend.stream_q is not None:
                        # The SSE handler waits on the queue, not on the
                        # done event: it needs the sentinel.
                        pend.stream_q.put(("error", e))
            finally:
                if self._metrics is not None:
                    self._metrics.inc(
                        "tokens_generated_total",
                        sum(
                            len(r)
                            for p in tick
                            if p.outputs is not None
                            for r in p.outputs
                        ),
                    )
                for pend in tick:
                    pend.done.set()
        with self._cv:
            queue, self._queue = self._queue, []
        for pend in queue:
            pend.error = RuntimeError("the serving batcher is closed")
            if pend.stream_q is not None:
                pend.stream_q.put(("error", pend.error))
            pend.done.set()


class _SlotJob:
    """One prompt ROW moving through the slot pool: a request's rows may
    join across chunk boundaries as slots free up, and each retires at
    its own EOS or max_new."""

    __slots__ = ("req", "prompt", "p_bucket", "max_new", "cache_len",
                 "tokens", "unflushed", "cp")

    def __init__(self, req, prompt, p_bucket, max_new, cache_len):
        self.req = req
        self.prompt = prompt
        self.p_bucket = p_bucket
        self.max_new = max_new
        self.cache_len = cache_len
        self.tokens: list[int] = []
        self.unflushed: list[int] = []
        # The in-flight ChunkedPrefill while the row prefills chunk by
        # chunk in its slot; None once it decodes.
        self.cp = None


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

    Chunked prefill (``prefill_chunk_pages`` > 0, paged only): a row
    takes its slot at once as a PREFILLING occupant and runs one
    page-aligned chunk per scheduler pass, ahead of the pass's decode
    chunk, so a long prompt no longer blocks the rows behind it.
    Admission reserves around the pages the in-flight prefills still owe,
    so two part-admitted rows never deadlock on the arena.

    Speculation (``spec_k`` > 0): while the active slots' mean accept EMA
    clears ``spec_min_accept``, a pass drafts ``spec_k`` tokens per slot
    (n-gram self-drafting, or a draft pool with its own cache over a draft
    model, sharing the target's page allocator) and verifies them in ONE
    target pass, each slot advancing by its own accept count; otherwise
    the pool decodes plainly. A speculative row reserves ``spec_k`` extra
    KV slots (cache rung and pages), so its verify block never reaches
    past its own cache. Pools with a repetition penalty never speculate.

    Sampling: each prefill and each chunk draws from its own generator
    (``stream_generator``), so the same arrival order and ``TPUFW_SEED``
    replay the same tokens; ``reset_after_warmup`` rewinds both indices.
    A chunked prefill samples its first token with the generator a cold
    prefill of the whole prompt would use.
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
        spec_min_accept: Optional[float] = None,
        spec_draft_built=None,
        prefill_chunk_pages: Optional[int] = None,
        events=None,
        tracer=None,
        goodput=None,
        watchdog=None,
        perf=None,
    ):
        from tpufw_torch.obs import events as obs_events
        from tpufw_torch.obs import goodput as obs_goodput
        from tpufw_torch.obs import perf as obs_perf
        from tpufw_torch.obs import trace as obs_trace
        from tpufw_torch.obs.health import NULL_WATCHDOG

        self.model = model
        self._eos = eos_id
        self._default_sampling = (
            default_sampling
            if default_sampling is not None
            else sampling_from_env()
        )
        self._metrics = metrics
        self._seed_base = seed_base
        # Telemetry (the server's TPUFW_TELEMETRY_DIR; shared no-ops
        # without it): events, spans, the goodput split of each chunk,
        # the hang watchdog around each admit + chunk, and the decode
        # chunks' counted costs and MFU.
        self._events = events if events is not None else obs_events.NULL
        self._tracer = tracer if tracer is not None else obs_trace.NULL
        self._goodput = goodput if goodput is not None else obs_goodput.NULL
        self._watchdog = watchdog if watchdog is not None else NULL_WATCHDOG
        self._perf = perf if perf is not None else obs_perf.NULL
        # Disaggregated handoff hook: called with (job, state) for every
        # naturally completing paged row, ``state`` being the slot's
        # export_slot() taken BEFORE the slot is released.
        self._page_export = page_export
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
        # Chunked prefill is page-granular: pages per chunk, 0 = off.
        self.prefill_chunk_pages = (
            env_int("serve_prefill_chunk", 0) if prefill_chunk_pages is None
            else int(prefill_chunk_pages)
        )
        if self.prefill_chunk_pages and not self.page:
            raise ValueError(
                f"TPUFW_SERVE_PREFILL_CHUNK={self.prefill_chunk_pages}: "
                "chunked prefill is page-granular and needs "
                "TPUFW_SERVE_PAGE > 0"
            )
        # The host spill tier behind the page arena: TPUFW_KV_SPILL
        # budgets it in PAGES, TPUFW_KV_SPILL_DIR adds the directory
        # overflow. Evicted prefix pages demote there instead of dying,
        # and a later prompt sharing the prefix restores them instead of
        # prefilling them again.
        self.kv_spill_pages = max(0, env_int("kv_spill", 0))
        self.kv_spill_dir = env_str("kv_spill_dir", "")
        self._spill = None
        if self.kv_spill_pages or self.kv_spill_dir:
            if not self.page:
                raise ValueError(
                    f"TPUFW_KV_SPILL={self.kv_spill_pages}: the spill "
                    "tier is page-granular and needs TPUFW_SERVE_PAGE > 0"
                )
            from tpufw_torch.infer.spill import SpillTier

            self._spill = SpillTier(self.kv_spill_pages, self.kv_spill_dir)
        # Scrape-time cursor: the tier's byte total is monotonic but a
        # registry counter only increments, so /metrics adds the delta.
        self._spill_seen_bytes = 0
        # Speculation: spec_draft "" or "ngram" drafts on the host; a
        # preset name builds a draft model; spec_draft_built is a draft
        # model already built (the server's TPUFW_DRAFT_MODEL, or the
        # target itself).
        self.spec_k = (
            env_int("serve_spec_k", 0) if spec_k is None else int(spec_k)
        )
        self.spec_draft = (
            env_str("serve_spec_draft", "") if spec_draft is None
            else str(spec_draft)
        )
        self.spec_min_accept = (
            env_float("serve_spec_min_accept", 0.25)
            if spec_min_accept is None else float(spec_min_accept)
        )
        self._draft_model = None
        self._draft_n_params = 0
        self._draft_pool = None
        self._ema = None
        # Cumulative accept bookkeeping behind tpufw_spec_accept_rate.
        self._spec_accept_sum = 0.0
        self._spec_accept_rows = 0
        # Host wall time, passes and tokens of the speculative passes.
        self.spec_s = 0.0
        self.spec_passes = 0
        self.spec_tokens = 0
        if self.spec_k:
            if self.spec_k < 1:
                raise ValueError(
                    f"TPUFW_SERVE_SPEC_K={self.spec_k}: need >= 1"
                )
            if self.page and self.spec_k + 1 > self.page:
                # A done row's clamped verify block must stay inside the
                # row's own last page.
                raise ValueError(
                    f"TPUFW_SERVE_SPEC_K={self.spec_k}: the k+1 verify "
                    f"block must fit one KV page (page={self.page})"
                )
            if spec_draft_built is not None:
                self._draft_model = spec_draft_built
            elif self.spec_draft and self.spec_draft != "ngram":
                # The draft pools' caches are as long as the target's.
                self._draft_model = build_draft_model(
                    self.spec_draft, model.device, seed_base + 1,
                    model.cfg.max_seq_len,
                )
            if self._draft_model is not None:
                if self._draft_model.cfg.vocab_size != model.cfg.vocab_size:
                    raise ValueError(
                        "the draft model's vocabulary "
                        f"({self._draft_model.cfg.vocab_size}) differs from "
                        f"the target's ({model.cfg.vocab_size})"
                    )
                # Wasted-draft-FLOPs accounting: ~2 * params per drafted
                # token; 0 for self-drafting.
                self._draft_n_params = sum(
                    t.numel() for t in self._draft_model.parameters()
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
            if self.prefill_chunk_pages:
                # The JAX server's unprefixed chunked-prefill series,
                # gated like it.
                metrics.registry.counter("tpufw_prefill_chunks_total")
                metrics.registry.counter("tpufw_prefill_resumes_total")
                metrics.registry.gauge("tpufw_prefill_inflight")
            if self._spill is not None:
                # The JAX server's unprefixed KV spill series, gated so
                # a spill-less exposition stays as it was.
                metrics.registry.counter("tpufw_kv_spill_bytes_total")
                metrics.registry.gauge("tpufw_kv_spill_pages")
                metrics.registry.histogram(
                    "tpufw_kv_restore_seconds",
                    "Spill-tier restore wall (host fetch + decode)",
                )
            if self.spec_k:
                metrics.registry.counter(
                    "tpufw_spec_wasted_draft_flops_total"
                )
                metrics.registry.gauge("tpufw_spec_accept_rate")
                metrics.registry.gauge("tpufw_spec_fallback_slots")
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
        worker may swap the pool: under the lock, as ``_build_pool``
        retires a pool."""
        with self._cv:
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
        """Most arena pages in use at once, over every pool so far. The
        retired pools' peak and the current pool are read together under
        the lock, so a pool swap in between cannot drop the old pool's
        peak from the answer."""
        with self._cv:
            a = self._allocator()
            return max(self._peak_pages, 0 if a is None else a.peak_in_use)

    @property
    def pool(self):
        """The current pool (None before the first admission)."""
        with self._cv:
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
        # A speculative row's verify block writes up to spec_k slots past
        # its last cursor before the rewind: its cache rung and pages
        # cover them.
        slack = self._spec_slack(sampling)
        for prompt in pend.prompts:
            # Paged rows prefill at their EXACT width: padding would
            # burn pages and misalign the prompt's page chunks.
            pb = max(len(prompt), 1) if self.page else _bucket(len(prompt), 64)
            # Prefill writes pb slots, decode max_new - 1 more.
            if pb + pend.max_new - 1 + slack > cap:
                raise ValueError(
                    f"prompt ({len(prompt)}, bucketed to {pb}) + "
                    f"max_new_tokens ({pend.max_new})"
                    + (f" + spec slack ({slack})" if slack else "")
                    + f" exceeds the KV cache (max_seq_len={cap})"
                )
            if self.page and self.arena_pages is not None:
                need = -(-(pb + pend.max_new - 1 + slack) // self.page)
                if need > self.arena_pages - 1:
                    # A row that can NEVER fit would block the FIFO.
                    raise ValueError(
                        f"row needs {need} KV pages but the arena holds "
                        f"{self.arena_pages - 1}"
                    )
            jobs.append(_SlotJob(
                req, prompt, pb, pend.max_new,
                _cache_bucket(pb + pend.max_new - 1 + slack, cap,
                              self.cache_floor),
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
            # device call, so it turns gradients off for itself. The
            # watchdog window is one admit + one chunk, a bounded amount
            # of device work; idle waiting above stays disarmed.
            self._watchdog.arm()
            with torch.no_grad():
                try:
                    self._admit()
                    if self._n_active:
                        self._run_chunk()
                except Exception as e:  # noqa: BLE001 — serving loop
                    self._fail_active(e)
                finally:
                    self._watchdog.disarm()
        self._fail_all(RuntimeError("the serving scheduler is closed"))

    def _generator(self, stream: int, index: int):
        """The stream's generator, or None for greedy pools (they draw
        nothing)."""
        if not self._pool.sampling.temperature:
            return None
        return stream_generator(
            self.model.device, self._seed_base, stream, index
        )

    def _spec_slack(self, sampling) -> int:
        """Extra KV slots a speculative row needs past max_new - 1 (0 when
        speculation is off or this sampling cannot speculate)."""
        from tpufw_torch.infer.sampling import track_seen

        if not self.spec_k or track_seen(sampling):
            return 0
        return self.spec_k

    def _build_pool(self, key) -> None:
        cache_len = key[0]
        # Fold the old pool's peak and drop the pool in one step under
        # the lock: a scrape (peak_pages_in_use) sees either both before
        # or both after. The old pools' memory serves the new ones.
        with self._cv:
            if self.page and self._pool is not None:
                self._peak_pages = max(
                    self._peak_pages, self._pool.allocator.peak_in_use
                )
            self._pool = None
        self._draft_pool = None
        self._ema = None
        with self._tracer.span("serve_pool_build", cache_len=cache_len,
                               slots=self.n_slots):
            self._make_pools(key)
        self._events.emit(
            "serve_pool_switch", cache_len=cache_len, slots=self.n_slots
        )

    def _make_pools(self, key) -> None:
        from tpufw_torch.infer import AcceptEMA, SamplingConfig
        from tpufw_torch.infer.pages import PagedSlotPool
        from tpufw_torch.infer.slots import SlotPool

        cache_len, sampling = key
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
        if self._spill is not None:
            # Re-wired on every pool rebuild: the callbacks close over the
            # pool they serialize for. The tier and its contents survive
            # rebuilds, so a cache-ladder switch forgets no spilled K/V.
            from tpufw_torch.serve.bundle import attach_spill

            attach_spill(
                self._pool, self._spill, events=self._events,
                on_restore=(
                    self._metrics.registry.histogram(
                        "tpufw_kv_restore_seconds"
                    ).observe
                    if self._metrics is not None else None
                ),
            )
        if self._spec_slack(sampling):
            if self._draft_model is not None:
                # The draft pool only holds the draft's cache: its
                # prefills sample nothing (greedy), and the pass reads
                # the target pool's tokens, positions and sampling.
                if self.page:
                    self._draft_pool = PagedSlotPool.create_paged(
                        self._draft_model,
                        self.n_slots,
                        cache_len=cache_len,
                        page=self.page,
                        n_pages=self.arena_pages,
                        kv_quant=self.kv_quant,
                        sampling=SamplingConfig(),
                        prefix_cache=False,
                        allocator=self._pool.allocator,
                    )
                else:
                    self._draft_pool = SlotPool.create(
                        self._draft_model, self.n_slots, cache_len=cache_len
                    )
            self._ema = AcceptEMA(
                self.n_slots,
                min_accept=self.spec_min_accept,
                # Plain chunks leave a draft pool's KV stale, so its
                # fallback is sticky until the pool drains.
                probe_every=0 if self._draft_pool is not None else 8,
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
        with self._tracer.span("serve_admit", queued=len(queue)):
            self._admit_queue(queue, free, pool_sampling, cache_cap)

    def _admit_queue(self, queue, free, pool_sampling, cache_cap) -> None:
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
            if self.prefill_chunk_pages:
                # Chunked admission: the row takes its slot now and
                # acquires pages chunk by chunk in the passes to come.
                if not self._can_admit_chunked(job):
                    break
                try:
                    self._admit_chunked(job, free[0])
                except Exception as e:  # noqa: BLE001 — isolate request
                    self._fail_req(req, e)
                    return admitted
                req.next_job += 1
                admitted = True
                free.pop(0)
                continue
            grant = None
            if self.page:
                # Page-budget admission: the row needs every page of its
                # prompt + budget up front. None = arena full even after
                # trie eviction: stop and let retires free pages.
                grant = self._pool.acquire_pages(
                    job.prompt, self._row_need(job)
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

    def _row_need(self, job: _SlotJob) -> int:
        """KV slots ``job``'s row owns pages for: prompt, decode budget
        and speculative slack."""
        return (len(job.prompt) + job.max_new - 1
                + self._spec_slack(self._pool.sampling))

    def _cp_deficit(self) -> int:
        """Pages the in-flight chunked prefills still owe: what they will
        hold at finalize less what they hold now."""
        return sum(
            j.cp.deficit for j in self._slots
            if j is not None and j.cp is not None
        )

    def _can_admit_chunked(self, job: _SlotJob) -> bool:
        """Admit a chunked prefill only when the free and trie-evictable
        pages cover every in-flight prefill's remaining need plus this
        row's whole need; each chunk's grab is all or nothing, so every
        admitted prefill then reaches its full grant."""
        a = self._pool.allocator
        evictable = sum(1 for i in a.held if not a.refs.get(i, 0))
        n_total = self._pool.n_pages_for(self._row_need(job))
        return self._cp_deficit() + n_total <= a.n_free + evictable

    def _admit_chunked(self, job: _SlotJob, slot: int) -> None:
        """Open a chunked prefill and seat it in ``slot`` without a device
        call: the slot's pool state stays born done (its junk decode
        writes land in page 0), and ``_run_prefill_chunks`` advances the
        row one chunk per pass."""
        with self._cv:
            job_index = self._job_index
            self._job_index += 1
        cp = self._pool.start_chunked(
            job.prompt, self._row_need(job),
            self._generator(_PREFILL_STREAM, job_index),
            self.prefill_chunk_pages,
        )
        if self.prefix_enabled and self._metrics is not None:
            hit = cp.shared_n > 0
            self._metrics.inc(
                "prefix_hits_total" if hit else "prefix_misses_total"
            )
            if hit:
                # Trie hits are the resume path of abandoned prefills.
                self._metrics.registry.counter(
                    "tpufw_prefill_resumes_total"
                ).inc()
        job.cp = cp
        with self._cv:
            self._slots[slot] = job
            self._n_active += 1
        self._set_prefill_inflight()

    def _set_prefill_inflight(self) -> None:
        if self._metrics is None or not self.prefill_chunk_pages:
            return
        self._metrics.registry.gauge("tpufw_prefill_inflight").set(float(
            sum(1 for j in self._slots if j is not None and j.cp is not None)
        ))

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
            self._events.emit("serve_prefix", hit=shared_n > 0,
                              shared_pages=shared_n,
                              prompt_tokens=len(job.prompt))
        prefill_t0 = time.perf_counter()
        with self._tracer.span("serve_prefill", prompt=len(job.prompt),
                               width=job.p_bucket):
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
        self._occupy_spec(job, slot)
        with self._cv:
            self._slots[slot] = job
            self._n_active += 1
        return True

    def _occupy_spec(self, job: _SlotJob, slot: int) -> None:
        """A decoding row joins speculation: the draft pool's slot gets
        its prompt, and its accept EMA starts optimistic."""
        if self._draft_pool is not None:
            self._admit_draft(job, slot)
        if self._ema is not None:
            self._ema.occupy(slot)

    def _admit_draft(self, job: _SlotJob, slot: int) -> None:
        """Prefill ``job``'s prompt through the draft model into the draft
        pool's slot. Draft pages come from the shared allocator strictly
        after the target's, and a failed draft grant degrades the slot
        (its proposals verify as junk, and the EMA sends the pool to plain
        decode) instead of blocking admission."""
        from tpufw_torch.infer.slots import prefill_row

        dpool = self._draft_pool
        need = len(job.prompt) + job.max_new - 1 + self.spec_k
        d_grant = None
        if self.page:
            deficit = self._cp_deficit()
            if deficit and dpool.allocator.n_free < (
                    deficit + dpool.n_pages_for(need)):
                # Draft pages would eat into the pages in-flight chunked
                # prefills count on.
                return
            d_grant = dpool.acquire_pages(job.prompt, need)
            if d_grant is None:
                return
        try:
            cache, _f, d_first, _d, _s = prefill_row(
                dpool.model, job.prompt, None, sampling=dpool.sampling,
                eos_id=None,
                pad_to=len(job.prompt) if self.page else job.p_bucket,
                prefill_chunk_size=self.prefill_chunk,
                cache_len=dpool.cache_len,
            )
            if d_grant is not None:
                dpool.insert_paged(slot, cache, d_first, len(job.prompt),
                                   need - len(job.prompt), d_grant[0], 0)
            else:
                dpool.insert(slot, cache, d_first, len(job.prompt),
                             need - len(job.prompt))
        except Exception:  # noqa: BLE001 — degrade the slot, not the request
            if d_grant is not None:
                self._free_pages(dpool.release_pages(d_grant[0]))

    def _free_pages(self, freed: int) -> None:
        if freed and self._metrics is not None:
            self._metrics.inc("pages_freed_total", freed)

    def _retire_slot(self, slot: int, *, device: bool) -> None:
        """Vacate ``slot``. ``device=True`` also freezes the row's masks
        (error paths; natural completions froze inside the step). Paged
        pools always zero the slot's table row before its pages go back
        on the free list."""
        job = self._slots[slot]
        if job is not None and job.cp is not None:
            # A preempted chunked prefill: its trie-checkpointed pages
            # stay held, the resume point of a re-submission.
            self._free_pages(self._pool.abandon_chunked(job.cp))
            job.cp = None
            self._set_prefill_inflight()
        if self.page:
            self._free_pages(self._pool.release_slot(slot))
        elif device:
            self._pool.retire(slot)
        if self._draft_pool is not None:
            # A slot that never got a draft grant releases nothing.
            if self.page:
                self._free_pages(self._draft_pool.release_slot(slot))
            elif device:
                self._draft_pool.retire(slot)
        if self._ema is not None:
            self._ema.vacate(slot)
        with self._cv:
            self._slots[slot] = None
            self._n_active -= 1

    def _run_prefill_chunks(self) -> bool:
        """Advance every PREFILLING slot by one page-aligned chunk, in the
        same pass as the decoding slots. A row whose final chunk lands
        here is finalized at once and decodes in this pass. Returns True
        iff a chunk ran."""
        if not self.prefill_chunk_pages:
            return False
        progressed = False
        for slot, job in [(i, j) for i, j in enumerate(self._slots)
                          if j is not None and j.cp is not None]:
            t0 = time.perf_counter()
            with self._tracer.span("serve_prefill_chunk", slot=slot,
                                   cursor=job.cp.cursor,
                                   prompt=len(job.prompt)):
                status = self._pool.chunk_step(job.cp)
            if status == "stalled":
                # The arena is full for now: the row keeps its slot and
                # retries next pass.
                continue
            progressed = True
            if self._metrics is not None:
                self._metrics.registry.counter(
                    "tpufw_prefill_chunks_total"
                ).inc()
            self._events.emit(
                "serve_prefill_chunk", prompt_tokens=len(job.prompt),
                cursor=job.cp.cursor,
                chunk_s=round(time.perf_counter() - t0, 6),
                final=status == "done", slot=slot,
            )
            if status == "done":
                self._finalize_chunked(slot, job)
        self._set_prefill_inflight()
        return progressed

    def _finalize_chunked(self, slot: int, job: _SlotJob) -> None:
        """A chunked prefill sampled its first token: finish the row
        outright (max_new == 1 or EOS first; its checkpointed pages stay
        in the trie) or install it as a decoding occupant of its slot."""
        cp, req = job.cp, job.req
        job.cp = None
        job.tokens.append(cp.first_int)
        job.unflushed.append(cp.first_int)
        if self._metrics is not None:
            self._metrics.inc("tokens_generated_total")
        if job.max_new == 1 or (
            self._eos is not None and cp.first_int == self._eos
        ):
            self._free_pages(self._pool.abandon_chunked(cp))
            with self._cv:
                self._slots[slot] = None
                self._n_active -= 1
            if self._metrics is not None:
                self._metrics.inc("retired_rows_total")
            req.rows_left -= 1
        else:
            self._pool.finalize_chunked(slot, cp, job.max_new - 1)
            self._occupy_spec(job, slot)
        if req.pend.stream_q is not None:
            self._flush_stream(req)
        if req.rows_left == 0 and req.next_job == len(req.jobs):
            self._finish(req)

    def _use_spec(self, active) -> bool:
        """Acceptance-aware scheduling: speculate while the active slots'
        mean accept EMA clears the threshold."""
        return self._ema is not None and self._ema.use_spec(
            [slot for slot, _ in active]
        )

    def _run_chunk(self) -> None:
        progressed = self._run_prefill_chunks()
        active = [(i, j) for i, j in enumerate(self._slots)
                  if j is not None and j.cp is None]
        if not active:
            if self._n_active and not progressed:
                # Every occupied slot is a prefill stalled on pages: do
                # not spin hot while waiting for a release.
                time.sleep(0.001)
            return
        if self._use_spec(active):
            self._run_spec_chunk(active)
            return
        # Pow-2 ladder on the chunk length: the tail of a nearly done
        # pool shrinks k in big steps.
        max_left = max(j.max_new - len(j.tokens) for _, j in active)
        k = min(self.chunk, _pow2_ceil(max_left))
        with self._cv:
            chunk_index = self._chunk_index
            self._chunk_index += 1
        gen = self._generator(_CHUNK_STREAM, chunk_index)
        snap = self._page_snapshot(active)
        program = f"serve_decode_k{k}"
        chunk_t0 = time.perf_counter()
        with self._tracer.span("serve_decode_chunk", k=k, rows=len(active)):
            # The first chunk of each k is counted (obs.perf): its costs,
            # then each chunk's wall, give the program's MFU.
            counted = self._perf.will_observe(program)
            out = self._perf.observe_step(
                program, self._pool.decode_steps, k, gen
            ).tolist()  # one host sync
        chunk_s = time.perf_counter() - chunk_t0
        if not counted:
            self._perf.record_wall(program, chunk_s)
        self.decode_s += chunk_s
        self.decode_steps_run += k
        live_tokens = self._deliver(active, [row[:k] for row in out], snap)
        if self._metrics is not None:
            # S * k slot-steps ran; those not delivering a live token are
            # the batching overhead TPUFW_SERVE_SLOTS/_CHUNK trade off.
            self._metrics.inc(
                "wasted_slot_steps_total", self.n_slots * k - live_tokens
            )
        # Goodput: the chunk's wall split by the same capacity count.
        live_frac = live_tokens / (self.n_slots * k)
        self._goodput.add("busy", chunk_s * live_frac)
        self._goodput.add("wasted_slot", chunk_s * (1.0 - live_frac))

    def _run_spec_chunk(self, active) -> None:
        """One speculative pass over every occupied slot: draft spec_k
        tokens (n-gram self-draft or the draft pool), verify them in ONE
        target pass, and advance each slot by its own emit count."""
        from tpufw_torch.infer.speculative import ngram_propose

        k = self.spec_k
        with self._cv:
            chunk_index = self._chunk_index
            self._chunk_index += 1
        gen = self._generator(_CHUNK_STREAM, chunk_index)
        snap = self._page_snapshot(active)
        chunk_t0 = time.perf_counter()
        with self._tracer.span("serve_spec_chunk", k=k, rows=len(active)):
            if self._draft_pool is not None:
                out, n_emit, accept = self._pool.spec_draft_steps(
                    self._draft_pool, gen, k
                )
            else:
                props = np.zeros((self.n_slots, k), np.int64)
                for slot, job in active:
                    props[slot] = ngram_propose(
                        list(job.prompt) + job.tokens, k)
                out, n_emit, accept = self._pool.spec_steps(props, gen)
            # One host sync for the pass.
            res = torch.cat([out, n_emit[:, None], accept[:, None]],
                            1).tolist()
        chunk_s = time.perf_counter() - chunk_t0
        self._perf.record_wall(
            f"serve_spec_draft_k{k}" if self._draft_pool is not None
            else f"serve_spec_k{k}", chunk_s)
        self.spec_s += chunk_s
        self.spec_passes += 1
        rows = [r[: r[k + 1]] for r in res]
        accepts = {slot: res[slot][k + 2] for slot, _ in active}
        for slot, _ in active:
            self._ema.update(slot, accepts[slot] / k)
        live_tokens = self._deliver(active, rows, snap)
        self.spec_tokens += live_tokens
        accept_frac = sum(a / k for a in accepts.values())
        self._spec_accept_sum += accept_frac
        self._spec_accept_rows += len(active)
        if self._metrics is not None:
            # S * (k+1) verify positions ran; rejected drafts are
            # counted apart as wasted draft FLOPs.
            self._metrics.inc(
                "wasted_slot_steps_total",
                self.n_slots * (k + 1) - live_tokens,
            )
            reg = self._metrics.registry
            # The cumulative mean: a scrape after the traffic drains
            # still reports what the server accepted.
            reg.gauge("tpufw_spec_accept_rate").set(
                self._spec_accept_sum / max(self._spec_accept_rows, 1)
            )
            reg.gauge("tpufw_spec_fallback_slots").set(float(
                self._ema.fallback_slots([s for s, _ in active])
            ))
            reg.counter("tpufw_spec_wasted_draft_flops_total").inc(
                sum(k - a for a in accepts.values())
                * 2.0 * self._draft_n_params
            )
        self._events.emit("serve_spec", k=k, mode="pass", rows=len(active),
                          accept_rate=round(accept_frac / len(active), 4))
        live_frac = live_tokens / (self.n_slots * (k + 1))
        self._goodput.add("busy", chunk_s * live_frac)
        self._goodput.add("wasted_slot", chunk_s * (1.0 - live_frac))

    def _page_snapshot(self, active) -> dict:
        """{slot: page ids} of the active rows as the chunk launches, for
        the page_export hook. A row finishing mid-chunk exports these
        pages: once it retires, its freed pages may be granted to a
        queued admission within the same pass."""
        if not (self.page and self._page_export is not None):
            return {}
        return {slot: list(self._pool.slot_pages[slot])
                for slot, _ in active}

    def _deliver(self, active, rows, page_snap) -> int:
        """Hand each active slot's tokens of this pass (``rows[slot]``,
        before budget and EOS cuts) to its job; retire the rows that
        finished (a paged row first goes through the page_export hook
        with the pages of ``page_snap``), flush streams, finish requests.
        Returns the live tokens delivered."""
        if self._metrics is not None:
            self._metrics.inc("ticks_total")
            self._metrics.inc("tick_rows_total", len(active))
        live_tokens = 0
        flush: list[_SlotReq] = []
        finished: list[_SlotReq] = []
        for slot, job in active:
            req = job.req
            row = rows[slot][: job.max_new - len(job.tokens)]
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
                if page_snap:
                    self._page_export(job, self._pool.export_slot(
                        slot, page_ids=page_snap[slot]))
                self._retire_slot(slot, device=False)
                if self._metrics is not None:
                    self._metrics.inc("retired_rows_total")
                req.rows_left -= 1
                if req.rows_left == 0 and req.next_job == len(req.jobs):
                    finished.append(req)
        if self._metrics is not None:
            self._metrics.inc("tokens_generated_total", live_tokens)
        for req in flush:
            if req not in finished:
                self._flush_stream(req)
        for req in finished:
            self._finish(req)
        return live_tokens

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
        self._events.emit(
            "serve_request", rows=len(req.jobs),
            new_tokens=sum(len(o) for o in outs),
            latency_s=round(time.time() - req.t_submit, 6),
        )
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
        self._pool = self._draft_pool = self._ema = None
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


class _Server:
    """HTTP serving (port of the JAX ``_Server``) over the slot scheduler,
    or, with ``TPUFW_SERVE_SLOTS=0``, over the tick batcher.

    ``model`` serves a model the caller built (its weights are used as
    they are); otherwise ``build_generator`` builds one from the
    ``TPUFW_*`` environment and ``TPUFW_DECODE_DTYPE`` casts it. The
    speculative draft is ``draft_model`` if given (it may be ``model``
    itself), else ``TPUFW_DRAFT_MODEL``'s, with k = ``TPUFW_DRAFT_K``. It
    becomes the slot scheduler's draft pool, unless the
    ``TPUFW_SERVE_SPEC_*`` knobs choose the speculation themselves; the
    tick batcher runs whole-batch ``speculative_generate`` with it."""

    def __init__(self, port: int, max_new_tokens: int, model=None,
                 draft_model=None):
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
        self._tel = self._start_telemetry(port, max_new_tokens)
        draft = (
            build_draft_generator(model.cfg.max_seq_len)
            if draft_model is None
            else (draft_model, env_int("draft_k", 4))
        )
        self._draft = draft
        spec_kw = {}
        if draft is not None:
            # The tick batcher's speculation counters, registered at 0
            # in both modes as in the JAX server (the slot scheduler
            # reports through the tpufw_spec_* series).
            self.metrics.register("spec_iterations_total",
                                  "spec_emitted_total")
            if (env_int("serve_spec_k", 0) == 0
                    and not env_str("serve_spec_draft", "")):
                spec_kw = {"spec_k": draft[1], "spec_draft_built": draft[0]}
        self.port = port
        self.httpd = None
        self._codec = None
        # Distinct per-request sampling configs admitted so far: each
        # config keys its own pool, so their variety is capped.
        self._sampling_seen: set = set()
        self._sampling_cap = env_int("max_sampling_configs", 32)
        self._sampling_lock = threading.Lock()
        self._seed_base = env_int("seed", 0)
        # Tick mode: each tick's seed is TPUFW_SEED + a monotonic tick
        # index (only the batcher thread moves it), so sampled requests
        # differ across ticks and the server replays given the same
        # arrival order.
        self._tick_index = 0
        if env_int("serve_slots", 8) > 0:
            self._batcher = _SlotScheduler(
                self.model,
                eos_id=self._eos_id,
                default_sampling=self._sampling,
                metrics=self.metrics,
                seed_base=self._seed_base,
                events=self._tel.events,
                tracer=self._tel.tracer,
                goodput=self._tel.goodput,
                watchdog=self._tel.watchdog,
                perf=self._tel.perf,
                **spec_kw,
            )
        else:
            self._batcher = _Batcher(
                self._run_tick, self.metrics, run_stream=self._run_stream
            )
        if env_int("warmup", 1):
            self._warmup()

    def _start_telemetry(self, port: int, max_new_tokens: int):
        """The server's Telemetry under ``TPUFW_TELEMETRY_DIR`` (the
        shared disabled one without it), mounted on the server's own
        registry so ``/metrics`` and the snapshot render one truth: the
        event log, a span trace capped at 100,000 events
        (``trace-serve.json``: a server runs indefinitely, the
        interesting spans are at the head), the goodput ledger (busy,
        wasted slots, idle), the crash flight recorder (``role="serve"``
        terminates on SIGTERM after flushing), the
        ``TPUFW_HANG_TIMEOUT_S`` watchdog, and the profiler behind
        ``/debug/profile``. Closed by ``shutdown`` or at exit."""
        from tpufw_torch.obs import Telemetry

        tdir = env_str("telemetry_dir", "")
        if not tdir:
            return Telemetry.disabled()
        import atexit

        tel = Telemetry.create(
            telemetry_dir=tdir,
            role="serve",
            registry=self.metrics.registry,
            trace_name="trace-serve.json",
            trace_max_events=100_000,
            device=self.model.device,
        )
        tel.set_run_info(backend=self.model.device.type,
                         model=type(self.model).__name__, mesh="serve")
        tel.record_config({"serve": {
            "port": port,
            "max_new_tokens": max_new_tokens,
            "slots": env_int("serve_slots", 8),
            "chunk": env_int("serve_chunk", 0) or env_int("stream_chunk", 16),
            "page": env_int("serve_page", 0),
            "kv_quant": env_str("serve_kv_quant", ""),
        }})
        atexit.register(tel.close)
        return tel

    def _warmup(self) -> None:
        """Warm-up before the listener binds, so the first live request
        does not pay for the first pool and the allocator's first
        blocks. Slot mode: one tiny request. Tick mode: one tick per
        batch bucket of TPUFW_WARMUP_BUCKETS (row counts, default "1").
        The counters it moved and the random-stream indices are
        restored, so warmup stays invisible to scrapes and to seed
        replay."""
        import sys

        if isinstance(self._batcher, _Batcher):
            tick0 = self._tick_index
            try:
                # Parsed inside the try: a malformed value degrades to a
                # warning. Buckets clamp to the batcher's row cap.
                max_rows = env_int("batch_max_rows", 64)
                buckets = sorted({
                    min(_pow2_ceil(int(b)), _pow2_ceil(max_rows))
                    for b in env_str("warmup_buckets", "1").split(",")
                    if b.strip()
                })
                with torch.no_grad():
                    for rows in buckets:
                        self._run_tick([[1]] * rows,
                                       _pow2_ceil(self.default_new), None)
            except Exception as e:  # noqa: BLE001 — warmup is optional
                print(f"serve: warmup skipped: {e}", file=sys.stderr)
            finally:
                self._tick_index = tick0
                if self._draft is not None:
                    self.metrics.reset(
                        "spec_iterations_total", "spec_emitted_total"
                    )
            return
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
            b = self._batcher
            if b.prefill_chunk_pages:
                reg.counter("tpufw_prefill_chunks_total").reset()
                reg.counter("tpufw_prefill_resumes_total").reset()
            if b.spec_k:
                reg.counter("tpufw_spec_wasted_draft_flops_total").reset()
                b._spec_accept_sum, b._spec_accept_rows = 0.0, 0
                reg.gauge("tpufw_spec_accept_rate").set(0.0)
                reg.gauge("tpufw_spec_fallback_slots").set(0.0)
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
        }
        if isinstance(b, _Batcher):
            return g
        g["slots_occupied"] = float(b.slots_occupied)
        g["slots_total"] = float(b.slots_total)
        if b.page:
            g["pages_in_use"] = float(b.pages_in_use)
            g["pages_total"] = float(b.pages_total)
        if b._spill is not None:
            # The unprefixed spill series refresh at scrape time too;
            # the tier owns the numbers.
            st = b._spill.stats()
            reg = self.metrics.registry
            reg.gauge("tpufw_kv_spill_pages").set(
                float(st["ram_pages"]), tier="ram"
            )
            reg.gauge("tpufw_kv_spill_pages").set(
                float(st["dir_pages"]), tier="dir"
            )
            delta = st["spilled_bytes_total"] - b._spill_seen_bytes
            if delta > 0:
                reg.counter("tpufw_kv_spill_bytes_total").inc(delta)
                b._spill_seen_bytes = st["spilled_bytes_total"]
        return g

    def _cache_len(self, longest: int, max_new: int) -> int:
        """KV cache sized to the tick, not the model maximum: the
        smallest power-of-two length covering it (plus the speculative
        k+1 slack), capped at the model's. The masks make the tokens
        independent of it; ``tpufw`` builds a model of that length."""
        slack = (self._draft[1] + 1) if self._draft else 0
        return _cache_bucket(longest + max_new + slack,
                             self.model.cfg.max_seq_len)

    def _tick_prep(self, prompts, max_new, sampling):
        """The per-tick preamble of the coalesced and streaming paths:
        the env-default sampling, the monotonic tick seed (batcher
        thread only), prompt-length bucketing with a filler row, and the
        tick's cache length. Returns (sampling, seed, padded, real_n,
        live, cache_len); ``live`` masks the pow-2 fillers AND the
        length-bucket row, which start done."""
        if sampling is None:
            sampling = self._sampling
        seed = self._seed_base + self._tick_index
        self._tick_index += 1
        longest = _bucket(max(len(p) for p in prompts), 64)
        fill = self._eos_id if self._eos_id is not None else 0
        padded, real_n = _pad_batch(prompts, fill)
        padded = padded + [[fill] * longest]  # length-bucket filler row
        live = [i < real_n for i in range(len(padded))]
        return (sampling, seed, padded, real_n, live,
                self._cache_len(longest, max_new))

    def _run_tick(self, prompts, max_new: int, sampling=None):
        """One device call for one coalesced tick (batcher thread only):
        ``generate_text``, or whole-batch ``speculative_generate_text``
        with the draft, on the tick's padded rows; ``sampling`` is a
        per-request override every request of the tick shares."""
        from tpufw_torch.infer import (
            generate_text,
            speculative_generate_text,
        )

        sampling, seed, padded, real_n, live, cache_len = self._tick_prep(
            prompts, max_new, sampling
        )
        common = dict(
            max_new_tokens=max_new, sampling=sampling, seed=seed,
            eos_id=self._eos_id, live_rows=live, cache_len=cache_len,
            prefill_chunk_size=env_int("prefill_chunk", 0) or None,
        )
        if self._draft is not None:
            draft_model, k = self._draft
            outs, stats = speculative_generate_text(
                draft_model, self.model, padded, k=k, **common
            )
            # emitted / iterations: tokens per verify pass (k+1 at most).
            self.metrics.inc("spec_iterations_total", stats["iterations"])
            self.metrics.inc("spec_emitted_total", stats["emitted"])
            return outs[:real_n]
        return generate_text(self.model, padded, **common)[:real_n]

    def _run_stream(self, pend) -> None:
        """Streaming tick (batcher thread only): the ``_tick_prep``
        preamble, then ``generate_text_stream``'s chunk loop, each
        chunk's per-row new tokens onto the pending's queue as they
        exist. ``max_new`` runs at the coalesced path's power-of-two
        bucket; emission stops at the requested length."""
        from tpufw_torch.infer import generate_text_stream

        run_new = _pow2_ceil(pend.max_new)
        sampling, seed, padded, real_n, live, cache_len = self._tick_prep(
            pend.prompts, run_new, pend.sampling
        )
        emitted = 0  # live rows advance in lockstep; eos rows yield []
        n_tokens = 0  # over all rows (what the batch path counts)
        for chunk in generate_text_stream(
            self.model,
            padded,
            max_new_tokens=run_new,
            chunk_size=env_int("stream_chunk", 16),
            sampling=sampling,
            seed=seed,
            eos_id=self._eos_id,
            live_rows=live,
            prefill_chunk_size=env_int("prefill_chunk", 0) or None,
            cache_len=cache_len,
        ):
            budget = pend.max_new - emitted
            rows = [r[:budget] for r in chunk[:real_n]]
            emitted += max((len(r) for r in rows), default=0)
            n_tokens += sum(len(r) for r in rows)
            pend.stream_q.put(("chunk", rows))
            if emitted >= pend.max_new:
                break  # the bucket's tail beyond the request
        self.metrics.inc("tokens_generated_total", n_tokens)
        pend.stream_q.put(("done", n_tokens))

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
        """Stop the listener (if serving) and the scheduler's or the
        batcher's thread."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self._batcher.close()
        self._tel.close()

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
                    # Goodput is refreshed at scrape time too (the ledger
                    # otherwise publishes only at close, and a server
                    # rarely closes).
                    outer._tel.goodput.publish()
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
                    # On-demand torch.profiler capture (the training
                    # metrics server's contract); 404 without telemetry.
                    profiler = outer._tel.profiler
                    if profiler is None:
                        self._reply(404,
                                    {"error": "profiler not configured"})
                        return
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    try:
                        seconds = float(q.get("seconds", ["2.0"])[0])
                    except ValueError:
                        seconds = 2.0
                    result = profiler.trigger(seconds)
                    self._reply(409 if "error" in result else 200, result)
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
    role = env_str("serve_role", "")
    if role:
        # Disaggregated serving: this process is one replica role (a
        # prefill or decode page-bundle server, or the front-door router)
        # instead of the monolithic endpoint below.
        from tpufw_torch.serve.roles import main_role

        return main_role(role)
    from tpufw_torch.utils.profiling import enable_compile_cache

    enable_compile_cache()
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
