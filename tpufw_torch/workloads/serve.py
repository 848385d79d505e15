"""Inference serving workload, batch mode (port of ``tpufw.workloads.serve``):
``python -m tpufw_torch.workloads.serve``.

Builds the decode model and generates continuations for
``TPUFW_PROMPTS_FILE`` (JSON: a list of token-id lists) or the built-in
demo prompts, printing one JSON line per prompt and then a
``generate_ok`` line.

Knobs, as in the JAX workload: ``TPUFW_MODEL`` (a ``LLAMA_CONFIGS``
preset or ``llama3_600m_bench``, the default), ``TPUFW_MAX_SEQ_LEN``,
``TPUFW_SEED``, ``TPUFW_MAX_NEW_TOKENS`` (16), ``TPUFW_QUANTIZE=int8``,
``TPUFW_DECODE_DTYPE`` (e.g. ``bfloat16``), ``TPUFW_PREFILL_CHUNK``,
``TPUFW_EOS_ID``, the sampling knobs ``TPUFW_TEMPERATURE``,
``TPUFW_TOP_K``, ``TPUFW_TOP_P``, ``TPUFW_MIN_P`` and
``TPUFW_REPETITION_PENALTY``, ``TPUFW_TOKENIZER`` (``bytes``), and
``TPUFW_DEVICE`` (default ``cuda``). Weights are drawn at random from
``TPUFW_SEED``.

Not ported yet, and refused: the HTTP server and the disaggregated roles
(``TPUFW_SERVE_PORT`` > 0, ``TPUFW_SERVE_ROLE``; ROADMAP.md Queue 1 items 8
and 9), speculative decoding (``TPUFW_DRAFT_MODEL``; item 8), and loading
weights (``TPUFW_CHECKPOINT_DIR``, ``TPUFW_PARAMS_CHECKPOINT``,
``TPUFW_HF_CHECKPOINT``; item 6). Telemetry hooks come with item 13.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import torch

from tpufw_torch.workloads.env import env_float, env_int, env_str

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


def main() -> int:
    if env_str("serve_role", ""):
        _refuse("serve_role", "disaggregated serving", "9")
    if env_int("serve_port", 0):
        _refuse("serve_port", "the HTTP server", "8")
    max_new = env_int("max_new_tokens", 16)
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
