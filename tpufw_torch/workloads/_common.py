"""Shared scaffolding of the training entry points (port of
``tpufw.workloads._common``): the JSON-lines telemetry channel, the
global-batch contract, the resumed run's data seed, the post-training
data paths' tokenizer and the preemption and telemetry lines."""

from __future__ import annotations

import json
import time
from typing import Callable

from tpufw_torch.train.metrics import StepMetrics


def check_global_batch(batch_size: int, n_processes: int) -> int:
    """Global-batch contract: returns the LOCAL batch size per process."""
    if batch_size % n_processes:
        raise ValueError(
            f"global batch {batch_size} not divisible by "
            f"{n_processes} processes"
        )
    return batch_size // n_processes


def metrics_printer(t0: float) -> Callable[[StepMetrics], None]:
    """on_metrics callback: the first call prints the cold-start to
    first-step record, every call the step's JSON line."""
    first_step: dict = {}

    def on_metrics(m: StepMetrics) -> None:
        if not first_step:
            first_step["t"] = time.time()
            print(json.dumps(
                {"cold_start_to_first_step_s": round(first_step["t"] - t0, 1)}
            ), flush=True)
        print(json.dumps(m.as_dict()), flush=True)

    return on_metrics


def resume_data_seed(base_seed: int, restored_step: int) -> int:
    """Data seed of a (possibly) resumed run, the JAX package's formula: a
    run restored at step N shuffles the corpus with a fresh permutation
    (the step folded into the seed) rather than replaying batches 1..N.
    Not sample-exact resume, but no duplication bias, O(1), and equal to
    what a resumed ``tpufw`` run draws."""
    if restored_step <= 0:
        return base_seed
    return base_seed + 1_000_003 * restored_step


def resolve_encode(tok_name: str):
    """The text encoder of the SFT, DPO, RL and embedding data paths
    (``TPUFW_SFT_TOKENIZER``): "bytes", the dependency-free byte
    tokenizer (``train.sft.byte_encode``), or a LOCAL HuggingFace
    tokenizer directory (``tools.pack_corpus.hf_tokenizer``: no hub
    download; without ``transformers`` it raises ImportError naming the
    package), encoding context-free (no special tokens, so span masks
    stay exact)."""
    if tok_name == "bytes":
        from tpufw_torch.train.sft import byte_encode

        return byte_encode
    from tpufw_torch.tools.pack_corpus import hf_tokenizer

    tok = hf_tokenizer(tok_name)

    def encode(text):
        return tok.encode(text, add_special_tokens=False)

    return encode


def report_preemption(trainer) -> None:
    """One JSON line when the run stopped on SIGTERM (the forced
    checkpoint is on disk; a clean exit lets the restart resume)."""
    if getattr(trainer, "preempted", False):
        print(json.dumps({"preempted": True, "step": int(trainer.step)}),
              flush=True)


def report_telemetry(trainer) -> None:
    """One JSON line pointing at the run's telemetry artifacts
    (events.jsonl and trace.json under TPUFW_TELEMETRY_DIR), so log
    scrapers find them without knowing the env."""
    tel = getattr(trainer, "telemetry", None)
    if tel is not None and getattr(tel, "out_dir", None):
        print(json.dumps({"telemetry_dir": tel.out_dir}), flush=True)


def print_summary(history: list[StepMetrics]) -> None:
    if not history:
        return
    last = history[-1]
    print(
        f"TRAIN OK: {len(history)} steps, final loss {last.loss:.4f}, "
        f"{last.tokens_per_sec_per_gpu:.0f} tok/s/GPU, "
        f"MFU {last.mfu:.1%}"
    )
