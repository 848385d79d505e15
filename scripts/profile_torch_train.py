#!/usr/bin/env python3
"""Where the time of one ``tpufw_torch`` train step goes, on one GPU.

    python3 scripts/profile_torch_train.py [--model llama3_8b] [--layers N]
        [--remat-policy dots] [--moe-dispatch einsum] [--steps 3]
        [--trace PATH]

Trains a chip_smoke.py train slice (``--model llama3_8b``:
``llama3_8b_train_slice`` in ``tpufw_torch/configs/presets.py``;
``--model gemma2_9b``: ``gemma2_9b_train_slice``, whose flash kernels are
the head-dim-256 builds; ``--model deepseek_mla_bench``:
``deepseek_mla_train_slice``, the head-dim-192 builds; ``--model
mixtral_8x7b``: ``mixtral_8x7b_train_slice``, under ``--moe-dispatch``;
depth ``--layers``, by default the slice's own: 4, 4, all 10 and 2;
``--remat-policy``, by default the config's "dots"), runs two warm-up
steps, then traces ``--steps`` steps with ``torch.profiler`` and prints one
JSON line: wall time per step, device busy time per step (the union of the
trace's kernel, memcpy and memset intervals), the device's idle share,
kernel time by category (each flash kernel, GEMMs, PyTorch's elementwise
and reduction kernels, the rest) and the top kernels. It fails when the
busy time exceeds the wall time, which only a miscount can give.
``--trace`` keeps the Chrome trace at PATH.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def category(name: str) -> str:
    for k in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        if k in name:
            return k
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet",
                              "sm90_")):
        return "gemm"
    if "at::native" in name:
        return "torch_elementwise_reduce"
    return "other"


def trace_breakdown(prof, steps: int, wall_s: float, trace=None) -> dict:
    """Per step of a ``torch.profiler`` run over ``steps`` steps that took
    ``wall_s`` seconds each: device busy time (the union of kernel,
    memcpy and memset intervals), idle share, the number of those device
    operations, time by category and the top kernels. Keeps the Chrome
    trace at ``trace``. A negative idle share means the trace was
    miscounted: it is reported on stderr."""
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels: dict[str, float] = {}
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset"
        ):
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"]
            spans.append((e["ts"], e["ts"] + e["dur"]))
    busy_us = 0.0
    end = float("-inf")
    for lo, hi in sorted(spans):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy_ms = busy_us / 1e3 / steps
    by_cat: dict[str, float] = {}
    for name, us in kernels.items():
        c = category(name)
        by_cat[c] = by_cat.get(c, 0.0) + us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    idle_share = 1.0 - busy_ms / (wall_s * 1e3)
    if idle_share < 0.0:
        print(f"device busy {busy_ms:.3f} ms exceeds wall "
              f"{wall_s * 1e3:.3f} ms per step: the trace was miscounted",
              file=sys.stderr)
    return {
        "wall_ms_per_step": wall_s * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": idle_share,
        "device_ops_per_step": len(spans) / steps,
        "ms_per_step_by_category": by_cat,
        "top_kernels_ms_per_step": [
            {"name": n[:120], "ms": us / 1e3 / steps} for n, us in top
        ],
    }


# --model: the presets module's train slice of that model.
SLICES = {"llama3_8b": "llama3_8b_train_slice",
          "gemma2_9b": "gemma2_9b_train_slice",
          "deepseek_mla_bench": "deepseek_mla_train_slice",
          "mixtral_8x7b": "mixtral_8x7b_train_slice"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--model", default="llama3_8b", choices=tuple(SLICES))
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--moe-dispatch", default=None,
                    choices=("einsum", "sorted"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpufw_torch import configs
    from tpufw_torch.train import Trainer, synthetic_batches

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    depth = {} if args.layers is None else {"n_layers": args.layers}
    cfg, tcfg = getattr(configs, SLICES[args.model])(
        total_steps=2 + args.steps, **depth)
    if args.remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    if args.moe_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=args.moe_dispatch)
    trainer = Trainer(cfg, tcfg, device="cuda")
    trainer.init_state(seed=0)
    data = synthetic_batches(tcfg.batch_size, tcfg.seq_len, cfg.vocab_size,
                             seed=0)
    for _ in range(2):
        float(trainer.train_step(next(data))["loss"])
    batches = [next(data) for _ in range(args.steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            float(trainer.train_step(b)["loss"])
        wall = (time.perf_counter() - t0) / args.steps
    out = trace_breakdown(prof, args.steps, wall, args.trace)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": args.model, "layers": cfg.n_layers,
                      "remat_policy": cfg.remat_policy,
                      "moe_dispatch": getattr(cfg, "moe_dispatch", None),
                      "steps_traced": args.steps}
                     | out), flush=True)
    return 0 if out["idle_share"] >= 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
