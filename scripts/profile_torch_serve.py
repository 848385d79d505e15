#!/usr/bin/env python3
"""Where the time of one ``tpufw_torch`` decode step goes, on one GPU.

    python3 scripts/profile_torch_serve.py [--int8] [--steps 8] [--trace PATH]
    python3 scripts/profile_torch_serve.py --pool contiguous|paged|paged_int8

Builds the chip_smoke.py serve slice (``llama3_8b_serve_slice`` in
``tpufw_torch/configs/presets.py``: Llama-3-8B, 32 layers, bf16 weights,
or their int8 twin with ``--int8``), prefills its 4 prompts, runs two
warm-up decode steps of the whole batch, then traces ``--steps`` decode
steps with ``torch.profiler`` and prints one JSON line: wall time per
step, device busy time, idle share, device operations per step, time by
category and the top kernels (``profile_torch_train.trace_breakdown``).
It fails when the busy time exceeds the wall time. ``--trace`` keeps the
Chrome trace at PATH.

``--pool`` traces the step of chip_smoke.py's online phase instead: an
8-slot pool at 1024 KV slots (contiguous, paged with 64-slot pages, or
paged with int8 KV; bf16 weights), all 8 slots occupied by the slice's 4
prompts twice over, each advanced by ``SlotPool.decode_steps(1)``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--pool", choices=("contiguous", "paged", "paged_int8"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_torch_train import trace_breakdown
    from tpufw_torch.configs import llama3_8b_serve_slice
    from tpufw_torch.infer import SamplingConfig, pad_prompts
    from tpufw_torch.infer.generate import _decode_step, _prefill_and_first
    from tpufw_torch.models import Llama
    from tpufw_torch.workloads.serve import quantize_model

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    cfg, prompts, max_new = llama3_8b_serve_slice()
    if 2 + args.steps >= max_new:
        print(f"profile_torch_serve: --steps must be below {max_new - 2}",
              file=sys.stderr)
        return 1
    model = Llama(cfg, device="cuda", seed=0)
    if args.pool:
        return profile_pool(model, prompts, args)
    if args.int8:
        model = quantize_model(model)
        torch.cuda.empty_cache()
    tokens, pads = pad_prompts(prompts)
    greedy = SamplingConfig()
    with torch.no_grad():
        cache, token, pos, done, seen = _prefill_and_first(
            model, torch.tensor(tokens, device="cuda").long(),
            torch.tensor(pads, device="cuda").long(), None,
            sampling=greedy, eos_id=None, prefill_chunk_size=None,
        )

        def step(token, pos, done):
            return _decode_step(model, cache, token, pos, done, seen, None,
                                sampling=greedy, pad_id=0, eos_id=None)

        for _ in range(2):
            token, pos, done = step(token, pos, done)
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                token, pos, done = step(token, pos, done)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
    out = trace_breakdown(prof, args.steps, wall, args.trace)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "weights": "int8" if args.int8 else "bf16",
                      "batch": len(prompts), "steps_traced": args.steps}
                     | out), flush=True)
    return 0 if out["idle_share"] >= 0.0 else 1


def profile_pool(model, prompts, args) -> int:
    """The online phase's decode step: 8 occupied slots at 1024 KV slots,
    one ``decode_steps(1)`` per traced step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_torch_train import trace_breakdown
    from tpufw_torch.infer import (
        PagedSlotPool,
        SamplingConfig,
        SlotPool,
        prefill_row,
    )

    greedy, rows, cache_len = SamplingConfig(), prompts * 2, 1024
    budget = args.steps + 2
    with torch.no_grad():
        if args.pool == "contiguous":
            pool = SlotPool.create(model, len(rows), cache_len=cache_len)
        else:
            pool = PagedSlotPool.create_paged(
                model, len(rows), cache_len=cache_len, page=64,
                kv_quant="int8" if args.pool == "paged_int8" else "",
                sampling=greedy, prefix_cache=False)
        for slot, p in enumerate(rows):
            cache, _, first, _, _ = prefill_row(
                model, p, None, sampling=greedy, eos_id=None,
                cache_len=cache_len)
            if args.pool == "contiguous":
                pool.insert(slot, cache, first, len(p), budget)
            else:
                ids, shared = pool.acquire_pages(p, len(p) + budget)
                try:
                    pool.insert_paged(slot, cache, first, len(p), budget,
                                      ids, shared)
                except BaseException:
                    pool.release_pages(ids)
                    raise
        del cache
        pool.decode_steps(2)
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                pool.decode_steps(1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
    out = trace_breakdown(prof, args.steps, wall, args.trace)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "weights": "bf16", "pool": args.pool,
                      "batch": len(rows), "cache_len": cache_len,
                      "steps_traced": args.steps} | out), flush=True)
    return 0 if out["idle_share"] >= 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
