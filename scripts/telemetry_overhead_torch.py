"""What phase 20b's telemetry on/off ratio reads on one card, and why.

Runs ``chip_smoke.telemetry_train`` (``llama3_600m_bench`` through
``train_llama`` at B=4 x 2048, TEL_STEPS steps) in one process, in
``--blocks`` blocks of the modes in ``--order``: ``on`` (phase 20a's
telemetry), ``off`` (20b's run without it) and ``noprof`` (20a's
telemetry without its profiler window). Prints one JSON line a run: its
steps, the median of its TEL_MEDIAN_STEPS, the cyclic garbage
collector's passes and pauses by generation, the objects it tracks and
the live threads at the run's end. Then, for each mode, its median step
over the off runs' (TEL_MEDIAN_STEPS pooled) in each pair of runs (0-1,
2-3, ...), each block and all runs. Needs a CUDA card; run from the root
of the repo:

    python3 scripts/telemetry_overhead_torch.py [--blocks 3]
        [--order on,off,off,on]
"""

import argparse
import gc
import json
import os
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("on", "off", "noprof")


def over_off(runs: list, steps: list) -> dict:
    """Each mode's median step over the off runs', pooled over steps."""
    by = {m: [r["steps_ms"][i] for r in runs if r["mode"] == m
              for i in steps] for m in MODES}
    if not by["off"]:
        return {}
    return {m: statistics.median(v) / statistics.median(by["off"])
            for m, v in by.items() if v and m != "off"}


class GcPauses:
    """Passes and milliseconds of the cyclic collector, by generation,
    while installed."""

    def __init__(self):
        self.passes, self.ms, self._t0 = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.passes[g] += 1
            self.ms[g] += 1e3 * (time.perf_counter() - self._t0)

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--order", default="on,off,off,on")
    args = ap.parse_args()
    order = args.order.split(",")
    if "off" not in order or not set(order) <= set(MODES):
        ap.error(f"--order takes {MODES}, off among them")
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from tpufw_torch.ops import _build
    from tpufw_torch.workloads import train_llama

    if not torch.cuda.is_available():
        print("telemetry_overhead_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    _build.build()
    build_trainer = train_llama.build_trainer

    def without_profiler():
        for k in ("TPUFW_PROFILE_DIR", "TPUFW_PROFILE_STEPS"):
            os.environ.pop(k, None)
        return build_trainer()

    base = os.path.join(ROOT, "build-torch", f"telemetry-ab-{os.getpid()}")
    runs = []
    for j, mode in enumerate(order * args.blocks):
        wd = os.path.join(base, f"run{j}")
        os.makedirs(wd, exist_ok=True)
        train_llama.build_trainer = (without_profiler if mode == "noprof"
                                     else build_trainer)
        t0 = time.perf_counter()
        with GcPauses() as pauses:
            r = cs.telemetry_train(torch, wd, on=mode != "off")
        steps = [1e3 * m.step_time_s for m in r["history"]]
        runs.append({"run": j, "mode": mode, "median_ms": statistics.median(
            steps[i] for i in cs.TEL_MEDIAN_STEPS),
            "run_s": time.perf_counter() - t0, "steps_ms": steps,
            "gc_passes": pauses.passes, "gc_ms": pauses.ms,
            "gc_tracked": len(gc.get_objects()),
            "threads": threading.active_count(),
            "card": cs.nvidia_smi(cs.CARD_STATE)})
        print(json.dumps(runs[-1]), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    train_llama.build_trainer = build_trainer
    med, n = cs.TEL_MEDIAN_STEPS, len(order)
    print(json.dumps({
        "order": order,
        "pair_over_off": [over_off(runs[k:k + 2], med)
                          for k in range(0, len(runs) - 1, 2)],
        "block_over_off": [over_off(runs[k:k + n], med)
                           for k in range(0, len(runs), n)],
        "all_over_off": over_off(runs, med)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
