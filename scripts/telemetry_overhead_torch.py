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
2-3, ...), each block and all runs. Each run line also holds the
process's CPU seconds over each step's period beside its wall.

``--turns A,B[,first]`` runs phase 20's two-process turns
(``chip_smoke.telemetry_worker``) with side 0 in mode A and side 1 in
mode B ("on" or "off"; an A/A pair shows what the turns cost a side;
``off:on`` is a side that first trains one "on" run alone), ``--blocks``
runs a side, side ``first`` (default 0) taking the first turn; it
prints each side's runs and side 0's pooled median step over side 1's.
``--variant`` takes one part of the telemetry out of side 0's "on"
runs: ``noprof`` the profiler window, ``noperf`` the counted step
(``TPUFW_PERF_OBS=0``), ``noport`` the metrics server, ``nocrash`` the
flight recorder (``TPUFW_CRASH_BUNDLE=0``); ``teardown`` keeps every
part and sets ``TEARDOWN_CUPTI=1`` in side 0.

``--pairs N`` runs another probe instead: N times, two trainers built
alike (telemetry off) are stepped in turn for ``--pair-steps`` steps
each, a host sync after each step, so that a difference of their
medians belongs to the trainer and not to the time it ran at. Needs a
CUDA card; run from the root of the repo:

    python3 scripts/telemetry_overhead_torch.py [--blocks 3]
        [--order on,off,off,on] [--pairs N [--pair-steps 24]]
        [--turns A,B[,first] [--variant noprof]]
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


class HostClock:
    """Wraps a trainer's ``train_step`` to read the wall and the
    process's CPU seconds at each call."""

    def __init__(self, trainer):
        self.marks, step = [], trainer.train_step

        def timed(batch):
            self.marks.append((time.perf_counter(), time.process_time()))
            return step(batch)

        trainer.train_step = timed

    def periods(self) -> list:
        """(wall, process CPU) ms from each call to the next."""
        return [(round(1e3 * (q[0] - p[0]), 3), round(1e3 * (q[1] - p[1]), 3))
                for p, q in zip(self.marks, self.marks[1:])]


def paired(torch, cs, train_llama, pairs: int, steps: int) -> None:
    """``--pairs``: two trainers stepped in turn (ABBA within each pair
    of steps), one JSON line a pair."""
    from tpufw_torch.train import synthetic_batches

    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        del os.environ[k]
    os.environ.update({"TPUFW_MODEL": "llama3_600m_bench",
                       "TPUFW_BATCH_SIZE": str(cs.RESUME_BATCH),
                       "TPUFW_SEQ_LEN": str(cs.RESUME_SEQ),
                       "TPUFW_TOTAL_STEPS": str(steps),
                       "TPUFW_LOSS_CHUNK_SIZE": "512"})
    for p in range(pairs):
        trainers = []
        for _ in range(2):
            trainer, cfg = train_llama.build_trainer()
            trainer.init_state(seed=0)
            trainers.append(trainer)
        it = synthetic_batches(cs.RESUME_BATCH, cs.RESUME_SEQ,
                               cfg.vocab_size, seed=7)
        batches = [{k: torch.from_numpy(v).cuda() for k, v in
                    next(it).items()} for _ in range(steps)]
        ms = [[], []]
        for i in range(steps):
            for t in ((0, 1) if i % 2 == 0 else (1, 0)):
                t0 = time.perf_counter()
                float(trainers[t].train_step(batches[i])["loss"])
                ms[t].append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({"pair": p, "steps_ms": ms, "median_ms": [
            statistics.median(m[1:]) for m in ms]}), flush=True)
        del trainers, batches
        gc.collect()
        torch.cuda.empty_cache()


VARIANTS = {"noprof": ({"TPUFW_PROFILE_DIR", "TPUFW_PROFILE_STEPS"}, {}),
            "noperf": (set(), {"TPUFW_PERF_OBS": "0"}),
            "noport": ({"TPUFW_METRICS_PORT"}, {}),
            "nocrash": (set(), {"TPUFW_CRASH_BUNDLE": "0"}),
            "teardown": (set(), {})}


def variant_worker(variant: str, *args) -> None:
    """``chip_smoke.telemetry_worker`` with ``VARIANTS[variant]`` applied
    to every ``build_trainer`` of this process's telemetry runs."""
    sys.path.insert(0, ROOT)
    if variant == "teardown":
        # Kineto's switch to detach CUPTI when a profiler window ends.
        os.environ["TEARDOWN_CUPTI"] = "1"
    import chip_smoke as cs
    from tpufw_torch.workloads import train_llama

    build, (drop, add) = train_llama.build_trainer, VARIANTS[variant]

    def patched():
        # A run without telemetry reads none of these knobs.
        for k in drop:
            os.environ.pop(k, None)
        os.environ.update(add)
        return build()

    train_llama.build_trainer = patched
    # 20a's checks need every part; the probe reads only step times.
    cs.telemetry_checks = lambda run, workdir: {}
    cs.telemetry_worker(*args)


def turns(cs, modes: list, first: int, runs: int,
          variant: str = "") -> None:
    """``--turns``: two ``telemetry_worker`` sides taking turns, one
    results queue a side."""
    import multiprocessing
    import shutil

    ctx = multiprocessing.get_context("spawn")
    batons = [ctx.Semaphore(0), ctx.Semaphore(0)]
    queues = [ctx.Queue(), ctx.Queue()]
    base = os.path.join(ROOT, "build-torch", f"turns-{os.getpid()}")
    sides = [(m.split(":") + [None])[:2] for m in modes]
    dirs = [[os.path.join(base, f"s{k}r{j}") for j in range(
        runs + bool(sides[k][1]))] for k in (0, 1)]
    for d in dirs[0] + dirs[1]:
        os.makedirs(d, exist_ok=True)
    args = [(sides[k][0], dirs[k], (batons[k], batons[1 - k]), queues[k],
             sides[k][1]) for k in (0, 1)]
    procs = [ctx.Process(target=variant_worker, args=(variant, *args[0]),
                         daemon=True) if variant else
             ctx.Process(target=cs.telemetry_worker, args=args[0],
                         daemon=True),
             ctx.Process(target=cs.telemetry_worker, args=args[1],
                         daemon=True)]
    try:
        for p in procs:
            p.start()
        batons[first].release()
        # A turn takes seconds: a side that ends early ends the wait.
        got = [q.get(timeout=120) for q in queues]
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(base, ignore_errors=True)
    for k, (_, out, info) in enumerate(got):
        if out is None:
            raise RuntimeError(f"side {k}: {info}")
    med = [statistics.median(r["step_ms"][i] for r in out["runs"]
                             for i in cs.TEL_MEDIAN_STEPS)
           for _, out, _ in got]
    print(json.dumps({"modes": modes, "first": first, "variant": variant,
                      "sides": [
        [r["step_ms"] for r in out["runs"]] for _, out, _ in got],
        "median_ms": med, "side0_over_side1": med[0] / med[1]}), flush=True)


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
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--pair-steps", type=int, default=24)
    ap.add_argument("--turns", default="")
    ap.add_argument("--variant", default="", choices=["", *VARIANTS])
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
    if args.pairs:
        paired(torch, cs, train_llama, args.pairs, args.pair_steps)
        return 0
    if args.turns:
        spec = args.turns.split(",")
        turns(cs, spec[:2], int(spec[2]) if len(spec) > 2 else 0,
              args.blocks, args.variant)
        return 0
    build_trainer = train_llama.build_trainer
    clocks = []

    def clocked(made):
        clocks.append(HostClock(made[0]))
        return made

    def without_profiler():
        for k in ("TPUFW_PROFILE_DIR", "TPUFW_PROFILE_STEPS"):
            os.environ.pop(k, None)
        return clocked(build_trainer())

    base = os.path.join(ROOT, "build-torch", f"telemetry-ab-{os.getpid()}")
    runs = []
    for j, mode in enumerate(order * args.blocks):
        wd = os.path.join(base, f"run{j}")
        os.makedirs(wd, exist_ok=True)
        train_llama.build_trainer = (
            without_profiler if mode == "noprof"
            else lambda: clocked(build_trainer()))
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
            "step_periods_ms": clocks.pop().periods(),
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
