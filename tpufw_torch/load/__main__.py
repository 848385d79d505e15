"""Operator CLI for the load observatory.

    python -m tpufw_torch.load replay --base-url http://router:8080
    python -m tpufw_torch.load sweep --base-url http://router:8080 \\
        --rungs 1,2,4,8 --hold-s 10 --out BENCH_load.json

``replay`` sends the TPUFW_LOAD_* mix (docs/ENV.md) once against a live
router, writes one ``load-trace.jsonl`` record per request and prints a
summary line with the schedule's digest. ``sweep`` replays the same mix
at each rung and writes the BENCH_load payload, as ``python -m
tpufw.load sweep`` does. The trace goes to ``TPUFW_LOAD_DIR``, else
beside ``--out`` (sweep) or into the working directory (replay). The
in-process hooks (SLO phase stamps, fleet joins, executor) need the
sweep to share a process with the gang; this CLI is the remote-router
case.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpufw_torch.load.genload import (
    MixConfig,
    ReplayClient,
    TraceWriter,
    schedule,
    schedule_digest,
)
from tpufw_torch.load.sweep import SweepConfig, run_sweep, write_payload
from tpufw_torch.workloads.env import env_opt_str


def _replay(args) -> int:
    mix = MixConfig.from_env()
    reqs = schedule(mix)
    trace_dir = env_opt_str("load_dir") or os.getcwd()
    path = os.path.join(trace_dir, "load-trace.jsonl")
    with TraceWriter(path) as trace:
        client = ReplayClient.from_env(
            args.base_url, trace=trace, offered_rps=mix.rate_rps
        )
        summary = client.run(reqs)
    summary.update(
        schedule_digest=schedule_digest(reqs), trace=path,
        process=mix.process, seed=mix.seed,
    )
    print(json.dumps({"load_replay": summary}, sort_keys=True))
    return 0 if summary["completed"] == summary["offered"] else 1


def _sweep(args) -> int:
    mix = MixConfig.from_env()
    sweep = SweepConfig(
        rungs=tuple(
            float(r) for r in args.rungs.split(",") if r.strip()
        ),
        hold_s=args.hold_s,
        settle_s=args.settle_s,
        goal=args.goal,
        ttft_target_s=args.ttft_target_s,
        tok_target_s=args.tok_target_s,
        threads=args.threads,
    )
    trace_dir = env_opt_str("load_dir") or os.path.dirname(
        os.path.abspath(args.out)
    )
    trace = TraceWriter(os.path.join(trace_dir, "load-trace.jsonl"))
    try:
        payload = run_sweep(args.base_url, mix, sweep, trace=trace)
    finally:
        trace.close()
    write_payload(payload, args.out)
    print(json.dumps({"knee": payload["knee"]}, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpufw_torch.load")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser(
        "replay", help="send the TPUFW_LOAD_* mix once and trace it"
    )
    rp.add_argument("--base-url", required=True)
    sw = sub.add_parser("sweep", help="run a capacity sweep")
    sw.add_argument("--base-url", required=True)
    sw.add_argument(
        "--rungs", default="1,2,4,8",
        help="comma-separated offered rps per rung",
    )
    sw.add_argument("--hold-s", type=float, default=6.0)
    sw.add_argument("--settle-s", type=float, default=1.0)
    sw.add_argument("--goal", type=float, default=0.99)
    sw.add_argument("--ttft-target-s", type=float, default=2.0)
    sw.add_argument("--tok-target-s", type=float, default=0.2)
    sw.add_argument("--threads", type=int, default=8)
    sw.add_argument("--out", default="BENCH_load.json")
    args = ap.parse_args(argv)
    if args.cmd == "replay":
        return _replay(args)
    return _sweep(args)


if __name__ == "__main__":
    sys.exit(main())
