"""Capacity-frontier sweep (a copy of ``tpufw.load.sweep``): step
offered load, hold each rung to steady state, find the knee.

The question every scaling decision hangs on is "how much load can
this gang take before the SLO goal slips?" — attainment as a function
of offered load, per tenant. The sweep answers it empirically: replay
the same seeded mix at increasing arrival rates (rungs), hold each
rung long enough to reach steady state, score every request against
its tenant's TTFT/per-token targets from the client side, and join
each rung's window with the router's ``tpufw_slo_*`` gauges and the
fleet observatory's derived series so the server-side view rides
along in the artifact.

The **knee** is the last rung whose overall attainment still meets
the SLO goal — the capacity frontier. Everything past it is load the
gang accepts but cannot serve within target, which is exactly the
regime the burn-rate autoscaling loop (executor.py) exists to escape.

Queueing-delay decomposition comes free: the router already returns
its TTFT stage breakdown (queue wait, prefill, first decode step) in
every response body, so per-rung stage means show *where* the added
latency lands as rungs climb — queue growth (admission-bound) reads
very differently from prefill growth (compute-bound).
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from tpufw_torch.load.genload import (
    MixConfig,
    ReplayClient,
    TraceWriter,
    schedule,
    schedule_digest,
)

#: BENCH_load.json schema version.
SWEEP_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """The sweep plan: which rungs (offered rps), how long to hold
    each, how much of each hold to discard as warm-up, and what
    "good" means (TTFT / per-token targets, attainment goal)."""

    rungs: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0)
    hold_s: float = 6.0
    settle_s: float = 1.0
    goal: float = 0.99
    ttft_target_s: float = 2.0
    tok_target_s: float = 0.2
    #: Per-tenant (ttft_s, tok_s) target overrides.
    tenant_targets: Tuple[Tuple[str, Tuple[float, float]], ...] = ()
    threads: int = 8

    def targets_for(self, tenant: str) -> Tuple[float, float]:
        for name, tgt in self.tenant_targets:
            if name == tenant:
                return tgt
        return (self.ttft_target_s, self.tok_target_s)


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(
        len(sorted_vals) - 1, int(q / 100.0 * (len(sorted_vals) - 1))
    )
    return sorted_vals[i]


def _is_good(rec: dict, ttft_t: float, tok_t: float) -> bool:
    if rec.get("status") != 200:
        return False
    ttft = rec.get("ttft_s")
    if isinstance(ttft, (int, float)) and ttft > ttft_t:
        return False
    tok = rec.get("tok_s")
    if isinstance(tok, (int, float)) and tok > tok_t:
        return False
    return True


def rung_stats(
    records: Sequence[dict], sweep: SweepConfig, wall_s: float
) -> dict:
    """Score one rung's trace records. Attainment counts rejected and
    errored load *against* the tenant — a 429 is offered load the SLO
    did not serve, which is why the router's reject counter carries
    the tenant label."""
    tenants: Dict[str, List[dict]] = {}
    for rec in records:
        tenants.setdefault(str(rec.get("tenant", "")), []).append(rec)
    per_tenant: Dict[str, dict] = {}
    good_all = offered_all = 0
    goodput_tokens = 0
    stage_acc: Dict[str, List[float]] = {}
    for tenant, recs in sorted(tenants.items()):
        ttft_t, tok_t = sweep.targets_for(tenant)
        offered = len(recs)
        completed = sum(1 for r in recs if r["status"] == 200)
        rejected = sum(1 for r in recs if r["status"] == 429)
        good = sum(1 for r in recs if _is_good(r, ttft_t, tok_t))
        ttfts = sorted(
            float(r["ttft_s"])
            for r in recs
            if isinstance(r.get("ttft_s"), (int, float))
        )
        toks = sorted(
            float(r["tok_s"])
            for r in recs
            if isinstance(r.get("tok_s"), (int, float))
        )
        good_tokens = sum(
            int(r.get("n_tokens", 0))
            for r in recs
            if _is_good(r, ttft_t, tok_t)
        )
        per_tenant[tenant] = {
            "offered": offered,
            "completed": completed,
            "rejected": rejected,
            "errors": offered - completed - rejected,
            "good": good,
            "attainment": round(good / offered, 6) if offered else 1.0,
            "goodput_tok_s": (
                round(good_tokens / wall_s, 6) if wall_s > 0 else 0.0
            ),
            "ttft_p50_s": round(_percentile(ttfts, 50), 6),
            "ttft_p95_s": round(_percentile(ttfts, 95), 6),
            "tok_p50_s": round(_percentile(toks, 50), 6),
            "ttft_target_s": ttft_t,
            "tok_target_s": tok_t,
        }
        good_all += good
        offered_all += offered
        goodput_tokens += good_tokens
        for r in recs:
            for stage, v in (r.get("stages") or {}).items():
                if isinstance(v, (int, float)):
                    stage_acc.setdefault(str(stage), []).append(
                        float(v)
                    )
    return {
        "tenants": per_tenant,
        "attainment": (
            round(good_all / offered_all, 6) if offered_all else 1.0
        ),
        "offered": offered_all,
        "goodput_tok_s": (
            round(goodput_tokens / wall_s, 6) if wall_s > 0 else 0.0
        ),
        "stages_mean_s": {
            stage: round(sum(vs) / len(vs), 6)
            for stage, vs in sorted(stage_acc.items())
        },
    }


def detect_knee(rungs: Sequence[dict], goal: float) -> Optional[dict]:
    """The capacity frontier: the LAST rung whose overall attainment
    meets the goal. "Last" rather than "first failing minus one"
    because noisy middle rungs shouldn't hide real capacity above
    them; a monotone sweep gives the same answer either way."""
    knee = None
    for r in rungs:
        if r["attainment"] >= goal:
            knee = {
                "rung": r["rung"],
                "offered_rps": r["offered_rps"],
                "attainment": r["attainment"],
            }
    return knee


def _scrape_slo(base_url: str, timeout_s: float = 5.0) -> Dict[str, float]:
    """Snapshot the router's tpufw_slo_* gauges — the server-side SLO
    view joined into each rung record. Best-effort: a sweep against a
    router without an SLO tracker still produces curves."""
    from tpufw_torch.obs import promtext

    try:
        with urllib.request.urlopen(
            base_url.rstrip("/") + "/metrics", timeout=timeout_s
        ) as resp:
            text = resp.read().decode("utf-8")
    except (OSError, ValueError):
        return {}
    return {
        k: v
        for k, v in promtext.flatten(text).items()
        if k.startswith("tpufw_slo_")
    }


def run_sweep(
    base_url: str,
    mix: MixConfig,
    sweep: SweepConfig,
    *,
    trace: Optional[TraceWriter] = None,
    events=None,
    slo=None,
    fleet_records: Optional[Sequence[dict]] = None,
) -> dict:
    """Run the full rung ladder against ``base_url`` and return the
    BENCH_load payload.

    ``events``/``slo`` are optional in-process hooks: when the sweep
    shares a process with the gang (bench, smoke), rung boundaries
    land in the event log as ``load_phase`` events and stamp the SLO
    tracker's phase so violations attribute to their rung.
    ``fleet_records`` (a SeriesStore read) joins each rung's window
    with the fleet's derived series.
    """
    from tpufw_torch.obs import fleet as fleet_mod

    rungs_out: List[dict] = []
    for i, rate in enumerate(sweep.rungs):
        phase = f"rung-{i}"
        if events is not None:
            events.emit("load_phase", phase=phase)
        if slo is not None and hasattr(slo, "set_phase"):
            slo.set_phase(phase)
        # Per-rung seed derived from the mix seed: deterministic, but
        # rungs don't replay literally identical arrival gaps.
        cfg = dataclasses.replace(
            mix,
            seed=mix.seed + i,
            rate_rps=rate,
            duration_s=sweep.hold_s,
        )
        reqs = schedule(cfg)
        client = ReplayClient(
            base_url,
            trace,
            threads=sweep.threads,
            rung=i,
            offered_rps=rate,
        )
        t_start = time.time()
        summary = client.run(reqs)
        t_end = time.time()
        # Steady state only: drop the rung's warm-up head.
        cut = t_start + sweep.settle_s
        steady = [r for r in client.records if r["ts_offered"] >= cut]
        stats = rung_stats(steady, sweep, summary["wall_s"])
        rung = {
            "rung": i,
            "offered_rps": rate,
            "hold_s": sweep.hold_s,
            "schedule_digest": schedule_digest(reqs),
            "summary": summary,
            "slo_snapshot": _scrape_slo(base_url),
            **stats,
        }
        if fleet_records is not None:
            rung["fleet_window"] = fleet_mod.window_stats(
                fleet_records, t_start, t_end
            )
        rungs_out.append(rung)
    if slo is not None and hasattr(slo, "set_phase"):
        slo.set_phase("")
    if events is not None:
        events.emit("load_phase", phase="done")
    return {
        "bench": "load",
        "schema": SWEEP_SCHEMA,
        "mix": dataclasses.asdict(mix),
        "sweep": dataclasses.asdict(sweep),
        "goal": sweep.goal,
        "rungs": rungs_out,
        "knee": detect_knee(rungs_out, sweep.goal),
    }


def write_payload(payload: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
