"""Closed-loop scaling executor (a copy of ``tpufw.load.executor``):
recommendation → replica → recovery.

``ScalingRecommender`` (``tpufw_torch.obs.fleet``) turns sustained burn
into a patched manifest and a ``fleet_recommendation`` event; this
module applies the decision to the in-process gang: ``GangExecutor``
subscribes to the recommender's decision stream and translates each
pool delta into real replicas — spawning a fresh engine via a caller-provided factory
and registering it with the router on scale-up, draining (the
session-safe drain path) and deregistering on scale-in. Prefill and
decode pools scale independently, the disaggregation dividend.

Every step is stamped as a schema'd ``scale_action`` event so the
whole causal chain is reconstructable from the event log alone:
burn-rate alert (``fleet_alert``) → decision
(``fleet_recommendation``, with its burn-rate-at-decision) → action
(``scale_action`` add/remove, carrying the decision timestamp) →
observed recovery (``scale_action`` action="recovered", once the fast
burn window falls back under 1.0). The obs_summary load digest
renders that chain as a timeline.

Safety rails: the executor only ever removes replicas *it* spawned
(LIFO), so the base gang survives any recommendation storm, and a
scale-down with nothing of its own to remove records an explicit
``skipped`` action instead of guessing.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

#: Factory signature: given a replica name, build + return a replica
#: client (e.g. a LocalReplica over a fresh engine) ready to serve.
SpawnFn = Callable[[str], object]


class GangExecutor:
    """Applies ScalingRecommender decisions to an in-process gang."""

    def __init__(
        self,
        router,
        *,
        spawn: Dict[str, SpawnFn],
        events=None,
        slo=None,
        burn_window: Optional[str] = None,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.router = router
        self.spawn = dict(spawn)
        self.events = events
        self.slo = slo
        #: Burn-rate window to judge decisions/recovery by; None means
        #: the tracker's fastest window (max_burn default).
        self.burn_window = burn_window
        self._wall = wall_clock
        self._lock = threading.Lock()
        #: Replicas this executor spawned, per pool — the only ones
        #: it is allowed to remove, newest first out.
        self.spawned: Dict[str, List[object]] = {}
        #: Applied/skipped/recovered action records, oldest first.
        self.actions: List[dict] = []
        self._seq = 0
        #: Decision ts of the last scale-up still awaiting observed
        #: burn-rate recovery (None once recovered).
        self._awaiting: Optional[dict] = None

    # ----------------------------------------------------- wiring

    def subscribe(self, recommender) -> None:
        """Attach to a ScalingRecommender's decision stream."""
        recommender.listeners.append(self.on_decision)

    # ----------------------------------------------------- helpers

    def _burn(self) -> Optional[float]:
        if self.slo is None:
            return None
        try:
            return self.slo.max_burn(self.burn_window)
        except Exception:
            return None

    def _emit(self, *, pool: str, action: str, replica: str, **extra):
        rec = {
            "pool": pool,
            "action": action,
            "replica": replica,
            "ts": round(self._wall(), 3),
            **extra,
        }
        burn = self._burn()
        if burn is not None:
            rec["burn"] = round(burn, 4)
        with self._lock:
            self.actions.append(rec)
        if self.events is not None:
            self.events.emit("scale_action", **rec)
        return rec

    # ----------------------------------------------------- actions

    def on_decision(self, decision: dict) -> None:
        """Recommender listener: apply each pool's delta. Exceptions
        are contained per pool — a failed prefill spawn must not
        strand the decode delta."""
        ts = decision.get("ts")
        reason = decision.get("reason", "")
        for pool, move in sorted(decision.get("pools", {}).items()):
            delta = int(move["to"]) - int(move["from"])
            try:
                if delta > 0:
                    for _ in range(delta):
                        self._scale_up(pool, ts, reason)
                elif delta < 0:
                    for _ in range(-delta):
                        self._scale_down(pool, ts, reason)
            except Exception as e:
                self._emit(
                    pool=pool,
                    action="error",
                    replica="",
                    decision_ts=ts,
                    error=f"{type(e).__name__}: {e}",
                )

    def _scale_up(self, pool: str, decision_ts, reason: str) -> None:
        factory = self.spawn.get(pool)
        if factory is None:
            self._emit(
                pool=pool,
                action="skipped",
                replica="",
                decision_ts=decision_ts,
                why="no spawn factory for pool",
            )
            return
        with self._lock:
            self._seq += 1
            name = f"{pool}-auto{self._seq}"
        client = factory(name)
        self.router.add_replica(client, pool)
        with self._lock:
            self.spawned.setdefault(pool, []).append(client)
        rec = self._emit(
            pool=pool,
            action="add",
            replica=name,
            decision_ts=decision_ts,
            reason=reason,
        )
        with self._lock:
            self._awaiting = {
                "pool": pool,
                "replica": name,
                "decision_ts": decision_ts,
                "action_ts": rec["ts"],
            }

    def _scale_down(self, pool: str, decision_ts, reason: str) -> None:
        with self._lock:
            own = self.spawned.get(pool) or []
            client = own.pop() if own else None
        if client is None:
            # Never touch the base gang: nothing of ours to remove.
            self._emit(
                pool=pool,
                action="skipped",
                replica="",
                decision_ts=decision_ts,
                why="no executor-spawned replica in pool",
            )
            return
        name = getattr(client, "name", "")
        self.router.remove_replica(name, drain=True)
        close = getattr(client, "close", None)
        if callable(close):
            close()
        self._emit(
            pool=pool,
            action="remove",
            replica=name,
            decision_ts=decision_ts,
            reason=reason,
        )

    # ----------------------------------------------------- recovery

    def poll_recovery(self) -> Optional[dict]:
        """Close the causal chain: after a scale-up, once the fast
        burn window drops back under 1.0 (burning slower than budget)
        stamp a ``recovered`` scale_action linking back to the
        decision. Call from the smoke/sweep loop after each scrape;
        returns the action record when recovery is observed."""
        with self._lock:
            awaiting = self._awaiting
        if awaiting is None:
            return None
        burn = self._burn()
        if burn is None or burn >= 1.0:
            return None
        with self._lock:
            self._awaiting = None
        return self._emit(
            pool=awaiting["pool"],
            action="recovered",
            replica=awaiting["replica"],
            decision_ts=awaiting["decision_ts"],
            recovery_s=round(self._wall() - awaiting["action_ts"], 3),
        )

    # ----------------------------------------------------- teardown

    def close(self) -> None:
        """Drain and remove every replica this executor spawned —
        newest first, per pool. Idempotent."""
        with self._lock:
            pools = {p: list(cs) for p, cs in self.spawned.items()}
            self.spawned = {}
        for pool, clients in sorted(pools.items()):
            for client in reversed(clients):
                name = getattr(client, "name", "")
                try:
                    self.router.remove_replica(name, drain=True)
                except Exception:
                    pass
                close = getattr(client, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:
                        pass
                self._emit(pool=pool, action="remove", replica=name)
