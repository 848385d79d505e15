"""The port's fleet observatory (``tpufw_torch.obs.fleet``) against
``tpufw.obs.fleet``.

The first part is ``tests/test_fleet.py`` run on the port's modules:
series store, collector, derived series, alert engine, scaling
recommender and the retrospective query layer, wall-clock-free where
timing matters (injectable clocks, ``scrape_once`` driven by hand). The
second feeds both packages the same inputs and holds what they produce
exactly equal (host code, the same Python arithmetic: tolerance 0): the
series file's bytes after appends and compaction, the deriver's outputs,
the alert engine's transitions and events on one fake clock, the
recommender's decision and artifact, and the query CLI's JSON. The last
part is the router's attach point: ``TPUFW_FLEET_SCRAPE_S`` unset starts
no collector and writes no file, set it scrapes the router and its
replicas.
"""

import json
import os
import threading
import urllib.request

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.obs import fleet as j_fleet
from tpufw_torch.obs import events as obs_events
from tpufw_torch.obs import fleet
from tpufw_torch.obs.registry import Registry
from tpufw_torch.serve import router

MANIFEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "deploy",
    "manifests",
    "13-serve-disagg-v5e8-jobset.yaml",
)


# ------------------------------------------------------- series store


def test_store_append_read_round_trip(tmp_path):
    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"), clock=lambda: 5.0)
    store.append("r0", "decode", {"tpufw_x": 1.0})
    store.append("r1", "prefill", {"tpufw_x": 2.0}, ts=7.0, stale=True)
    store.close()
    recs = fleet.read_series(str(tmp_path / "s.jsonl"))
    assert [r["ts"] for r in recs] == [5.0, 7.0]
    assert recs[0]["series"] == {"tpufw_x": 1.0}
    assert not recs[0].get("stale") and recs[1]["stale"] is True


def test_store_torn_tail_read(tmp_path):
    path = tmp_path / "s.jsonl"
    store = fleet.SeriesStore(str(path))
    store.append("r0", "decode", {"tpufw_x": 1.0}, ts=1.0)
    store.append("r0", "decode", {"tpufw_x": 2.0}, ts=2.0)
    store.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"ts": 3.0, "replica": "r0", "ser')  # killed mid-write
    recs = fleet.read_series(str(path))
    assert [r["ts"] for r in recs] == [1.0, 2.0]
    # And appending after a torn tail still works (new writer).
    store2 = fleet.SeriesStore(str(path))
    store2.append("r0", "decode", {"tpufw_x": 3.0}, ts=4.0)
    store2.close()
    assert [r["ts"] for r in fleet.read_series(str(path))] == [
        1.0, 2.0, 4.0,
    ]


def test_read_series_missing_file_is_empty():
    assert fleet.read_series("/nonexistent/fleet-series.jsonl") == []


def test_compaction_hand_computed_fixture(tmp_path):
    # max_records=16 -> compaction at the 17th append: tail keeps the
    # newest 8 verbatim, the 9-record head decimates per replica from
    # the end (keep/drop alternating, newest anchored): positions
    # 0,2,4,6,8 of the head survive -> ts 1,3,5,7,9 + ts 10..17.
    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"), max_records=16)
    for i in range(1, 18):
        store.append("r0", "decode", {"tpufw_x": float(i)}, ts=float(i))
    recs = store.read()
    assert [r["ts"] for r in recs] == [
        1.0, 3.0, 5.0, 7.0, 9.0,
        10.0, 11.0, 12.0, 13.0, 14.0, 15.0, 16.0, 17.0,
    ]
    # Survivors are untouched genuine snapshots, not averages.
    assert all(r["series"]["tpufw_x"] == r["ts"] for r in recs)
    store.close()


def test_compaction_keeps_newest_sample_per_replica(tmp_path):
    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"), max_records=16)
    # Interleave two replicas; r1's newest sample sits mid-file at
    # compaction time and must survive the head decimation.
    for i in range(1, 6):
        store.append("r1", "prefill", {}, ts=100.0 + i)
    for i in range(1, 13):
        store.append("r0", "decode", {}, ts=200.0 + i)
    replicas = {r["replica"] for r in store.read()}
    assert replicas == {"r0", "r1"}
    r1_ts = [r["ts"] for r in store.read() if r["replica"] == "r1"]
    assert r1_ts[-1] == 105.0
    store.close()


# --------------------------------------------------- derived + rates


def _rec(ts, replica, role, series, stale=False):
    rec = {"ts": ts, "replica": replica, "role": role, "series": series}
    if stale:
        rec["stale"] = True
    return rec


def test_deriver_counts_sums_and_rates():
    dv = fleet._Deriver()
    sweep1 = [
        _rec(0.0, "router", "router", {
            "tpufw_router_tokens_total": 0.0,
            "tpufw_router_requests_total": 0.0,
            "tpufw_router_piggyback_total": 0.0,
            "tpufw_router_queue_depth": 2.0,
        }),
        _rec(0.0, "decode-0", "decode", {
            "tpufw_fleet_replica_pages_in_use": 10.0,
            "tpufw_fleet_replica_pages_total": 64.0,
        }),
    ]
    d1 = dv.derive(sweep1)
    assert d1['tpufw_fleet_replicas{role="router"}'] == 1
    assert d1['tpufw_fleet_replicas{role="decode"}'] == 1
    assert d1["tpufw_fleet_queue_depth"] == 2.0
    assert d1["tpufw_fleet_pages_in_use"] == 10.0
    assert d1["tpufw_fleet_page_occupancy"] == pytest.approx(10 / 64)
    assert "tpufw_fleet_tokens_per_s" not in d1  # no previous sweep
    sweep2 = [
        _rec(10.0, "router", "router", {
            "tpufw_router_tokens_total": 500.0,
            "tpufw_router_requests_total": 20.0,
            "tpufw_router_piggyback_total": 5.0,
            "tpufw_router_queue_depth": 0.0,
        }),
        _rec(10.0, "decode-0", "decode", {
            "tpufw_fleet_replica_pages_in_use": 40.0,
            "tpufw_fleet_replica_pages_total": 64.0,
        }),
    ]
    d2 = dv.derive(sweep2)
    assert d2["tpufw_fleet_tokens_per_s"] == pytest.approx(50.0)
    assert d2["tpufw_fleet_requests_per_s"] == pytest.approx(2.0)
    assert d2["tpufw_fleet_piggyback_fraction"] == pytest.approx(0.25)


def test_deriver_counter_reset_clamps_to_zero():
    dv = fleet._Deriver()
    dv.derive([_rec(0.0, "r", "router",
                    {"tpufw_router_tokens_total": 1000.0})])
    d = dv.derive([_rec(10.0, "r", "router",
                        {"tpufw_router_tokens_total": 5.0})])  # restart
    assert d["tpufw_fleet_tokens_per_s"] == 0.0


def test_deriver_reaggregates_slo_series_across_routers():
    dv = fleet._Deriver()
    d = dv.derive([
        _rec(0.0, "router-a", "router", {
            'tpufw_slo_ttft_attainment{tenant="t"}': 0.9,
            'tpufw_slo_burn_rate{metric="ttft",tenant="t",window="60s"}': 20.0,
        }),
        _rec(0.0, "router-b", "router", {
            'tpufw_slo_ttft_attainment{tenant="t"}': 0.7,
            'tpufw_slo_burn_rate{metric="ttft",tenant="t",window="60s"}': 10.0,
        }),
    ])
    assert d[
        'tpufw_fleet_slo_attainment{metric="ttft",tenant="t"}'
    ] == pytest.approx(0.8)
    assert d[
        'tpufw_fleet_slo_burn_rate{metric="ttft",tenant="t",window="60s"}'
    ] == pytest.approx(15.0)


def test_stale_records_are_excluded_from_aggregates():
    dv = fleet._Deriver()
    d = dv.derive([
        _rec(0.0, "d0", "decode",
             {"tpufw_fleet_replica_pages_in_use": 10.0}),
        _rec(0.0, "d1", "decode", {}, stale=True),
    ])
    assert d['tpufw_fleet_replicas{role="decode"}'] == 1
    assert d["tpufw_fleet_replicas_unhealthy"] == 1
    assert d["tpufw_fleet_pages_in_use"] == 10.0


# --------------------------------------------------------- collector


def test_collector_scrapes_registry_and_signals_targets(tmp_path):
    reg = Registry()
    reg.counter("tpufw_router_requests_total").inc(3)
    signals = {"role": "decode", "pages_in_use": 7, "pages_total": 64,
               "slots_active": 2, "slots_total": 8}
    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"))
    col = fleet.FleetCollector(
        [
            fleet.Target("router", "router", reg.render),
            fleet.Target("decode-0", "decode", lambda: signals),
        ],
        store,
        clock=lambda: 100.0,
    )
    derived = col.scrape_once()
    recs = store.read()
    by_name = {r["replica"]: r for r in recs}
    assert by_name["router"]["series"][
        "tpufw_router_requests_total"] == 3
    assert by_name["decode-0"]["series"][
        "tpufw_fleet_replica_pages_in_use"] == 7
    assert by_name["fleet"]["series"] == derived
    assert derived["tpufw_fleet_page_occupancy"] == pytest.approx(7 / 64)
    # Derived series re-export as gauges on the collector's registry.
    assert "tpufw_fleet_page_occupancy" in col.registry.render()
    store.close()


def test_replica_dying_mid_scrape_is_stale_marked_not_crashed(tmp_path):
    def dead():
        raise ConnectionRefusedError("replica gone")

    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"))
    col = fleet.FleetCollector(
        [
            fleet.Target("live", "decode",
                         lambda: {"pages_in_use": 1, "pages_total": 4}),
            fleet.Target("dead", "decode", dead),
        ],
        store,
        clock=lambda: 100.0,
    )
    derived = col.scrape_once()  # must not raise
    by_name = {r["replica"]: r for r in store.read()}
    assert by_name["dead"]["stale"] is True
    assert by_name["dead"]["series"] == {}
    assert "stale" not in by_name["live"]
    assert derived["tpufw_fleet_replicas_unhealthy"] == 1
    assert derived['tpufw_fleet_replicas{role="decode"}'] == 1
    store.close()


def test_collector_folds_healthz_detail_for_unscraped_replicas(tmp_path):
    health = {
        "ok": True,
        "replicas": {
            "decode-1": {"role": "decode", "healthy": True,
                         "pages_in_use": 5, "pages_total": 64},
            "decode-2": {"role": "decode", "healthy": False,
                         "pages_in_use": 0, "pages_total": 64},
        },
    }
    store = fleet.SeriesStore(str(tmp_path / "s.jsonl"))
    col = fleet.FleetCollector([], store, health_fn=lambda: health,
                               clock=lambda: 100.0)
    derived = col.scrape_once()
    by_name = {r["replica"]: r for r in store.read()}
    assert by_name["decode-1"]["series"][
        "tpufw_fleet_replica_pages_in_use"] == 5
    assert by_name["decode-2"]["stale"] is True
    assert derived["tpufw_fleet_replicas_unhealthy"] == 1
    store.close()


# ---------------------------------------------- fake-clock alert math


def _burn(metric, tenant, window, v):
    return {
        fleet.promtext.sample_key(
            "tpufw_fleet_slo_burn_rate",
            {"metric": metric, "tenant": tenant, "window": window},
        ): v
    }


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_burn_rate_pair_needs_both_windows(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    clock = _Clock()
    eng = fleet.AlertEngine(
        [fleet.BurnRateRule(name="b", metric="ttft",
                            fast_threshold=14.4, slow_threshold=6.0)],
        events=log, clock=clock,
    )
    fast_only = {**_burn("ttft", "t", "60s", 20.0),
                 **_burn("ttft", "t", "300s", 1.0)}
    assert eng.evaluate(fast_only) == []  # slow window says blip
    both = {**_burn("ttft", "t", "60s", 20.0),
            **_burn("ttft", "t", "300s", 8.0)}
    firing = eng.evaluate(both)
    assert [f["name"] for f in firing] == ["b"]
    # Clearing the fast window resolves.
    cleared = {**_burn("ttft", "t", "60s", 1.0),
               **_burn("ttft", "t", "300s", 8.0)}
    assert eng.evaluate(cleared) == []
    log.close()
    states = [
        e["state"]
        for e in obs_events.read_events(str(tmp_path / "ev.jsonl"))
        if e["kind"] == "fleet_alert"
    ]
    assert states == ["firing", "resolved"]


def test_threshold_rule_for_duration_fake_clock(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    clock = _Clock()
    eng = fleet.AlertEngine(
        [fleet.AlertRule(name="backlog",
                         series="tpufw_fleet_queue_depth",
                         op=">", threshold=8.0, for_s=30.0)],
        events=log, clock=clock,
    )
    hot = {"tpufw_fleet_queue_depth": 12.0}
    assert eng.evaluate(hot) == []  # pending: condition just started
    clock.t = 29.0
    assert eng.evaluate(hot) == []  # still inside for_s
    clock.t = 31.0
    firing = eng.evaluate(hot)
    assert firing and firing[0]["name"] == "backlog"
    assert firing[0]["value"] == 12.0
    # A dip resets the pending timer entirely.
    clock.t = 40.0
    assert eng.evaluate({"tpufw_fleet_queue_depth": 1.0}) == []
    clock.t = 41.0
    assert eng.evaluate(hot) == []  # pending restarted from 41
    log.close()


def test_alert_events_validate_against_schema(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    eng = fleet.AlertEngine(
        [fleet.AlertRule(name="r", series="tpufw_fleet_queue_depth",
                         threshold=0.0, for_s=0.0)],
        events=log, clock=_Clock(),
    )
    eng.evaluate({"tpufw_fleet_queue_depth": 5.0})
    log.close()
    events = obs_events.read_events(str(tmp_path / "ev.jsonl"))
    assert events
    for ev in events:
        obs_events.validate(ev)  # raises on schema drift


# ------------------------------------------- recommender + artifacts


def test_patch_manifest_replicas_one_shot_arming():
    text = open(MANIFEST, encoding="utf-8").read()
    assert fleet.read_manifest_replicas(text) == {
        "prefill": 1, "decode": 1,
    }
    patched = fleet.patch_manifest_replicas(
        text, {"prefill": 3, "decode": 2}
    )
    assert fleet.read_manifest_replicas(patched) == {
        "prefill": 3, "decode": 2,
    }
    # The container also named "prefill" (image: on the next line)
    # must not arm the patcher: no replicas line may move anywhere
    # else, so patched and original differ on exactly two lines.
    diff = [
        (a, b)
        for a, b in zip(text.split("\n"), patched.split("\n"))
        if a != b
    ]
    assert [(a.strip(), b.strip()) for a, b in diff] == [
        ("replicas: 1", "replicas: 3"),
        ("replicas: 1", "replicas: 2"),
    ]


def test_recommender_writes_lintable_artifact_and_event(tmp_path):
    log = obs_events.EventLog(str(tmp_path / "ev.jsonl"))
    rec = fleet.ScalingRecommender(
        str(tmp_path), MANIFEST, cooldown_s=0.0, events=log,
        clock=_Clock(), wall_clock=lambda: 42.0,
    )
    decision = rec.consider(
        [{"name": "fleet_ttft_burn", "scale": "prefill:+1"}], now=0.0
    )
    assert decision["pools"] == {"prefill": {"from": 1, "to": 2}}
    yaml_path = tmp_path / decision["artifact"]
    assert yaml_path.exists()
    text = yaml_path.read_text(encoding="utf-8")
    assert text.startswith("# fleet-recommendation: ")
    assert fleet.read_manifest_replicas(text) == {
        "prefill": 2, "decode": 1,
    }
    sidecar = json.loads(
        (tmp_path / "fleet-rec-0001.json").read_text(encoding="utf-8")
    )
    assert sidecar["reason"] == ["fleet_ttft_burn"]
    log.close()
    kinds = [
        e["kind"]
        for e in obs_events.read_events(str(tmp_path / "ev.jsonl"))
    ]
    assert kinds == ["fleet_recommendation"]


def test_recommender_cooldown_and_clamps(tmp_path):
    clock = _Clock()
    rec = fleet.ScalingRecommender(
        str(tmp_path), MANIFEST, cooldown_s=100.0, max_replicas=2,
        clock=clock,
    )
    firing = [{"name": "a", "scale": "decode:+1"}]
    assert rec.consider(firing, now=0.0)["replicas"]["decode"] == 2
    # Cooldown: same pool cannot move again for 100s.
    assert rec.consider(firing, now=50.0) is None
    # Past cooldown, but already at max_replicas: clamped, no decision.
    assert rec.consider(firing, now=200.0) is None
    # Scale-down ignores the other pool's cooldown state.
    down = [{"name": "b", "scale": "decode:-1"}]
    assert rec.consider(down, now=301.0)["replicas"]["decode"] == 1
    # min_replicas floor.
    assert rec.consider(down, now=602.0) is None


def test_recommender_one_vote_per_rule_and_one_step_per_decision(
    tmp_path,
):
    rec = fleet.ScalingRecommender(
        str(tmp_path), MANIFEST, cooldown_s=0.0, clock=_Clock(),
    )
    # Three instances of one rule + one more rule, both prefill:+1 —
    # still a single +1 step.
    firing = [
        {"name": "burn", "scale": "prefill:+1"},
        {"name": "burn", "scale": "prefill:+1"},
        {"name": "backlog", "scale": "prefill:+1"},
    ]
    decision = rec.consider(firing, now=0.0)
    assert decision["pools"]["prefill"] == {"from": 1, "to": 2}
    assert decision["reason"] == ["backlog", "burn"]


# ------------------------------------------------------ query layer


def _seeded_dir(tmp_path):
    store = fleet.SeriesStore(str(tmp_path / fleet.SERIES_FILENAME))
    for t in (10.0, 20.0, 30.0):
        store.append("router", "router",
                     {"tpufw_router_queue_depth": t / 10}, ts=t)
        store.append("fleet", "fleet",
                     {"tpufw_fleet_queue_depth": t / 10}, ts=t)
    store.close()
    log = obs_events.EventLog(str(tmp_path / fleet.EVENTS_FILENAME))
    log.emit("fleet_alert", rule="backlog", state="firing",
             series="tpufw_fleet_queue_depth", value=3.0)
    log.close()
    # Rewrite the alert ts to sit between sweeps 2 and 3.
    path = tmp_path / fleet.EVENTS_FILENAME
    ev = json.loads(path.read_text(encoding="utf-8"))
    ev["ts"] = 25.0
    path.write_text(json.dumps(ev) + "\n", encoding="utf-8")
    return tmp_path


def test_state_at_reconstructs_pre_alert_window(tmp_path):
    d = _seeded_dir(tmp_path)
    records = fleet.read_series(str(d / fleet.SERIES_FILENAME))
    history = fleet.load_alert_history(str(d / fleet.EVENTS_FILENAME))
    before = fleet.state_at(records, history, 20.0)
    assert before["derived"] == {"tpufw_fleet_queue_depth": 2.0}
    assert before["alerts_firing"] == []
    after = fleet.state_at(records, history, 30.0)
    assert after["derived"] == {"tpufw_fleet_queue_depth": 3.0}
    assert [a["rule"] for a in after["alerts_firing"]] == ["backlog"]
    stats = fleet.window_stats(records, 0.0, 30.0)
    assert stats["tpufw_fleet_queue_depth"] == {
        "min": 1.0, "mean": 2.0, "max": 3.0, "n": 3.0,
    }


def test_query_cli_json(tmp_path, capsys):
    d = _seeded_dir(tmp_path)
    rc = fleet.main([
        "query", "--dir", str(d), "--at", "20.0", "--window", "15",
        "--json",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["derived"] == {"tpufw_fleet_queue_depth": 2.0}
    assert out["alerts_firing"] == []
    assert out["window"]["tpufw_fleet_queue_depth"]["n"] == 2.0


def test_query_cli_empty_dir(tmp_path, capsys):
    assert fleet.main(["query", "--dir", str(tmp_path)]) == 1
    assert "no fleet series" in capsys.readouterr().out


# ------------------------------------------------------ env plumbing


def test_collector_from_env_disabled_creates_nothing(
    tmp_path, monkeypatch
):
    monkeypatch.delenv("TPUFW_FLEET_SCRAPE_S", raising=False)
    col = fleet.collector_from_env(
        [], default_dir=str(tmp_path / "fleet")
    )
    assert col is None
    assert not (tmp_path / "fleet").exists()


def test_collector_from_env_enabled(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFW_FLEET_SCRAPE_S", "30")
    monkeypatch.setenv("TPUFW_FLEET_DIR", str(tmp_path / "f"))
    monkeypatch.setenv("TPUFW_FLEET_MANIFEST", MANIFEST)
    col = fleet.collector_from_env(
        [fleet.Target("x", "decode", lambda: {"pages_in_use": 1})]
    )
    assert col is not None
    try:
        assert col.recommender is not None
        assert (tmp_path / "f" / fleet.SERIES_FILENAME).exists()
    finally:
        col.stop()


# ============================================ parity with tpufw.obs.fleet


class _Rec:
    """An event sink both packages' emitters accept; keeps (kind, level,
    fields) in order."""

    def __init__(self):
        self.events = []

    def emit(self, kind, level="info", **fields):
        self.events.append((kind, level, fields))


def _appends(n):
    """``n`` appends over three replicas, one of them going stale."""
    out = []
    for i in range(n):
        name = ("router", "decode-0", "prefill-0")[i % 3]
        out.append((name, name.split("-")[0],
                    {"tpufw_x": float(i) / 3.0, f"tpufw_{name[0]}": i * 1.5},
                    100.0 + i * 0.25, i % 7 == 6))
    return out


@pytest.mark.parametrize("max_records,n", [(16, 40), (20, 57)])
def test_series_file_bytes_equal_tpufw(tmp_path, max_records, n):
    paths = {}
    for name, mod in (("port", fleet), ("jax", j_fleet)):
        paths[name] = str(tmp_path / name / fleet.SERIES_FILENAME)
        store = mod.SeriesStore(paths[name], max_records=max_records,
                                clock=lambda: 7.0)
        for replica, role, series, ts, stale in _appends(n):
            store.append(replica, role, series, ts=ts, stale=stale)
        store.append("fleet", "fleet", {"tpufw_y": 1.0})  # store's clock
        store.close()
    got = open(paths["port"], "rb").read()
    assert got == open(paths["jax"], "rb").read()
    assert len(fleet.read_series(paths["port"])) < n  # compacted


def _sweeps():
    """Six sweeps of per-replica records: counters that grow and one that
    resets, page and spill gauges, a stale replica, SLO series of two
    routers and a spec accept rate."""
    out = []
    for k in range(6):
        ts = 10.0 * k + (0.5 if k == 3 else 0.0)
        router_a = {
            "tpufw_router_tokens_total": 100.0 * k * k,
            "tpufw_router_requests_total": 7.0 * k,
            "tpufw_router_piggyback_total": 2.0 * (k // 2),
            "tpufw_router_queue_depth": float(k % 3),
            'tpufw_slo_ttft_attainment{tenant="vip"}': 1.0 - 0.07 * k,
            'tpufw_slo_tok_attainment{tenant="vip"}': 0.9,
            'tpufw_slo_burn_rate{metric="tok",tenant="vip",window="60s"}':
                3.3 * k,
            'tpufw_slo_burn_rate{metric="tok",tenant="vip",window="300s"}':
                1.7 * k,
        }
        router_b = {
            "tpufw_router_tokens_total": 0.0 if k == 4 else 50.0 * k,
            'tpufw_slo_ttft_attainment{tenant="vip"}': 0.8,
            'tpufw_slo_burn_rate{metric="tok",tenant="vip",window="60s"}':
                1.1,
            "tpufw_spec_accept_rate": 0.61,
        }
        decode = {
            "tpufw_fleet_replica_pages_in_use": 3.0 * k + 1,
            "tpufw_fleet_replica_pages_total": 64.0,
            "tpufw_fleet_replica_spill_ram_pages": float(k),
            "tpufw_fleet_replica_spill_dir_pages": 2.0,
            "tpufw_fleet_replica_draining": float(k == 5),
            "tpufw_fleet_replica_prefix_hits": float(k * 3),
            "tpufw_fleet_replica_prefix_misses": 5.0,
            "tpufw_serve_tokens_generated_total": 13.0 * k,
            "tpufw_spec_accept_rate": 0.45,
        }
        out.append([
            {"ts": ts, "replica": "router-a", "role": "router",
             "series": router_a},
            {"ts": ts, "replica": "router-b", "role": "router",
             "series": router_b},
            {"ts": ts, "replica": "decode-0", "role": "decode",
             "series": decode},
            {"ts": ts, "replica": "decode-1", "role": "decode",
             "series": {}, **({"stale": True} if k % 2 else {})},
        ])
    return out


def test_deriver_outputs_equal_tpufw():
    port, ref = fleet._Deriver(), j_fleet._Deriver()
    for sweep in _sweeps():
        got = port.derive(json.loads(json.dumps(sweep)))
        want = ref.derive(json.loads(json.dumps(sweep)))
        assert got == want
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)


def _firing_rows(firing):
    return [{k: (v.name if k == "rule" else v) for k, v in f.items()}
            for f in firing]


def test_alert_engine_transitions_equal_tpufw():
    """Both engines, the default catalog plus a short-hold burn pair, on
    one fake clock: the same firing lists at every step and the same
    fleet_alert events in the same order."""
    def rules(mod):
        return mod.DEFAULT_ALERT_RULES + (
            mod.BurnRateRule(name="tok_fast", metric="tok",
                             fast_window="60s", slow_window="300s",
                             fast_threshold=5.0, slow_threshold=2.0,
                             for_s=5.0, scale="decode:+1"),
        )

    clock = _Clock()
    rec_p, rec_j = _Rec(), _Rec()
    port = fleet.AlertEngine(rules(fleet), events=rec_p, clock=clock)
    ref = j_fleet.AlertEngine(rules(j_fleet), events=rec_j, clock=clock)
    dv = fleet._Deriver()
    steps = 0
    for sweep in _sweeps():
        derived = dv.derive(sweep)
        derived["tpufw_fleet_queue_depth"] = 9.0 + steps
        for dt in (0.0, 12.0, 31.0):
            clock.t += dt
            assert _firing_rows(port.evaluate(derived)) == _firing_rows(
                ref.evaluate(derived))
            steps += 1
    clock.t += 1.0
    assert port.evaluate({}) == ref.evaluate({}) == []
    assert rec_p.events == rec_j.events
    states = [f["state"] for _k, _l, f in rec_p.events]
    assert "firing" in states and "resolved" in states


def test_recommender_decision_and_artifact_equal_tpufw(tmp_path):
    """Same alerts, same clocks: the same decisions, sidecar bytes and
    event fields; the artifact text differs only in the header's
    ``Emitted by`` module name."""
    clock = _Clock()
    recs, sinks = {}, {}
    for name, mod in (("port", fleet), ("jax", j_fleet)):
        sinks[name] = _Rec()
        recs[name] = mod.ScalingRecommender(
            str(tmp_path / name), MANIFEST, cooldown_s=50.0,
            max_replicas=3, events=sinks[name], clock=clock,
            wall_clock=lambda: 1234.5,
        )
    plan = [
        (0.0, [{"name": "fleet_tok_burn", "scale": "decode:+1"},
               {"name": "fleet_ttft_burn", "scale": "prefill:+1"}]),
        (10.0, [{"name": "fleet_tok_burn", "scale": "decode:+1"}]),
        (60.0, [{"name": "fleet_tok_burn", "scale": "decode:+1"},
                {"name": "fleet_idle_capacity", "scale": "decode:-1"},
                {"name": "fleet_queue_backlog", "scale": "prefill:+1"}]),
        (120.0, [{"name": "a", "scale": "decode:+1"},
                 {"name": "b", "scale": "decode:+1"}]),
        (200.0, [{"name": "fleet_idle_capacity", "scale": "decode:-1"},
                 {"name": "x", "scale": "bogus"}]),
    ]
    n = 0
    for now, firing in plan:
        got = recs["port"].consider(firing, now=now)
        want = recs["jax"].consider(firing, now=now)
        assert got == want
        if got is None:
            continue
        n += 1
        stem = got["artifact"][: -len(".yaml")]
        p_dir, j_dir = tmp_path / "port", tmp_path / "jax"
        assert (p_dir / f"{stem}.json").read_bytes() == (
            j_dir / f"{stem}.json").read_bytes()
        text = (p_dir / got["artifact"]).read_text(encoding="utf-8")
        assert text.replace("tpufw_torch.obs.fleet", "tpufw.obs.fleet") == (
            j_dir / got["artifact"]).read_text(encoding="utf-8")
        assert fleet.read_manifest_replicas(text) == got["replicas"]
    assert n >= 3
    strip = [(k, lvl, {**f, "artifact": os.path.basename(f["artifact"])})
             for k, lvl, f in sinks["port"].events]
    assert strip == [(k, lvl, {**f, "artifact": os.path.basename(
        f["artifact"])}) for k, lvl, f in sinks["jax"].events]


@pytest.mark.parametrize("args", [
    ["--at", "20.0", "--window", "15", "--json"],
    ["--json"],
    ["--at", "30.0", "--json"],
    ["--at", "25.0", "--window", "30"],
])
def test_query_cli_output_equal_tpufw(tmp_path, capsys, args):
    d = _seeded_dir(tmp_path)
    assert fleet.main(["query", "--dir", str(d)] + args) == 0
    got = capsys.readouterr().out
    assert j_fleet.main(["query", "--dir", str(d)] + args) == 0
    assert got == capsys.readouterr().out


def test_collector_sweeps_equal_tpufw(tmp_path):
    """Both collectors scrape the same exposition text, signals dicts and
    /healthz detail (one target dying on the third sweep) on fake clocks:
    the same derived series every sweep and the same series file."""
    reg = Registry()
    state = {"k": 0}

    def router_text():
        reg.counter("tpufw_router_requests_total").inc(3)
        reg.counter("tpufw_router_tokens_total").inc(40 + state["k"])
        reg.gauge("tpufw_router_queue_depth").set(state["k"] % 4)
        return reg.render()

    def decode_sig():
        if state["k"] == 2:
            raise ConnectionRefusedError("replica gone")
        return {"role": "decode", "pages_in_use": 5 + state["k"],
                "pages_total": 64, "slots_active": 2, "slots_total": 8,
                "migrations": 3 * state["k"]}

    def health():
        return {"ok": True, "replicas": {
            "decode-0": {"role": "decode", "healthy": True},
            "decode-9": {"role": "decode", "healthy": state["k"] != 1,
                         "pages_in_use": 1, "pages_total": 32}}}

    clock = _Clock(100.0)
    cols = {}
    for name, mod in (("port", fleet), ("jax", j_fleet)):
        store = mod.SeriesStore(str(tmp_path / name / "s.jsonl"),
                                max_records=16)
        cols[name] = mod.FleetCollector(
            [mod.Target("router", "router", router_text),
             mod.Target("decode-0", "decode", decode_sig)],
            store, health_fn=health, clock=clock, mono=clock,
        )
    for k in range(5):
        state["k"] = k
        clock.t = 100.0 + 5.0 * k
        text = router_text()  # both read the same exposition
        for col in cols.values():
            col.targets[0].scrape = lambda text=text: text
        got = cols["port"].scrape_once()
        assert got == cols["jax"].scrape_once()
    for col in cols.values():
        col.stop()
    assert (tmp_path / "port" / "s.jsonl").read_bytes() == (
        tmp_path / "jax" / "s.jsonl").read_bytes()


# ================================================ the router's attach point


def _run_router(monkeypatch, capsys, tmp_path, until, scrape_s=None):
    """``router.main_router()`` on an unreachable gang in ``tmp_path``;
    its sleep loop ends once ``until(banner)`` returns (a
    KeyboardInterrupt, as Ctrl-C would). Returns (banner, its result)."""
    for k in list(os.environ):
        if k.startswith("TPUFW_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPUFW_ROUTER_PREFILL", "127.0.0.1:1")
    monkeypatch.setenv("TPUFW_ROUTER_DECODE", "127.0.0.1:1")
    monkeypatch.setenv("TPUFW_ROUTER_PORT", "0")
    if scrape_s is not None:
        monkeypatch.setenv("TPUFW_FLEET_SCRAPE_S", str(scrape_s))
        monkeypatch.setenv("TPUFW_FLEET_DIR", str(tmp_path / "fleet"))
    os.makedirs(tmp_path, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    real_sleep = router.time.sleep
    seen = {}

    def sleep(s):
        if s < 3600:
            return real_sleep(s)
        seen["banner"] = json.loads(capsys.readouterr().out.splitlines()[0])
        seen["result"] = until(seen["banner"])
        raise KeyboardInterrupt

    monkeypatch.setattr(router.time, "sleep", sleep)
    assert router.main_router() == 0
    return seen["banner"], seen["result"]


def _metrics_families(port):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return [f.name for f in fleet.promtext.parse(r.read().decode())]


def test_router_without_fleet_knob_starts_no_collector(tmp_path, monkeypatch,
                                                       capsys):
    def until(banner):
        names = _metrics_families(banner["port"])
        threads = [t.name for t in threading.enumerate()]
        return names, threads, sorted(os.listdir(tmp_path))

    banner, (names, threads, files) = _run_router(
        monkeypatch, capsys, tmp_path, until)
    assert banner["fleet"] is False
    assert "fleet-collector" not in threads
    assert files == []  # no series, no event log, nowhere
    assert not any(n.startswith("tpufw_fleet_") for n in names)
    assert "tpufw_router_requests_total" in names

    # With the knob on, the router's own /metrics keeps the same series
    # (the collector re-exports on a registry of its own).
    banner_on, (names_on, threads_on, _f) = _run_router(
        monkeypatch, capsys, tmp_path / "on", until, scrape_s=30)
    assert banner_on["fleet"] is True and "fleet-collector" in threads_on
    assert names_on == names
    assert "fleet-collector" not in [t.name for t in threading.enumerate()]
