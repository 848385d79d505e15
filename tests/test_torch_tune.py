"""The port's autotuner (``tpufw_torch.tune``) against ``tpufw``'s
(``tests/test_tune.py`` case for case), on the CPU:

- ``enumerate_candidates`` gives ``tpufw``'s valid and pruned lists, with
  the same reasons, on every axis but the flash one (grad_accum against
  the batch and the data x fsdp rows, the remat and flash axes collapsing
  when off, the pipeline schedule axis, memory pre-pruning on the same
  estimate); the flash axis takes the port's builds (a pair is valid when
  the head dim has it for all three kernels; no divisibility rule);
- ``search``: selection, quarantine, the budget, as ``tpufw``'s on the
  same fake measurements; the events;
- the cache: key, round trip, a corrupt entry, the port's own directory;
- ``Trainer.run`` with ``search`` that keeps its winner and then hits the
  cache, a remat winner that re-points the model's policy, a
  ``PipelineTrainer`` whose schedule winner moves its state across
  layouts, and each measured trial in the perf observatory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.models import LLAMA_CONFIGS as J_LLAMA
from tpufw.tune import SearchSpace as JSearchSpace
from tpufw.tune import enumerate_candidates as j_enumerate
from tpufw.tune import search as j_search
from tpufw.tune.space import Candidate as JCandidate
from tpufw_torch.models import PRESETS
from tpufw_torch.tune import (
    Candidate,
    SearchSpace,
    cache,
    enumerate_candidates,
    search,
)
from tpufw_torch.tune.runner import (
    apply_autotune,
    apply_candidate,
    candidate_program_name,
)
from tpufw_torch.train import Trainer, TrainerConfig

TINY = dataclasses.replace(PRESETS["llama3_tiny"], dtype=torch.float32)
J_TINY = J_LLAMA["llama3_tiny"]

SMALL = dict(remat_policies=("dots",), grad_accums=(1,),
             loss_chunk_sizes=(None, 64), flash_blocks=(None,),
             sync_everys=(1,))


@pytest.fixture
def tune_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFW_TUNE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("TPUFW_FLASH_BQ", raising=False)
    monkeypatch.delenv("TPUFW_FLASH_BKV", raising=False)
    return tmp_path


def _both(space: dict, *args, tcfg=TINY, jcfg=J_TINY, **kw):
    """(port's, tpufw's) (valid, pruned) as dicts and reasons."""
    mine = enumerate_candidates(tcfg, *args, space=SearchSpace(**space),
                                **kw)
    theirs = j_enumerate(jcfg, *args, space=JSearchSpace(**space), **kw)
    return tuple(([c.as_dict() for c in v], [(c.as_dict(), r) for c, r in p])
                 for v, p in (mine, theirs))


# Spaces of tpufw's tests, and the pipeline axis, on every non-flash axis.
SPACES = {
    "grad_accum_vs_batch": (dict(SMALL, grad_accums=(1, 3, 16),
                                 loss_chunk_sizes=(None,)), (8, 129), {}),
    "grad_accum_vs_dp": (dict(SMALL, grad_accums=(1, 2),
                              loss_chunk_sizes=(None,)), (8, 129),
                         dict(dp_shards=8)),
    "remat_collapses": (dict(SMALL, remat_policies=("dots", "nothing",
                                                    "attn_out")),
                        (8, 129), {}),
    "flash_collapses_on_xla": (dict(SMALL, flash_blocks=(None, (128, 128))),
                               (8, 129), {}),
    "hbm_roomy": (SMALL, (8, 129), dict(hbm_bytes=64 * 2**30)),
    "hbm_tight": (SMALL, (8, 129), dict(hbm_bytes=1e4)),
    "every_axis": (dict(remat_policies=("dots", "nothing"),
                        grad_accums=(1, 2, 3), loss_chunk_sizes=(None, 64),
                        flash_blocks=(None,), sync_everys=(1, 4)),
                   (12, 65), dict(dp_shards=2, hbm_bytes=2**30)),
    "pipeline_schedules": (dict(SMALL, pipeline_schedules=(
        None, ("1f1b", 1), ("interleaved", 2), ("interleaved", 1),
        ("zb1", 2))), (8, 129), dict(pipe_stages=2, pipe_microbatches=4)),
    "schedules_without_pipeline": (dict(SMALL, pipeline_schedules=(
        None, ("1f1b", 1))), (8, 129), {}),
}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", sorted(SPACES))
def test_enumerate_equals_tpufw_on_non_flash_axes(case, remat):
    space, args, kw = SPACES[case]
    tcfg = dataclasses.replace(TINY, remat=remat)
    jcfg = dataclasses.replace(J_TINY, remat=remat)
    mine, theirs = _both(space, *args, tcfg=tcfg, jcfg=jcfg, **kw)
    assert mine == theirs
    if case == "hbm_tight":
        assert mine[0] == [] and all("HBM" in r for _, r in mine[1])
    if case == "grad_accum_vs_batch":
        assert [c["grad_accum"] for c in mine[0]] == [1]


def test_flash_blocks_are_the_head_dims_builds():
    """A (bq, bkv) is valid when every kernel has that build at the
    model's head dim (128 here), whatever the sequence: 64 keys need not
    divide anything (tpufw prunes (256, 256) against a 128-token row);
    no build, pruned with the kernel's own message."""
    fcfg = dataclasses.replace(TINY, attention_backend="flash", head_dim=128)
    valid, pruned = enumerate_candidates(
        fcfg, 8, 129, space=SearchSpace(**dict(SMALL, loss_chunk_sizes=(
            None,), flash_blocks=(None, (128, 64), (None, 64), (128, 128),
                                  (64, 64), (100, 128)))))
    assert [(c.flash_bq, c.flash_bkv) for c in valid] == [
        (None, None), (None, 64), (128, 64), (128, 128)]
    assert sorted(r.split(" (from")[0] for _, r in pruned) == [
        "flash q block 100", "flash q block 64"]
    # The default axis: None plus the head dim's other build of the step.
    for d, want in ((128, (128, 64)), (256, (64, 64)), (192, (64, 64))):
        cfg = dataclasses.replace(fcfg, head_dim=d)
        valid, _ = enumerate_candidates(cfg, 8, 129, space=SearchSpace(
            remat_policies=("dots",), grad_accums=(1,),
            loss_chunk_sizes=(None,), sync_everys=(1,)))
        assert [(c.flash_bq, c.flash_bkv) for c in valid] == [
            (None, None), want]
    assert SearchSpace().flash_blocks is None


# ------------------------------------------------------ search (fake)


def _cands(n, cls=Candidate):
    return [cls(grad_accum=1, sync_every=i + 1) for i in range(n)]


class _Events:
    def __init__(self):
        self.lines = []

    def emit(self, kind, level="info", **fields):
        self.lines.append((kind, fields))


def _trials(res):
    return [(t.candidate.as_dict(), t.status, t.median_step_s, t.error)
            for t in res.trials]


def test_best_of_selection_as_tpufw():
    times = {1: 3.0, 2: 1.0, 3: 2.0}
    events = _Events()
    res = search(_cands(3), lambda c: times[c.sync_every], budget_s=60,
                 events=events)
    jres = j_search(_cands(3, JCandidate), lambda c: times[c.sync_every],
                    budget_s=60)
    assert res.best.sync_every == 2 and res.best_step_s == 1.0
    assert _trials(res) == _trials(jres)
    assert [k for k, _ in events.lines] == ["tune_trial"] * 3
    assert events.lines[1][1]["median_step_s"] == 1.0


def test_quarantine_never_aborts():
    def measure(c):
        if c.sync_every == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return float(c.sync_every)

    res = search(_cands(3), measure, budget_s=60)
    assert res.best.sync_every == 2
    by = {t.candidate.sync_every: t for t in res.trials}
    assert by[1].status == "quarantined" and "OutOfMemoryError" in by[1].error
    assert res.summary()["n_quarantined"] == 1


def test_all_quarantined_yields_no_best():
    def boom(_c):
        raise RuntimeError("no")

    res = search(_cands(2), boom, budget_s=60)
    assert res.best is None
    assert all(t.status == "quarantined" for t in res.trials)


def test_budget_skips_but_first_always_measured():
    res = search(_cands(4), lambda c: 0.1, budget_s=0.0)
    jres = j_search(_cands(4, JCandidate), lambda c: 0.1, budget_s=0.0)
    assert [t.status for t in res.trials] == [t.status for t in jres.trials]
    assert res.trials[0].status == "ok"
    assert all(t.status == "skipped_budget" for t in res.trials[1:])
    assert res.best == res.trials[0].candidate


# ------------------------------------------------------------- cache


def test_cache_key_stable_and_discriminating():
    k1 = cache.cache_key(TINY, 8, 128, (1, 8), fingerprint="f")
    assert k1 == cache.cache_key(TINY, 8, 128, (1, 8), fingerprint="f")
    assert k1 != cache.cache_key(TINY, 16, 128, (1, 8), fingerprint="f")
    assert k1 != cache.cache_key(TINY, 8, 256, (1, 8), fingerprint="f")
    assert k1 != cache.cache_key(TINY, 8, 128, (2, 4), fingerprint="f")
    assert k1 != cache.cache_key(TINY, 8, 128, (1, 8), fingerprint="g")
    other = dataclasses.replace(TINY, d_model=128)
    assert k1 != cache.cache_key(other, 8, 128, (1, 8), fingerprint="f")
    bf16 = dataclasses.replace(TINY, dtype=torch.bfloat16)
    assert k1 != cache.cache_key(bf16, 8, 128, (1, 8), fingerprint="f")
    # The machine's fingerprint by default (utils.profiling).
    from tpufw_torch.utils.profiling import machine_fingerprint

    assert cache.cache_key(TINY, 8, 128, (1,)).startswith(
        machine_fingerprint() + "-")


def test_cache_round_trip(tune_cache_dir):
    cand = Candidate(remat_policy="nothing", grad_accum=2,
                     loss_chunk_size=64, flash_bq=128, flash_bkv=64,
                     sync_every=4)
    path = cache.store("k1", cand, median_step_s=0.5, tune_s=12.0)
    assert path.exists() and path.parent == tune_cache_dir
    assert cache.load_candidate("k1") == cand
    assert cache.load("k1")["median_step_s"] == 0.5
    # Entries read across packages' Candidate fields.
    assert JCandidate.from_dict(cache.load("k1")["candidate"]).as_dict() \
        == cand.as_dict()


def test_cache_miss_corrupt_entry_and_own_directory(tune_cache_dir,
                                                    monkeypatch):
    assert cache.load_candidate("nope") is None
    (tune_cache_dir / "bad.json").write_text("{truncated")
    assert cache.load("bad") is None
    (tune_cache_dir / "odd.json").write_text('{"no": "candidate"}')
    assert cache.load("odd") is None
    monkeypatch.delenv("TPUFW_TUNE_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tune_cache_dir))
    assert cache.cache_dir() == tune_cache_dir / ".cache" / "tpufw_torch" \
        / "tune"


# --------------------------------------------- trainer integration


def _trainer(autotune="off", cfg=TINY, **kw):
    tcfg = TrainerConfig(**{**dict(
        batch_size=8, seq_len=33, total_steps=2, lr=1e-3, warmup_steps=1,
        autotune=autotune, handle_preemption=False), **kw})
    return Trainer(cfg, tcfg, device="cpu")


def _data(n=2):
    rng = np.random.default_rng(0)
    return iter({"tokens": rng.integers(0, 256, (8, 33), dtype=np.int32)}
                for _ in range(n))


def test_autotune_off_is_inert():
    from tpufw.train import TrainerConfig as JTrainerConfig

    j = JTrainerConfig()
    assert (TrainerConfig().autotune, TrainerConfig().autotune_budget_s,
            TrainerConfig().autotune_steps) == (
        j.autotune, j.autotune_budget_s, j.autotune_steps)
    tr = _trainer()
    tr.run(_data(), model_flops_per_token=1e3)
    assert tr.last_tune is None


def test_cached_mode_without_entry_is_noop(tune_cache_dir):
    tr = _trainer(autotune="cached")
    before = dataclasses.replace(tr.cfg)
    events = _Events()
    res = apply_autotune(tr, events=events)
    assert res.best is None and not res.cache_hit
    assert tr.cfg == before
    assert [k for k, _ in events.lines] == ["tune_result"]


def test_search_persists_then_second_run_hits_cache(tune_cache_dir):
    tr = _trainer(autotune="search", autotune_steps=1,
                  autotune_budget_s=60.0)
    events = _Events()
    res = apply_autotune(tr, space=SearchSpace(**SMALL), events=events)
    assert res.best is not None and not res.cache_hit and res.tune_s > 0
    assert sum(1 for t in res.trials if t.status == "ok") == 2
    assert [k for k, _ in events.lines] == ["tune_trial"] * 2 + [
        "tune_result"]
    assert list(tune_cache_dir.glob("*.json")), "winner not kept"
    assert tr.cfg.loss_chunk_size == res.best.loss_chunk_size
    assert tr.cfg.grad_accum == res.best.grad_accum
    assert len(tr.run(_data(), model_flops_per_token=1e3)) >= 1

    tr2 = _trainer(autotune="search")
    res2 = apply_autotune(tr2, space=SearchSpace(**SMALL))
    assert res2.cache_hit and res2.trials == [] and res2.tune_s == 0.0
    assert tr2.cfg.loss_chunk_size == res.best.loss_chunk_size


def test_run_resolves_autotune_and_reports(tune_cache_dir, tmp_path):
    """Through Trainer.run (the workload path), a budget of 0: the first
    candidate is measured, the rest skipped; the measured trial's costs
    land in programs.json under its program name, and programs.json is
    keyed like the cache. A second run hits the cache."""
    tel = tmp_path / "tel"
    tr = _trainer(autotune="search", autotune_steps=1,
                  autotune_budget_s=0.0, telemetry_dir=str(tel))
    assert len(tr.run(_data(), model_flops_per_token=1e3)) >= 1
    summary = tr.last_tune.summary()
    assert summary["config"] is not None and summary["tune_s"] > 0
    assert summary["n_measured"] == 1
    import json

    doc = json.loads((tel / "programs.json").read_text())
    assert doc["key"] == tr.last_tune.cache_key
    first = next(t.candidate for t in tr.last_tune.trials
                 if t.status == "ok")
    assert candidate_program_name(first) in doc["programs"]
    kinds = [json.loads(ln)["kind"] for ln in
             (tel / "events.jsonl").read_text().splitlines()]
    assert "tune_trial" in kinds and "tune_result" in kinds

    tr2 = _trainer(autotune="search")
    tr2.run(_data(), model_flops_per_token=1e3)
    assert tr2.last_tune.cache_hit and tr2.last_tune.trials == []


def test_remat_winner_rebuilds_model(tune_cache_dir):
    """A remat winner re-points the config of the live model and of each
    module holding it: the same weights step under the new policy, equal
    to a model built at that policy."""
    rcfg = dataclasses.replace(TINY, remat=True, remat_policy="dots")
    tr = _trainer(cfg=rcfg, total_steps=1)
    model = tr.init_state(seed=0)
    apply_candidate(tr, Candidate(remat_policy="nothing", grad_accum=1,
                                  sync_every=1))
    assert tr.model is model
    assert tr.model_cfg.remat_policy == tr.model.cfg.remat_policy == "nothing"
    assert all(m.cfg is tr.model_cfg for m in tr.model.modules()
               if hasattr(m, "cfg"))
    ref = _trainer(cfg=dataclasses.replace(rcfg, remat_policy="nothing"),
                   total_steps=1)
    ref.init_state(seed=0)
    batch = next(_data(1))
    assert tr.train_step(batch)["loss"].item() == \
        ref.train_step(batch)["loss"].item()
    # A flash winner's build goes to the env override, and back off.
    apply_candidate(tr, Candidate(grad_accum=1, flash_bkv=64))
    import os

    assert os.environ["TPUFW_FLASH_BKV"] == "64"
    apply_candidate(tr, Candidate(grad_accum=1))
    assert "TPUFW_FLASH_BKV" not in os.environ


def _tensors(x) -> list:
    """Every tensor of a nested optimizer state, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=str) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def test_pipeline_schedule_winner_moves_the_state(tune_cache_dir):
    """A PipelineTrainer's schedule winner swaps its schedule; a change of
    stage layout (canonical to interleaved and back) keeps the whole
    params, the Adam moments and the step. Its search measures the
    pipeline space's schedules."""
    from tpufw_torch.parallel.pipeline import PipelineConfig
    from tpufw_torch.train import PipelineTrainer

    cfg = dataclasses.replace(TINY, n_layers=4)
    tcfg = TrainerConfig(batch_size=8, seq_len=33, total_steps=1,
                         handle_preemption=False, autotune="search",
                         autotune_steps=1)
    tr = PipelineTrainer(cfg, PipelineConfig(2, 4, "1f1b"), tcfg,
                         device="cpu")
    tr.init_state(seed=0)
    tr.train_step(next(_data(1)))
    before = tr.state_dict()
    apply_candidate(tr, Candidate(grad_accum=1, loss_chunk_size=None,
                                  pipeline_schedule="interleaved",
                                  pipeline_vstages=2))
    assert (tr.pipe.schedule, tr.pipe.n_virtual) == ("interleaved", 2)
    assert tr.step == before["step"] == 1
    apply_candidate(tr, Candidate(grad_accum=1, pipeline_schedule="1f1b"))
    after = tr.state_dict()
    for a, b in zip(*(list(s["params"]["stages"].values())
                      for s in (before, after))):
        assert torch.equal(a, b)
    moments = [_tensors(s["optimizer"]) for s in (before, after)]
    assert len(moments[0]) > 0 and len(moments[0]) == len(moments[1])
    assert all(torch.equal(a, b) for a, b in zip(*moments))

    fresh = PipelineTrainer(cfg, PipelineConfig(2, 4, "gpipe"), tcfg,
                            device="cpu")
    res = apply_autotune(fresh, space=SearchSpace(
        remat_policies=("dots",), grad_accums=(1,), loss_chunk_sizes=(None,),
        flash_blocks=(None,), sync_everys=(1,),
        pipeline_schedules=(None, ("1f1b", 1))))
    assert sum(t.status == "ok" for t in res.trials) == 2
    assert "pp2x4" in res.cache_key
