"""The port's interleaved and zero-bubble (ZB-H1) schedules against
``tpufw``'s (``tests/test_pipeline_interleaved.py``'s cases): loss and
gradients equal to ``tpufw``'s GPipe at 2e-4 (S = 2 and 4, Qwen's biases;
a gap is a schedule bug: a chunk or tick map, the stash lifetime, the
cotangent ring, the W phase), the bubble and tick tables from the port's
own tick maps, and the trainer. ``tpufw``'s tensor-parallel case is held
in ``tests/test_torch_pipeline_tensor.py``; its
trace counter has no eager counterpart (the chunk body runs once per real
sub-tick instead, pinned here)."""

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    B,
    M,
    assert_trees_close,
    canonical,
    j_mesh,
    jax_value_and_grad,
    llama_pair,
    np_params,
    tokens,
    torch_value_and_grad,
    virtual,
)
from tpufw.parallel import pipeline as jp
from tpufw_torch.parallel import pipeline as tp
from tpufw_torch.parallel.pipeline_1f1b import tick_plan

JCFG, TCFG = llama_pair()
MESH = dict(data=2, pipe=2, fsdp=2)
MESH4 = dict(data=1, pipe=4, fsdp=2)


def _check(jcfg, tcfg, s, m, schedule, v, seed, mesh, b=B):
    """The port's ``schedule`` against ``tpufw``'s GPipe on the same
    canonical params (regrouped for interleaved)."""
    params = np_params(jcfg, s, seed=seed)
    toks = tokens(seed + 1, jcfg.vocab_size, b=b)
    l_g, g_g = jax_value_and_grad(params, toks, jcfg, jp.PipelineConfig(s, m),
                                  j_mesh(**mesh))
    pipe = tp.PipelineConfig(s, m, schedule, v)
    pipe.validate(tcfg, b)
    if schedule == "interleaved":
        l_t, g_t = torch_value_and_grad(virtual(params, v, s), toks, tcfg,
                                        pipe)
        g_t = canonical(g_t, s)
    else:
        l_t, g_t = torch_value_and_grad(params, toks, tcfg, pipe)
    np.testing.assert_allclose(l_t, l_g, rtol=1e-5)
    assert_trees_close(g_t, g_g)
    return g_t, g_g


@pytest.mark.parametrize("schedule,v", [("interleaved", 2), ("zb1", 1)])
def test_matches_tpufw_gpipe_grads(devices8, schedule, v):
    """S = 2: interleaved at v = 2 (the [v, S, lpc] stacks flatten to the
    canonical layer order) and ZB-H1 (the deferred W phase's weight
    gradients sum to the autodiff ones)."""
    _check(JCFG, TCFG, 2, M, schedule, v, seed=0, mesh=MESH)


@pytest.mark.parametrize("schedule,v", [("interleaved", 2), ("zb1", 1)])
def test_qwen_bias_matches_tpufw_gpipe(devices8, schedule, v):
    jcfg, tcfg = llama_pair(attention_qkv_bias=True)
    g_t, g_g = _check(jcfg, tcfg, 2, M, schedule, v, seed=4, mesh=MESH)
    for name in ("bq", "bk", "bv"):
        assert np.abs(g_g["stages"][name]).max() > 0


@pytest.mark.parametrize("schedule,v", [("interleaved", 2), ("zb1", 1)])
def test_four_stages(devices8, schedule, v):
    """S = 4 over 8 layers and M = 8: interleaved's stash spans up to
    2vS - 2 = 14 ticks and every wrap fires; ZB-H1's cotangent ring holds
    S in-flight B -> W hand-offs and drains 3(S-1) = 9 ticks."""
    jcfg, tcfg = llama_pair(n_layers=8)
    _check(jcfg, tcfg, 4, 8, schedule, v, seed=8, mesh=MESH4)


def _fwd_ticks(pipe, s):
    return {t for t in range(pipe.n_ticks()) if tick_plan(pipe, t, s)[0]}


@pytest.mark.parametrize("s,v,m", [(2, 2, 4), (4, 2, 8), (4, 3, 12),
                                   (2, 4, 8)])
def test_interleaved_bubble_accounting(s, v, m):
    """From the port's tick maps: each stage's vM forward sub-ticks are
    the contiguous window [s, s + vM), so its idle in the global fill
    span is S - 1 ticks, ``tpufw``'s (S-1)/(vM+S-1); every (chunk,
    microbatch) runs once forward and once backward on every stage."""
    pipe = tp.PipelineConfig(s, m, "interleaved", v)
    jpipe = jp.PipelineConfig(s, m, "interleaved", v)
    span = v * m + s - 1
    for d in range(s):
        busy = _fwd_ticks(pipe, d)
        assert busy == set(range(d, d + v * m)), (s, v, m, d)
        assert (span - len(busy)) / span == pytest.approx(
            jpipe.bubble_fraction())
        rows = [tick_plan(pipe, t, d) for t in range(pipe.n_ticks())]
        want = sorted((k, j) for k in range(v) for j in range(m))
        assert sorted(f for f, _, _ in rows if f) == want
        assert sorted(b for _, b, _ in rows if b) == want
    assert pipe.n_ticks() == jpipe.n_ticks()
    assert tp.PipelineConfig(s, m, "1f1b").bubble_fraction() == \
        pytest.approx((s - 1) / (m + s - 1))


@pytest.mark.parametrize("s,m", [(2, 4), (4, 8), (4, 16)])
def test_schedule_bubble_ordering(s, m):
    """gpipe == 1f1b >= interleaved >= zb1 for v <= 3, v = 4 crossing,
    and the tick counts the tick maps run, all ``tpufw``'s."""

    def frac(schedule, v=1):
        return tp.PipelineConfig(s, m, schedule, v).bubble_fraction()

    assert frac("gpipe") == frac("1f1b")
    for v in (2, 3):
        assert frac("interleaved", v) < frac("1f1b")
        assert frac("zb1") <= frac("interleaved", v)
    assert frac("interleaved", 4) < frac("zb1")
    for schedule, v in (("1f1b", 1), ("interleaved", 2), ("zb1", 1)):
        pipe = tp.PipelineConfig(s, m, schedule, v)
        assert pipe.n_ticks() == jp.PipelineConfig(
            s, m, schedule, v).n_ticks()
        last = max(t for t in range(pipe.n_ticks()) for d in range(s)
                   if any(tick_plan(pipe, t, d)))
        assert last == pipe.n_ticks() - 1


def test_zb1_last_stage_dense_occupancy():
    """ZB-H1 from the port's maps: the last stage's F, B and W ticks all
    fill the same M-tick window; stage 0's last W closes the schedule."""
    s, m = 4, 8
    pipe = tp.PipelineConfig(s, m, "zb1")
    rows = [tick_plan(pipe, t, s - 1) for t in range(pipe.n_ticks())]
    window = set(range(s - 1, s - 1 + m))
    for i in range(3):
        assert {t for t, r in enumerate(rows) if r[i]} == window
    assert max(t for t in range(pipe.n_ticks())
               if tick_plan(pipe, t, 0)[2]) == pipe.n_ticks() - 1


@pytest.mark.parametrize("m", [4, 8])
def test_interleaved_chunk_runs_per_real_sub_tick(devices8, monkeypatch, m):
    """The port's counterpart of ``tpufw``'s trace counter: eager
    PyTorch traces nothing, and the chunk body runs once per real
    sub-tick, 2vSM times a step (forward, then the backward's
    recompute): bubble sub-ticks run nothing."""
    from tests.torch_pipeline import torch_batch, torch_params

    calls = []
    real = tp._stage
    import tpufw_torch.parallel.pipeline_1f1b as f1

    monkeypatch.setattr(f1, "_stage",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    v, s = 2, 2
    pipe = tp.PipelineConfig(s, m, "interleaved", v)
    params = virtual(np_params(JCFG, s, seed=14), v, s)
    tp.value_and_grad(torch_params(params),
                      torch_batch(tokens(15, JCFG.vocab_size, b=2 * m)),
                      TCFG, pipe)
    assert len(calls) == 2 * v * s * m


@pytest.mark.parametrize("schedule,v", [("interleaved", 2), ("zb1", 1)])
def test_trainer_learns(schedule, v):
    from tpufw_torch.train import (
        PipelineTrainer,
        TrainerConfig,
        synthetic_batches,
    )

    pt = PipelineTrainer(
        TCFG, tp.PipelineConfig(2, M, schedule, v),
        TrainerConfig(batch_size=B, seq_len=17, total_steps=8, lr=1e-2,
                      warmup_steps=1, log_every=1), device="cpu")
    pt.init_state(seed=0)
    if schedule == "interleaved":
        assert pt.params["stages"]["wq"].shape[:3] == (2, 2, 1)
    hist = pt.run(synthetic_batches(B, 17, TCFG.vocab_size),
                  model_flops_per_token=TCFG.flops_per_token(16))
    assert hist[-1].loss < hist[0].loss - 0.05, [h.loss for h in hist]
    ev = pt.evaluate(synthetic_batches(B, 17, TCFG.vocab_size, seed=9), 2)
    assert np.isfinite(ev["eval_loss"]) and ev["eval_tokens"] == 2 * B * 16
