"""The port's 1F1B schedule (``tpufw_torch.parallel.pipeline_1f1b``)
against ``tpufw``'s (``tests/test_pipeline_1f1b.py``'s cases): loss and
every gradient equal to ``tpufw``'s 1F1B and GPipe ones at 2e-4 on the same
numpy-made params and tokens (a gap is a schedule bug: the stash, the
cotangent timing, the epilogue), packed batches, four stages, the chunked
CE, the trainer, and the refusals. ``tpufw``'s tensor-parallel case is
held in ``tests/test_torch_pipeline_tensor.py``."""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    B,
    M,
    T,
    assert_trees_close,
    j_mesh,
    jax_value_and_grad,
    llama_pair,
    np_params,
    tokens,
    torch_value_and_grad,
)
from tpufw.parallel import pipeline as jp
from tpufw_torch.parallel import pipeline as tp
from tpufw_torch.parallel.pipeline_1f1b import (
    _Ring,
    pipeline_1f1b_value_and_grad,
    tick_plan,
)

JCFG, TCFG = llama_pair()
MESH = dict(data=2, pipe=2, fsdp=2)


@pytest.fixture(scope="module")
def setup(devices8):
    params = np_params(JCFG, 2, seed=0)
    toks = tokens(1, JCFG.vocab_size)
    want = jax_value_and_grad(params, toks, JCFG, jp.PipelineConfig(2, M),
                              j_mesh(**MESH))
    return params, toks, want


def test_1f1b_matches_tpufw_1f1b_and_gpipe(setup):
    """The port's 1F1B against ``tpufw``'s 1F1B, and both against
    ``tpufw``'s GPipe."""
    params, toks, (l_g, g_g) = setup
    l_f, g_f = jax_value_and_grad(params, toks, JCFG,
                                  jp.PipelineConfig(2, M, "1f1b"),
                                  j_mesh(**MESH), schedule="1f1b")
    l_t, g_t = torch_value_and_grad(params, toks, TCFG,
                                    tp.PipelineConfig(2, M, "1f1b"))
    np.testing.assert_allclose(l_t, l_f, rtol=1e-5)
    np.testing.assert_allclose(l_t, l_g, rtol=1e-5)
    assert_trees_close(g_t, g_f)
    assert_trees_close(g_t, g_g)


def test_1f1b_packed_batch_matches_tpufw(setup):
    params, toks, _ = setup
    rng = np.random.default_rng(3)
    seg = np.ones((B, T), np.int32)
    for r in range(B):
        seg[r, rng.integers(5, T - 2):] = 2
        if r % 4 == 0:
            seg[r, -2:] = 0
    batch = {"tokens": toks, "segment_ids": seg,
             "loss_mask": (seg > 0).astype(np.float32)}
    l_g, g_g = jax_value_and_grad(params, batch, JCFG,
                                  jp.PipelineConfig(2, M), j_mesh(**MESH))
    l_t, g_t = torch_value_and_grad(params, batch, TCFG,
                                    tp.PipelineConfig(2, M, "1f1b"))
    np.testing.assert_allclose(l_t, l_g, rtol=1e-5)
    assert_trees_close(g_t, g_g)


def test_1f1b_four_stages(devices8):
    """S=4: the stash lifetime 2(S-1) = 6 ticks in a ring of 8."""
    params = np_params(JCFG, 4, seed=6)
    toks = tokens(7, JCFG.vocab_size)
    l_g, g_g = jax_value_and_grad(params, toks, JCFG,
                                  jp.PipelineConfig(4, M),
                                  j_mesh(data=1, pipe=4, fsdp=2))
    l_t, g_t = torch_value_and_grad(params, toks, TCFG,
                                    tp.PipelineConfig(4, M, "1f1b"))
    np.testing.assert_allclose(l_t, l_g, rtol=1e-5)
    assert_trees_close(g_t, g_g)


def test_1f1b_chunked_ce_matches_full(setup):
    """The chunked CE in the last stage's epilogue, fp32 chunks."""
    params, toks, _ = setup
    pipe = tp.PipelineConfig(2, M, "1f1b")
    l_full, g_full = torch_value_and_grad(params, toks, TCFG, pipe)
    l_c, g_c = torch_value_and_grad(params, toks, TCFG, pipe,
                                    loss_chunk_size=8,
                                    loss_chunk_dtype=torch.float32)
    np.testing.assert_allclose(l_c, l_full, rtol=1e-4)
    assert_trees_close(g_c, g_full, atol=5e-4, rtol=5e-3)


def test_1f1b_pipeline_trainer_learns():
    """schedule='1f1b' through the PipelineTrainer surface."""
    from tpufw_torch.train import (
        PipelineTrainer,
        TrainerConfig,
        synthetic_batches,
    )

    pt = PipelineTrainer(
        TCFG, tp.PipelineConfig(2, M, "1f1b"),
        TrainerConfig(batch_size=B, seq_len=T, total_steps=8, lr=1e-2,
                      warmup_steps=1, log_every=1), device="cpu")
    pt.init_state(seed=0)
    hist = pt.run(synthetic_batches(B, T, TCFG.vocab_size),
                  model_flops_per_token=TCFG.flops_per_token(T - 1))
    # The port's default optimizer (clip, AdamW, warmup-cosine), not
    # tpufw's test's plain adam: exactness is the parity tests' part.
    assert hist[-1].loss < hist[0].loss - 0.05, [m.loss for m in hist]


def test_unknown_schedule_is_loud():
    with pytest.raises(ValueError, match="unknown pipeline schedule") as want:
        jp.PipelineConfig(2, 2, "wavefront").validate(JCFG, 4)
    with pytest.raises(ValueError, match="unknown pipeline schedule") as got:
        tp.PipelineConfig(2, 2, "wavefront").validate(TCFG, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("family", ["gemma2_tiny", "mixtral_tiny",
                                    "deepseek_moe_tiny"])
@pytest.mark.parametrize("schedule", ["1f1b", "zb1", "interleaved"])
def test_manual_schedules_reject_gemma_and_moe(family, schedule):
    """The manual schedules' envelope is ``tpufw``'s ``_check_1f1b``: the
    Llama family and dense MLA; GPipe runs the rest."""
    from tpufw_torch.configs import resolve_model_preset
    from tpufw_torch.parallel.pipeline_1f1b import manual_value_and_grad

    cfg = resolve_model_preset(family)
    pipe = tp.PipelineConfig(2, M, schedule, 2 if schedule == "interleaved"
                             else 1)
    toks = torch.zeros((B, T), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match=schedule):
        manual_value_and_grad({}, toks, cfg, pipe)


def test_1f1b_tick_maps_and_stash_bound():
    """``tick_plan`` is ``tpufw``'s 1F1B map (forward of t - s, backward of
    t - 2(S-1) + s), every microbatch's forward and backward run once on
    every stage, and a stash written at j + s is read by j + 2(S-1) - s:
    a ring of 2S slots never holds two live inputs (``_Ring`` raises on
    a live slot)."""
    s_n, m = 4, 8
    pipe = tp.PipelineConfig(s_n, m, "1f1b")
    for s in range(s_n):
        rows = [tick_plan(pipe, t, s) for t in range(pipe.n_ticks())]
        fs = [(t, f[1]) for t, (f, _, _) in enumerate(rows) if f]
        bs = [(t, b[1]) for t, (_, b, _) in enumerate(rows) if b]
        assert fs == [(j + s, j) for j in range(m)]
        assert bs == [(j + 2 * (s_n - 1) - s, j) for j in range(m)]
        live = max(tb - tf for (tf, _), (tb, _) in zip(fs, bs))
        assert live <= 2 * (s_n - 1)
    ring = _Ring(2 * s_n)
    ring.put(3, torch.zeros(1))
    with pytest.raises(AssertionError, match="still live"):
        ring.put(3 + 2 * s_n, torch.zeros(1))
    ring.take(3)
    ring.put(3 + 2 * s_n, torch.zeros(1))


def test_1f1b_schedule_entry_refuses_other_schedules(setup):
    params, toks, _ = setup
    with pytest.raises(ValueError, match="is not '1f1b'"):
        pipeline_1f1b_value_and_grad(params, toks, TCFG,
                                     tp.PipelineConfig(2, M, "zb1"))
