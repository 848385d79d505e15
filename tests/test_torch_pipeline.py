"""The port's GPipe schedule (``tpufw_torch.parallel.pipeline``) against
``tpufw``'s (``tests/test_pipeline.py``'s cases): the same numpy-made
params and tokens through ``tpufw`` on its 8 virtual devices and through
the port on a ``LocalPipeGroup`` (every stage in one process), logits,
losses and gradients at 2e-4; the sequential oracle; Gemma, Qwen's biases
and Mistral's window through the stages; and the checks that fail loudly.
``tpufw``'s tensor-parallel (``pptp``) cases are held in
``test_torch_pipeline_tensor.py``; here the axis's knobs."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    TOL,
    B,
    M,
    T,
    assert_trees_close,
    j_mesh,
    jax_forward,
    jax_value_and_grad,
    llama_pair,
    np_params,
    tokens,
    torch_batch,
    torch_params,
    torch_value_and_grad,
)
from tpufw.parallel import pipeline as jp
from tpufw_torch.parallel import pipeline as tp
from tpufw_torch.parallel.group import LocalPipeGroup, PipeGroup

JCFG, TCFG = llama_pair()
MESH = dict(data=2, pipe=2, fsdp=2)


def _forward(params, toks, jcfg, tcfg, mesh, m=M, s=2, seg=None):
    """(tpufw's pipelined logits, the port's, the port's oracle's)."""
    want = jax_forward(params, toks, jcfg, jp.PipelineConfig(s, m),
                       j_mesh(**mesh), seg)
    tparams = torch_params(params)
    tseg = None if seg is None else torch.from_numpy(seg)
    got = tp.pipeline_forward(tparams, torch.from_numpy(toks), tcfg,
                              tp.PipelineConfig(s, m), segment_ids=tseg)
    ref = tp.reference_forward(tparams, torch.from_numpy(toks), tcfg,
                               segment_ids=tseg)
    return np.asarray(want), got.detach().numpy(), ref.detach().numpy()


@pytest.fixture(scope="module")
def setup(devices8):
    params = np_params(JCFG, 2, seed=0)
    return params, tokens(1, JCFG.vocab_size)


def test_forward_matches_tpufw(setup):
    params, toks = setup
    want, got, ref = _forward(params, toks, JCFG, TCFG, MESH)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ref, want, **TOL)


def test_grads_match_tpufw(setup):
    """GPipe + autograd against ``tpufw``'s GPipe + autodiff: loss and
    every gradient, the embedding's and the head's included."""
    params, toks = setup
    pipe_j = jp.PipelineConfig(2, M)
    l_j, g_j = jax_value_and_grad(params, toks, JCFG, pipe_j, j_mesh(**MESH))
    l_t, g_t = torch_value_and_grad(params, toks, TCFG,
                                    tp.PipelineConfig(2, M))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(g_t, g_j)


class _Held(PipeGroup):
    """A process holding stage 1 of 2 (the rule, without a gang)."""

    size, indices = 2, (1,)


@pytest.mark.parametrize("virtual", [False, True])
def test_stage_slice_is_the_pipe_rule(setup, virtual):
    """A rank holds its stages along the stage axis (``tpufw``'s
    ``stage_partition_specs``: axis 0, or 1 interleaved); its chunk
    views are the whole tree's."""
    params, _ = setup
    stages = torch_params(params)["stages"]
    if virtual:
        stages = tp.to_virtual_stages(stages, 2, 2)
    held = tp.stage_slice(stages, _Held(), virtual)
    ax = 1 if virtual else 0
    assert held["wq"].shape[ax] == 1
    for k in range(2 if virtual else 1):
        for name in held:
            torch.testing.assert_close(
                tp.chunk_params(held, _Held(), 1, k, virtual)[name],
                tp.chunk_params(stages, LocalPipeGroup(2), 1, k, virtual)[
                    name], rtol=0, atol=0)


def test_train_step_learns(setup):
    from tpufw_torch.train.trainer import default_optimizer

    params, toks = setup
    p = {k: v for k, v in tp.tree_map(lambda a: a.requires_grad_(),
                                      torch_params(params)).items()}
    opt = default_optimizer([x for _, x in tp.tree_leaves(p)], lr=1e-2,
                            warmup_steps=1, total_steps=8)
    losses = [float(tp.pipeline_train_step(
        p, opt, torch_batch(toks), TCFG, tp.PipelineConfig(2, M))["loss"])
        for _ in range(8)]
    assert losses[-1] < losses[0] and np.isfinite(losses[-1]), losses


def test_four_stages(devices8):
    params = np_params(JCFG, 4, seed=2)
    toks = tokens(3, JCFG.vocab_size, t=9)
    want, got, _ = _forward(params, toks, JCFG, TCFG,
                            dict(data=2, pipe=4, fsdp=1), m=8, s=4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s,m,bs,match", [
    (3, 4, 8, "not divisible by 3 stages"),
    (2, 3, 8, "not divisible by 3 microbatches"),
])
def test_validation_is_loud(s, m, bs, match):
    with pytest.raises(ValueError, match=match) as want:
        jp.PipelineConfig(s, m).validate(JCFG, batch_size=bs)
    with pytest.raises(ValueError, match=match) as got:
        tp.PipelineConfig(s, m).validate(TCFG, batch_size=bs)
    assert str(got.value) == str(want.value)


def test_segment_forward_matches_tpufw(setup):
    """Packed-batch segment ids ride with their microbatch."""
    params, toks = setup
    seg = np.repeat(np.arange(1, 5), (T + 3) // 4)[:T][None].repeat(
        B, 0).astype(np.int32)
    want, got, ref = _forward(params, toks, JCFG, TCFG, MESH, seg=seg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ref, want, **TOL)
    plain = _forward(params, toks, JCFG, TCFG, MESH)[1]
    assert np.abs(got - plain).max() > 1e-3


def test_packed_loss_matches_tpufw(setup):
    """pipeline_loss on a packed batch: the Trainer's shift and masks."""
    from tpufw.train import synthetic_packed_batches

    params, _ = setup
    batch = next(iter(synthetic_packed_batches(16, 17, JCFG.vocab_size,
                                               mean_doc_len=6)))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: jp.pipeline_loss(
        p, b, JCFG, jp.PipelineConfig(2, M), j_mesh(**MESH)))(params, batch)
    got = tp.pipeline_loss(torch_params(params), torch_batch(batch), TCFG,
                           tp.PipelineConfig(2, M))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_stage_mesh_mismatch_is_loud(setup):
    params, toks = setup
    pipe = tp.PipelineConfig(n_stages=4, n_microbatches=4)
    with pytest.raises(ValueError, match="mesh pipe axis has size 2"):
        tp.pipeline_forward(torch_params(params), torch.from_numpy(toks),
                            TCFG, pipe, LocalPipeGroup(2))


@pytest.mark.parametrize("s,m,schedule,v", [
    (2, 4, "gpipe", 1), (4, 16, "gpipe", 1), (4, 8, "1f1b", 1),
    (2, 4, "zb1", 1), (4, 8, "interleaved", 2), (2, 8, "interleaved", 4),
])
def test_bubble_fraction_and_ticks_are_tpufws(s, m, schedule, v):
    want = jp.PipelineConfig(s, m, schedule, v)
    got = tp.PipelineConfig(s, m, schedule, v)
    assert got.bubble_fraction() == pytest.approx(want.bubble_fraction())
    assert got.n_ticks() == want.n_ticks()


def _gemma_pair(n_layers):
    from tpufw.models import GEMMA_CONFIGS as J
    from tpufw_torch.models import GEMMA_CONFIGS as P
    from tests.torch_pipeline import pair

    return pair(J, P, "gemma2_tiny", n_layers=n_layers)


def test_gemma_matches_tpufw(devices8):
    """Gemma pairs through the stages (caps, windows longer and shorter
    than the rows, sandwich norms, GeGLU, the tied capped head): logits,
    loss and gradients, and the chunked CE (the tied head and the final
    cap a chunk) against the full logits."""
    jcfg, tcfg = _gemma_pair(4)
    assert jcfg.sliding_window < 48
    params = np_params(jcfg, 2, seed=4)
    assert "head" not in params
    toks = tokens(5, jcfg.vocab_size, b=8, t=48)
    want, got, ref = _forward(params, toks, jcfg, tcfg, MESH, m=2)
    assert np.abs(want).max() <= 30.0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ref, want, atol=2e-5, rtol=2e-5)
    l_j, g_j = jax_value_and_grad(params, toks, jcfg,
                                  jp.PipelineConfig(2, 2), j_mesh(**MESH))
    l_t, g_t = torch_value_and_grad(params, toks, tcfg,
                                    tp.PipelineConfig(2, 2))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(g_t, g_j, atol=5e-4, rtol=5e-4)
    tparams, tb = torch_params(params), torch_batch(toks)
    full = tp.pipeline_eval(tparams, tb, tcfg, tp.PipelineConfig(2, 2))
    chunked = tp.pipeline_eval(tparams, tb, tcfg, tp.PipelineConfig(2, 2),
                               loss_chunk_size=16,
                               loss_chunk_dtype=torch.float32)
    np.testing.assert_allclose(float(chunked["loss"]), float(full["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(full["loss"]), l_j, rtol=1e-5)


def test_init_params_guards_direct_callers():
    """``init_pipeline_params`` re-checks the split itself, with
    ``tpufw``'s errors: indivisible layers, odd Gemma pairs a stage, and
    MoE with qkv biases."""
    from tpufw.models import MIXTRAL_CONFIGS as JX
    from tpufw_torch.models import MIXTRAL_CONFIGS as PX

    cases = [
        (dataclasses.replace(JCFG, n_layers=10),
         dataclasses.replace(TCFG, n_layers=10), 4, ValueError, "divisible"),
        (*_gemma_pair(10), 2, ValueError, "PAIRS"),
        (*_gemma_pair(6), 2, ValueError, "PAIRS"),
        (dataclasses.replace(JX["mixtral_tiny"], attention_qkv_bias=True),
         dataclasses.replace(PX["mixtral_tiny"], attention_qkv_bias=True), 2,
         NotImplementedError, "qkv_bias"),
    ]
    for jcfg, tcfg, s, err, match in cases:
        with pytest.raises(err, match=match) as want:
            jp.init_pipeline_params(jax.random.key(0), jcfg,
                                    jp.PipelineConfig(s, 2))
        with pytest.raises(err, match=match) as got:
            tp.init_pipeline_params(tcfg, tp.PipelineConfig(s, 2),
                                    device="cpu")
        assert str(got.value) == str(want.value)


def test_init_params_layouts_and_held_stages():
    """The port's init: ``tpufw``'s tree shapes; the interleaved layout
    holds the canonical one's layers; a rank draws only its stages."""
    pipe = tp.PipelineConfig(2, 4)
    full = tp.init_pipeline_params(TCFG, pipe, seed=3, device="cpu")
    shapes = jax.eval_shape(lambda k: jp.init_pipeline_params(
        k, JCFG, jp.PipelineConfig(2, 4)), jax.random.key(0))
    assert {p: tuple(x.shape) for p, x in tp.tree_leaves(full)} == {
        p: x.shape for p, x in tp.tree_leaves(shapes)}
    inter = tp.init_pipeline_params(
        TCFG, tp.PipelineConfig(2, 4, "interleaved", 2), seed=3,
        device="cpu")
    for name, a in tp.to_canonical_stages(inter["stages"], 2).items():
        torch.testing.assert_close(a, full["stages"][name], rtol=0, atol=0)
    held = tp.init_pipeline_params(TCFG, pipe, seed=3, device="cpu",
                                   group=_Held())
    for name, a in held["stages"].items():
        torch.testing.assert_close(a[0], full["stages"][name][1], rtol=0,
                                   atol=0)


def _qwen_params(jcfg, seed):
    params = np_params(jcfg, 2, seed=seed)
    assert np.abs(params["stages"]["bq"]).max() > 0
    return params


def test_qwen_bias_matches_tpufw(devices8):
    """Nonzero qkv biases flow into q/k/v as in ``tpufw``; zeroing one
    changes the logits."""
    jcfg, tcfg = llama_pair(attention_qkv_bias=True)
    params = _qwen_params(jcfg, 8)
    toks = tokens(9, jcfg.vocab_size)
    want, got, _ = _forward(params, toks, jcfg, tcfg, MESH)
    np.testing.assert_allclose(got, want, **TOL)
    zeroed = dict(params, stages=dict(
        params["stages"], bq=np.zeros_like(params["stages"]["bq"])))
    other = tp.pipeline_forward(torch_params(zeroed), torch.from_numpy(toks),
                                tcfg, tp.PipelineConfig(2, M))
    assert not np.allclose(got, other.detach().numpy())


def test_qwen_bias_1f1b_matches_tpufw(devices8):
    """The biases reach the 1F1B schedule, their gradients included,
    against ``tpufw``'s GPipe."""
    jcfg, tcfg = llama_pair(attention_qkv_bias=True)
    params = _qwen_params(jcfg, 10)
    toks = tokens(11, jcfg.vocab_size)
    l_j, g_j = jax_value_and_grad(params, toks, jcfg, jp.PipelineConfig(2, M),
                                  j_mesh(**MESH))
    l_t, g_t = torch_value_and_grad(params, toks, tcfg,
                                    tp.PipelineConfig(2, M, "1f1b"))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    for name in ("bq", "bk", "bv"):
        assert np.abs(g_j["stages"][name]).max() > 0
        np.testing.assert_allclose(g_t["stages"][name], g_j["stages"][name],
                                   atol=5e-4, rtol=5e-4)
    assert_trees_close(g_t, g_j)


def test_mistral_window_reaches_pipeline_blocks(devices8):
    jcfg, tcfg = llama_pair("mistral_tiny", n_layers=2)
    params = np_params(jcfg, 2, seed=12)
    toks = tokens(13, 256, b=8, t=64)
    want, got, ref = _forward(params, toks, jcfg, tcfg, MESH, m=2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    wide = tp.reference_forward(
        torch_params(params), torch.from_numpy(toks),
        dataclasses.replace(tcfg, sliding_window=None)).detach().numpy()
    assert np.abs(ref - wide).max() > 1e-4


@pytest.mark.parametrize("case", [
    "pptp_mesh_shape", "pptp_mesh_from_env", "pptp_trainer",
    "pptp_workload",
])
def test_pptp_tensor_axis_is_refused(case, monkeypatch):
    """``tpufw`` splits heads over ``tensor`` inside the stages; the port
    refused a ``tensor`` axis beside ``pipe`` until ROADMAP.md item
    12g-2 and takes it now, everywhere a pipeline takes one: the mesh
    shape, the workload's mesh knobs, the trainer (one process holds
    every tensor shard) and the workload. (The test keeps its name.)"""
    from tpufw_torch.mesh import MeshConfig, mesh_shape
    from tpufw_torch.train import PipelineTrainer, TrainerConfig
    from tpufw_torch.workloads import env as wenv
    from tpufw_torch.workloads import train_pipeline

    for k in [k for k in os.environ if k.startswith("TPUFW_")]:
        monkeypatch.delenv(k)
    mcfg = MeshConfig(data=1, pipe=2, fsdp=2, tensor=2)
    if case == "pptp_mesh_shape":
        assert mesh_shape(mcfg, 8) == {"data": 1, "pipe": 2, "fsdp": 2,
                                       "sequence": 1, "tensor": 2}
    elif case == "pptp_mesh_from_env":
        monkeypatch.setenv("TPUFW_MESH_TENSOR", "2")
        assert wenv.mesh_from_env(8, pipe=2) == MeshConfig(
            pipe=2, fsdp=-1, tensor=2)
    elif case == "pptp_trainer":
        tr = PipelineTrainer(TCFG, tp.PipelineConfig(2, 4),
                             TrainerConfig(batch_size=8, seq_len=17),
                             MeshConfig(pipe=2, fsdp=1, tensor=2),
                             device="cpu")
        assert [g.size for g in tr.groups] == [2, 1]
    else:
        for k, v in dict(PIPE_STAGES=2, MODEL="llama3_tiny",
                         MESH_TENSOR=2, DEVICE="cpu").items():
            monkeypatch.setenv(f"TPUFW_{k}", str(v))
        tr, _ = train_pipeline.build_trainer()
        assert tr.mesh_cfg.tensor == 2 and tr.groups[0].size == 2


def test_gpipe_runs_real_ticks_only(setup, monkeypatch):
    """A divergence by design: ``tpufw`` runs every stage on every tick
    (bubble ticks on clipped microbatches, masked out); the port runs a
    stage on its M real ticks only: S x M stage calls a forward."""
    params, toks = setup
    calls = []
    real = tp._stage
    monkeypatch.setattr(tp, "_stage",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tp.pipeline_forward(torch_params(params), torch.from_numpy(toks), TCFG,
                        tp.PipelineConfig(2, M))
    assert len(calls) == 2 * M
