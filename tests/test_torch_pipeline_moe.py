"""The port's pipelined Mixtral (GPipe) against ``tpufw``'s
(``tests/test_pipeline_moe.py``'s cases, without the expert axis): MoE
routing capacity is a property of a routing group, and ``tpufw`` routes
each (microbatch x data-shard) group alone, so the port routes groups of
the same ``group_rows``; logits, the router loss and gradients match at
2e-4 (the reference's 5e-4 for gradients), capacity drops are the same
tokens', and packed rows' padding takes no routing. The sorted dispatch
is refused, which ``tpufw``'s pipeline replaces by the capacity router
silently. The ``expert`` axis's cases are in
``test_torch_pipeline_moe_tensor.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    TOL,
    assert_trees_close,
    j_mesh,
    jax_forward,
    jax_value_and_grad,
    np_params,
    pair,
    tokens,
    torch_batch,
    torch_params,
)
from tpufw.models import MIXTRAL_CONFIGS as J
from tpufw.parallel import pipeline as jp
from tpufw_torch.models import MIXTRAL_CONFIGS as P
from tpufw_torch.parallel import pipeline as tp

JCFG, TCFG = pair(J, P, "mixtral_tiny", capacity_factor=2.0)
B, T, M = 8, 17, 2
# tpufw's pipe=2 x fsdp=2 x expert=2 mesh: rows shard over fsdp only, so
# a routing group is (B/M)/2 rows.
EP_MESH = dict(data=1, pipe=2, fsdp=2, expert=2)
ROWS = (B // M) // 2


@pytest.fixture(scope="module")
def setup(devices8):
    return np_params(JCFG, 2, seed=0), tokens(1, JCFG.vocab_size, b=B, t=T)


def _both(params, toks, jcfg=JCFG, tcfg=TCFG, seg=None, mesh=EP_MESH,
          rows=ROWS):
    want, aux = jax_forward(params, toks, jcfg, jp.PipelineConfig(2, M),
                            j_mesh(**mesh), seg)
    got, t_aux = tp.pipeline_forward(
        torch_params(params), torch.from_numpy(toks), tcfg,
        tp.PipelineConfig(2, M), group_rows=rows,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    ref, r_aux = tp.reference_forward(
        torch_params(params), torch.from_numpy(toks), tcfg, group_rows=rows,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    return (np.asarray(want), float(aux)), (got.numpy(), float(t_aux)), (
        ref.numpy(), float(r_aux))


def test_moe_forward_and_aux_match_tpufw(setup):
    params, toks = setup
    (want, aux), (got, t_aux), (ref, r_aux) = _both(params, toks)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_aux, aux, rtol=1e-5)
    np.testing.assert_allclose(ref, want, **TOL)
    np.testing.assert_allclose(r_aux, aux, rtol=1e-5)


def test_moe_grads_match_tpufw(setup):
    """d(CE + aux) through the schedule: the router's gradient included."""
    params, toks = setup
    l_j, g_j = jax_value_and_grad(params, toks, JCFG,
                                  jp.PipelineConfig(2, M), j_mesh(**EP_MESH))
    l_t, g_t = tp.gpipe_value_and_grad(
        torch_params(params), torch_batch(toks), TCFG,
        tp.PipelineConfig(2, M), group_rows=ROWS)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    g_t = {k: (tp.tree_map(lambda a: a.numpy(), v) if isinstance(v, dict)
               else v.numpy()) for k, v in g_t.items()}
    assert_trees_close(g_t, g_j, rtol=5e-4, atol=5e-4)


def test_moe_packed_segments_match_tpufw(setup):
    """Segment ids mask cross-document attention and keep padding rows
    (id 0) out of routing and capacity, in both."""
    params, toks = setup
    rng = np.random.default_rng(7)
    seg = np.ones((B, T), np.int32)
    for r in range(B):
        seg[r, rng.integers(4, T - 4):] = 2
        if r % 3 == 0:
            seg[r, -3:] = 0
    (want, aux), (got, t_aux), _ = _both(params, toks, seg=seg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_aux, aux, rtol=1e-5)


def test_moe_capacity_drops_are_identical(devices8):
    """Capacity factor 0.5 drops tokens: the same ones (slot-major
    priority is part of the routing), so the logits still match, and
    differ from the roomy routing's."""
    jt, tt = (dataclasses.replace(c, capacity_factor=0.5)
              for c in (JCFG, TCFG))
    params = np_params(jt, 2, seed=4)
    toks = tokens(5, jt.vocab_size, b=B, t=T)
    (want, _), (got, _), _ = _both(params, toks, jt, tt)
    np.testing.assert_allclose(got, want, **TOL)
    roomy = tp.pipeline_forward(torch_params(params), torch.from_numpy(toks),
                                TCFG, tp.PipelineConfig(2, M),
                                group_rows=ROWS)[0]
    assert np.abs(roomy.numpy() - got).max() > 1e-4


def test_moe_train_step_learns(setup):
    from tpufw_torch.train.trainer import default_optimizer

    params, toks = setup
    p = tp.tree_map(lambda a: a.requires_grad_(), torch_params(params))
    opt = default_optimizer([x for _, x in tp.tree_leaves(p)], lr=1e-2,
                            warmup_steps=1, total_steps=8)
    losses = [float(tp.pipeline_train_step(
        p, opt, torch_batch(toks), TCFG, tp.PipelineConfig(2, M))["loss"])
        for _ in range(8)]
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("case", ["mesh", "trainer"])
def test_expert_axis_is_refused(case):
    """``tpufw`` shards expert stacks over ``expert`` inside the stages;
    the port refused an ``expert`` axis beside ``pipe`` until ROADMAP.md
    item 12g-2 and takes it now: the mesh has the dimension, and one
    process holds every expert shard; on a dense model the axis is still
    refused in ``tpufw``'s words. (The test keeps its name.)"""
    import dataclasses

    from tpufw_torch.mesh import MeshConfig, mesh_shape
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.train import PipelineTrainer, TrainerConfig

    mcfg = MeshConfig(data=1, pipe=2, fsdp=2, expert=2)
    if case == "mesh":
        assert mesh_shape(mcfg, 8) == {"data": 1, "pipe": 2, "fsdp": 2,
                                       "expert": 2, "sequence": 1}
        return
    one = dataclasses.replace(mcfg, fsdp=1)
    tr = PipelineTrainer(TCFG, tp.PipelineConfig(2, M),
                         TrainerConfig(batch_size=B, seq_len=T), one,
                         device="cpu")
    assert [g.size for g in tr.groups] == [1, 2]
    dense = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"], n_layers=4)
    with pytest.raises(NotImplementedError, match="no experts to shard"):
        PipelineTrainer(dense, tp.PipelineConfig(2, M),
                        TrainerConfig(batch_size=B, seq_len=T), one,
                        device="cpu")
@pytest.mark.parametrize("family", ["mixtral_tiny", "deepseek_moe_tiny"])
def test_sorted_dispatch_is_refused(family, setup):
    """A divergence by design: ``tpufw``'s pipelined MoE routes with the
    capacity router whatever ``moe_dispatch`` says; the port raises."""
    from tpufw_torch.configs import resolve_model_preset

    cfg = dataclasses.replace(resolve_model_preset(family),
                              moe_dispatch="sorted")
    with pytest.raises(NotImplementedError, match="moe_dispatch='sorted'"):
        tp.PipelineConfig(2, M).validate(cfg, B)
    with pytest.raises(NotImplementedError, match="moe_dispatch='sorted'"):
        tp.init_pipeline_params(cfg, tp.PipelineConfig(2, M), device="cpu")
