"""Expert and tensor parallelism inside the port's pipelined MoE and MLA
stages against ``tpufw``'s (``tests/test_pipeline_moe.py``'s expert-axis
cases, ``tests/test_pipeline_mla.py::test_pptp_forward_and_grads`` and
``tests/test_dryrun16.py``'s ``pipe=4 x tensor=4`` MLA step): ``tpufw`` on
its 8 virtual devices, the port on one process's ``LocalPipeGroup`` x
``LocalExpertGroup`` x ``LocalTensorGroup``, the same numpy-made params
and tokens in fp32. Held: Mixtral's logits and router loss over two
expert shards (and two tensor shards) at 2e-4, its gradients at the
reference's 5e-4 (the replicated router's whole on every shard), packed
rows and capacity drops; MLA's heads split with the latent kernels
replicated, forward and gradients; MLA-MoE over every axis; and the
16-device shape's one step against its unsplit run."""

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
    torch_params,
    torch_value_and_grad,
)
from tpufw.models import DEEPSEEK_CONFIGS as JD
from tpufw.models import MIXTRAL_CONFIGS as JM
from tpufw.parallel import pipeline as jp
from tpufw_torch.models import DEEPSEEK_CONFIGS as D
from tpufw_torch.models import MIXTRAL_CONFIGS as MX
from tpufw_torch.parallel import pipeline as tp
from tpufw_torch.parallel.context import use_groups
from tpufw_torch.parallel.group import LocalExpertGroup, LocalTensorGroup

JCFG, TCFG = pair(JM, MX, "mixtral_tiny", capacity_factor=2.0)
B, T, M = 8, 17, 2
# tpufw's pipe=2 x fsdp=2 x expert=2 mesh: rows shard over fsdp only, so a
# routing group is (B/M)/2 rows; with fsdp=1 a microbatch.
EP_MESH = dict(data=1, pipe=2, fsdp=2, expert=2)
EP_TP_MESH = dict(data=1, pipe=2, fsdp=1, tensor=2, expert=2)
ROWS = {"ep": (B // M) // 2, "ep_tp": B // M}
MESHES = {"ep": EP_MESH, "ep_tp": EP_TP_MESH}


def shards(ep=1, tp_=1):
    return use_groups(tensor=LocalTensorGroup(tp_),
                      expert=LocalExpertGroup(ep))


def _split(case):
    return shards(2, 2 if case == "ep_tp" else 1)


@pytest.fixture(scope="module")
def setup(devices8):
    return np_params(JCFG, 2, seed=0), tokens(1, JCFG.vocab_size, b=B, t=T)


def _both(params, toks, case, jcfg=JCFG, tcfg=TCFG, seg=None):
    """(tpufw's (logits, aux) on ``case``'s mesh, the port's over its
    shards)."""
    want, aux = jax_forward(params, toks, jcfg, jp.PipelineConfig(2, M),
                            j_mesh(**MESHES[case]), seg)
    with _split(case):
        got, t_aux = tp.pipeline_forward(
            torch_params(params), torch.from_numpy(toks), tcfg,
            tp.PipelineConfig(2, M), group_rows=ROWS[case],
            segment_ids=None if seg is None else torch.from_numpy(seg))
    return (np.asarray(want), float(aux)), (got.detach().numpy(),
                                            float(t_aux))


@pytest.mark.parametrize("case", ["ep", "ep_tp"])
def test_moe_forward_and_aux_over_expert_shards(setup, case):
    """Each expert shard's slots of the global routing, through each
    tensor shard's ``d_ff`` columns, one sum: ``tpufw``'s logits and
    router loss on ``pipe=2 x fsdp=2 x expert=2`` and on the full
    ``pipe=2 x tensor=2 x expert=2`` composition."""
    params, toks = setup
    (want, aux), (got, t_aux) = _both(params, toks, case)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_aux, aux, rtol=1e-5)


@pytest.mark.parametrize("case", ["ep", "ep_tp"])
def test_moe_grads_over_expert_shards_match_tpufw(setup, case):
    """d(CE + aux)/d params through the schedule over the shards:
    ``tpufw``'s, with no tensor or expert overcount on the replicated
    router's cotangent (each shard passes back its share of the router
    loss)."""
    params, toks = setup
    l_j, g_j = jax_value_and_grad(params, toks, JCFG, jp.PipelineConfig(2, M),
                                  j_mesh(**MESHES[case]))
    with _split(case):
        l_t, g_t = torch_value_and_grad(params, toks, TCFG,
                                        tp.PipelineConfig(2, M),
                                        group_rows=ROWS[case])
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(g_t, g_j, rtol=5e-4, atol=5e-4)
    assert np.abs(g_t["stages"]["router"]).max() > 0


def test_moe_packed_segments_over_expert_shards(setup):
    """Packed rows: segment ids mask cross-document attention and keep
    padding out of the routing, over the expert shards as in ``tpufw``."""
    params, toks = setup
    rng = np.random.default_rng(7)
    seg = np.ones((B, T), np.int32)
    for r in range(B):
        seg[r, rng.integers(4, T - 4):] = 2
        if r % 3 == 0:
            seg[r, -3:] = 0
    (want, aux), (got, t_aux) = _both(params, toks, "ep", seg=seg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_aux, aux, rtol=1e-5)


def test_moe_capacity_drops_over_expert_shards(devices8):
    """A tight capacity (0.5): the expert shards drop the tokens
    ``tpufw`` drops (the routing is global, each shard slices its
    experts' slots of it)."""
    jcfg, tcfg = pair(JM, MX, "mixtral_tiny", capacity_factor=0.5)
    params = np_params(jcfg, 2, seed=4)
    toks = tokens(5, jcfg.vocab_size, b=B, t=T)
    (want, _), (got, _) = _both(params, toks, "ep", jcfg, tcfg)
    np.testing.assert_allclose(got, want, **TOL)


MLA = pair(JD, D, "deepseek_tiny", n_layers=4)
MLA_MOE = pair(JD, D, "deepseek_moe_tiny", n_layers=2, first_k_dense=0)


def test_mla_pptp_forward_and_grads_match_tpufw(devices8):
    """pp x tp on MLA: the heads (``wq``, ``wkv_b``, ``wo``) split over
    ``tensor``, the latent kernels and norms replicated and entering the
    heads at their outputs, so ``wkv_a``'s gradient is whole on every
    shard: forward and gradients ``tpufw``'s on ``pipe=2 x fsdp=2 x
    tensor=2``."""
    jcfg, tcfg = MLA
    mesh = j_mesh(data=1, pipe=2, fsdp=2, tensor=2)
    params = np_params(jcfg, 2, seed=0)
    toks = tokens(1, jcfg.vocab_size, b=B, t=T)
    want = jax_forward(params, toks, jcfg, jp.PipelineConfig(2, 4), mesh)
    l_j, g_j = jax_value_and_grad(params, toks, jcfg, jp.PipelineConfig(2, 4),
                                  mesh)
    with shards(tp_=2):
        got = tp.pipeline_forward(torch_params(params),
                                  torch.from_numpy(toks), tcfg,
                                  tp.PipelineConfig(2, 4))
        l_t, g_t = torch_value_and_grad(params, toks, tcfg,
                                        tp.PipelineConfig(2, 4))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(g_t, g_j)
    assert np.abs(g_t["stages"]["wkv_a"]).max() > 0


def test_mla_moe_over_every_axis_matches_tpufw(devices8):
    """MLA-MoE on ``pipe=2 x tensor=2 x expert=2``: the routed experts
    split over ``expert`` and their ``moe_d_ff`` over ``tensor``, the
    shared expert's width over ``tensor``; logits and router loss
    ``tpufw``'s."""
    jcfg, tcfg = MLA_MOE
    params = np_params(jcfg, 2, seed=6)
    toks = tokens(7, jcfg.vocab_size, b=B, t=T)
    (want, aux), (got, t_aux) = _both(params, toks, "ep_tp", jcfg, tcfg)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_aux, aux, rtol=1e-4)


@pytest.mark.parametrize("cfg,match", [
    (MLA[1], "no experts to shard"),
    (dataclasses.replace(TCFG, n_experts=3), "must divide n_experts=3"),
    (dataclasses.replace(MLA_MOE[1], moe_d_ff=47),
     "must divide moe_d_ff=47"),
])
def test_expert_and_tensor_checks_are_tpufws(cfg, match):
    """An expert axis on a dense model, one that does not divide the
    experts, and a tensor axis that does not divide MLA-MoE's
    ``moe_d_ff``: ``tpufw``'s errors, before any stage runs."""
    err = NotImplementedError if "no experts" in match else ValueError
    with shards(2, 2), pytest.raises(err, match=match):
        tp.pipeline_forward({}, torch.zeros(B, T, dtype=torch.long), cfg,
                            tp.PipelineConfig(2, M))


def test_pp4tp4_mla_step():
    """``tests/dryrun16_worker.py``'s 16-device shape on one process: MLA
    (8 layers, 2 a stage) through the PipelineTrainer on
    ``pipe=4 x tensor=4`` (every head its own shard), one step: its loss
    and grad norm those of the unsplit pipeline within 1e-5, and
    finite."""
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import (
        PipelineTrainer,
        TrainerConfig,
        synthetic_batches,
    )

    cfg = dataclasses.replace(MLA[1], n_layers=8)
    batch = next(synthetic_batches(16, 33, cfg.vocab_size, seed=0))
    out = {}
    for tensor in (4, 1):
        tr = PipelineTrainer(
            cfg, tp.PipelineConfig(n_stages=4, n_microbatches=4),
            TrainerConfig(batch_size=16, seq_len=33, total_steps=1,
                          lr=1e-3, handle_preemption=False),
            MeshConfig(data=1, pipe=4, tensor=tensor, fsdp=1), device="cpu")
        tr.init_state(seed=0)
        m = tr.train_step(batch)
        out[tensor] = (float(m["loss"]), float(m["grad_norm"]))
    assert np.isfinite(out[4]).all()
    np.testing.assert_allclose(out[4], out[1], rtol=1e-5)
