"""Tensor parallelism inside the port's pipeline stages against ``tpufw``'s
pp x tp (``tests/test_pipeline.py``'s ``pptp`` cases,
``test_pipeline_1f1b.py::test_1f1b_pptp_matches_gpipe`` and
``test_pipeline_interleaved.py::test_interleaved_pptp_matches_gpipe``):
``tpufw`` on ``MeshConfig(data=1, pipe=2, fsdp=2, tensor=2)`` over its 8
virtual devices, the port on one process's ``LocalPipeGroup(2)`` x
``LocalTensorGroup(2)``, the same numpy-made params and tokens in fp32.
Held: each stage leaf's split is ``tpufw``'s partition spec and a rank's
shards put back are the whole leaf; logits, losses and every gradient at
2e-4 (GPipe, 1F1B, interleaved, each against ``tpufw``'s GPipe, the
oracle of its own pptp schedule tests; Gemma's sandwich norms after the
sum);
ZB-H1 at the same split against the port's GPipe; the divisibility
errors in ``tpufw``'s words; the trainer and the workload under a tensor
axis against their unsplit runs."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    TOL,
    assert_trees_close,
    canonical,
    j_mesh,
    jax_forward,
    jax_value_and_grad,
    llama_pair,
    np_params,
    pair,
    to_numpy,
    tokens,
    torch_params,
    torch_value_and_grad,
    virtual,
)
from tpufw.parallel import pipeline as jp
from tpufw_torch.parallel import pipeline as tp
from tpufw_torch.parallel.context import use_groups
from tpufw_torch.parallel.group import (
    LocalExpertGroup,
    LocalTensorGroup,
    ProcessTensorGroup,
)

JCFG, TCFG = llama_pair()
PPTP = dict(data=1, pipe=2, fsdp=2, tensor=2)
B, T, M = 8, 17, 4


def tp2():
    return use_groups(tensor=LocalTensorGroup(2))


@pytest.fixture(scope="module")
def setup(devices8):
    return np_params(JCFG, 2, seed=2), tokens(3, JCFG.vocab_size, b=B, t=T)


def _families():
    from tpufw.models import DEEPSEEK_CONFIGS as JD
    from tpufw.models import GEMMA_CONFIGS as JG
    from tpufw.models import MIXTRAL_CONFIGS as JM
    from tpufw_torch.models import DEEPSEEK_CONFIGS as D
    from tpufw_torch.models import GEMMA_CONFIGS as G
    from tpufw_torch.models import MIXTRAL_CONFIGS as MX

    return {"llama": (JCFG, TCFG),
            "qwen": llama_pair("qwen25_tiny"),
            "gemma": pair(JG, G, "gemma2_tiny"),
            "mixtral": pair(JM, MX, "mixtral_tiny"),
            "mla_moe": pair(JD, D, "deepseek_moe_tiny", n_layers=2,
                            first_k_dense=0),
            "mla_qlora": pair(JD, D, "deepseek_tiny_qlora")}


@pytest.mark.parametrize("family,virtual_layout", [
    ("llama", False), ("qwen", False), ("gemma", False), ("mixtral", False),
    ("mla_moe", False), ("mla_qlora", False), ("llama", True),
    ("qwen", True)])
def test_pptp_leaf_splits_are_tpufws(devices8, family, virtual_layout):
    """``leaf_split`` of every stage leaf is ``tpufw``'s
    ``stage_partition_specs`` (its ``tensor`` and ``expert`` dims; MLA's
    latent kernels and every norm replicated), and the two tensor ranks'
    shards (``cut_stages`` over a process group) concatenate to the
    whole leaf."""
    jcfg, tcfg = _families()[family]
    params = np_params(jcfg, 2, seed=1)
    stages = (virtual(params, 2, 2) if virtual_layout else params)["stages"]
    specs = dict(tp.tree_leaves(jp.stage_partition_specs(stages,
                                                         virtual_layout)))
    whole = torch_params({"stages": stages})["stages"]
    parts = [tp.cut_stages(whole, (ProcessTensorGroup(None, 2, r),
                                   LocalExpertGroup(1)), virtual_layout)
             for r in range(2)]
    for path, a in tp.tree_leaves(whole):
        split = dict(tp.leaf_split(path, a.ndim, virtual_layout))
        spec = tuple(specs[path]) + (None,) * (a.ndim - len(specs[path]))
        assert {ax: d for d, ax in enumerate(spec)
                if ax in ("tensor", "expert")} == split, path
        got = [dict(tp.tree_leaves(p))[path] for p in parts]
        if "tensor" in split:
            assert torch.equal(torch.cat(got, split["tensor"]), a), path
        else:
            assert all(torch.equal(g, a) for g in got), path


def test_pptp_forward_matches_tpufw(setup):
    params, toks = setup
    want = jax_forward(params, toks, JCFG, jp.PipelineConfig(2, M),
                       j_mesh(**PPTP))
    tparams = torch_params(params)
    with tp2():
        got = tp.pipeline_forward(tparams, torch.from_numpy(toks), TCFG,
                                  tp.PipelineConfig(2, M))
    ref = tp.reference_forward(tparams, torch.from_numpy(toks), TCFG)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ref.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pptp_grads_match_tpufw(setup, schedule):
    """GPipe's autograd and 1F1B's per-stage ``autograd.grad`` over the
    tensor shards: the loss and every gradient (the replicated norms'
    whole, the split kernels' shards in place) those of ``tpufw``'s GPipe
    on its pptp mesh, the oracle of its own 1F1B pptp test."""
    params, toks = setup
    l_j, g_j = jax_value_and_grad(params, toks, JCFG, jp.PipelineConfig(2, M),
                                  j_mesh(**PPTP))
    with tp2():
        l_t, g_t = torch_value_and_grad(params, toks, TCFG,
                                        tp.PipelineConfig(2, M, schedule))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(g_t, g_j)


def test_interleaved_pptp_matches_tpufw(devices8):
    """Megatron's split inside interleaved chunks (v = 2): the port's
    loss and canonical gradients ``tpufw``'s GPipe's on its pptp mesh
    (the oracle of its interleaved pptp test)."""
    params = np_params(JCFG, 2, seed=12)
    toks = tokens(13, JCFG.vocab_size, b=B, t=T)
    l_j, g_j = jax_value_and_grad(params, toks, JCFG,
                                  jp.PipelineConfig(2, M), j_mesh(**PPTP))
    with tp2():
        l_t, g_t = torch_value_and_grad(
            virtual(params, 2, 2), toks, TCFG,
            tp.PipelineConfig(2, M, "interleaved", 2))
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5)
    assert_trees_close(canonical(g_t, 2), g_j)


def test_zb1_pptp_matches_gpipe(setup):
    """ZB-H1's split backward over the tensor shards: B's input
    cotangents and W's weight gradients each take their sum over the
    axis once, so its gradients are GPipe's at the same split."""
    params, toks = setup
    with tp2():
        l_g, g_g = torch_value_and_grad(params, toks, TCFG,
                                        tp.PipelineConfig(2, M))
        l_z, g_z = torch_value_and_grad(params, toks, TCFG,
                                        tp.PipelineConfig(2, M, "zb1"))
    np.testing.assert_allclose(l_z, l_g, rtol=1e-6)
    assert_trees_close(g_z, g_g, rtol=1e-5, atol=1e-6)


def test_pptp_gemma_forward_matches_tpufw(devices8):
    """Gemma pairs under pp x tp: each sublayer's shards summed before its
    post-norm (an RMSNorm of a partial sum is another function)."""
    from tpufw.models import GEMMA_CONFIGS as JG
    from tpufw_torch.models import GEMMA_CONFIGS as G

    jcfg, tcfg = pair(JG, G, "gemma2_tiny", n_layers=8)
    params = np_params(jcfg, 2, seed=4)
    toks = tokens(5, jcfg.vocab_size, b=B, t=32)
    want = jax_forward(params, toks, jcfg, jp.PipelineConfig(2, M),
                       j_mesh(**PPTP))
    with tp2():
        got = tp.pipeline_forward(torch_params(params),
                                  torch.from_numpy(toks), tcfg,
                                  tp.PipelineConfig(2, M))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(n_kv_heads=1, n_heads=3, d_model=48), "must divide n_heads=3"),
    (dict(n_kv_heads=1), "must divide n_kv_heads=1"),
    (dict(d_ff=129), "must divide d_ff=129"),
])
def test_pptp_indivisible_dims_loud(bad, match):
    """A tensor axis that does not divide the heads, the KV heads or the
    MLP width fails before any stage runs, in ``tpufw``'s words."""
    from tpufw_torch.train import PipelineTrainer, TrainerConfig
    from tpufw_torch.mesh import MeshConfig

    cfg = dataclasses.replace(TCFG, **bad)
    pipe = tp.PipelineConfig(2, M)
    with tp2(), pytest.raises(ValueError, match=match):
        tp.pipeline_forward({}, torch.zeros(B, T, dtype=torch.long), cfg,
                            pipe)
    with pytest.raises(ValueError, match=match):
        PipelineTrainer(cfg, pipe, TrainerConfig(batch_size=B, seq_len=T),
                        MeshConfig(pipe=2, fsdp=1, tensor=2), device="cpu")


def test_pptp_trainer_matches_tpufw(devices8):
    """Three steps of ``tpufw``'s PipelineTrainer on its pptp mesh and of
    the port's with ``MeshConfig(pipe=2, fsdp=1, tensor=2)`` in one
    process (every stage and tensor shard), from the same params on the
    same batches: losses and params; the grad norms those of the port's
    unsplit run."""
    from tpufw.mesh import MeshConfig as JMeshConfig
    from tpufw.train import PipelineTrainer as JTrainer
    from tpufw.train import TrainerConfig as JTrainerConfig
    from tpufw_torch.mesh import MeshConfig
    from tpufw_torch.train import (
        PipelineTrainer,
        TrainerConfig,
        synthetic_batches,
    )

    params = np_params(JCFG, 2, seed=3)
    it = synthetic_batches(B, T, JCFG.vocab_size, seed=4)
    data = [next(it) for _ in range(3)]
    kw = dict(batch_size=B, seq_len=T, total_steps=3, lr=1e-2,
              warmup_steps=1, log_every=1)
    jt = JTrainer(JCFG, jp.PipelineConfig(2, M), JTrainerConfig(**kw),
                  JMeshConfig(**PPTP))
    jt.init_state()
    sh = jt._shardings
    jparams = jax.device_put(params, sh.params)
    jt.state = jt.state.replace(params=jparams, opt_state=jax.device_put(
        jt.tx.init(jparams), sh.opt_state))
    want = [m.loss for m in jt.run(iter(data), model_flops_per_token=1.0)]
    runs = {}
    for tensor in (2, 1):
        tt = PipelineTrainer(TCFG, tp.PipelineConfig(2, M),
                             TrainerConfig(**kw, handle_preemption=False),
                             MeshConfig(pipe=2, fsdp=1, tensor=tensor),
                             device="cpu")
        tt.init_state(params=torch_params(params))
        runs[tensor] = ([tt.train_step(b) for b in data], tt)
    got = [float(m["loss"]) for m in runs[2][0]]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    np.testing.assert_allclose(
        [float(m["grad_norm"]) for m in runs[2][0]],
        [float(m["grad_norm"]) for m in runs[1][0]], rtol=1e-5)
    assert_trees_close(to_numpy(runs[2][1].whole_params()),
                       jax.device_get(jt.state.params), **TOL)


def test_workload_under_mesh_tensor(monkeypatch, capsys):
    """``python -m tpufw_torch.workloads.train_pipeline`` with
    ``TPUFW_MESH_TENSOR=2`` in one process holds both stages and both
    tensor shards; its losses are the unsplit run's."""
    import json

    from tests.torch_parity import workload_env
    from tpufw_torch.models import LLAMA_CONFIGS, PRESETS
    from tpufw_torch.workloads import train_pipeline

    f32 = dataclasses.replace(LLAMA_CONFIGS["llama3_tiny"],
                              dtype=torch.float32)
    monkeypatch.setitem(PRESETS, "llama3_tiny", f32)
    losses = {}
    for tensor in ("2", "1"):
        workload_env(monkeypatch, dict(
            PIPE_STAGES=2, MODEL="llama3_tiny", BATCH_SIZE=8, SEQ_LEN=17,
            TOTAL_STEPS=2, LOG_EVERY=1, DEVICE="cpu", HANDLE_PREEMPTION=0,
            PIPELINE_SCHEDULE="1f1b", MESH_TENSOR=tensor))
        assert train_pipeline.main() == 0
        out = capsys.readouterr().out
        assert ("'tensor': 2" in out) == (tensor == "2")
        losses[tensor] = [json.loads(ln)["loss"] for ln in out.splitlines()
                          if ln.startswith('{"step"')]
    assert len(losses["2"]) == 2
    np.testing.assert_allclose(losses["2"], losses["1"], rtol=1e-5)
    assert os.environ["TPUFW_MESH_TENSOR"] == "1"
