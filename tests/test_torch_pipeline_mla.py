"""The port's pipelined DeepSeek-MLA blocks against ``tpufw``
(``tests/test_pipeline_mla.py``'s cases): (1) the port's sequential
oracle on params restacked from a Flax ``Deepseek`` init
(``interop.pipeline_params_from_flax``) reproduces the Flax logits, both q
paths, and the MoE form with and without group-limited routing; (2) the
port's GPipe matches ``tpufw``'s pipelined forward and gradients, the
MoE form's router loss included; (3) 1F1B, ZB-H1 and interleaved match
``tpufw``'s GPipe gradients on dense MLA. All fp32, 2e-4 unless the
reference's own case says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_pipeline import (
    TOL,
    assert_trees_close,
    canonical,
    j_mesh,
    jax_forward,
    jax_value_and_grad,
    np_params,
    pair,
    tokens,
    torch_params,
    torch_value_and_grad,
    virtual,
)
from tpufw.models import DEEPSEEK_CONFIGS as J
from tpufw.models import Deepseek
from tpufw.parallel import pipeline as jp
from tpufw_torch.interop import pipeline_params_from_flax
from tpufw_torch.models import DEEPSEEK_CONFIGS as P
from tpufw_torch.parallel import pipeline as tp

JCFG, TCFG = pair(J, P, "deepseek_tiny", n_layers=4)
JQCFG, TQCFG = pair(J, P, "deepseek_tiny_qlora", n_layers=4)
JMOE, TMOE = pair(J, P, "deepseek_moe_tiny", n_layers=4)
MESH = dict(data=1, pipe=2, fsdp=4)


def _flax(jcfg, seed):
    """(the Flax model, its params made with numpy from ``seed`` in its
    init's shapes: kernels N(0, 1/fan-in), norm scales 1 + 0.1 N)."""
    model = Deepseek(jcfg)
    shapes = meta.unbox(jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * x
        if "embedding" in name:
            return x
        fan_in = int(np.prod(leaf.shape[1:-1])) if "layers" in name else \
            leaf.shape[0]
        return x / np.sqrt(max(fan_in, 1))

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("cfgs", [(JCFG, TCFG), (JQCFG, TQCFG)],
                         ids=["full_q", "q_lora"])
def test_sequential_oracle_matches_flax(devices8, cfgs):
    """The port's ``_mla_block`` == the Flax ``DeepseekBlock``."""
    jcfg, tcfg = cfgs
    model, fparams = _flax(jcfg, 3)
    toks = tokens(2, jcfg.vocab_size, b=2, t=13)
    want = model.apply({"params": fparams}, toks)
    got = tp.reference_forward(pipeline_params_from_flax(fparams, tcfg, 2),
                               torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.fixture(scope="module")
def setup(devices8):
    return np_params(JCFG, 2, seed=0), tokens(1, JCFG.vocab_size)


def test_pipeline_matches_tpufw(setup):
    params, toks = setup
    want = jax_forward(params, toks, JCFG, jp.PipelineConfig(2, 4),
                       j_mesh(**MESH))
    got = tp.pipeline_forward(torch_params(params), torch.from_numpy(toks),
                              TCFG, tp.PipelineConfig(2, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.fixture(scope="module")
def gpipe_grads(setup):
    params, toks = setup
    return jax_value_and_grad(params, toks, JCFG, jp.PipelineConfig(2, 4),
                              j_mesh(**MESH))


@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1),
                                        ("zb1", 1), ("interleaved", 2)])
def test_grads_match_tpufw(setup, gpipe_grads, schedule, v):
    """Every schedule of the port on dense MLA against ``tpufw``'s GPipe
    (its own 1F1B is pinned to that GPipe by its tests)."""
    params, toks = setup
    l_g, g_g = gpipe_grads
    pipe = tp.PipelineConfig(2, 4, schedule, v)
    if schedule == "interleaved":
        l_t, g_t = torch_value_and_grad(virtual(params, v, 2), toks, TCFG,
                                        pipe)
        g_t = canonical(g_t, 2)
    else:
        l_t, g_t = torch_value_and_grad(params, toks, TCFG, pipe)
    np.testing.assert_allclose(l_t, l_g, rtol=1e-5)
    assert_trees_close(g_t, g_g)


def test_flash_backend_pads_v(setup, monkeypatch):
    """Under ``flash`` the MLA sublayer gives the kernels V zero-padded
    to the qk head dim (192 at DeepSeek-V2's widths) and slices the
    output back: the same numbers as ``xla``'s unpadded V."""
    from tpufw_torch.ops import flash

    params, toks = setup
    shapes = []
    real = flash.flash_attention
    monkeypatch.setattr(flash, "flash_attention", lambda q, k, v, **kw: (
        shapes.append(v.shape[-1]) or real(q, k, v, **kw)))
    fcfg = dataclasses.replace(TCFG, attention_backend="flash")
    got = tp.pipeline_forward(torch_params(params), torch.from_numpy(toks),
                              fcfg, tp.PipelineConfig(2, 4))
    want = tp.pipeline_forward(torch_params(params), torch.from_numpy(toks),
                               TCFG, tp.PipelineConfig(2, 4))
    assert set(shapes) == {TCFG.qk_head_dim}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("n_group", [0, 2], ids=["plain", "group_limited"])
def test_moe_sequential_matches_flax(devices8, n_group):
    """``_mla_moe_block`` (routed dispatch, shared expert, scaling) ==
    the Flax MoE block, one routing group of the whole batch."""
    jcfg = dataclasses.replace(JMOE, n_group=n_group,
                               topk_group=1 if n_group else 0)
    tcfg = dataclasses.replace(TMOE, n_group=n_group,
                               topk_group=1 if n_group else 0)
    model, fparams = _flax(jcfg, 5)
    toks = tokens(4, jcfg.vocab_size, b=2, t=13)
    want = model.apply({"params": fparams}, toks, return_aux=False)
    got, _aux = tp.reference_forward(
        pipeline_params_from_flax(fparams, tcfg, 2), torch.from_numpy(toks),
        tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                               rtol=2e-3)


def test_moe_pipeline_matches_tpufw(devices8):
    """MoE-MLA through the stages: logits and router loss against
    ``tpufw``'s schedule, routed in its (microbatch x data-shard) groups
    of ``group_rows`` rows, and its oracle's."""
    params = np_params(JMOE, 2, seed=6)
    toks = tokens(7, JMOE.vocab_size)
    want, aux = jax_forward(params, toks, JMOE, jp.PipelineConfig(2, 2),
                            j_mesh(**MESH))
    rows = (16 // 2) // 4
    got, t_aux = tp.pipeline_forward(torch_params(params),
                                     torch.from_numpy(toks), TMOE,
                                     tp.PipelineConfig(2, 2), group_rows=rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(t_aux), float(aux), rtol=1e-4)
    ref, r_aux = tp.reference_forward(torch_params(params),
                                      torch.from_numpy(toks), TMOE,
                                      group_rows=rows)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(r_aux), float(aux), rtol=1e-4)


def test_moe_mixed_dense_rejected_loudly():
    mixed = dataclasses.replace(TMOE, first_k_dense=2, scan_layers=False)
    jmixed = dataclasses.replace(JMOE, first_k_dense=2, scan_layers=False)
    with pytest.raises(NotImplementedError, match="UNIFORM") as want:
        jp.init_pipeline_params(jax.random.key(0), jmixed,
                                jp.PipelineConfig(2, 4))
    with pytest.raises(NotImplementedError, match="UNIFORM") as got:
        tp.init_pipeline_params(mixed, tp.PipelineConfig(2, 4), device="cpu")
    assert str(got.value).replace("plain Trainer", "") == \
        str(want.value).replace("flax trainer", "")
