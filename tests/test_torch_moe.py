"""tpufw_torch.ops.moe against tpufw.ops.moe on the same router logits,
and the port's MoE layer on its own (tests/test_moe_sorted.py and the
routing tests of tests/test_mixtral.py).

Both routings agree with the JAX package's in fp32: the one-hot dispatch
tensor, the sorted token order and the group sizes bit for bit; the
combine tensor and the sorted gates within 1e-6 relative, and aux_lb and
z within 1e-6. The gates are softmax probabilities, and the two libraries'
softmax differ in the last bit of a few entries (a different exp and sum
order), so the gates cannot be held bit for bit; where a gate is zero in
one it is zero in the other. Cases: with and without a valid mask,
norm_topk on and off, capacities 1.0 and 1.25 of the balanced load,
DeepSeek's group-limited selection, and exact ties, which must break by
index (lower first) as ``jax.lax.top_k`` does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.ops import moe as j_moe
from tpufw_torch.models import MIXTRAL_CONFIGS, MixtralConfig, MoEMLP
from tpufw_torch.ops import moe

G, E, K = 64, 8, 2


def _logits(g=G, e=E, seed=0):
    return (np.random.default_rng(seed).standard_normal((g, e)) * 2.0
            ).astype(np.float32)


def _valid(g=G, seed=5):
    return np.random.default_rng(seed).random(g) < 0.7


def _both(fn_name, logits, cap, valid=None, k=K, **kw):
    """(JAX outputs, port outputs) of routing ``fn_name`` as numpy."""
    j_out = getattr(j_moe, fn_name)(
        jnp.asarray(logits), k, cap,
        valid=None if valid is None else jnp.asarray(valid),
        dtype=jnp.float32, **kw)
    t_out = getattr(moe, fn_name)(
        torch.from_numpy(logits), k, cap,
        valid=None if valid is None else torch.from_numpy(valid),
        dtype=torch.float32, **kw)
    return ([np.asarray(x) for x in j_out], [x.numpy() for x in t_out])


def _assert_gates(got, want):
    assert np.array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _assert_stats(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


CASES = [(cf, v, nt) for cf in (1.0, 1.25) for v in (False, True)
         for nt in (True, False)]


@pytest.mark.parametrize("cf, with_valid, norm_topk", CASES,
                         ids=[f"cf{c}-{'valid' if v else 'all'}-"
                              f"{'norm' if n else 'raw'}" for c, v, n in CASES])
def test_routings_match_jax(cf, with_valid, norm_topk):
    logits = _logits()
    valid = _valid() if with_valid else None
    cap = moe.expert_capacity(G, K, E, cf)
    assert cap == j_moe.expert_capacity(G, K, E, cf)
    (jd, jc, ja, jz), (td, tc, ta, tz) = _both(
        "route_topk_capacity", logits, cap, valid, norm_topk=norm_topk)
    assert td.shape == (G, E, cap) and np.array_equal(td, jd)
    _assert_gates(tc, jc)
    _assert_stats(ta, ja)
    _assert_stats(tz, jz)
    (jt, jg, jw, ja2, jz2), (tt, tg, tw, ta2, tz2) = _both(
        "route_topk_sorted", logits, cap, valid, norm_topk=norm_topk)
    assert np.array_equal(tt, jt) and np.array_equal(tg, jg)
    assert tg.shape == (E + 1,) and tg.sum() == K * G
    _assert_gates(tw, jw)
    _assert_stats(ta2, ja2)
    _assert_stats(tz2, jz2)
    if cf == 1.0:  # capacity binds: some assignment was dropped
        assert (tw == 0).sum() > 0


@pytest.mark.parametrize("fn", ["route_topk_capacity", "route_topk_sorted"])
def test_group_limit_matches_jax(fn):
    """DeepSeek-236B's group-limited selection: 8 experts in 4 groups, the
    top 2 groups survive, raw gates."""
    logits = _logits(32, 8, seed=7)
    cap = moe.expert_capacity(32, K, 8, 2.0)
    j_out, t_out = _both(fn, logits, cap, norm_topk=False,
                         group_limit=(4, 2))
    if fn == "route_topk_capacity":
        assert np.array_equal(t_out[0], j_out[0])
        _assert_gates(t_out[1], j_out[1])
    else:
        assert np.array_equal(t_out[0], j_out[0])
        assert np.array_equal(t_out[1], j_out[1])
        _assert_gates(t_out[2], j_out[2])
    _assert_stats(t_out[-2], j_out[-2])


@pytest.mark.parametrize("group_limit", [None, (4, 2)],
                         ids=["plain", "group_limit"])
def test_ties_break_by_index_as_jax(group_limit):
    """Exact ties: rows of equal logits (every expert ties), repeated
    integer logits, and rows whose survivors' probabilities underflow to
    exactly 0 beside the group-limited mask's zeros. Both packages take
    the lower index first, so the dispatch and the sorted order agree."""
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, (48, 8)).astype(np.float32)
    logits[:8] = 0.0
    # One expert far above the rest: the others' softmax mass is exactly
    # zero in fp32, tying with the masked experts.
    logits[8:16] = 0.0
    logits[8:16, 5] = 200.0
    cap = moe.expert_capacity(48, 3, 8, 4.0)
    kw = dict(k=3, norm_topk=False, group_limit=group_limit)
    (jd, jc, _, _), (td, tc, _, _) = _both(
        "route_topk_capacity", logits, cap, **kw)
    assert np.array_equal(td, jd)
    _assert_gates(tc, jc)
    (jt, jg, jw, _, _), (tt, tg, tw, _, _) = _both(
        "route_topk_sorted", logits, cap, **kw)
    assert np.array_equal(tt, jt) and np.array_equal(tg, jg)
    _assert_gates(tw, jw)
    # Row 0 ties everywhere: experts 0, 1, 2, in that order.
    _, idx = moe._topk(torch.zeros(1, 8), 3)
    assert idx.tolist() == [[0, 1, 2]]


def _identity_experts(logits, x, cap, valid=None, norm_topk=True):
    """(einsum y, sorted y, aux, z pairs): expert i multiplies its tokens
    by i + 1, so routing, capacity and gate differences show in y."""
    lg, xt = torch.from_numpy(logits), torch.from_numpy(x)
    v = None if valid is None else torch.from_numpy(valid)
    e = logits.shape[1]
    scale = torch.arange(1.0, e + 1.0)
    d, c, aux0, z0 = moe.route_topk_capacity(lg, K, cap, v, torch.float32,
                                             norm_topk)
    ye = torch.einsum("gec,gd->ecd", d, xt) * scale[:, None, None]
    y0 = torch.einsum("gec,ecd->gd", c, ye)
    tok, sizes, gates, aux1, z1 = moe.route_topk_sorted(
        lg, K, cap, v, torch.float32, norm_topk)
    eid = torch.repeat_interleave(torch.arange(e + 1), sizes)
    ys = xt[tok] * torch.cat([scale, torch.zeros(1)])[eid][:, None]
    y1 = torch.zeros_like(xt).index_add(0, tok, ys * gates[:, None])
    return (y0, y1), (aux0, aux1), (z0, z1)


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("cf", [4.0, 0.6], ids=["ample", "drops"])
def test_sorted_matches_einsum_in_the_port(cf, norm_topk):
    logits = _logits()
    x = np.random.default_rng(1).standard_normal((G, 16)).astype(np.float32)
    cap = moe.expert_capacity(G, K, E, cf)
    (y0, y1), (a0, a1), (z0, z1) = _identity_experts(
        logits, x, cap, norm_topk=norm_topk)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    assert float(a0) == float(a1) and float(z0) == float(z1)


def test_sorted_matches_einsum_with_valid_mask():
    logits = _logits(48, 4, seed=3)
    x = np.random.default_rng(4).standard_normal((48, 8)).astype(np.float32)
    valid = _valid(48)
    cap = moe.expert_capacity(48, K, 4, 1.0)
    (y0, y1), (a0, a1), _ = _identity_experts(logits, x, cap, valid)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    assert float(a0) == float(a1)
    # Invalid rows get nothing.
    assert (y1.numpy()[~valid] == 0).all() and (y0.numpy()[~valid] == 0).all()


def _layer_cfg(**kw):
    return MixtralConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
        head_dim=16, d_ff=64, n_experts=4, experts_per_token=2, remat=False,
        dtype=torch.float32, **kw)


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_capacity_drops_dont_nan(mode):
    """capacity_factor 0.25 forces drops; dropped tokens pass residual
    only, and the output stays finite."""
    layer = MoEMLP(_layer_cfg(capacity_factor=0.25, moe_dispatch=mode),
                   torch.Generator().manual_seed(1), "cpu")
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, aux = layer(x)
    assert torch.isfinite(y).all() and float(aux) >= 0.0
    assert (y.abs().sum(-1) == 0).any()  # some tokens were dropped


@pytest.mark.parametrize("mode", ["einsum", "sorted"])
def test_pads_do_not_consume_capacity(mode):
    """With tight capacity, pads first or pads last give the real tokens
    the same outputs: pads take no slot."""
    layer = MoEMLP(_layer_cfg(capacity_factor=1.0, moe_dispatch=mode),
                   torch.Generator().manual_seed(1), "cpu")
    x_real = torch.randn(1, 8, 32, generator=torch.Generator().manual_seed(0))
    pad = torch.zeros(1, 8, 32)
    on, off = torch.ones(1, 8, dtype=torch.bool), torch.zeros(1, 8,
                                                                dtype=torch.bool)
    with torch.no_grad():
        y_last, _ = layer(torch.cat([x_real, pad], 1), torch.cat([on, off], 1))
        y_first, _ = layer(torch.cat([pad, x_real], 1), torch.cat([off, on], 1))
    np.testing.assert_allclose(y_last[:, :8].numpy(), y_first[:, 8:].numpy(),
                               atol=2e-5, rtol=2e-5)
    assert float(y_first[:, 8:].abs().sum()) > 0


def test_unknown_dispatch_mode_refused():
    with pytest.raises(ValueError, match="moe_dispatch"):
        MoEMLP(_layer_cfg(moe_dispatch="nope"), None, "cpu")


def test_int8_experts_run_the_einsum_dispatch():
    """Int8 expert stacks are einsum-shaped: a quantized layer under
    moe_dispatch="sorted" runs the einsum mode, as tpufw's does."""
    cfg = dataclasses.replace(MIXTRAL_CONFIGS["mixtral_tiny"],
                              moe_dispatch="sorted", quantized_weights=True)
    layer = MoEMLP(cfg, None, "cpu")
    assert layer.mode == "einsum"
