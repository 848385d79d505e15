"""tpufw_torch ops vs their tpufw twins on the same numpy-seeded inputs
(fp32, tolerance 2e-4 as in tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.models.llama import RopeScaling as JRopeScaling
from tpufw.models.llama import apply_rope as j_apply_rope
from tpufw.ops.attention import xla_attention as j_xla
from tpufw.ops.loss import chunked_cross_entropy as j_chunked_ce
from tpufw.ops.loss import token_cross_entropy as j_token_ce
from tpufw.ops.norms import rms_norm as j_rms_norm
from tpufw_torch.models.llama import RopeScaling, apply_rope
from tpufw_torch.ops.attention import xla_attention
from tpufw_torch.ops.loss import chunked_cross_entropy, token_cross_entropy
from tpufw_torch.ops.norms import rms_norm

TOL = dict(rtol=2e-4, atol=2e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches():
    rng = _rng()
    x = rng.standard_normal((2, 7, 32), np.float32) * 3
    w = rng.standard_normal((32,), np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.tensor(x), torch.tensor(w), 1e-6).numpy(),
        np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **TOL,
    )


@pytest.mark.parametrize(
    "scaling",
    [None, "llama3", "linear"],
)
def test_apply_rope_matches(scaling):
    rng = _rng(1)
    x = rng.standard_normal((2, 9, 3, 16), np.float32)
    pos = rng.integers(0, 20_000, (2, 9)).astype(np.int32)
    kw = dict(factor=8.0, original_max_position_embeddings=64)
    j_s = t_s = None
    if scaling is not None:
        j_s = JRopeScaling(rope_type=scaling, **kw)
        t_s = RopeScaling(rope_type=scaling, **kw)
    got = apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0, t_s)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, j_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# name: (t, s, h, kh, causal, segments, q_positions, cap, window)
ATTN_CASES = {
    "gqa_causal": (12, 12, 4, 2, True, False, False, None, None),
    "mqa_noncausal": (12, 12, 4, 1, False, False, False, None, None),
    "segments": (16, 16, 4, 2, True, True, False, None, None),
    "offset_t_lt_s": (5, 16, 2, 2, True, False, False, None, None),
    "q_positions": (4, 16, 2, 1, True, False, True, None, None),
    "soft_cap": (12, 12, 4, 2, True, False, False, 5.0, None),
    "window": (16, 16, 2, 1, True, False, False, None, 5),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_xla_attention_matches(name):
    t, s, h, kh, causal, segs, qpos, cap, window = ATTN_CASES[name]
    rng = _rng(2)
    q = rng.standard_normal((2, t, h, 16), np.float32) * 2
    k = rng.standard_normal((2, s, kh, 16), np.float32) * 2
    v = rng.standard_normal((2, s, kh, 16), np.float32)
    kw = dict(causal=causal, logits_soft_cap=cap, sliding_window=window)
    jkw, tkw = dict(kw), dict(kw)
    if segs:
        seg = np.repeat([[1] * (t // 2) + [2] * (t - t // 2)], 2, 0)
        jkw["segment_ids"] = jnp.asarray(seg, jnp.int32)
        tkw["segment_ids"] = torch.tensor(seg, dtype=torch.int32)
    if qpos:
        p = np.stack([np.arange(3, 3 + t), np.arange(8, 8 + t)]).astype(np.int32)
        jkw["q_positions"] = jnp.asarray(p)
        tkw["q_positions"] = torch.tensor(p)
    got = xla_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **tkw)
    want = j_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_token_cross_entropy_matches():
    rng = _rng(3)
    logits = rng.standard_normal((3, 5, 40), np.float32) * 4
    tgt = rng.integers(0, 40, (3, 5)).astype(np.int32)
    got = token_cross_entropy(torch.tensor(logits), torch.tensor(tgt))
    want = j_token_ce(jnp.asarray(logits), jnp.asarray(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "t, chunk, dtype, masked, cap",
    [
        (16, 4, "float32", False, None),
        (13, 4, "float32", True, None),  # T padded to a chunk multiple
        (13, 8, "float32", True, 3.0),
        (13, 4, "bfloat16", True, None),
    ],
)
def test_chunked_cross_entropy_matches(t, chunk, dtype, masked, cap):
    """Loss, token count and (fp32) grads w.r.t. hidden and kernel."""
    rng = _rng(4)
    h = rng.standard_normal((2, t, 8), np.float32)
    w = rng.standard_normal((8, 50), np.float32)
    tgt = rng.integers(0, 50, (2, t)).astype(np.int32)
    mask = (rng.random((2, t)) > 0.3).astype(np.float32) if masked else None

    def jloss(h, w):
        return j_chunked_ce(
            h, w, jnp.asarray(tgt),
            None if mask is None else jnp.asarray(mask),
            chunk_size=chunk, compute_dtype=jnp.dtype(dtype),
            logits_soft_cap=cap,
        )

    (jl, jn), jgrads = jax.value_and_grad(
        lambda h, w: jloss(h, w), argnums=(0, 1), has_aux=True
    )(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    tl, tn = chunked_cross_entropy(
        ht, wt, torch.tensor(tgt), None if mask is None else torch.tensor(mask),
        chunk_size=chunk, compute_dtype=getattr(torch, dtype),
        logits_soft_cap=cap,
    )
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert tn.item() == float(jn)
    if dtype == "float32":
        tl.backward()
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgrads[0]), **TOL)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrads[1]), **TOL)
