"""tpufw_torch flash attention vs the JAX Pallas kernels (interpret mode).

The port's ``flash_attention`` runs its fwd / dq / dk-dv decomposition
through the kernels' plain PyTorch versions on the CPU; the reference is
``tpufw.ops.flash.flash_attention(..., interpret=True)`` and ``jax.vjp``
through it. Both take the same numpy-seeded fp32 inputs; tolerance is
the repo's 2e-4 (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.ops.flash import flash_attention as jax_flash
from tpufw_torch.ops import flash as tflash

TOL = dict(rtol=2e-4, atol=2e-4)

# name: (b, t, s, h, kh, d, causal, segments, soft_cap, window, scale)
CASES = {
    "unaligned_gqa": (1, 100, 100, 4, 1, 16, True, False, None, None, 1.0),
    "gqa_noncausal": (2, 128, 128, 4, 2, 32, False, False, None, None, 1.0),
    "segments": (2, 256, 256, 4, 2, 16, True, True, None, None, 1.0),
    "decode_offset": (1, 128, 256, 2, 2, 32, True, False, None, None, 1.0),
    "soft_cap": (1, 128, 128, 4, 2, 16, True, False, 20.0, None, 3.0),
    "cap_segments": (1, 128, 128, 2, 2, 32, True, True, 20.0, None, 3.0),
    "window100": (1, 256, 256, 2, 1, 16, True, False, None, 100, 1.0),
    "window128": (1, 256, 256, 2, 1, 16, True, False, None, 128, 1.0),
    "window300": (1, 256, 256, 2, 1, 32, True, False, None, 300, 1.0),
    # Gemma-2's head dim, which the CUDA kernels also take: cap 50 with a
    # window under T, and packed segments.
    "d256_cap50_window100": (1, 256, 256, 2, 1, 256, True, False, 50.0, 100, 3.0),
    "d256_segments": (1, 128, 128, 2, 1, 256, True, True, None, None, 1.0),
    # DeepSeek's MLA head dim (128 nope + 64 rope), also built for the CUDA
    # kernels: causal with V's last 64 columns zero (as the model pads it),
    # and segments with a cap and a window.
    "d192_causal_zero_padded_v": (1, 128, 128, 4, 4, 192, True, False, None,
                                  None, 1.0),
    "d192_segments_cap_window": (1, 128, 128, 2, 1, 192, True, True, 20.0, 50,
                                 3.0),
}


def _segments(b, t):
    """Two documents then padding (segment 0), the packed-data layout."""
    seg = np.zeros((b, t), np.int32)
    seg[:, : int(t * 0.4)] = 1
    seg[:, int(t * 0.4): int(t * 0.85)] = 2
    return seg


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_fwd_and_grads_match_jax_interpret(name):
    b, t, s, h, kh, d, causal, segs, cap, window, scale = CASES[name]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, t, h, d), np.float32) * scale
    k = rng.standard_normal((b, s, kh, d), np.float32) * scale
    v = rng.standard_normal((b, s, kh, d), np.float32)
    if name.endswith("zero_padded_v"):
        v[..., 128:] = 0.0  # MLA's V (128 columns) padded to the qk dim
    g = rng.standard_normal((b, t, h, d), np.float32)
    seg = _segments(b, t) if segs else None
    kw = dict(causal=causal, logits_soft_cap=cap, sliding_window=window)

    def jf(q, k, v):
        return jax_flash(
            q, k, v, segment_ids=None if seg is None else jnp.asarray(seg),
            interpret=True, **kw,
        )

    out_j, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tflash.flash_attention(
        qt, kt, vt, segment_ids=None if seg is None else torch.tensor(seg),
        **kw,
    )
    out_t.backward(torch.tensor(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    for name_, gt, gj in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(
            gt.numpy(), np.asarray(gj), err_msg=f"d{name_}", **TOL
        )


def test_flash_lse_matches_logsumexp():
    """The forward's LSE is logsumexp of the masked, capped, scaled logits."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((1, 64, 2, 16), np.float32))
    k = torch.tensor(rng.standard_normal((1, 64, 1, 16), np.float32))
    v = torch.tensor(rng.standard_normal((1, 64, 1, 16), np.float32))
    _, lse = tflash.flash_fwd(q, k, v, causal=True, soft_cap=5.0)
    logits = torch.einsum("bthd,bshd->bhts", q, k.expand(-1, -1, 2, -1)) / 4.0
    logits = 5.0 * torch.tanh(logits / 5.0)
    logits = logits.masked_fill(~torch.ones(64, 64).tril().bool(), -1e30)
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(logits, -1).numpy(), **TOL
    )


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch no
    kernel; the kernels' shape limits do not apply there."""
    tflash.reset_launch_counts()
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    v = torch.randn(1, 8, 1, 16, requires_grad=True)
    tflash.flash_attention(q, k, v).sum().backward()
    assert tflash.LAUNCHES == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
        "flash_fwd_d192": 0, "flash_dq_d192": 0, "flash_dkv_d192": 0,
        "flash_fwd_d256": 0, "flash_dq_d256": 0, "flash_dkv_d256": 0,
        "flash_fwd_k64": 0, "flash_dq_k64": 0, "flash_dkv_k64": 0,
        "flash_fwd_d192_q64": 0, "flash_dq_d192_q64": 0,
        "flash_fwd_d256_q64": 0, "flash_dq_d256_q64": 0,
    }


@pytest.mark.parametrize("head_dim", [96, 64])
def test_unported_head_dims_raise_off_the_cpu(head_dim):
    """A tensor off the CPU at a head dim the CUDA kernels are not built
    for raises NotImplementedError naming the builds (``BUILDS``) before
    any build or launch: there is no route to the plain version. Meta
    tensors stand in for CUDA ones here."""
    tflash.reset_launch_counts()
    q = torch.empty(1, 128, 2, head_dim, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 128, 1, head_dim, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="built per head dim"):
        tflash.flash_fwd(q, k, k)
    do = torch.empty_like(q)
    lse = torch.empty(1, 2, 128, device="meta")
    for fn in (tflash.flash_dq, tflash.flash_dkv):
        with pytest.raises(NotImplementedError, match="built per head dim"):
            fn(q, k, k, do, lse, lse)
    assert not any(tflash.LAUNCHES.values())


def test_head_dim_192_off_the_cpu_goes_to_its_kernel():
    """Head dim 192 (MLA) passes the head-dim check and reaches the
    kernels' own argument checks (a meta tensor is refused as not on
    CUDA), not a plain version, in each of the three wrappers."""
    q = torch.empty(1, 128, 16, 192, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 128, 16, 192, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        tflash.flash_fwd(q, k, k)
    lse = torch.empty(1, 16, 128, device="meta")
    for fn in (tflash.flash_dq, tflash.flash_dkv):
        with pytest.raises(ValueError, match="is on meta"):
            fn(q, k, k, torch.empty_like(q), lse, lse)
    assert tflash.kernel_name("flash_dkv", 192) == "flash_dkv_d192"


def test_head_dim_256_off_the_cpu_goes_to_its_kernel():
    """Head dim 256 passes the head-dim check and reaches the kernel's
    own argument checks (a meta tensor is refused as not on CUDA), not a
    plain version."""
    q = torch.empty(1, 128, 2, 256, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 128, 1, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="is on meta"):
        tflash.flash_fwd(q, k, k)


@pytest.mark.parametrize(
    "kwargs, err",
    [
        (dict(segment_ids=torch.ones(1, 8, dtype=torch.int32),
              kv_segment_ids=None, s=4), ValueError),
        (dict(h=3, kh=2), ValueError),
    ],
)
def test_flash_argument_checks(kwargs, err):
    s = kwargs.pop("s", 8)
    h, kh = kwargs.pop("h", 2), kwargs.pop("kh", 1)
    q = torch.randn(1, 8, h, 16)
    k = torch.randn(1, s, kh, 16)
    with pytest.raises(err):
        tflash.flash_attention(q, k, k, **kwargs)

