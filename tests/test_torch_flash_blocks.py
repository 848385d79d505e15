"""The port's flash tile override against ``tpufw``'s
(``tests/test_flash_blocks.py`` case for case), on the CPU, where the
wrappers run the plain versions after checking the override.

- Lengths whose tiles leave a ragged tail (640, 768, 200): outputs and dQ
  of ``flash_attention`` with and without ``block_sizes`` against
  ``tpufw``'s ``flash_attention(interpret=True)`` on the same numpy-seeded
  inputs, at 2e-5 (outputs) and 5e-4 (gradients), the tolerances of
  ``tpufw``'s test. Head dim 128, the port's builds; ``tpufw`` at its
  128 x 128 blocks, the port at its 64-key build.
- The precedence: the kwarg over ``TPUFW_FLASH_BQ``/``TPUFW_FLASH_BKV``
  over the head dim's default, per axis, resolved once for every kernel.
- Each error names its source and the built values. By design the port
  takes any built value (64-multiples, 64 keys at head dim 128) without
  ``tpufw``'s rule that a block divide the padded length: its kernels mask
  the ragged tail (ROADMAP.md Queue 2, divergences by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw.ops.flash import flash_attention as j_flash
from tpufw_torch.ops import flash as tflash

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture(autouse=True)
def no_block_env(monkeypatch):
    monkeypatch.delenv("TPUFW_FLASH_BQ", raising=False)
    monkeypatch.delenv("TPUFW_FLASH_BKV", raising=False)


def _qkv(t, b=1, h=2, kh=1, d=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32),
            rng.standard_normal((b, t, kh, d), np.float32))


def _jax(q, k, v, blocks):
    """tpufw's output and d(sum out^2)/dq, jitted."""
    k, v = jnp.asarray(k), jnp.asarray(v)

    def fn(q):
        return j_flash(q, k, v, causal=True, interpret=True,
                       block_sizes=blocks)

    out = jax.jit(fn)(jnp.asarray(q))
    g = jax.jit(jax.grad(lambda q: (fn(q) ** 2).sum()))(jnp.asarray(q))
    return np.asarray(out), np.asarray(g)


def _port(q, k, v, blocks):
    qt = torch.tensor(q, requires_grad=True)
    out = tflash.flash_attention(qt, torch.tensor(k), torch.tensor(v),
                                 causal=True, block_sizes=blocks)
    (out ** 2).sum().backward()
    return out.detach().numpy(), qt.grad.numpy()


@pytest.mark.parametrize("t", [640, 768, 200])
@pytest.mark.parametrize("blocks", [None, "override"])
def test_flash_odd_lengths_match_tpufw(t, blocks):
    """Outputs and dQ at lengths with a ragged tail, default tiles and an
    override (tpufw: 128 x 128; the port: its 64-key build)."""
    q, k, v = _qkv(t)
    j_blocks, t_blocks = (None, None) if blocks is None else (
        (128, 128), (128, 64))
    out_j, g_j = _jax(q, k, v, j_blocks)
    out_t, g_t = _port(q, k, v, t_blocks)
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    np.testing.assert_allclose(g_t, g_j, **GRAD_TOL)


def test_block_size_override_matches_default():
    """An override re-tiles and never changes the math: with and without
    it the plain versions agree exactly, forward and backward."""
    q, k, v = _qkv(256)
    assert all(np.array_equal(a, b) for a, b in zip(
        _port(q, k, v, None), _port(q, k, v, (128, 64))))
    assert all(np.array_equal(a, b) for a, b in zip(
        _port(q, k, v, None), _port(q, k, v, (None, 64))))


def test_env_override_applies_and_validates(monkeypatch):
    """TPUFW_FLASH_BQ/BKV pick the build when the kwarg leaves an axis
    None, the kwarg wins where it is set, and a value with no build names
    its variable (tpufw's test: a block its rule refuses names
    TPUFW_FLASH_BQ)."""
    q, k, v = _qkv(256)
    ref, j_ref = _port(q, k, v, None), _jax(q, k, v, None)[0]
    # 128 x 128 is a build of the port and a valid block of tpufw's.
    monkeypatch.setenv("TPUFW_FLASH_BQ", "128")
    monkeypatch.setenv("TPUFW_FLASH_BKV", "128")
    np.testing.assert_allclose(_jax(q, k, v, None)[0], j_ref, **OUT_TOL)
    np.testing.assert_allclose(_port(q, k, v, None)[0], j_ref, **OUT_TOL)
    monkeypatch.setenv("TPUFW_FLASH_BKV", "64")
    assert [tflash.resolve_tiles(b, 128) for b in tflash.KERNELS] == [
        (128, 64), (128, 64), (64, 64)]
    assert tflash.resolve_tiles("flash_fwd", 128, (None, 128)) == (128, 128)
    got = _port(q, k, v, None)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    # A block with no build names its source (tpufw's: one that does not
    # divide the padded length).
    monkeypatch.setenv("TPUFW_FLASH_BKV", "128")
    monkeypatch.setenv("TPUFW_FLASH_BQ", "384")
    with pytest.raises(ValueError, match="TPUFW_FLASH_BQ") as got:
        _port(q, k, v, None)
    assert "built: [128]" in str(got.value)
    with pytest.raises(ValueError, match="TPUFW_FLASH_BQ"):
        _jax(q, k, v, None)
    monkeypatch.delenv("TPUFW_FLASH_BQ")
    monkeypatch.setenv("TPUFW_FLASH_BKV", "96")
    with pytest.raises(ValueError, match="TPUFW_FLASH_BKV") as got:
        _port(q, k, v, None)
    assert "built: [64, 128]" in str(got.value)


def test_bad_kwarg_blocks_rejected():
    """A kwarg value no build has raises before any kernel or plain
    version runs, naming the kwarg and the built values; the wrappers
    check it as flash_attention does."""
    q, k, v = (torch.tensor(x) for x in _qkv(256))
    with pytest.raises(ValueError, match="block_sizes kwarg.*built: "
                                         r"\[128\]"):
        tflash.flash_attention(q, k, v, block_sizes=(100, 128))
    with pytest.raises(ValueError, match="block_sizes kwarg.*built: "
                                         r"\[64, 128\]"):
        tflash.flash_attention(q, k, v, block_sizes=(128, 512))
    with pytest.raises(ValueError, match="block_sizes kwarg"):
        tflash.flash_fwd(q, k, v, block_sizes=(64, None))
    # A head dim with no build at all: any override raises, none passes.
    small = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="no build at head dim 16"):
        tflash.flash_attention(small, small[:, :, :1], small[:, :, :1],
                               block_sizes=(None, 64))
    tflash.flash_attention(small, small[:, :, :1], small[:, :, :1])


@pytest.mark.parametrize("d", sorted(tflash.BUILDS))
def test_builds_and_names(d):
    """Every head dim's builds: the default first under the head dim's
    name (``TILES``), the others under ``_q<bq>``/``_k<bkv>`` names, each
    counted in LAUNCHES, each mapped back to its kernel by flash_costs
    (the tiling changes neither FLOPs nor bytes), and ``tile_choices``
    the overrides a whole training step can take."""
    for base in tflash.KERNELS:
        builds = tflash.BUILDS[d][base]
        default = next(iter(builds))
        assert default == tflash.TILES[d][base.removeprefix("flash_")]
        assert builds[default] == tflash.kernel_name(base, d)
        for tiles, name in builds.items():
            assert name in tflash.LAUNCHES
            assert tflash.base_kernel(name) == base
            assert tflash.flash_costs(name, 1, 300, 300, 4, 2, d) == \
                tflash.flash_costs(base, 1, 300, 300, 4, 2, d)
            assert tflash.resolve_tiles(base, d, tiles) == tiles
    assert tflash.tile_choices(d) == {128: [(128, 64)], 192: [(64, 64)],
                                      256: [(64, 64)]}[d]
    # dK/dV's streamed query tile is its own: bq does not reach it.
    assert tflash.resolve_tiles("flash_dkv", d, (64, None)) == \
        tflash.TILES[d]["dkv"]


@pytest.mark.parametrize("d,tiles", [(d, t) for d in tflash.BUILDS
                                     for t in tflash.tile_choices(d)])
def test_loop_bounds_cover_every_pair_at_each_build(d, tiles):
    """The loop bounds at a build's tiles (``fwd_kv_tiles`` with
    ``tiles=``, ``dkv_q_tiles`` at that build's dK/dV tiles) visit every
    visible (query, key) pair, at the lengths above and a window."""
    dkv = tflash.resolve_tiles("flash_dkv", d, tiles)
    for t, window in ((640, None), (768, None), (200, None), (300, 129)):
        visible = tflash._mask(t, t, 0, True, window, None, None,
                               "cpu")[0, 0]
        qi, ki = visible.nonzero(as_tuple=True)
        bq, bkv = tiles
        fwd = torch.tensor([tflash.fwd_kv_tiles(i, t, t, 0, True, window, d,
                                                tiles)
                            for i in range(-(-t // bq))])
        kt = ki // bkv
        assert ((fwd[qi // bq, 0] <= kt) & (kt < fwd[qi // bq, 1])).all()
        dq_, dk_ = dkv
        back = torch.tensor([tflash.dkv_q_tiles(j, t, t, 0, True, window, d,
                                                dkv)
                             for j in range(-(-t // dk_))])
        it = qi // dq_
        assert ((back[ki // dk_, 0] <= it) & (it < back[ki // dk_, 1])).all()
