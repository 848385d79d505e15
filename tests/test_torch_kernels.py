"""tpufw_torch flash CUDA kernels vs their plain PyTorch versions, on the
card. This file imports no JAX so that it runs where the kernels do:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``tests/conftest.py`` imports JAX). Without a CUDA device it skips;
``chip_smoke.py`` holds the same kernels at the train path's shapes.
"""

import numpy as np
import pytest
import torch

from tpufw_torch.ops import flash as tflash


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as ``tests/torch_parity.py``'s fixture (which
    this file cannot import: that module imports JAX and Flax)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# Every |got - want| within ROW_TOL of the largest |want| in its row (one
# query's or one key's head vector), and the whole tensor within FRO_TOL
# in relative Frobenius norm: bf16 P and dS feed the tensor-core products
# and O and dQ are stored in bf16. A row's scale is at least ROW_FLOOR of
# the tensor's largest |want|: a row whose true value is zero (dQ of a
# query that sees one key) holds only rounding noise. LSE sums stay fp32:
# absolute LSE_TOL. The same tolerances as chip_smoke.py.
ROW_TOL = 2.0 ** -6
ROW_FLOOR = 1e-3
FRO_TOL = 1e-2
LSE_TOL = 1e-3

# name: (b, t, s, h, kh, input scale, masks). Besides the two first cases,
# the tile edges of the forward's and dQ's 128 x 128 and dK/dV's 64 x 128
# tiles: one tile and one row past it, under one tile, two batches whose
# padding rows must not reach the next batch's rows (the TMA maps are per
# batch), a t < s offset, windows at and past a tile, segment boundaries
# mid-tile.
CASES = {
    "causal_gqa_unaligned": (1, 700, 700, 4, 2, 1.0, dict(causal=True)),
    "segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        dict(causal=True, window=300, soft_cap=50.0, segments=True),
    ),
    "t129_s129": (1, 129, 129, 4, 2, 1.0, dict(causal=True)),
    "t64_s64": (1, 64, 64, 4, 2, 1.0, dict(causal=True)),
    "b2_t700_s700": (2, 700, 700, 4, 2, 1.0, dict(causal=True)),
    "b2_t700_s700_noncausal": (2, 700, 700, 4, 2, 1.0, dict(causal=False)),
    "t100_s300_offset": (1, 100, 300, 4, 2, 1.0, dict(causal=True)),
    "window128": (1, 600, 600, 4, 2, 1.0, dict(causal=True, window=128)),
    "window129": (1, 600, 600, 4, 2, 1.0, dict(causal=True, window=129)),
    "segments_mid_tile": (2, 400, 400, 4, 2, 1.0,
                          dict(causal=True, segments=True)),
}
# Head dim 256 (the *_d256 builds, Gemma-2: 128 x 64 forward and dQ tiles,
# 64 x 64 dK/dV tiles): the same edges at its tiles, and Gemma-2's masks,
# soft cap 50 with a window shorter than T.
CASES_D256 = {
    "d256_segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        dict(causal=True, window=300, soft_cap=50.0, segments=True),
    ),
    "d256_cap50_window1024": (1, 2048, 2048, 4, 2, 4.0,
                              dict(causal=True, window=1024, soft_cap=50.0)),
    "d256_t129_s129": (1, 129, 129, 4, 2, 1.0, dict(causal=True)),
    "d256_t64_s64": (1, 64, 64, 4, 2, 1.0, dict(causal=True)),
    "d256_b2_t700_s700_noncausal": (2, 700, 700, 4, 2, 1.0, dict(causal=False)),
    "d256_window65": (1, 600, 600, 4, 2, 1.0, dict(causal=True, window=65)),
    "d256_segments_mid_tile": (2, 400, 400, 4, 2, 1.0,
                               dict(causal=True, segments=True)),
}

# Head dim 192 (the *_d192 builds, DeepSeek's MLA: 128 x 64 forward and dQ
# tiles, 64 x 64 dK/dV tiles, three swizzle atoms a row): MLA's shape (16/16
# heads, V with its last 64 columns zero, as the model pads it), the same V
# random (the kernels' own contract), the masks case and the tile edges.
CASES_D192 = {
    "d192_mla_causal_zero_padded_v": (1, 1000, 1000, 16, 16, 1.0,
                                      dict(causal=True, pad_v=64)),
    "d192_mla_causal": (1, 1000, 1000, 16, 16, 1.0, dict(causal=True)),
    "d192_segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        dict(causal=True, window=300, soft_cap=50.0, segments=True),
    ),
    "d192_t129_s129": (1, 129, 129, 4, 2, 1.0, dict(causal=True)),
    "d192_t64_s64": (1, 64, 64, 4, 2, 1.0, dict(causal=True)),
    "d192_b2_t700_s700_noncausal": (2, 700, 700, 4, 2, 1.0, dict(causal=False)),
    "d192_segments_mid_tile": (2, 400, 400, 4, 2, 1.0,
                               dict(causal=True, segments=True)),
}


# The shapes a tensor shard gives the kernels on the paths the tensor axis
# reaches (each shard attends with its own heads): head dim, then
# (b, t, s, h, kh, input scale, masks) of llama3_600m_bench's 6/3 heads a
# shard (a post-trainer's 8 rows of 1023 positions; a pipeline
# microbatch's row of 2047), deepseek_mla_bench's and V2-Lite's 8/8 MLA
# heads a shard (V zero-padded) and Gemma-2-9B's 8/4 heads with its soft
# cap.
SHARD_CASES = {
    "d128_600m_post_shard": (128, (8, 1023, 1023, 6, 3, 1.0,
                                   dict(causal=True))),
    "d128_600m_pipeline_microbatch_shard": (128, (1, 2047, 2047, 6, 3, 1.0,
                                                  dict(causal=True))),
    "d192_mla_shard": (192, (2, 2047, 2047, 8, 8, 1.0,
                             dict(causal=True, pad_v=64))),
    "d256_gemma_shard": (256, (1, 2048, 2048, 8, 4, 4.0,
                               dict(causal=True, soft_cap=50.0))),
}


# The other tile builds (``tflash.BUILDS``: 64-key tiles at head dim 128,
# 64-row forward and dQ blocks at 192 and 256), each through the tile
# override at the lengths of tests/test_flash_blocks.py and the tile edges
# of its own tiles, the masks case and a two-batch non-causal one; dK/dV
# runs the head dim's build of that override (at 192 and 256 its default).
BUILD_CASES = {
    "t64": (1, 64, 64, 4, 2, 1.0, dict(causal=True)),
    "t129": (1, 129, 129, 4, 2, 1.0, dict(causal=True)),
    "t200": (1, 200, 200, 4, 2, 1.0, dict(causal=True)),
    "t640": (1, 640, 640, 4, 2, 1.0, dict(causal=True)),
    "t768": (1, 768, 768, 4, 2, 1.0, dict(causal=True)),
    "b2_t700_noncausal": (2, 700, 700, 4, 2, 1.0, dict(causal=False)),
    "segments_offset_window300_cap50": (
        1, 300, 700, 4, 2, 4.0,
        dict(causal=True, window=300, soft_cap=50.0, segments=True),
    ),
}
OTHER_BUILDS = [(d, tiles) for d in tflash.BUILDS
                for tiles in tflash.tile_choices(d)]


def _assert_close(name, got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row_max = want.abs().amax(-1, keepdim=True)
    row = (diff / torch.maximum(row_max, ROW_FLOOR * row_max.max())).max().item()
    fro = (diff.norm() / want.norm()).item()
    assert row <= ROW_TOL and fro <= FRO_TOL, f"{name}: row {row}, fro {fro}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions_on_gpu(case):
    """On the card: each kernel against its plain version in fp32 on the
    same bf16 inputs."""
    _check_case(CASES[case], 128)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES_D256))
def test_head_dim_256_kernels_match_plain_versions_on_gpu(case):
    """On the card: each head-dim-256 kernel against its plain version."""
    before = {k: v for k, v in tflash.LAUNCHES.items()}
    _check_case(CASES_D256[case], 256)
    for name in ("flash_fwd_d256", "flash_dq_d256", "flash_dkv_d256"):
        assert tflash.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES_D192))
def test_head_dim_192_kernels_match_plain_versions_on_gpu(case):
    """On the card: each head-dim-192 kernel against its plain version."""
    before = {k: v for k, v in tflash.LAUNCHES.items()}
    _check_case(CASES_D192[case], 192)
    for name in ("flash_fwd_d192", "flash_dq_d192", "flash_dkv_d192"):
        assert tflash.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_shapes_match_plain_versions_on_gpu(case):
    """On the card: each kernel at a tensor shard's shapes against its
    plain version, one launch of each."""
    d, spec = SHARD_CASES[case]
    before = {k: v for k, v in tflash.LAUNCHES.items()}
    _check_case(spec, d)
    for base in tflash.KERNELS:
        name = tflash.kernel_name(base, d)
        assert tflash.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BUILD_CASES))
@pytest.mark.parametrize("build", OTHER_BUILDS,
                         ids=lambda b: f"d{b[0]}_{b[1][0]}x{b[1][1]}")
def test_tile_builds_match_plain_versions_on_gpu(build, case):
    """On the card: each other tile build, chosen by ``block_sizes``,
    against the same plain versions; its launches land under its own
    names and no default build of a kernel it has launches."""
    d, tiles = build
    before = dict(tflash.LAUNCHES)
    _check_case(BUILD_CASES[case], d, block_sizes=tiles)
    grew = {k for k, v in tflash.LAUNCHES.items() if v != before[k]}
    assert grew == {tflash.BUILDS[d][base][tflash.resolve_tiles(
        base, d, tiles)] for base in tflash.KERNELS}, grew


def _check_case(spec, d, block_sizes=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    b, t, s, h, kh, scale, masks = spec
    masks = dict(masks)
    rng = np.random.default_rng(2)
    dev = "cuda"

    def bf16(*shape, scale=1.0):
        x = rng.standard_normal(shape, np.float32) * scale
        return torch.tensor(x, device=dev, dtype=torch.bfloat16)

    q, k = bf16(b, t, h, d, scale=scale), bf16(b, s, kh, d, scale=scale)
    v, do = bf16(b, s, kh, d), bf16(b, t, h, d)
    pad_v = masks.pop("pad_v", 0)
    if pad_v:
        v[..., d - pad_v:] = 0  # MLA's V, zero-padded to the qk head dim
    if masks.pop("segments", False):
        # Three segments; for s = 400 the boundaries (150, 300) fall inside
        # 64- and 128-row tiles.
        kseg = torch.tensor([1] * (s * 3 // 8) + [2] * (s * 3 // 8), device=dev)
        kseg = torch.cat([kseg, torch.full((s - kseg.numel(),), 3, device=dev)])
        kseg = kseg.to(torch.int32)[None].expand(b, s).contiguous()
        masks |= dict(qseg=kseg[:, s - t:].contiguous(), kseg=kseg)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = tflash.flash_fwd_reference(qf, kf, vf, **masks)
    blocks = dict(block_sizes=block_sizes)
    o, lse = tflash.flash_fwd(q, k, v, **masks, **blocks)
    _assert_close("o", o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    delta = tflash.flash_delta(o_ref, dof)
    dq = tflash.flash_dq(q, k, v, do, lse_ref, delta, **masks, **blocks)
    _assert_close("dq", dq, tflash.flash_dq_reference(
        qf, kf, vf, dof, lse_ref, delta, **masks))
    dk, dv = tflash.flash_dkv(q, k, v, do, lse_ref, delta, **masks, **blocks)
    dk_ref, dv_ref = tflash.flash_dkv_reference(
        qf, kf, vf, dof, lse_ref, delta, **masks)
    _assert_close("dk", dk, dk_ref)
    _assert_close("dv", dv, dv_ref)


@pytest.mark.cuda
def test_attn_out_train_step_matches_nothing_on_gpu():
    """On the card: one Llama train step through the head-dim-128 kernels
    under remat_policy "attn_out" against "nothing". The policy changes
    what the forward keeps, never the numbers: the same loss and
    gradients. Both re-run the attention forward in the backward (two
    forward launches a layer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    import dataclasses

    from tpufw_torch.models import LLAMA_CONFIGS, model_for_config

    cfg = dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, vocab_size=1024, attention_backend="flash",
        remat=True,
    )
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300))).cuda()
    out = {}
    for policy in ("nothing", "attn_out"):
        model = model_for_config(dataclasses.replace(cfg, remat_policy=policy),
                                 device="cuda", seed=0)
        tflash.reset_launch_counts()
        loss = model(tokens).float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        out[policy] = (loss.item(), [p.grad for p in model.parameters()],
                       dict(tflash.LAUNCHES))
    (l0, g0, n0), (l1, g1, n1) = out["nothing"], out["attn_out"]
    assert l1 == l0
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)
    for launches in (n0, n1):
        assert launches["flash_fwd"] == 2 * cfg.n_layers
        assert launches["flash_dq"] == launches["flash_dkv"] == cfg.n_layers


@pytest.mark.cuda
def test_prefetch_streams_on_gpu():
    """On the card: prefetch_to_device copies on its side stream, the
    consumer's stream waits on the copy's event, and the batches equal the
    host arrays; a second consumer stream sees them too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    from tpufw_torch.train import prefetch_to_device

    rng = np.random.default_rng(0)
    host = [{"tokens": rng.integers(0, 1000, (4, 2048), dtype=np.int32),
             "loss_mask": rng.random((4, 2048), dtype=np.float32)}
            for _ in range(8)]
    out = []
    for b in prefetch_to_device(iter(host), "cuda", buffer_size=2):
        # Work on the consumer's stream right away: it must see the data.
        out.append({k: (v * 1).cpu() for k, v in b.items()})
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        again = [{k: v.clone() for k, v in b.items()}
                 for b in prefetch_to_device(iter(host), "cuda")]
    side.synchronize()
    for o, a, h in zip(out, again, host):
        for k in h:
            np.testing.assert_array_equal(o[k].numpy(), h[k])
            np.testing.assert_array_equal(a[k].cpu().numpy(), h[k])


@pytest.mark.cuda
def test_checkpoint_round_trip_on_gpu(tmp_path):
    """On the card: a trainer's state saved from CUDA (pinned buffers, the
    background write) restores onto CUDA with equal checksums, and 2 steps
    + restore + 2 steps equal 4 steps bit for bit through the head-dim-128
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    import dataclasses

    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.train import (
        CheckpointManager,
        Trainer,
        TrainerConfig,
        synthetic_batches,
    )
    from tpufw_torch.train.checkpoint import checksums

    cfg = dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, vocab_size=1024, attention_backend="flash",
        remat=True,
    )
    batches = list(synthetic_batches(2, 257, cfg.vocab_size, n_batches=4))
    tcfg = TrainerConfig(batch_size=2, seq_len=257, total_steps=4,
                         loss_chunk_size=128, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path))
    full = Trainer(cfg, tcfg, device="cuda")
    full.init_state(seed=0)
    h_full = full.run(iter(batches), 1.0)
    state = CheckpointManager(str(tmp_path)).restore(2, device="cuda")
    assert all(t.is_cuda for t in state["model"].values())
    resumed = Trainer(cfg, dataclasses.replace(tcfg, checkpoint_dir=None),
                      device="cuda")
    resumed.load_state_dict(state)
    h_res = resumed.run(iter(batches[2:]), 1.0)
    assert [m.loss for m in h_res] == [m.loss for m in h_full[2:]]
    assert checksums(resumed.state_dict()) == checksums(full.state_dict())
