"""Flash attention on Hopper: hand-written CUDA kernels plus their plain
PyTorch versions (port of ``tpufw.ops.flash``).

The forward and backward follow the JAX package's decomposition:

- ``flash_fwd``   — O and LSE = m + log l by online softmax over kv tiles
                    (``csrc/flash_fwd.cu``, replaces ``_fwd_kernel``);
- ``flash_dq``    — dQ from recomputed P (``csrc/flash_dq.cu``, replaces
                    ``_dq_kernel``);
- ``flash_dkv``   — dK, dV per *query* head in fp32 (``csrc/flash_dkv.cu``,
                    replaces ``_dkv_kernel``);
- Δ = rowsum(dO∘O) and the GQA sum of dK/dV stay outside the kernels in
  plain torch, as in ``tpufw/ops/flash.py:497-500`` and ``:617-618``.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for CUDA tensors, or raises: there is no fallback. The kernels
take head dim 128 (Llama, Mistral, Qwen), 192 (DeepSeek's MLA, V
zero-padded to the qk head dim by the model; the ``csrc/*_d192.cu``
builds) and 256 (Gemma-2; the ``csrc/*_d256.cu`` builds), each with tiles
of its own (``TILES``) and further tilings of the same kernels
(``BUILDS``), which the tile override picks: ``block_sizes=(bq, bkv)`` on
``flash_attention`` and the wrappers, else ``TPUFW_FLASH_BQ`` /
``TPUFW_FLASH_BKV`` (``resolve_tiles``, which every launch goes through).
Each launch adds one to ``LAUNCHES[name]`` of the build it ran
(``build_name``: ``flash_fwd``, ``flash_fwd_k64``, ``flash_dq_d192_q64``
...) and, while the perf observatory counts a step, hands its
``flash_costs`` to ``COST_SINK``.

Layouts: q, O, dO, dQ are [B, T, H, D]; k, v are [B, S, K, D]; LSE and Δ
are fp32 [B, H, T]; the dK/dV kernel output is fp32 [B, H, S, D]. Query i
sits at absolute key position ``offset + i`` (default S - T). Masked
logits are filled with the finite -1e30, so the kernels treat rows that
are masked so far exactly as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpufw_torch.ops.attention import NEG_INF, tanh_soft_cap
from tpufw_torch.workloads.env import env_opt_int

# Tiles of the forward (csrc/flash_fwd.cu), dQ (csrc/flash_dq.cu) and dK/dV
# (csrc/flash_dkv.cu) kernels, by the head dims they are built for: (query
# rows, keys) per kernel. These are each head dim's default builds.
TILES = {
    128: {"fwd": (128, 128), "dq": (128, 128), "dkv": (64, 128)},
    192: {"fwd": (128, 64), "dq": (128, 64), "dkv": (64, 64)},
    256: {"fwd": (128, 64), "dq": (128, 64), "dkv": (64, 64)},
}
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# The other tilings each kernel is built at (csrc/<build name>.cu, a
# wrapper that defines TPUFW_BQ or TPUFW_BKV and includes the kernel's
# source): 64-key tiles at head dim 128, 64-row query blocks of the
# forward and dQ at 192 and 256. The notes in each kernel's source say why
# there is no other (no 32-key tile: dK/dV cannot take one; no 128-key
# tile at 192 or 256: shared memory and registers).
OTHER_TILES = {
    128: {"fwd": ((128, 64),), "dq": ((128, 64),), "dkv": ((64, 64),)},
    192: {"fwd": ((64, 64),), "dq": ((64, 64),), "dkv": ()},
    256: {"fwd": ((64, 64),), "dq": ((64, 64),), "dkv": ()},
}


def kernel_name(base: str, head_dim: int) -> str:
    """The library and launch-count name of kernel ``base``'s default
    build at ``head_dim``: ``flash_fwd`` at 128, ``flash_fwd_d192`` at
    192."""
    return base if head_dim == 128 else f"{base}_d{head_dim}"


def build_name(base: str, head_dim: int, tiles: tuple[int, int]) -> str:
    """The library and launch-count name of kernel ``base``'s build at
    ``head_dim`` with ``tiles`` (query rows, keys): the default build's
    name, plus ``_q<bq>`` and ``_k<bkv>`` for each axis that differs from
    the default (``flash_fwd_k64``, ``flash_dq_d256_q64``)."""
    dq, dk = TILES[head_dim][base.removeprefix("flash_")]
    bq, bkv = tiles
    return (kernel_name(base, head_dim) + (f"_q{bq}" if bq != dq else "")
            + (f"_k{bkv}" if bkv != dk else ""))


# {head dim: {kernel: {(query rows, keys): build name}}}, the default first.
BUILDS = {
    d: {base: {t: build_name(base, d, t)
               for t in (TILES[d][base.removeprefix("flash_")],
                         *OTHER_TILES[d][base.removeprefix("flash_")])}
        for base in KERNELS}
    for d in TILES
}


def base_kernel(name: str) -> str:
    """The kernel (``flash_fwd``, ``flash_dq`` or ``flash_dkv``) a build
    name belongs to."""
    for base in KERNELS:
        if name == base or name.startswith(base + "_"):
            return base
    raise ValueError(f"unknown flash kernel {name!r}")


def resolve_tiles(base: str, head_dim: int, block_sizes=None):
    """(query rows, keys) of the build of kernel ``base`` that a launch at
    ``head_dim`` runs: per axis the ``block_sizes`` element, else
    ``TPUFW_FLASH_BQ`` / ``TPUFW_FLASH_BKV``, else the head dim's default
    (``TILES``). ``bq`` is the query rows of a forward or dQ block; the
    dK/dV kernel's streamed query tile is its own (the override's ``bq``
    does not reach it); ``bkv`` is the keys of a tile in all three. A value
    no build has, at that head dim and for that kernel, raises
    ValueError naming its source and the built values. Returns None for
    a head dim with no build when nothing overrides (the plain versions
    take any head dim)."""
    bq, bkv = block_sizes if block_sizes is not None else (None, None)
    src_q = src_kv = "block_sizes kwarg"
    if bq is None and (e := env_opt_int("flash_bq")) is not None:
        bq, src_q = e, "TPUFW_FLASH_BQ"
    if bkv is None and (e := env_opt_int("flash_bkv")) is not None:
        bkv, src_kv = e, "TPUFW_FLASH_BKV"
    if base == "flash_dkv":
        bq = None
    builds = BUILDS.get(head_dim, {}).get(base)
    if builds is None:
        if bq is None and bkv is None:
            return None
        src = src_q if bq is not None else src_kv
        raise ValueError(
            f"flash block override (from {src}): {base} has no build at "
            f"head dim {head_dim}; built head dims: {sorted(BUILDS)}")
    dq, dk = TILES[head_dim][base.removeprefix("flash_")]
    for b, axis, src, i in ((bq, "q", src_q, 0), (bkv, "kv", src_kv, 1)):
        built = sorted({t[i] for t in builds})
        if b is not None and b not in built:
            raise ValueError(
                f"flash {axis} block {b} (from {src}) has no {base} build "
                f"at head dim {head_dim}; built: {built}")
    tiles = (dq if bq is None else bq, dk if bkv is None else bkv)
    if tiles not in builds:
        raise ValueError(
            f"flash blocks {tiles} (q from {src_q}, kv from {src_kv}) have "
            f"no {base} build at head dim {head_dim}; built: "
            f"{sorted(builds)}")
    return tiles


def tile_choices(head_dim: int) -> list:
    """The (bq, bkv) overrides that every kernel of a training step (the
    forward, dQ and dK/dV) has a build for at ``head_dim``, the default
    pair excluded: the tuner's flash axis."""
    out = []
    for tiles in BUILDS.get(head_dim, {}).get("flash_fwd", ()):
        if tiles == TILES[head_dim]["fwd"]:
            continue
        try:
            for base in KERNELS:
                resolve_tiles(base, head_dim, tiles)
        except ValueError:
            continue
        out.append(tiles)
    return out


# Kernel launches since the last reset, by build.
LAUNCHES = {name: 0 for d in BUILDS for base in KERNELS
            for name in BUILDS[d][base].values()}

# Set by ``tpufw_torch.obs.perf`` while it counts a step's costs: called
# with each launch's kernel name, FLOPs and bytes (``flash_costs``).
COST_SINK = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def visible_pairs(t, s, offset, causal, window) -> int:
    """(query, key) pairs the masks let through, per (batch, head)."""
    total = 0
    for i in range(t):
        q_pos = offset + i
        hi = min(q_pos, s - 1) if causal else s - 1
        lo = max(q_pos - window + 1, 0) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_costs(kernel, b, t, s, h, kh, d, masks=None) -> tuple[int, int]:
    """(FLOPs, bytes) of one launch of ``kernel`` (``flash_fwd``,
    ``flash_dq`` or ``flash_dkv``, under any build's name: the tiling
    changes neither) on q [b, t,
    h, d] and k/v [b, s, kh, d] under ``masks`` (``causal``, default
    True; ``window``; ``offset``, default s - t). FLOPs count the
    (query, key) pairs the causal and window masks let through (segment
    masks are not subtracted): 2 products of 2·d a pair forward, dQ's
    recomputed QKᵀ, dP and dS·K, and dK/dV's QKᵀ, dP, dSᵀ·Q and Pᵀ·dO.
    Bytes: each input read once, each output written once (LSE and Δ
    fp32, dK/dV fp32 per query head). The roofline bound of
    ``chip_smoke.py`` and the perf observatory read these counts."""
    masks = masks or {}
    causal = masks.get("causal", True)
    offset = masks.get("offset")
    offset = s - t if offset is None else offset
    pairs = b * h * visible_pairs(t, s, offset, causal, masks.get("window"))
    n_q, n_kv = b * t * h * d, b * s * kh * d
    rows = b * h * t
    base = base_kernel(kernel)
    if base == "flash_fwd":
        return 4 * pairs * d, 2 * (n_q + 2 * n_kv) + 2 * n_q + 4 * rows
    if base == "flash_dq":
        return (6 * pairs * d,
                2 * (2 * n_q + 2 * n_kv) + 8 * rows + 2 * n_q)
    if base == "flash_dkv":
        return (8 * pairs * d,
                2 * (2 * n_q + 2 * n_kv) + 8 * rows + 2 * 4 * b * h * s * d)
    raise ValueError(f"unknown flash kernel {kernel!r}")


def _count_costs(base, b, t, s, h, kh, d, causal, offset, window,
                 name=None) -> None:
    """Hand one launch's costs to ``COST_SINK`` when a count is on, under
    the build's ``name`` (default: the head dim's default build)."""
    sink = COST_SINK
    if sink is not None:
        sink(name or kernel_name(base, d), *flash_costs(
            base, b, t, s, h, kh, d,
            {"causal": causal, "offset": offset, "window": window}))


# ---------------------------------------------------------------------------
# Plain versions: the same functions over materialized [B, H, T, S] logits.
# ---------------------------------------------------------------------------


def _mask(t, s, offset, causal, window, qseg, kseg, device):
    """[B or 1, 1, T, S] bool: which (query, key) pairs may attend."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones(t, s, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    mask = mask[None, None]
    if qseg is not None:
        mask = mask & (qseg[:, None, :, None] == kseg[:, None, None, :])
    return mask


def _heads(x, rep=1):
    """[B, N, K, D] -> fp32 [B, K*rep, N, D] (query-head layout)."""
    x = x.float()
    if rep > 1:
        b, n, k, d = x.shape
        x = x[:, :, :, None, :].expand(b, n, k, rep, d).reshape(
            b, n, k * rep, d
        )
    return x.transpose(1, 2)


def _capped_logits(q, k, soft_cap):
    """cap(scale · qkᵀ), fp32 [B, H, T, S]."""
    rep = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _heads(q) @ _heads(k, rep).transpose(-1, -2) * scale
    return logits if soft_cap is None else tanh_soft_cap(logits, soft_cap)


def flash_fwd_reference(
    q, k, v, *, causal=True, offset=None, soft_cap=None, window=None,
    qseg=None, kseg=None,
):
    """(O [B,T,H,D] in q.dtype, LSE fp32 [B,H,T]) — the forward kernel's
    function, computed in fp32 over the whole key axis at once."""
    b, t, h, d = q.shape
    s = k.shape[1]
    offset = s - t if offset is None else offset
    capped = _capped_logits(q, k, soft_cap)
    mask = _mask(t, s, offset, causal, window, qseg, kseg, q.device)
    logits = torch.where(mask, capped, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p / l) @ _heads(v, h // v.shape[2])
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def _bwd_probs(q, k, v, do, lse, delta, causal, offset, soft_cap, window,
               qseg, kseg):
    """Recomputed P and dS, fp32 [B, H, T, S], as both bwd kernels form
    them: P = exp(cap(scale·qkᵀ) − lse) under the mask, dS = P∘(dP − Δ)
    times the soft cap's derivative."""
    t, s = q.shape[1], k.shape[1]
    offset = s - t if offset is None else offset
    capped = _capped_logits(q, k, soft_cap)
    mask = _mask(t, s, offset, causal, window, qseg, kseg, q.device)
    p = torch.where(mask, torch.exp(capped - lse[..., None]), 0.0)
    dp = _heads(do) @ _heads(v, q.shape[2] // v.shape[2]).transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    if soft_cap is not None:
        ds = ds * (1.0 - (capped / soft_cap) ** 2)
    return p, ds


def flash_dq_reference(
    q, k, v, do, lse, delta, *, causal=True, offset=None, soft_cap=None,
    window=None, qseg=None, kseg=None,
):
    """dQ [B,T,H,D] in q.dtype: scale · dS·K."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, offset, soft_cap,
                       window, qseg, kseg)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = ds @ _heads(k, q.shape[2] // k.shape[2]) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_dkv_reference(
    q, k, v, do, lse, delta, *, causal=True, offset=None, soft_cap=None,
    window=None, qseg=None, kseg=None,
):
    """(dK, dV), fp32 [B, H, S, D] per QUERY head: dV = Pᵀ·dO and
    dK = scale · dSᵀ·q. The GQA group sum happens in the caller."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, offset, soft_cap,
                       window, qseg, kseg)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = p.transpose(-1, -2) @ _heads(do)
    dk = ds.transpose(-1, -2) @ _heads(q) * scale
    return dk, dv


# ---------------------------------------------------------------------------
# Loop bounds of the kernels, as the CUDA sources compute them. Each function
# mirrors a device function of its .cu: an edit to one must be made in both.
# ---------------------------------------------------------------------------


def _div(a: int, b: int) -> int:
    """C's truncating division (``jax.lax.div``), b > 0."""
    return -((-a) // b) if a < 0 else a // b


def fwd_kv_tiles(qt, t, s, offset, causal, window, head_dim=128,
                 tiles=None):
    """[j0, j_hi): the kv tiles forward query tile ``qt`` visits
    (``kv_tiles`` in csrc/flash_common.cuh) at the build's ``tiles``
    (default: ``head_dim``'s default build): up to the causal diagonal,
    from the window's first key. ``t`` is unused, as in the kernel."""
    bq, bkv = tiles or TILES[head_dim]["fwd"]
    n_kv = -(-s // bkv)
    j_hi = min(_div((qt + 1) * bq + offset + bkv - 1, bkv), n_kv) if causal \
        else n_kv
    j0 = max(_div(qt * bq + offset - window + 1, bkv), 0) \
        if window is not None else 0
    return j0, j_hi


# dQ walks the forward's kv loop: csrc/flash_dq.cu calls the same device
# function (``kv_tiles``), and its builds have the forward's tiles
# (BUILDS[d]["flash_dq"] and ["flash_fwd"] hold the same pairs).
dq_kv_tiles = fwd_kv_tiles


def dkv_q_tiles(jt, t, s, offset, causal, window, head_dim=128,
                tiles=None):
    """[i0, i_hi): the query tiles the dK/dV kernel visits for kv tile
    ``jt`` (``q_tiles`` in csrc/flash_dkv.cu) at the build's ``tiles``
    (default: ``head_dim``'s default build): from the causal first to the
    window's last. ``s`` is unused, as in the kernel."""
    bq, bkv = tiles or TILES[head_dim]["dkv"]
    n_q = -(-t // bq)
    k0 = jt * bkv
    i0 = max(_div(k0 - offset, bq), 0) if causal else 0
    i_hi = n_q
    if window is not None:
        last_q = k0 + bkv - 1 + window - 1 - offset
        i_hi = max(min(_div(last_q, bq) + 1, n_q), i0)
    return i0, i_hi


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _ptr(x: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _check_cuda(names_tensors, dtype):
    for name, x in names_tensors:
        if x is None:
            continue
        if x.device.type != "cuda":
            raise ValueError(f"flash kernel: {name} is on {x.device}")
        if x.dtype != dtype:
            raise TypeError(
                f"flash kernel: {name} is {x.dtype}, expected {dtype}"
            )
        # TMA needs a 16-byte aligned base; every row stride (H*D*2,
        # KV*D*2 bytes) is then a multiple of 16 as well.
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"flash kernel: {name} must be contiguous and 16-byte "
                "aligned"
            )


def _check_qkv(q, k, v):
    if q.shape[-1] not in TILES:
        raise NotImplementedError(
            f"flash CUDA kernels take head_dim {tuple(TILES)}, got "
            f"{q.shape[-1]}: each kernel is built per head dim (BUILDS)"
        )
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash CUDA kernels take bfloat16, got {q.dtype}")
    _check_cuda([("q", q), ("k", k), ("v", v)], torch.bfloat16)


def _seg_args(qseg, kseg):
    if qseg is None:
        return None, None
    qseg, kseg = qseg.to(torch.int32), kseg.to(torch.int32)
    _check_cuda([("segment_ids", qseg), ("kv_segment_ids", kseg)],
                torch.int32)
    return qseg, kseg


def _mask_args(causal, offset, soft_cap, window):
    return (
        ctypes.c_int(int(causal)),
        ctypes.c_int(int(offset)),
        ctypes.c_int(window is not None),
        ctypes.c_int(0 if window is None else int(window)),
        ctypes.c_int(soft_cap is not None),
        ctypes.c_float(0.0 if soft_cap is None else float(soft_cap)),
    )


def _launch(base, head_dim, tiles, *args) -> str:
    """Launch kernel ``base`` of the build at ``head_dim`` and ``tiles``
    on the current stream; count it. Returns the build's name."""
    from tpufw_torch.ops import _build

    name = build_name(base, head_dim, tiles)
    fn = getattr(_build.library(name), f"tpufw_{base}")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return name


def flash_fwd(
    q, k, v, *, causal=True, offset=None, soft_cap=None, window=None,
    qseg=None, kseg=None, block_sizes=None,
):
    """(O, LSE): the forward kernel on CUDA tensors, its plain version on
    CPU tensors. ``block_sizes``: the tile override (``resolve_tiles``),
    checked on either device."""
    tiles = resolve_tiles("flash_fwd", q.shape[-1], block_sizes)
    if q.device.type == "cpu":
        return flash_fwd_reference(
            q, k, v, causal=causal, offset=offset, soft_cap=soft_cap,
            window=window, qseg=qseg, kseg=kseg,
        )
    _check_qkv(q, k, v)
    qseg, kseg = _seg_args(qseg, kseg)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    offset = s - t if offset is None else offset
    o = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    name = _launch(
        "flash_fwd", d, tiles,
        _ptr(q), _ptr(k), _ptr(v), _ptr(qseg), _ptr(kseg), _ptr(o),
        _ptr(lse), b, t, s, h, kh,
        *_mask_args(causal, offset, soft_cap, window),
    )
    _count_costs("flash_fwd", b, t, s, h, kh, d, causal, offset, window,
                 name)
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta, qseg, kseg):
    _check_qkv(q, k, v)
    _check_cuda([("dO", do)], torch.bfloat16)
    _check_cuda([("lse", lse), ("delta", delta)], torch.float32)
    return _seg_args(qseg, kseg)


def flash_dq(
    q, k, v, do, lse, delta, *, causal=True, offset=None, soft_cap=None,
    window=None, qseg=None, kseg=None, block_sizes=None,
):
    """dQ [B,T,H,D]: the dq kernel on CUDA tensors, its plain version on
    CPU tensors."""
    tiles = resolve_tiles("flash_dq", q.shape[-1], block_sizes)
    if q.device.type == "cpu":
        return flash_dq_reference(
            q, k, v, do, lse, delta, causal=causal, offset=offset,
            soft_cap=soft_cap, window=window, qseg=qseg, kseg=kseg,
        )
    qseg, kseg = _bwd_inputs(q, k, v, do, lse, delta, qseg, kseg)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    offset = s - t if offset is None else offset
    dq = torch.empty_like(q)
    name = _launch(
        "flash_dq", d, tiles,
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(qseg), _ptr(kseg), _ptr(dq), b, t, s, h, kh,
        *_mask_args(causal, offset, soft_cap, window),
    )
    _count_costs("flash_dq", b, t, s, h, kh, d, causal, offset, window,
                 name)
    return dq


def flash_dkv(
    q, k, v, do, lse, delta, *, causal=True, offset=None, soft_cap=None,
    window=None, qseg=None, kseg=None, block_sizes=None,
):
    """(dK, dV) fp32 [B,H,S,D] per query head: the dk/dv kernel on CUDA
    tensors, its plain version on CPU tensors."""
    tiles = resolve_tiles("flash_dkv", q.shape[-1], block_sizes)
    if q.device.type == "cpu":
        return flash_dkv_reference(
            q, k, v, do, lse, delta, causal=causal, offset=offset,
            soft_cap=soft_cap, window=window, qseg=qseg, kseg=kseg,
        )
    qseg, kseg = _bwd_inputs(q, k, v, do, lse, delta, qseg, kseg)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    offset = s - t if offset is None else offset
    # The kernel stores whole key tiles: pad S, slice after.
    bkv = tiles[1]
    s_pad = -(-s // bkv) * bkv
    dk = torch.empty(b, h, s_pad, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    name = _launch(
        "flash_dkv", d, tiles,
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
        _ptr(qseg), _ptr(kseg), _ptr(dk), _ptr(dv), b, t, s, h, kh,
        *_mask_args(causal, offset, soft_cap, window),
    )
    _count_costs("flash_dkv", b, t, s, h, kh, d, causal, offset, window,
                 name)
    return dk[:, :, :s], dv[:, :, :s]


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O), fp32 [B, H, T]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def gqa_sum(dx_full: torch.Tensor, kv_heads: int, dtype) -> torch.Tensor:
    """fp32 [B, H, S, D] per query head -> [B, S, K, D] in ``dtype``."""
    b, h, s, d = dx_full.shape
    dx = dx_full.reshape(b, kv_heads, h // kv_heads, s, d).sum(2)
    return dx.transpose(1, 2).to(dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, soft_cap, window, offset,
                block_sizes):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        masks = dict(causal=causal, soft_cap=soft_cap, window=window,
                     qseg=qseg, kseg=kseg, offset=offset,
                     block_sizes=block_sizes)
        o, lse = flash_fwd(q, k, v, **masks)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = masks
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(o, g)
        dq = flash_dq(q, k, v, g, lse, delta, **ctx.masks)
        dk_full, dv_full = flash_dkv(q, k, v, g, lse, delta, **ctx.masks)
        kh = k.shape[2]
        return (
            dq,
            gqa_sum(dk_full, kh, k.dtype),
            gqa_sum(dv_full, kh, v.dtype),
            None, None, None, None, None, None, None,
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    offset: Optional[int] = None,
    block_sizes: Optional[tuple] = None,
) -> torch.Tensor:
    """Flash attention. q:[B,T,H,D], k/v:[B,S,K,D] -> [B,T,H,D].

    ``segment_ids`` ([B, T] int) masks cross-segment attention for packed
    batches; ``kv_segment_ids`` ([B, S]) defaults to ``segment_ids``
    (which then requires T == S). ``logits_soft_cap`` applies
    ``cap * tanh(logits / cap)`` to the scaled logits before the mask.
    ``offset`` is the key position of query 0 (default S - T).

    ``block_sizes`` is an explicit (bq, bkv) tile override for the forward
    and both backward kernels (either element None: that axis falls to
    ``TPUFW_FLASH_BQ`` / ``TPUFW_FLASH_BKV``, else the head dim's default);
    a value no build has raises ValueError (``resolve_tiles``). The
    kernels mask the ragged tail themselves, so no value has to divide the
    sequence. No kwarg and no env: the default builds, as before.
    """
    h, kh = q.shape[2], k.shape[2]
    if h % kh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kh}")
    qseg = segment_ids
    kseg = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if (qseg is None) != (kseg is None):
        raise ValueError(
            "segment_ids and kv_segment_ids must be given together"
        )
    if qseg is not None and kv_segment_ids is None and (
        q.shape[1] != k.shape[1]
    ):
        raise ValueError(
            f"segment_ids without kv_segment_ids requires T==S "
            f"(self-attention); got T={q.shape[1]}, S={k.shape[1]}"
        )
    if qseg is not None:
        qseg, kseg = qseg.contiguous(), kseg.contiguous()
    cap = None if logits_soft_cap is None else float(logits_soft_cap)
    win = None if sliding_window is None else int(sliding_window)
    blocks = None if block_sizes is None else tuple(block_sizes)
    # Checked here too, before any kernel or plain version runs.
    for base in KERNELS:
        resolve_tiles(base, q.shape[-1], blocks)
    return _Flash.apply(q, k, v, qseg, kseg, causal, cap, win, offset,
                        blocks)
