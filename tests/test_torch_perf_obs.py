"""The port's perf observatory (``tpufw_torch.obs.perf``, ``roofline``)
against ``tests/test_perf_obs.py``, case for case, and its FLOP count
against a hand count.

``tpufw`` reads a compiled program's FLOPs from XLA's ``cost_analysis``,
which counts elementwise work too, so its total is no yardstick here:
the port counts the aten matmul, convolution and attention products
(``torch.utils.flop_counter``'s formulas) of one real step, plus the
flash kernels' ``flash_costs`` at each launch. So the count is held to a
hand count written out from the config's shapes, exactly; the
roofline math and the gauges to a hand computation, as in ``tpufw``'s
test; and ``flash_costs`` to the bounds ``chip_smoke.py`` printed for
phase 2's shapes. The traces the port's tracer writes go through
``tpufw``'s ``scripts/trace_merge.py`` unchanged.
"""

import dataclasses
import json
import os
import sys
import time

import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.obs import trace as trace_mod
from tpufw_torch.obs.perf import (
    NULL,
    PerfObservatory,
    ProfileTrigger,
    load_programs,
    parse_profile_steps,
    resolve_profile_window,
)
from tpufw_torch.obs.registry import Registry
from tpufw_torch.obs.roofline import (
    PeakSpec,
    attainable_flops_per_s,
    classify,
    detect_peaks,
    peaks_from_spec,
)
from tpufw_torch.ops import flash

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import trace_merge  # noqa: E402  (scripts/ is not a package)

CPU_PEAKS = PeakSpec("test", 1e12, 1e11, 16_000_000_000)


# ----------------------------------------------------------- the count


def test_observe_step_counts_costs_on_cpu(tmp_path):
    """One real call counted: a 64x64x48 matmul is 2·64·64·48 FLOPs and
    moves its two inputs and its output; programs.json parses; a second
    call with the name runs uncounted and returns its result."""
    obs = PerfObservatory(registry=Registry(), out_dir=str(tmp_path),
                          peaks=CPU_PEAKS, device="cpu")
    a, b = torch.ones(64, 64), torch.ones(64, 48)
    assert obs.will_observe("matmul")
    out = obs.observe_step("matmul", torch.mm, a, b)
    assert torch.equal(out, a @ b)
    snap = obs.snapshot()["matmul"]
    assert snap["flops"] == 2 * 64 * 64 * 48
    assert snap["aten_flops_by_op"] == {"aten.mm": 2 * 64 * 64 * 48}
    assert snap["bytes_accessed"] == 4 * (64 * 64 + 64 * 48 + 64 * 48)
    assert snap["ai_flops_per_byte"] == pytest.approx(
        snap["flops"] / snap["bytes_accessed"])
    doc = load_programs(str(tmp_path))
    assert doc is not None and "matmul" in doc["programs"]
    assert not obs.will_observe("matmul")
    assert torch.equal(obs.observe_step("matmul", torch.mm, b.T, a),
                       b.T @ a)
    assert obs.snapshot()["matmul"] == snap


def test_observe_step_failure_records_error_and_never_raises(
        tmp_path, monkeypatch):
    """A counter that fails records its error and the call's result
    still comes back; an error of the call itself propagates."""
    from torch.utils import flop_counter

    def broken(*a, **k):
        raise RuntimeError("formula broke")

    monkeypatch.setitem(flop_counter.flop_registry,
                        torch.ops.aten.mm, broken)
    obs = PerfObservatory(out_dir=str(tmp_path), peaks=CPU_PEAKS,
                          device="cpu")
    a = torch.ones(8, 8)
    assert torch.equal(obs.observe_step("broken", torch.mm, a, a), a @ a)
    snap = obs.snapshot()["broken"]
    assert "formula broke" in snap["error"]
    # and the failed count is latched, not retried
    obs.observe_step("broken", torch.mm, a, a)
    assert obs.snapshot()["broken"] == snap
    with pytest.raises(RuntimeError, match="size mismatch|shapes cannot"):
        obs.observe_step("bad_call", torch.mm, a, torch.ones(3, 3))


def _hand_count(cfg, b, t, policy, chunk):
    """Matmul FLOPs of one train step of ``cfg`` (Llama) on b rows of t
    input positions: every projection's forward 2·m·n·k and its two
    backward products (dX and dW), the LM head likewise; the plain
    attention's full T × S products, QKᵀ and PV forward and dS, dV, dQ,
    dK backward; plus each policy's recompute and the chunked CE's."""
    n = b * t
    d, dh = cfg.d_model, cfg.head_dim
    hq, hk, ff, v = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    proj = {"q": d * hq * dh, "k": d * hk * dh, "v": d * hk * dh,
            "o": hq * dh * d, "gate": d * ff, "up": d * ff, "down": ff * d}
    block = sum(proj.values())
    fwd_proj = 2 * n * block
    attn_fwd = 2 * (2 * b * hq * t * t * dh)
    count = cfg.n_layers * (3 * fwd_proj + 3 * attn_fwd) + 3 * 2 * n * d * v
    # Recompute under torch.utils.checkpoint (non-reentrant): a
    # checkpointed region is replayed up to the last tensor its backward
    # needs, so the op that ENDS a region (the down projection; under
    # attn_out also the o projection, which ends `attend`) is not
    # replayed. "dots" keeps every projection output and replays the
    # attention's batched products.
    if policy == "nothing":
        count += cfg.n_layers * (
            2 * n * (block - proj["down"]) + attn_fwd)
    elif policy == "attn_out":
        count += cfg.n_layers * (
            2 * n * (block - proj["down"] - proj["o"]) + attn_fwd)
    elif policy == "dots":
        count += cfg.n_layers * attn_fwd
    if chunk:
        # The chunked CE recomputes each chunk's logits in its backward.
        count += 2 * n * d * v
    return count


@pytest.mark.parametrize("policy,chunk", [
    (None, None), ("everything", None), ("nothing", None), ("dots", None),
    ("attn_out", None), ("nothing", 8),
])
def test_train_step_matmul_flops_equal_hand_count(policy, chunk):
    """llama3_tiny in fp32, B=8 × 16 positions: the counted matmul FLOPs
    equal the hand count exactly. Without remat (None) and under
    "everything" nothing is recomputed; "nothing" replays each block's
    forward but its last projection (+7.9e6 a layer here: the six
    earlier projections and the attention forward), "attn_out" also
    skips the o projection (+6.8e6), "dots" only the attention's products
    (+5.2e5); the chunked CE (chunk 8) replays the head (+4.2e6)."""
    from tpufw_torch.models import LLAMA_CONFIGS
    from tpufw_torch.train import Trainer, TrainerConfig, synthetic_batches

    cfg = dataclasses.replace(
        LLAMA_CONFIGS["llama3_tiny"], dtype=torch.float32,
        remat=policy is not None, remat_policy=policy or "dots")
    tr = Trainer(cfg, TrainerConfig(batch_size=8, seq_len=17, total_steps=1,
                                    loss_chunk_size=chunk,
                                    loss_chunk_dtype="float32"),
                 device="cpu")
    tr.init_state()
    batch = next(synthetic_batches(8, 17, cfg.vocab_size, seed=0))
    obs = PerfObservatory(peaks=CPU_PEAKS, device="cpu")
    m = obs.observe_step("train_step", tr.train_step, batch)
    assert torch.isfinite(m["loss"])
    got = obs.snapshot()["train_step"]
    assert got["flops"] == got["aten_flops"] == _hand_count(
        cfg, 8, 16, policy, chunk)
    assert set(got["aten_flops_by_op"]) == {"aten.mm", "aten.bmm"}
    assert got["flash"] == {}  # the CPU runs the plain versions


def _bound_ms(kernel, b, t, h, kh, d, masks):
    flops, nbytes = flash.flash_costs(kernel, b, t, t, h, kh, d, masks)
    return max(flops / 989e12, nbytes / 3.35e12) * 1e3


@pytest.mark.parametrize("d,b,t,h,kh,masks,want", [
    (128, 2, 2047, 32, 8, {"causal": True}, (0.0694, 0.1042, 0.1389)),
    (256, 1, 8191, 16, 8, {"causal": True, "soft_cap": 50.0},
     (0.5558, 0.8337, 1.1116)),
    (256, 1, 8191, 16, 8, {"causal": True, "soft_cap": 50.0,
                           "window": 4096}, (0.4169, 0.6253, 0.8337)),
    (192, 8, 2047, 16, 16, {"causal": True}, (0.2083, 0.3125, 0.4167)),
], ids=["d128", "d256", "d256_window4096", "d192"])
def test_flash_costs_give_chip_smoke_bounds(d, b, t, h, kh, masks, want):
    """``flash_costs`` at phase 2's shapes gives the bound column
    ``chip_smoke.py`` printed on the H100 (PERF.md's kernel table), whose
    counts it now reads: 2·2·d FLOPs a visible (query, key) pair forward,
    3·2·d for dQ, 4·2·d for dK/dV."""
    pairs = b * h * flash.visible_pairs(t, t, 0, True, masks.get("window"))
    for i, base in enumerate(flash.KERNELS):
        flops, _ = flash.flash_costs(flash.kernel_name(base, d), b, t, t, h,
                                     kh, d, masks)
        assert flops == (4, 6, 8)[i] * pairs * d
        assert round(_bound_ms(base, b, t, h, kh, d, masks), 4) == want[i]
    if "window" not in masks:
        assert pairs == b * h * t * (t + 1) // 2
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "flash.flash_costs(base, b, t, s, h, kh, d, masks)" in src


def test_flash_launch_costs_reach_the_count():
    """Each launch hands its ``flash_costs`` to the observatory while a
    step is counted (the CUDA wrappers call ``_count_costs`` after the
    launch; here a step calls it as they do), and nothing after."""
    obs = PerfObservatory(peaks=CPU_PEAKS, device="cpu")

    def step():
        for base in ("flash_fwd", "flash_fwd", "flash_dq", "flash_dkv"):
            flash._count_costs(base, 4, 2047, 2047, 12, 6, 128, True, 0,
                               None)
        return 1

    assert obs.observe_step("train_step", step) == 1
    got = obs.snapshot()["train_step"]
    fwd = flash.flash_costs("flash_fwd", 4, 2047, 2047, 12, 6, 128)
    dq = flash.flash_costs("flash_dq", 4, 2047, 2047, 12, 6, 128)
    dkv = flash.flash_costs("flash_dkv", 4, 2047, 2047, 12, 6, 128)
    assert got["flash"] == {
        "flash_fwd": {"launches": 2, "flops": 2 * fwd[0],
                      "bytes": 2 * fwd[1]},
        "flash_dq": {"launches": 1, "flops": dq[0], "bytes": dq[1]},
        "flash_dkv": {"launches": 1, "flops": dkv[0], "bytes": dkv[1]},
    }
    assert got["flops"] == got["flash_flops"] == 2 * fwd[0] + dq[0] + dkv[0]
    assert flash.COST_SINK is None
    flash._count_costs("flash_fwd", 1, 8, 8, 1, 1, 128, True, 0, None)


# ------------------------------------------------------ MFU gauge math


def _fixture_obs(registry=None):
    # Hand-computable peaks: 1 TFLOP/s, 100 GB/s (balance = 10
    # FLOPs/byte), 16 GB HBM.
    return PerfObservatory(registry=registry, peaks=CPU_PEAKS)


def test_mfu_and_roofline_gauges_match_hand_computation():
    reg = Registry()
    obs = _fixture_obs(reg)
    obs.record_costs(
        "p",
        flops=2e9,
        bytes_accessed=1e9,
        memory={
            "argument_bytes": 4_000_000_000,
            "output_bytes": 1_000_000_000,
            "temp_bytes": 2_000_000_000,
            "alias_bytes": 1_000_000_000,
        },
    )
    # AI = 2e9/1e9 = 2 FLOPs/byte, below the balance point 10 ->
    # memory-bound.
    assert reg.gauge("tpufw_program_ai").value(program="p") == 2.0
    assert reg.gauge("tpufw_program_compute_bound").value(program="p") == 0
    # peak HBM = 4 + 1 + 2 - 1 = 6 GB -> headroom = 16 - 6 = 10 GB.
    assert reg.gauge("tpufw_hbm_headroom_bytes").value() == 10_000_000_000
    # 2e9 FLOPs in 4 ms on a 1 TFLOP/s card = 0.5 MFU.
    mfu = obs.record_wall("p", 0.004)
    assert mfu == pytest.approx(0.5)
    assert reg.gauge("tpufw_program_mfu").value(program="p") == (
        pytest.approx(0.5)
    )
    # attrib surfaces the same numbers for bench/goodput.
    at = obs.attrib("p")
    assert at["measured_mfu"] == pytest.approx(0.5)
    assert at["roofline_bound"] == "memory"
    assert at["hbm_headroom_bytes"] == 10_000_000_000


def test_record_wall_unknown_or_flopless_program_returns_none():
    obs = _fixture_obs()
    assert obs.record_wall("nope", 0.1) is None
    obs.record_costs("zero", flops=0.0, bytes_accessed=0.0)
    assert obs.record_wall("zero", 0.1) is None
    assert obs.record_wall("zero", -1.0) is None


def test_roofline_classify_and_attainable():
    peaks = PeakSpec("t", 1e12, 1e11, 0)
    assert classify(2.0, peaks) == "memory"
    assert classify(10.0, peaks) == "compute"
    assert classify(None, peaks) is None
    assert classify(1.0, PeakSpec("t", 1e12, 0.0, 0)) is None
    assert attainable_flops_per_s(2.0, peaks) == 2e11
    assert attainable_flops_per_s(1e6, peaks) == 1e12


def test_detect_peaks_reads_the_card_table(monkeypatch):
    """The H100 rows (SXM 989e12 FLOP/s, 3.35e12 B/s, 80 GB; PCIe), the
    TPUFW_PEAK_* overrides, and no fallback: without a GPU the CUDA
    default raises, as ``detect_chip`` does."""
    from tpufw_torch.utils.hardware import chip_from_name

    sxm = peaks_from_spec(chip_from_name("NVIDIA H100 80GB HBM3"))
    assert (sxm.flops_per_s, sxm.hbm_bw_bytes_per_s, sxm.hbm_bytes) == (
        989e12, 3.35e12, 80 * 10**9)
    assert sxm.balance_flops_per_byte == pytest.approx(989e12 / 3.35e12)
    pcie = peaks_from_spec(chip_from_name("NVIDIA H100 PCIe"))
    assert (pcie.flops_per_s, pcie.hbm_bw_bytes_per_s) == (756e12, 2.0e12)
    monkeypatch.setenv("TPUFW_PEAK_FLOPS", "5e14")
    monkeypatch.setenv("TPUFW_PEAK_HBM_BW", "1e12")
    over = peaks_from_spec(chip_from_name("NVIDIA H100 80GB HBM3"))
    assert (over.flops_per_s, over.hbm_bw_bytes_per_s) == (5e14, 1e12)
    assert detect_peaks("cpu").chip == "cpu"
    with pytest.raises(ValueError, match="unknown accelerator"):
        chip_from_name("NVIDIA A100-SXM4-80GB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect_peaks()


# ------------------------------------------------------ programs.json


def test_load_programs_torn_file_returns_none(tmp_path):
    assert load_programs(str(tmp_path)) is None  # missing
    with open(os.path.join(tmp_path, "programs.json"), "w") as f:
        f.write('{"programs": {"x": ')  # torn mid-write
    assert load_programs(str(tmp_path)) is None


# -------------------------------------------------------- trace merge


def _port_trace(path, pid, spans):
    """A trace the port's Tracer writes, with its spans stamped at the
    given local offsets (us)."""
    tr = trace_mod.Tracer(str(path), pid=pid, process_name=f"train:p{pid}/2")
    for name, ts, dur in spans:
        tr._events.append({"name": name, "ph": "X", "ts": ts, "dur": dur,
                          "pid": pid, "tid": 1})
    tr.close()
    return json.loads(path.read_text())


def test_trace_merge_aligns_two_hosts(tmp_path):
    a = _port_trace(tmp_path / "trace.json", 0,
                    [("step", 0.0, 10.0), ("step", 2_000_000.0, 10.0)])
    b = _port_trace(tmp_path / "trace-p1.json", 1,
                    [("step", 0.0, 10.0), ("step", 1_000_000.0, 10.0)])
    # Rank 1 started 0.5 s after rank 0.
    b["otherData"]["wall_epoch_s"] = a["otherData"]["wall_epoch_s"] + 0.5
    (tmp_path / "trace-p1.json").write_text(json.dumps(b))
    out = tmp_path / "merged.json"
    assert trace_merge.main([str(tmp_path), "-o", str(out)]) == 0
    doc = json.loads(out.read_text())
    ts = [e["ts"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert ts == sorted(ts)
    assert ts == [0.0, 500_000.0, 1_500_000.0, 2_000_000.0]
    assert {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"} == {
        0, 1}
    assert sorted(doc["otherData"]["merged_from"]) == [
        "trace-p1.json", "trace.json"]


def test_trace_merge_skips_torn_file(tmp_path):
    _port_trace(tmp_path / "trace.json", 0, [("s", 0.0, 1.0)])
    (tmp_path / "trace-p1.json").write_text('{"traceEvents": [')
    out = tmp_path / "merged.json"
    assert trace_merge.main([str(tmp_path), "-o", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["otherData"]["merged_from"] == ["trace.json"]


def test_trace_merge_no_inputs_fails_cleanly(tmp_path):
    assert trace_merge.main([str(tmp_path)]) == 1


# ---------------------------------------------------- profiler window


def test_profiler_activities_detach_cupti_after_a_capture(monkeypatch):
    """With a GPU the captures ask kineto to detach CUPTI when they end
    (an attached CUPTI slowed every later step of a host-bound loop); a
    caller's own TEARDOWN_CUPTI is kept, and the CPU needs none."""
    from tpufw_torch.obs.perf import profiler_activities

    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_activities() == [torch.profiler.ProfilerActivity.CPU]
    assert "TEARDOWN_CUPTI" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert profiler_activities() == [torch.profiler.ProfilerActivity.CPU,
                                     torch.profiler.ProfilerActivity.CUDA]
    assert os.environ["TEARDOWN_CUPTI"] == "1"
    monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    profiler_activities()
    assert os.environ["TEARDOWN_CUPTI"] == "0"


def test_parse_profile_steps():
    assert parse_profile_steps("3:6") == (3, 6)
    assert parse_profile_steps("") is None
    assert parse_profile_steps("junk") is None
    assert parse_profile_steps("6:3") is None
    assert parse_profile_steps("-1:2") is None


def test_resolve_profile_window_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUFW_PROFILE_STEPS", "4:9")
    d, a, b = resolve_profile_window(
        None, 3, 6, telemetry_dir=str(tmp_path)
    )
    assert (a, b) == (4, 9)
    assert d == os.path.join(str(tmp_path), "profile")
    monkeypatch.delenv("TPUFW_PROFILE_STEPS")
    d, a, b = resolve_profile_window("/tmp/x", 3, 6, telemetry_dir=None)
    assert (d, a, b) == ("/tmp/x", 3, 6)


def test_profile_trigger_rejects_concurrent_capture(tmp_path):
    from tpufw.obs.perf import ProfileTrigger as JProfileTrigger

    for cls in (ProfileTrigger, JProfileTrigger):
        trig = cls(str(tmp_path))
        with trig._lock:
            trig._active = True
        assert trig.trigger(0.1) == {"error": "capture already in progress"}


# ------------------------------------------- disabled-overhead budget


def test_null_observatory_per_step_overhead_below_1pct():
    """TPUFW_PERF_OBS=0 path: the per-step probe calls (observe_step +
    record_wall on the null object) must cost well under 1% of the
    smallest real step (~25 ms on the CPU -> 250 us). Budget 100 us, as
    tpufw's test."""
    assert not NULL.enabled and not NULL.will_observe("train_step")

    def step(x):
        return x

    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        NULL.observe_step("train_step", step, 1)
        NULL.record_wall("train_step", 0.01)
    per_step = (time.perf_counter() - t0) / n
    assert per_step < 100e-6, f"null perf obs {per_step*1e6:.1f}us/step"
    assert NULL.attrib() == {} and NULL.snapshot() == {}
