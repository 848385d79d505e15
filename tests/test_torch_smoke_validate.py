"""The port's smoke and validate workloads (``tpufw_torch.workloads.smoke``,
``.validate``) against ``tpufw``'s: the smoke's device proof on the CPU
(the mirror of ``tests/test_workloads.py::test_smoke_main_prints_device_
proof``), its refusal without a GPU, and the validate ladder, whose
PASS/FAIL lines and exit codes follow ``tpufw``'s for the same outcome of
each rung (the globs, the driver library, the env and the framework's
device enumeration are stood in for)."""

import math
import re

import pytest
import torch

from tests.torch_parity import one_torch_thread, workload_env  # noqa: F401
from tpufw.workloads import validate as jv
from tpufw_torch.workloads import smoke as ts
from tpufw_torch.workloads import validate as tv


def test_smoke_main_prints_device_proof(capsys, monkeypatch):
    workload_env(monkeypatch, {"DEVICE": "cpu", "SMOKE_MATMUL_DIM": 128,
                               "SMOKE_MATMUL_REPS": 3})
    assert ts.main() == 0
    out = capsys.readouterr().out
    assert "torch.cuda devices" in out
    assert "platform: cpu" in out
    assert "SMOKE OK" in out
    assert "TFLOP/s" in out
    m = re.search(r"matmul\[128x128\] checksum=(\S+) time=(\S+)ms/iter", out)
    assert m and math.isfinite(float(m.group(1))), out
    # The checksum is element [0, 0] of one a @ a + a on the seeded input.
    x = (torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
         / 128).to(torch.bfloat16)
    assert float(m.group(1)) == pytest.approx(
        float((x @ x + x)[0, 0]), abs=1e-4)


def test_smoke_without_a_gpu_names_the_knob(monkeypatch):
    workload_env(monkeypatch, {"SMOKE_MATMUL_DIM": 128})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="TPUFW_DEVICE=cpu"):
        ts.main()


class _JaxDev:
    def __init__(self, platform):
        self.platform = platform

    def __repr__(self):
        return f"{self.platform}:0"


_LIBTPU = "/nonexistent/libtpu.so"

# (nodes, library, allocation env, framework device, require device)
LADDER = [
    (True, True, True, True, True),
    (False, True, True, True, True),
    (True, False, True, True, True),
    (True, True, False, True, True),
    (True, True, True, False, True),
    (True, True, True, False, False),
    (False, False, False, False, True),
]


def _tpufw_side(monkeypatch, nodes, lib, env, dev):
    import jax

    monkeypatch.setattr(
        jv.glob, "glob",
        lambda pat: ["/dev/accel0"] if nodes and "accel" in pat else [])
    real_exists = jv.os.path.exists
    libs = {_LIBTPU, "/lib/libtpu.so", "/usr/lib/libtpu.so",
            "/usr/local/lib/libtpu.so"}
    monkeypatch.setattr(
        jv.os.path, "exists",
        lambda p: (lib and p == _LIBTPU) if p in libs else real_exists(p))
    monkeypatch.setenv("TPU_LIBRARY_PATH", _LIBTPU)
    for k in ("TPU_VISIBLE_CHIPS", "TPU_CHIPS_PER_HOST_BOUNDS"):
        monkeypatch.delenv(k, raising=False)
    if env:
        monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0")
        monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "1,1,1")
    monkeypatch.setattr(
        jax, "devices", lambda: [_JaxDev("tpu" if dev else "cpu")])


def _port_side(monkeypatch, nodes, lib, env, dev):
    monkeypatch.setattr(
        tv.glob, "glob",
        lambda pat: ["/dev/nvidia0", "/dev/nvidiactl"]
        if nodes and "nvidia" in pat else [])

    def cdll(name):
        if not lib:
            raise OSError(f"{name}: cannot open shared object file")
        return object()

    monkeypatch.setattr(tv.ctypes, "CDLL", cdll)
    for k in ("NVIDIA_VISIBLE_DEVICES", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    if env:
        monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: dev)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(dev))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")


def _verdicts(out):
    return [ln.split(":")[0] for ln in out.splitlines()
            if ln.startswith(("PASS:", "FAIL:"))]


@pytest.mark.parametrize("nodes,lib,env,dev,require", LADDER)
def test_validate_ladder_matches_tpufw(monkeypatch, capsys, nodes, lib, env,
                                       dev, require):
    knob = {"VALIDATE_REQUIRE_JAX": "1" if require else "0"}
    workload_env(monkeypatch, knob)
    _tpufw_side(monkeypatch, nodes, lib, env, dev)
    want_rc = jv.main()
    want = capsys.readouterr().out
    workload_env(monkeypatch, knob)
    _port_side(monkeypatch, nodes, lib, env, dev)
    got_rc = tv.main()
    got = capsys.readouterr().out
    assert _verdicts(got) == _verdicts(want), (got, want)
    assert len(_verdicts(got)) == (4 if require else 3)
    assert got_rc == want_rc
    assert ("VALIDATION FAILED" in got) == ("VALIDATION FAILED" in want)
    assert ("VALIDATION OK" in got) == (got_rc == 0)


@pytest.mark.parametrize("visible,ok", [
    ({"NVIDIA_VISIBLE_DEVICES": "all"}, True),
    ({"CUDA_VISIBLE_DEVICES": "0"}, True),
    ({"NVIDIA_VISIBLE_DEVICES": "void"}, False),
    ({"NVIDIA_VISIBLE_DEVICES": "none"}, False),
    ({}, False),
])
def test_validate_allocation_env(monkeypatch, capsys, visible, ok):
    """Either variable counts; the container toolkit's ``void``/``none``
    give the container no GPU."""
    _port_side(monkeypatch, True, True, False, True)
    for k, v in visible.items():
        monkeypatch.setenv(k, v)
    results = dict(tv.run_checks())
    assert results["allocation env injected"] is ok
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "allocation env injected" in ln][0]
    assert line.startswith("PASS" if ok else "FAIL")
    assert "NVIDIA_VISIBLE_DEVICES=" in line
