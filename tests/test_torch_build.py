"""The kernel build's cache and ``chip_smoke.build_report`` on the CPU.

``_build.build()`` reuses a library whose sources are unchanged. The
``-Xptxas -v`` report that ``build_report`` reads registers and spills from
must then come back with it, or a second run in one checkout would find no
spill line and fail. A stand-in ``nvcc`` (and ``cuobjdump`` beside it)
prints a ptxas-shaped report, so the cold and the warm build can both be
driven here.
"""

import os
import stat
import sys

import pytest

import chip_smoke
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from tpufw_torch.ops import _build

NVCC = """#!{python}
import os, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
name = os.path.basename(args[-1])[:-3]
with open(os.path.join(os.path.dirname(__file__), "calls"), "a") as f:
    f.write(name + "\\n")
with open(out, "w") as f:
    f.write("library")
sym = "_Z%d%s_kernelv" % (len(name) + 7, name)
print("ptxas info    : Compiling entry function '%s' for 'sm_90a'" % sym)
print("ptxas info    : Function properties for %s" % sym)
print("    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads")
print("ptxas info    : Used 168 registers, used 1 barriers, 0 bytes smem")
"""
CUOBJDUMP = """#!/bin/sh
echo "  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;"
echo "  UTMALDG.4D [UR8], [UR10] ;"
"""


def _script(path, text):
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    def make(spill):
        bin_dir = tmp_path / "bin"
        bin_dir.mkdir(exist_ok=True)
        _script(bin_dir / "nvcc", NVCC.format(python=sys.executable, spill=spill))
        _script(bin_dir / "cuobjdump", CUOBJDUMP)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(bin_dir / "nvcc"))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build-torch")
        monkeypatch.setattr(_build, "PTXAS_LOG", {})
        return bin_dir / "calls"
    return make


def _calls(path):
    return sorted(path.read_text().split()) if path.exists() else []


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("spill", [0, 8])
def test_build_report_reads_spills_on_a_cold_and_a_warm_build(
    fake_toolkit, warm, spill
):
    calls = fake_toolkit(spill)
    paths = _build.build()
    assert _calls(calls) == sorted(_build.SOURCES)
    if warm:
        _build.PTXAS_LOG.clear()
        assert _build.build() == paths
        assert _calls(calls) == sorted(_build.SOURCES), "a library was rebuilt"
    assert set(_build.PTXAS_LOG) == set(_build.SOURCES)
    if spill:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.build_report(_build, paths)
        return
    report = chip_smoke.build_report(_build, paths)
    for lib, symbol in chip_smoke.HOPPER_KERNELS.values():
        assert report[lib]["sass"]["HGMMA"] == 1
        assert report[lib]["sass"]["UTMALDG"] == 1
        (kernel,) = [v for k, v in report[lib]["kernels"].items() if symbol in k]
        assert kernel == {"registers": 168, "spill_bytes": 0}


def test_a_library_without_its_log_is_rebuilt(fake_toolkit):
    calls = fake_toolkit(0)
    paths = _build.build()
    os.remove(paths["flash_dkv"].with_suffix(".log"))
    _build.PTXAS_LOG.clear()
    _build.build()
    assert _calls(calls) == sorted([*_build.SOURCES, "flash_dkv"])
    assert set(_build.PTXAS_LOG) == set(_build.SOURCES)
