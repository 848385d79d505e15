"""Builds the CUDA kernels in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
``*_d192.cu`` and ``*_d256.cu`` sources are the head-dim-192 and 256
builds of the same kernels, and the ``*_k64.cu`` and ``*_q64.cu`` ones
their other tilings (``flash.BUILDS``): each defines ``TPUFW_HEAD_DIM``,
``TPUFW_BQ`` or ``TPUFW_BKV`` and includes its kernel's base source, so
they export the same C functions. The build goes into ``build-torch/``
at the repo root (listed in ``.gitignore``); a library's file name carries
a hash of the flags, the headers and the sources it compiles, so an edited
kernel is rebuilt and an unchanged one is reused. All missing libraries
are compiled in parallel, one ``nvcc`` per source.
``utils.profiling.enable_compile_cache`` (``TPUFW_COMPILE_CACHE_DIR``)
moves ``BUILD_DIR`` to a per-machine cache directory.
``nvcc``'s output (the ``-Xptxas -v`` report) is kept beside each library
as ``lib<name>-<hash>.log`` and read back when the library is reused.

``data_library_path`` builds the native corpus packer
(``native/dataloader/dataloader.cc``) the same way with ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build-torch"
SOURCES = (
    "flash_fwd", "flash_dq", "flash_dkv",
    "flash_fwd_d192", "flash_dq_d192", "flash_dkv_d192",
    "flash_fwd_d256", "flash_dq_d256", "flash_dkv_d256",
    # Other tilings (flash.BUILDS): 64-key tiles at head dim 128, 64-row
    # query blocks of the forward and dQ at 192 and 256.
    "flash_fwd_k64", "flash_dq_k64", "flash_dkv_k64",
    "flash_fwd_d192_q64", "flash_dq_d192_q64",
    "flash_fwd_d256_q64", "flash_dq_d256_q64",
)
BASES = ("flash_fwd", "flash_dq", "flash_dkv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_MASK_ARGS = [_I, _I, _I, _I, _I, _F]  # causal offset has_win win has_cap cap
# C signatures: pointers, then B T S H KV, then the mask args, then the stream.
_ARGTYPES = {
    "tpufw_flash_fwd": [_P] * 7 + [_I] * 5 + _MASK_ARGS + [_P],
    "tpufw_flash_dq": [_P] * 9 + [_I] * 5 + _MASK_ARGS + [_P],
    "tpufw_flash_dkv": [_P] * 10 + [_I] * 5 + _MASK_ARGS + [_P],
    # Each build's dynamic shared memory a block, in bytes.
    "tpufw_flash_fwd_smem": [],
    "tpufw_flash_dq_smem": [],
    "tpufw_flash_dkv_smem": [],
}

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's report per source (-Xptxas -v: registers, shared memory, spills),
# filled by build() whether it compiled the library or reused it.
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the flash kernels build only on a machine "
            "with the CUDA toolkit"
        )
    return nvcc


def base_source(name: str) -> str:
    """The kernel source a build's wrapper includes: ``flash_dq`` for
    ``flash_dq_d256_q64``."""
    for base in BASES:
        if name == base or name.startswith(base + "_"):
            return base
    raise ValueError(f"unknown kernel build {name!r}")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # A build's wrapper (another head dim or tiling) includes the source of
    # its kernel: an edit of that source rebuilds every build of it.
    own = {name, base_source(name)}
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem in own:
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def all_built() -> bool:
    """True when every source's library and its log are already in
    ``BUILD_DIR``: ``build`` would compile nothing."""
    return all(
        p.exists() and p.with_suffix(".log").exists()
        for p in (_lib_path(name) for name in SOURCES)
    )


def build() -> dict[str, Path]:
    """Compile every source whose library (or its log) is missing, in
    parallel, and fill ``PTXAS_LOG`` for every source."""
    paths = {name: _lib_path(name) for name in SOURCES}
    logs = {name: p.with_suffix(".log") for name, p in paths.items()}
    todo = [n for n, p in paths.items() if not (p.exists() and logs[n].exists())]
    for name in paths.keys() - set(todo):
        PTXAS_LOG[name] = logs[name].read_text()
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        PTXAS_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            log_tmp = logs[name].with_suffix(f".{os.getpid()}.logtmp")
            log_tmp.write_text(out)
            os.replace(log_tmp, logs[name])
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# The native corpus packer (train.native_data): the repo's
# native/dataloader/dataloader.cc, compiled as it is with the host C++
# compiler into build-torch/, its name hashed over the flags and sources.
DATA_SRC = Path(__file__).resolve().parents[2] / "native" / "dataloader"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def data_library_path() -> Path:
    """Build ``libtpufwdata`` if missing; return its path. Raises when the
    sources or a C++ compiler are missing or the compile fails."""
    src = DATA_SRC / "dataloader.cc"
    if not src.exists():
        raise RuntimeError(f"{src} is missing: run from a checkout of the repo")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build libtpufwdata")
    # The compiler and the machine are in the name too, so a build-torch/
    # copied from another host is not reused.
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(f"{version}{platform.machine()}".encode())
    for f in sorted(DATA_SRC.iterdir()):
        h.update(f.read_bytes())
    path = BUILD_DIR / f"libtpufwdata-{h.hexdigest()[:12]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {src}:\n{proc.stderr}")
    os.replace(tmp, path)
    return path
