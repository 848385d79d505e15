"""Step profiling and the kernel build cache (port of
``tpufw.utils.profiling``).

- ``StepProfiler`` captures a window of train steps with
  ``torch.profiler`` (CPU and, on a GPU, CUDA activity) into a Chrome
  trace, each step under a ``train_step#<i>`` record; step 0 is outside
  the default window.
- ``enable_compile_cache`` is the counterpart of ``tpufw``'s persistent
  XLA compile cache (``TPUFW_COMPILE_CACHE_DIR``): what the port
  compiles is its CUDA kernels (``ops/_build.py``), so the knob points
  their build directory at a per-machine subdirectory of the cache dir,
  and a restarted pod on a shared volume reuses the libraries instead of
  running ``nvcc`` again. Without the knob the kernels build into
  ``build-torch/`` at the repo root, as always.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import platform
from pathlib import Path
from typing import Optional

# Env var consumed by workload entry points (set in deploy/ manifests).
COMPILE_CACHE_ENV = "TPUFW_COMPILE_CACHE_DIR"

# The directory the last enable_compile_cache pointed the build at.
_CACHE_DIR: Optional[str] = None

_NO_STEP = contextlib.nullcontext()


def machine_fingerprint() -> str:
    """Short stable id of what a built kernel library depends on: the
    GPU's name, the NVIDIA driver, the CUDA and torch versions, and the
    host's architecture and CPU feature flags. Identical pods share a
    cache subdir; another card, driver or toolkit gets its own."""
    import torch

    bits = [platform.machine(), torch.__version__, str(torch.version.cuda)]
    if torch.cuda.is_available():
        bits.append(torch.cuda.get_device_name(0))
    try:
        with open("/proc/driver/nvidia/version") as f:
            bits.append(f.readline().strip())
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 "flags", arm64 "Features": the first hit describes
                # every core uniformly on the machines we care about.
                if line.startswith(("flags", "Features")):
                    bits.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        pass
    return hashlib.sha256(" ".join(bits).encode()).hexdigest()[:10]


def enable_compile_cache(
    path: Optional[str] = None, per_machine: bool = True
) -> Optional[str]:
    """Build (and reuse) the CUDA kernels under ``path``.

    ``path`` defaults to ``$TPUFW_COMPILE_CACHE_DIR``; no-op (returning
    None) when neither is set, so workloads can call this
    unconditionally. With ``per_machine`` (default) the libraries live in
    a ``machine_fingerprint()`` subdir, so a dir shared across machine
    types cannot serve a library built for another card or toolkit.
    Nothing is built here: the kernels build at their first launch."""
    global _CACHE_DIR
    path = path or os.environ.get(COMPILE_CACHE_ENV)
    if not path:
        return None
    if per_machine:
        path = os.path.join(path, machine_fingerprint())
    os.makedirs(path, exist_ok=True)
    from tpufw_torch.ops import _build

    _build.BUILD_DIR = Path(path)
    _CACHE_DIR = path
    return path


def compile_cache_state() -> Optional[tuple[str, bool]]:
    """(dir, warm) of the cache ``enable_compile_cache`` set, or None
    when it set none: warm when every kernel library is already there,
    so the first launches reuse them all."""
    if _CACHE_DIR is None:
        return None
    from tpufw_torch.ops import _build

    return _CACHE_DIR, _build.all_built()


class StepProfiler:
    """Captures steps [start, stop) of a train loop into a
    ``torch.profiler`` Chrome trace under ``trace_dir``.

    Usage from a step loop::

        prof = StepProfiler(dir, start_step=3, stop_step=6)
        for i, batch in enumerate(data):
            prof.maybe_start(i)
            with prof.step(i):
                run_step(batch)
            prof.maybe_stop(i)

    Inactive (``trace_dir=None``) it is free: every method returns at
    once and ``step`` hands back one shared null context. Stop waits for
    the card's queued work first, so the trace holds the window's
    kernels. The trace is ``trace-steps<start>-<stop>.json``
    (``-p<rank>`` before the suffix on a gang's rank above 0)."""

    def __init__(
        self,
        trace_dir: Optional[str],
        start_step: int = 3,
        stop_step: int = 6,
        rank: int = 0,
    ):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self.rank = rank
        self.trace_path: Optional[str] = None
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.trace_dir and self._prof is None and step == self.start_step:
            import torch

            from tpufw_torch.obs.perf import profiler_activities

            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = torch.profiler.profile(
                activities=profiler_activities())
            self._prof.start()

    def step(self, step: int):
        if self._prof is not None:
            import torch

            return torch.profiler.record_function(f"train_step#{step}")
        return _NO_STEP

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step + 1 >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        tag = "" if self.rank == 0 else f"-p{self.rank}"
        self.trace_path = os.path.join(
            self.trace_dir,
            f"trace-steps{self.start_step}-{self.stop_step}{tag}.json")
        prof.export_chrome_trace(self.trace_path)
