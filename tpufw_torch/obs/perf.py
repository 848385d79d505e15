"""Program cost observatory: FLOPs/bytes/memory per step program, live
MFU + roofline attribution, and the on-demand profiler hooks (port of
``tpufw.obs.perf``).

The goodput ledger attributes *seconds* to categories and the tracer
attributes them to spans; this module attributes them to *hardware*. For
every program the run drives (the train step, the pipeline step, a
serve decode chunk) it counts the costs of ONE real call, writes the
table to ``<telemetry_dir>/programs.json`` (``programs-p<N>.json`` on a
gang's rank N), and combines those costs
with the measured wall-clock the trainers and the scheduler already
collect to publish ``tpufw_program_mfu`` / ``tpufw_program_ai`` /
``tpufw_program_compute_bound`` / ``tpufw_hbm_headroom_bytes``.

Eager PyTorch has no compiled program whose cost analysis could be read
(``tpufw``'s ``observe_jit`` reads XLA's), so ``observe_step(name, fn,
*args)`` runs the caller's real call once per name under a counting
``TorchDispatchMode`` and returns its result: the call is one of the
run's steps, not an extra one, and its numbers are unchanged (the mode
only looks). It counts:

- **FLOPs** of the aten matmul, convolution and attention ops, with
  ``torch.utils.flop_counter``'s formulas (elementwise work is not
  counted, where XLA's ``cost_analysis`` counts it);
- **bytes**: each non-view aten op's tensor inputs and outputs. In eager
  mode every op reads its inputs from HBM and writes its outputs back,
  so this is an UPPER BOUND of the call's HBM traffic (a cache hit or a
  fused library kernel moves less);
- **the flash kernels**, which launch through ``ctypes`` where no
  dispatch mode sees them: each launch adds ``ops.flash.flash_costs``
  (the counts ``chip_smoke.py``'s bound column uses) to both totals, and
  the entry's ``flash`` table holds them by kernel. On the CPU the
  kernels' plain versions run as aten ops and are counted as such;
- **memory**: ``torch.cuda.max_memory_allocated`` over the call above
  the allocation at its start (``argument_bytes`` is that start,
  ``temp_bytes`` the rise), and ``memory_reserved`` beside it; the peak
  counter is reset for the call.

Costs are PER PROCESS (one GPU): MFU divides by one card's peak and the
headroom compares against one card's memory. Nothing here raises into
the run: a failed count records the error and the call goes on.
``TPUFW_PERF_OBS=0`` turns the observatory off (the null object keeps
every probe site branch-free).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from tpufw_torch.obs import roofline as roofline_mod

PROGRAMS_FILENAME = "programs.json"


def programs_path(out_dir: str, process: int = 0) -> str:
    """``programs.json`` of rank 0, ``programs-p<N>.json`` of rank N: a
    gang's ranks share one telemetry dir on a host."""
    name = (PROGRAMS_FILENAME if process == 0
            else f"programs-p{process}.json")
    return os.path.join(out_dir, name)


def parse_profile_steps(raw: str) -> Optional[Tuple[int, int]]:
    """``TPUFW_PROFILE_STEPS=a:b`` -> (a, b), or None when unset or
    malformed (a bad value must never kill a training run)."""
    raw = (raw or "").strip()
    if not raw:
        return None
    parts = raw.split(":")
    if len(parts) != 2:
        return None
    try:
        start, stop = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    if start < 0 or stop <= start:
        return None
    return start, stop


def resolve_profile_window(
    profile_dir: Optional[str],
    profile_start: int,
    profile_stop: int,
    telemetry_dir: Optional[str] = None,
) -> Tuple[Optional[str], int, int]:
    """The StepProfiler knobs after the ``TPUFW_PROFILE_STEPS`` env
    override: the env window wins over the config window, and when no
    profile dir is configured the capture lands under the telemetry
    dir (``<telemetry_dir>/profile``) so the trace is linkable from the
    run's own artifact directory."""
    from tpufw_torch.workloads.env import env_str

    window = parse_profile_steps(env_str("profile_steps", ""))
    if window is None:
        return profile_dir, profile_start, profile_stop
    out_dir = profile_dir or (
        os.path.join(telemetry_dir, "profile") if telemetry_dir else None
    )
    return out_dir, window[0], window[1]


def profiler_activities():
    """``torch.profiler`` activities of this machine: the CPU, and CUDA
    (CUPTI: every thread's kernels) when a GPU is present. With CUDA,
    kineto detaches CUPTI when the capture ends (``TEARDOWN_CUPTI``,
    unless the caller set it): left attached, CUPTI slowed every later
    step of the host-bound 600m train loop 13-22% on an H100
    (``scripts/telemetry_overhead_torch.py --turns off:on,off``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class ProfileTrigger:
    """On-demand ``torch.profiler`` capture behind ``/debug/profile``:
    one time-bounded trace at a time, taken on a daemon thread so the
    HTTP handler returns immediately with the trace dir. The CUDA
    activity is the whole process's (the scheduler thread's kernels are
    in it); the trace lands as ``<dir>/trace.json``."""

    def __init__(self, out_dir: str, max_seconds: float = 60.0):
        self.out_dir = out_dir
        self.max_seconds = max_seconds
        self._lock = threading.Lock()
        self._active = False

    def trigger(self, seconds: float = 2.0) -> dict:
        seconds = min(max(float(seconds), 0.1), self.max_seconds)
        with self._lock:
            if self._active:
                return {"error": "capture already in progress"}
            self._active = True
        trace_dir = os.path.join(
            self.out_dir, f"ondemand-{int(time.time())}"
        )

        def capture():
            try:
                import torch

                os.makedirs(trace_dir, exist_ok=True)
                prof = torch.profiler.profile(
                    activities=profiler_activities()
                )
                prof.start()
                time.sleep(seconds)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                prof.export_chrome_trace(
                    os.path.join(trace_dir, "trace.json")
                )
            except Exception:  # noqa: BLE001 — never kill the server
                pass
            finally:
                with self._lock:
                    self._active = False

        threading.Thread(
            target=capture, daemon=True, name="obs-profile-capture"
        ).start()
        return {"started": True, "dir": trace_dir, "seconds": seconds}


_COUNTER_CLS = None


def _counter_class():
    """The counting dispatch mode, defined at first use (this module
    imports no torch: ``tpufw_torch.obs`` loads in torch-free
    processes)."""
    global _COUNTER_CLS
    if _COUNTER_CLS is not None:
        return _COUNTER_CLS
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    def nbytes(tree) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)
        )

    class CostCounter(TorchDispatchMode):
        """Counts FLOPs by aten op and non-view op bytes; see the module
        docstring. A counting failure is recorded, never raised."""

        def __init__(self):
            super().__init__()
            self.flops_by_op: Dict[str, int] = {}
            self.aten_bytes = 0
            self.error: Optional[str] = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            try:
                fn = flop_registry.get(func._overloadpacket)
                if fn is not None:
                    key = str(func._overloadpacket)
                    self.flops_by_op[key] = self.flops_by_op.get(
                        key, 0) + int(fn(*args, **kwargs, out_val=out))
                if not func.is_view:
                    self.aten_bytes += nbytes((args, kwargs)) + nbytes(out)
            except Exception as e:  # noqa: BLE001 — observe-only
                if self.error is None:
                    self.error = f"{type(e).__name__}: {e}"[:300]
            return out

    _COUNTER_CLS = CostCounter
    return CostCounter


class PerfObservatory:
    """Per-run registry of step-program costs + live roofline gauges.
    ``registry``/``out_dir`` may each be None (gauges only, or file
    only); ``peaks`` defaults to ``device``'s row (the current CUDA
    device without one) with the ``TPUFW_PEAK_*`` overrides applied."""

    enabled = True

    def __init__(
        self,
        registry=None,
        out_dir: Optional[str] = None,
        peaks: Optional[roofline_mod.PeakSpec] = None,
        key: Optional[str] = None,
        device=None,
        proc: int = 0,
    ):
        self._registry = registry
        self._proc = proc
        self._out_dir = out_dir
        self._peaks = peaks
        self._key = key
        self._device = device
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._closed = False

    # -- static costs -------------------------------------------------

    @property
    def peaks(self) -> roofline_mod.PeakSpec:
        if self._peaks is None:
            self._peaks = roofline_mod.detect_peaks(self._device)
        return self._peaks

    def set_key(self, key: str) -> None:
        """Attach the run key (model, batch, sequence, mesh) the
        trainers know once the model resolves."""
        self._key = key
        self._write()

    def will_observe(self, name: str) -> bool:
        """True when the next ``observe_step(name, ...)`` counts (the
        first call per name): that call is slow, and the trainers keep
        its time out of their step statistics."""
        return name not in self._programs

    def observe_step(self, name: str, fn, *args):
        """``fn(*args)``, counted under ``name`` the first time; later
        calls with a seen name run ``fn`` alone. Errors of ``fn`` itself
        propagate; a failed count records the error and stops
        retrying."""
        if name in self._programs:
            return fn(*args)
        import torch

        from tpufw_torch.ops import flash

        cuda = self._device is not None and (
            torch.device(self._device).type == "cuda")
        flash_costs: Dict[str, Dict[str, int]] = {}

        def sink(kernel: str, flops: int, nbytes: int) -> None:
            c = flash_costs.setdefault(
                kernel, {"launches": 0, "flops": 0, "bytes": 0})
            c["launches"] += 1
            c["flops"] += flops
            c["bytes"] += nbytes

        try:
            counter = _counter_class()()
            if cuda:
                torch.cuda.synchronize(self._device)
                start = torch.cuda.memory_allocated(self._device)
                torch.cuda.reset_peak_memory_stats(self._device)
        except Exception as e:  # noqa: BLE001 — observe-only, never abort
            with self._lock:
                self._programs.setdefault(
                    name, {"error": f"{type(e).__name__}: {e}"[:300]})
            return fn(*args)
        flash.COST_SINK = sink
        try:
            with counter:
                out = fn(*args)
        finally:
            flash.COST_SINK = None
        memory: Dict[str, int] = {}
        if cuda:
            torch.cuda.synchronize(self._device)
            peak = torch.cuda.max_memory_allocated(self._device)
            memory = {
                "argument_bytes": int(start),
                "temp_bytes": int(peak - start),
                "reserved_bytes": int(
                    torch.cuda.memory_reserved(self._device)),
            }
        flash_flops = sum(c["flops"] for c in flash_costs.values())
        flash_bytes = sum(c["bytes"] for c in flash_costs.values())
        aten_flops = sum(counter.flops_by_op.values())
        self.record_costs(
            name,
            flops=float(aten_flops + flash_flops),
            bytes_accessed=float(counter.aten_bytes + flash_bytes),
            memory=memory,
            extra={
                "aten_flops": aten_flops,
                "aten_flops_by_op": dict(sorted(
                    counter.flops_by_op.items())),
                "aten_bytes": counter.aten_bytes,
                "flash": flash_costs,
                "flash_flops": flash_flops,
                "flash_bytes": flash_bytes,
                **({"error": counter.error} if counter.error else {}),
            },
        )
        return out

    def record_costs(
        self,
        name: str,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        memory: Optional[dict] = None,
        extra: Optional[dict] = None,
    ) -> None:
        """Ingest one program's costs (the seam observe_step feeds and
        tests drive directly) and publish the static gauges."""
        memory = memory or {}
        ai = flops / bytes_accessed if bytes_accessed > 0 else None
        peak_hbm = None
        if memory:
            # Live-at-peak upper bound: arguments + outputs + temp high-
            # water mark, minus donated aliases (the step's start plus
            # its rise above it, for observe_step's entries).
            peak_hbm = (
                memory.get("argument_bytes", 0)
                + memory.get("output_bytes", 0)
                + memory.get("temp_bytes", 0)
                - memory.get("alias_bytes", 0)
            )
        entry: Dict[str, Any] = {
            "flops": flops,
            "bytes_accessed": bytes_accessed,
            "ai_flops_per_byte": ai,
            "bound": roofline_mod.classify(ai, self.peaks),
            "peak_hbm_bytes": peak_hbm,
            **memory,
            **(extra or {}),
        }
        with self._lock:
            self._programs[name] = entry
        if self._registry is not None:
            if ai is not None:
                self._registry.gauge(
                    "tpufw_program_ai",
                    "arithmetic intensity (FLOPs/byte) of the program, "
                    "from its counted step",
                ).set(ai, program=name)
            if entry["bound"] is not None:
                self._registry.gauge(
                    "tpufw_program_compute_bound",
                    "roofline classification: 1 = compute-bound, "
                    "0 = memory-bound (vs the card balance point)",
                ).set(
                    1 if entry["bound"] == "compute" else 0, program=name
                )
            self._publish_headroom()
        self._write()

    def _publish_headroom(self) -> None:
        """``tpufw_hbm_headroom_bytes`` = card HBM minus the largest
        per-program peak footprint seen so far (can go negative: that
        IS the OOM warning)."""
        with self._lock:
            peaks_seen = [
                p["peak_hbm_bytes"]
                for p in self._programs.values()
                if p.get("peak_hbm_bytes")
            ]
        if not peaks_seen or self._registry is None:
            return
        self._registry.gauge(
            "tpufw_hbm_headroom_bytes",
            "per-card HBM capacity minus the largest program peak "
            "footprint (negative = expected OOM)",
        ).set(self.peaks.hbm_bytes - max(peaks_seen))

    # -- measured wall ------------------------------------------------

    def record_wall(self, name: str, wall_s: float) -> Optional[float]:
        """Combine a measured per-call wall with the counted FLOPs into
        MFU for ``name``; returns the MFU (None when the program is
        unknown, has no FLOPs figure, or the wall is degenerate)."""
        if wall_s <= 0:
            return None
        with self._lock:
            entry = self._programs.get(name)
            if entry is None or not entry.get("flops"):
                return None
            mfu = entry["flops"] / (wall_s * self.peaks.flops_per_s)
            entry["wall_s"] = wall_s
            entry["mfu"] = mfu
            entry["calls"] = entry.get("calls", 0) + 1
        if self._registry is not None:
            self._registry.gauge(
                "tpufw_program_mfu",
                "measured FLOP utilization of the program: counted "
                "FLOPs / (wall x per-card peak FLOPs)",
            ).set(mfu, program=name)
        return mfu

    # -- reads --------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._programs.items()}

    def attrib(self, prefix: str = "") -> dict:
        """The bench/goodput summary for programs whose name starts
        with ``prefix``: the highest-FLOP program's last MFU and
        roofline bound, plus the global HBM headroom. Empty dict when
        nothing matched."""
        progs = [
            (n, p)
            for n, p in self.snapshot().items()
            if n.startswith(prefix) and p.get("flops")
        ]
        if not progs:
            return {}
        name, p = max(progs, key=lambda np: np[1]["flops"])
        out: dict = {"program": name}
        if p.get("mfu") is not None:
            out["measured_mfu"] = round(p["mfu"], 4)
        if p.get("bound") is not None:
            out["roofline_bound"] = p["bound"]
        hbm_peaks = [
            q["peak_hbm_bytes"]
            for q in self.snapshot().values()
            if q.get("peak_hbm_bytes")
        ]
        if hbm_peaks:
            out["hbm_headroom_bytes"] = int(
                self.peaks.hbm_bytes - max(hbm_peaks)
            )
        return out

    # -- persistence --------------------------------------------------

    def _document(self) -> dict:
        peaks = self.peaks
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
        return {
            "version": 1,
            "key": self._key,
            "chip": peaks.chip,
            "peak_flops_per_chip": peaks.flops_per_s,
            "peak_hbm_bw_bytes_per_s": peaks.hbm_bw_bytes_per_s,
            "hbm_bytes_per_chip": peaks.hbm_bytes,
            "balance_flops_per_byte": peaks.balance_flops_per_byte,
            "programs": programs,
        }

    def _write(self) -> None:
        if not self._out_dir:
            return
        path = programs_path(self._out_dir, self._proc)
        tmp = path + ".tmp"
        try:
            os.makedirs(self._out_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._document(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except (OSError, RuntimeError, ValueError):
            pass  # telemetry write failure must never abort the run

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._write()


class NullPerfObservatory:
    """Disabled-path twin: every probe is a constant-time no-op (the
    <1% per-step budget the tests assert)."""

    enabled = False

    def will_observe(self, name):
        return False

    def observe_step(self, name, fn, *args):
        return fn(*args)

    def record_costs(self, name, flops=0.0, bytes_accessed=0.0,
                     memory=None, extra=None):
        pass

    def record_wall(self, name, wall_s):
        return None

    def set_key(self, key):
        pass

    def snapshot(self):
        return {}

    def attrib(self, prefix=""):
        return {}

    def close(self):
        pass


NULL = NullPerfObservatory()


def load_programs(telemetry_dir: str, process: int = 0) -> Optional[dict]:
    """Read rank ``process``'s ``programs.json``; None when absent or
    torn (the same graceful degradation as the other obs artifacts)."""
    path = programs_path(telemetry_dir, process)
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
