"""In-container enablement validator for an NVIDIA GPU (port of
``tpufw.workloads.validate``): ``python -m tpufw_torch.workloads.validate``.

Run inside a container that REQUESTS the accelerator. The checks climb
the same ladder as ``tpufw``'s, for NVIDIA: device nodes mounted ->
``libcuda.so.1`` loadable -> allocation env present -> torch actually
enumerates a CUDA device. Exit 0 only if every applicable check passes;
each check prints PASS/FAIL so the Job log is the diagnosis.

The last rung is switched by ``TPUFW_VALIDATE_REQUIRE_JAX`` (default
true), ``tpufw``'s name for it, kept so one manifest drives either
package: here it asks for torch's CUDA device, not JAX's TPU cores.
"""

from __future__ import annotations

import ctypes
import glob
import os

#: Values of NVIDIA_VISIBLE_DEVICES that give the container no GPU.
_NO_GPU = ("", "void", "none")


def _report(name: str, ok: bool, detail: str = "") -> bool:
    print(f"{'PASS' if ok else 'FAIL'}: {name}" + (f" — {detail}" if detail else ""))
    return ok


def run_checks(require_torch_cuda: bool = True) -> list[tuple[str, bool]]:
    results: list[tuple[str, bool]] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        results.append((name, _report(name, ok, detail)))

    nodes = sorted(glob.glob("/dev/nvidia*"))
    check(
        "NVIDIA device nodes mounted", bool(nodes),
        ", ".join(nodes) or "none under /dev",
    )

    try:
        ctypes.CDLL("libcuda.so.1")
        ok, detail = True, "libcuda.so.1"
    except OSError as e:
        ok, detail = False, f"{type(e).__name__}: {e}"
    check("libcuda.so.1 loadable", ok, detail)

    nvidia = os.environ.get("NVIDIA_VISIBLE_DEVICES")
    cuda = os.environ.get("CUDA_VISIBLE_DEVICES")
    check(
        "allocation env injected",
        (nvidia is not None and nvidia.strip().lower() not in _NO_GPU)
        or bool(cuda),
        f"NVIDIA_VISIBLE_DEVICES={nvidia!r} CUDA_VISIBLE_DEVICES={cuda!r}",
    )

    if require_torch_cuda:
        try:
            import torch

            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            ok = n > 0
            detail = str([torch.cuda.get_device_name(i) for i in range(n)])
        except Exception as e:  # driver init failure IS the finding
            ok, detail = False, f"{type(e).__name__}: {e}"
        check("torch enumerates CUDA devices", ok, detail)

    return results


def main() -> int:
    from tpufw_torch.workloads.env import env_bool

    require = env_bool("validate_require_jax", True)
    results = run_checks(require_torch_cuda=require)
    failed = [n for n, ok in results if not ok]
    if failed:
        print(f"VALIDATION FAILED: {failed} — the first FAIL is the layer "
              "to fix: nodes -> driver library -> device plugin env -> torch")
        return 1
    print("VALIDATION OK: container is GPU-enabled end to end")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
