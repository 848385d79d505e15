"""Smoke workload: the ``nvidia-smi``-in-a-pod proof (port of
``tpufw.workloads.smoke``).

The proof shows both *enumeration* and *compute*: it prints the CUDA
devices torch sees and runs a real bf16 matmul chain on one, ending in a
host read. ``python -m tpufw_torch.workloads.smoke``.

Knobs: ``TPUFW_SMOKE_MATMUL_DIM`` (4096), ``TPUFW_SMOKE_MATMUL_REPS``
(20), ``TPUFW_DEVICE`` (``cuda``; ``cpu`` is the counterpart of
``tpufw``'s config 1, a pod with no accelerator). Without a CUDA device
and without ``TPUFW_DEVICE=cpu`` it raises: it never falls back to the
CPU on its own.
"""

from __future__ import annotations

import time

from tpufw_torch.workloads.env import env_int, env_str


def _device(cluster):
    from tpufw_torch.cluster import local_device

    try:
        return local_device(cluster, env_str("device", "cuda"))
    except RuntimeError as e:
        raise RuntimeError(
            "tpufw_torch smoke: no CUDA device is available; set "
            "TPUFW_DEVICE=cpu to run the smoke on the CPU"
        ) from e


def main() -> int:
    from tpufw_torch.cluster import initialize_cluster

    cluster = initialize_cluster(device=env_str("device", "cuda"))
    dev = _device(cluster)

    import torch

    print(f"tpufw_torch smoke: process {cluster.process_id}/"
          f"{cluster.num_processes} (source={cluster.source})")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = []
    for i in range(count):
        major, minor = torch.cuda.get_device_capability(i)
        names.append(f"{torch.cuda.get_device_name(i)} (sm_{major}{minor})")
    print(f"torch.cuda devices -> {names} count={count}")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"platform: {dev.type}  kind: {kind}")

    n = env_int("smoke_matmul_dim", 4096)
    reps = env_int("smoke_matmul_reps", 20)
    gen = torch.Generator(device=dev).manual_seed(0)
    # Scaled so repeated self-multiplication stays finite in bf16.
    x = (torch.randn(n, n, generator=gen, device=dev) / n).to(torch.bfloat16)

    def f(a):
        return a @ a + a

    checksum = float(f(x)[0, 0])  # warm call + a real host read
    # Chain the iterations (each consumes the last) and end on a
    # device-to-host read, so queued launches cannot fake the rate.
    a = x
    t0 = time.perf_counter()
    for _ in range(reps):
        a = f(a)
    float(a[0, 0])
    dt = (time.perf_counter() - t0) / reps
    tflops = 2 * n**3 / dt / 1e12
    # "effective": launch and host-read overhead included; a proof that
    # the device computes, not a peak benchmark.
    print(f"matmul[{n}x{n}] checksum={checksum:.4f} "
          f"time={dt * 1e3:.2f}ms/iter ({tflops:.1f} effective TFLOP/s)")
    print("SMOKE OK: device enumerated and exercised")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
