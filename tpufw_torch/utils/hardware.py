"""Accelerator specs and device resolution — the numbers MFU depends on.

MFU is tokens/s * model FLOPs per token / peak FLOP/s, and the peak is a
per-part constant, not something a program can discover. The table holds
NVIDIA's data-sheet figures for the H100 (dense bf16 tensor-core rate,
HBM size and bandwidth). An unknown card raises: a wrong peak would make
every MFU figure wrong without a sign.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Static description of one accelerator."""

    name: str
    # Peak dense matmul throughput in FLOP/s (bf16 tensor cores).
    peak_bf16_flops: float
    hbm_bytes: int
    # Peak device-memory bandwidth in bytes/s.
    hbm_bw_bytes_per_s: float


# NVIDIA H100 data sheet, dense (no sparsity) bf16.
CHIP_SPECS: dict[str, ChipSpec] = {
    "h100_sxm": ChipSpec("h100_sxm", 989e12, 80 * 10**9, 3.35e12),
    "h100_pcie": ChipSpec("h100_pcie", 756e12, 80 * 10**9, 2.0e12),
    # Nominal figures so MFU arithmetic runs in CPU tests; nothing is
    # ever reported against them as a device metric.
    "cpu": ChipSpec("cpu", 100e9, 16 * 2**30, 5e10),
}


def chip_from_name(name: str) -> ChipSpec:
    """Map a CUDA device name (``torch.cuda.get_device_name``) to its
    spec. "NVIDIA H100 80GB HBM3" is the SXM part, "NVIDIA H100 PCIe"
    the PCIe card. Anything else raises."""
    n = name.lower()
    if "h100" in n:
        if "pcie" in n:
            return CHIP_SPECS["h100_pcie"]
        if "sxm" in n or "hbm3" in n:
            return CHIP_SPECS["h100_sxm"]
    raise ValueError(
        f"unknown accelerator {name!r}: tpufw_torch.utils.hardware has "
        "specs for the H100 SXM and PCIe parts only"
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for something else. Asking for CUDA on a machine without a GPU
    raises — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpufw_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def detect_chip(device=None) -> ChipSpec:
    """Spec of ``device`` (default: the current CUDA device)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CHIP_SPECS["cpu"]
    return chip_from_name(torch.cuda.get_device_name(dev))
