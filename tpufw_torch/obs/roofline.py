"""Roofline peaks and classification — the static half of the perf
observatory (port of ``tpufw.obs.roofline``; ``tpufw_torch.obs.perf``
is the other half).

A program's arithmetic intensity AI = FLOPs / bytes-accessed puts it on
one side of the machine balance point ``peak FLOP/s / peak HBM
bytes/s``: below it the program cannot reach peak FLOPs no matter how
good the schedule (memory-bound), above it the HBM is not the wall
(compute-bound). The peaks come from the card table
(``tpufw_torch.utils.hardware``: the H100 SXM at 989e12 dense bf16
FLOP/s, 3.35e12 B/s and 80 GB; the PCIe card at 756e12 and 2.0e12) with
env overrides — ``TPUFW_PEAK_FLOPS`` / ``TPUFW_PEAK_HBM_BW`` — for what-if
analysis against another roofline.

``detect_peaks`` raises for a card the table does not know, as
``detect_chip`` does: a wrong peak would make every MFU and roofline
figure wrong without a sign. The card table imports torch, so it is
read inside the functions: ``tpufw_torch.obs`` imports no torch (the
router, which imports none, emits through it).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

from tpufw_torch.workloads.env import env_float

if TYPE_CHECKING:
    from tpufw_torch.utils.hardware import ChipSpec


@dataclasses.dataclass(frozen=True)
class PeakSpec:
    """The two roofline ceilings plus the HBM capacity headroom math
    needs, resolved for one card (or overridden)."""

    chip: str
    flops_per_s: float
    hbm_bw_bytes_per_s: float
    hbm_bytes: int

    @property
    def balance_flops_per_byte(self) -> float:
        """Machine balance point: the AI at which compute and memory
        time are equal. 0 when bandwidth is unknown."""
        if self.hbm_bw_bytes_per_s <= 0:
            return 0.0
        return self.flops_per_s / self.hbm_bw_bytes_per_s


def peaks_from_spec(spec: ChipSpec) -> PeakSpec:
    """ChipSpec -> PeakSpec with the TPUFW_PEAK_* env overrides
    applied (0/unset keeps the table value)."""
    flops = env_float("peak_flops", 0.0) or spec.peak_bf16_flops
    bw = env_float("peak_hbm_bw", 0.0) or spec.hbm_bw_bytes_per_s
    return PeakSpec(
        chip=spec.name,
        flops_per_s=float(flops),
        hbm_bw_bytes_per_s=float(bw),
        hbm_bytes=spec.hbm_bytes,
    )


def detect_peaks(device=None) -> PeakSpec:
    """Peaks of ``device`` (default: the current CUDA device; "cpu" the
    nominal CPU row tests use). Raises for an unknown card and, without
    a GPU, for the CUDA default."""
    from tpufw_torch.utils.hardware import detect_chip

    return peaks_from_spec(detect_chip(device))


def classify(
    ai_flops_per_byte: Optional[float], peaks: PeakSpec
) -> Optional[str]:
    """"compute" / "memory" against the machine balance point; None
    when either side of the comparison is unknown (no bytes figure, or
    no bandwidth for this card)."""
    if ai_flops_per_byte is None or ai_flops_per_byte <= 0:
        return None
    balance = peaks.balance_flops_per_byte
    if balance <= 0:
        return None
    return "compute" if ai_flops_per_byte >= balance else "memory"


def attainable_flops_per_s(
    ai_flops_per_byte: float, peaks: PeakSpec
) -> float:
    """The roofline itself: min(peak FLOPs, AI * peak bandwidth) —
    the ceiling a program with this AI can reach on this card."""
    if peaks.hbm_bw_bytes_per_s <= 0:
        return peaks.flops_per_s
    return min(
        peaks.flops_per_s,
        max(0.0, ai_flops_per_byte) * peaks.hbm_bw_bytes_per_s,
    )
