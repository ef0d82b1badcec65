"""Per-card NVIDIA datasheet peaks: the physics check for every perf claim.

Port of `tpu_device_plugin/validator/peaks.py` for CUDA cards, keyed on
`torch.cuda.get_device_name()`. `check()` flags any measurement above
`SUSPECT_FACTOR` x peak as a timing artifact, and the validator refuses to
record such a run as ok. An unknown card (the CPU, a card not in the
table) has no peak: no fractions and never a false veto.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# A real card can transiently clock-boost measurement noise a few percent
# above nominal; anything past this factor is a broken estimator, not a
# fast card.
SUSPECT_FACTOR = 1.05


@dataclass(frozen=True)
class Peak:
    generation: str        # canonical short name
    bf16_tflops: float     # peak dense bf16 TFLOP/s per card
    hbm_gbps: float        # peak device-memory bandwidth GB/s per card


# NVIDIA H100 datasheet (nvidia.com/en-us/data-center/h100/): dense bf16
# tensor-core TFLOP/s (without sparsity) and HBM bandwidth.
PEAKS = {
    "h100-sxm5": Peak("h100-sxm5", 989.0, 3350.0),
    "h100-pcie": Peak("h100-pcie", 756.0, 2000.0),
}


def lookup(device_name: str) -> Optional[Peak]:
    """Map a `torch.cuda.get_device_name()` string to its datasheet peak.

    Observed names: "NVIDIA H100 80GB HBM3" (SXM5), "NVIDIA H100 PCIe".
    Anything else returns None."""
    name = (device_name or "").lower()
    if "h100" not in name:
        return None
    if "pcie" in name:
        return PEAKS["h100-pcie"]
    if "hbm3" in name:
        return PEAKS["h100-sxm5"]
    return None


def check(device_name: str, tflops: float = 0.0, gbps: float = 0.0):
    """Physics-check measurements against the card's datasheet peak.

    Returns (peak or None, suspect: bool, reason: str). suspect=True means
    a measurement exceeded SUSPECT_FACTOR x peak — the number is a timing
    artifact and must not be recorded as a valid result.
    """
    peak = lookup(device_name)
    if peak is None:
        return None, False, ""
    reasons = []
    if tflops > SUSPECT_FACTOR * peak.bf16_tflops:
        reasons.append(
            f"measured {tflops:.1f} TFLOP/s > {SUSPECT_FACTOR:g}x the "
            f"{peak.generation} datasheet peak {peak.bf16_tflops:g}")
    if gbps > SUSPECT_FACTOR * peak.hbm_gbps:
        reasons.append(
            f"measured {gbps:.1f} GB/s > {SUSPECT_FACTOR:g}x the "
            f"{peak.generation} datasheet HBM peak {peak.hbm_gbps:g}")
    return peak, bool(reasons), "; ".join(reasons)
