"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates without sparsity: 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of
HBM3. They assume the full 700 W power limit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Peak:
    bf16_flops: float      # FLOP/s
    f32_flops: float       # FLOP/s, without tensor cores (TF32 off)
    hbm_bytes: float       # bytes/s

    def flops(self, dtype: str) -> float:
        return self.bf16_flops if dtype == "bf16" else self.f32_flops


# keyed by `torch.cuda.get_device_name()`
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(989e12, 67e12, 3.35e12),
}


def lookup(device_name: str) -> Optional[Peak]:
    """The card's peaks, or None for a card (or a CPU) not in the table."""
    return PEAKS.get(device_name)
