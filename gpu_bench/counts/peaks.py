"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit) and the least time a piece of work can take.

PEAK_BYTES, PEAK_F32 and bound() are a frozen copy of chip_smoke.py's
(`bound`, PEAK_BYTES, PEAK_F32).
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES = 3.35e12   # HBM3 bytes/s
PEAK_F32 = 67e12       # f32 FLOP/s outside the tensor cores (TF32 off)
PEAK_BF16 = 989e12     # bf16 FLOP/s on the tensor cores
PEAKS = {"float32": PEAK_F32, "bfloat16": PEAK_BF16}


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32) -> Tuple[float, str]:
    """Least time on the card for the work: (seconds, "bytes" or
    "operations"), each input byte read once and each output byte written
    once."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
