"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit) and the least time a step could take on it.

A step's least time is the larger of its operations at the peak rate of the
precision it is stated in and its bytes at the memory bandwidth; a roofline
share is that least time over the measured time.  A card set below 700 W
runs slower under load: print its limit beside every share.
"""

from __future__ import annotations

FP32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3


def least_seconds(terms: dict, flop_per_s: float = FP32_FLOP_PER_S,
                  bytes_per_s: float = HBM_BYTES_PER_S) -> tuple:
    """``(seconds, "operations" | "bytes")`` of ``terms`` {name: (flops, bytes)}."""
    flops = sum(f for f, _ in terms.values())
    nbytes = sum(b for _, b in terms.values())
    by_ops, by_bytes = flops / flop_per_s, nbytes / bytes_per_s
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")

