"""Peaks of the card and the least bytes each hand-written kernel must
move, from the shapes of its launches.

The arithmetic is that of the port's ``utils/kernel_bench.py``
(``fast_bound``'s bytes term, ``hamming_bytes_ms``), copied so the
yardstick stays here: each input byte read once, each output byte written
once, at the card's HBM rate. Both kernels are bound by bytes at the
shapes the frame path gives them (their operations bound is 5-20 times
lower, ``PERF.md``), so the bytes bound is their roofline.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, at its 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12,
                              "bf16_dense_flops_per_s": 989e12},
}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def peak(kind: str, key: str) -> float:
    return PEAKS.get(kind, PEAKS[DEFAULT_KIND])[key]


def fast_bytes(shape) -> float:
    """One FAST launch on [B, H, W] float32 images: the images read, the
    float32 scores written, the float32 threshold read."""
    b, h, w = shape
    return 8.0 * b * h * w + 4


def hamming_bytes(problems) -> float:
    """One Hamming launch over ``problems``, each (n, m, mask_a, mask_b):
    both [*, 8] int32 descriptor sets read, each bool mask passed read, the
    int32 [n, m] matrix written."""
    return sum(32.0 * (n + m) + 4.0 * n * m + (n if ma else 0) + (m if mb else 0)
               for n, m, ma, mb in problems)


def share_pct(bound_bytes: float, device_s: float, kind: str) -> float | None:
    """The bytes bound's time over the measured device time, in %; None
    where the trace holds no time for the kernel."""
    if device_s <= 0:
        return None
    return 100.0 * bound_bytes / peak(kind, "hbm_bytes_per_s") / device_s
