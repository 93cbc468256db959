"""The yardstick, frozen here so that a change to the program cannot move it.

- `PEAK_MUL32_PER_S`: the 32-bit integer multiply-adds an NVIDIA H100 SXM
  issues a second: its 67 TFLOP/s of fp32 are 33.5e12 fused instructions on
  128 fp32 lanes an SM, and an SM has 64 int32 lanes, so 67e12 / 4 =
  16.75e12 (the model `chip_smoke.py` bounds every kernel with).
- `MUL32_PER_ADD`: the 32-bit multiplies of one complete Jacobian add of
  BLS12-381 G1 (add-2007-bl, 11M + 5S): a product at 300 multiplies (144
  word products, 144 of m * p and the 12 quotient words, over 12 words) and
  a square at 234 (the 78 distinct word products, then the same 156),
  11 * 300 + 5 * 234 = 4,470.
- `MUL32_PER_MIXED_ADD`: the same for an affine base added to a Jacobian
  bucket (madd-2007-bl, 7M + 4S): 7 * 300 + 4 * 234 = 3,036.
- `canonical_mul32(n, c)`: the multiplies a Pippenger MSM of n affine bases
  needs with c-bit windows, W = ceil(255 / c): each base once into a bucket
  per window, W * n mixed adds, and per window the running sum over the 2^c
  buckets, two complete adds a bucket (the running sum, then the total). It
  counts the work, not what one engine executes, so it stays put when the
  engine changes.
- `busy_union`: the device's busy time as the union of its intervals, so
  overlapping work counts once. A copy of the arithmetic of the program's
  `utils/profiling.py::busy_summary` as it stood when this benchmark was
  written.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

PEAK_MUL32_PER_S = 16.75e12
MUL32_PER_ADD = 11 * 300 + 5 * 234
MUL32_PER_MIXED_ADD = 7 * 300 + 4 * 234
FR_BITS = 255


def windows(c: int) -> int:
    return -(-FR_BITS // c)


def canonical_mul32(n: int, c: int) -> int:
    W = windows(c)
    return W * n * MUL32_PER_MIXED_ADD + 2 * W * (1 << c) * MUL32_PER_ADD


def busy_union(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(spans: Iterable[Tuple[float, float]], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The stretches of the window that no interval covers."""
    gaps, cursor = [], window[0]
    for s, e in sorted(spans):
        if s > cursor:
            gaps.append((cursor, min(s, window[1])))
        cursor = max(cursor, e)
        if cursor >= window[1]:
            break
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    return [(a, b) for a, b in gaps if b > a]
