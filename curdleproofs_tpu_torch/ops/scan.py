"""Batched group reductions and small prefix scans over point vectors.

The streaming MSM (ops.msm) needs two collective primitives over Jacobian
point vectors, both built purely from complete group adds (`g1.jadd`, which
is the CUDA point kernel on the card):

  * `_hs_scan`: fixed-width Hillis-Steele inclusive scan (the lane-offset
    stitch over the L scan lanes)
  * `tree_reduce_hybrid`: sum N points -> 1 (the bucket-boundary reduce)

The order of the adds is the JAX package's (`ops.scan`), so the Jacobian
representatives, not only the points, come out identical: halve by adding the
upper half onto the lower while the vector is wider than SMALL_WIDTH, then
finish with log-step shifted adds at fixed width.
"""
from __future__ import annotations

import torch

from curdleproofs_tpu_torch.ops.g1 import JPoints, jadd, jinf, jselect

SMALL_WIDTH = 2048


def _roll(p: JPoints, shift: int) -> JPoints:
    return JPoints(
        torch.roll(p.x, shift, dims=-1),
        torch.roll(p.y, shift, dims=-1),
        torch.roll(p.z, shift, dims=-1),
    )


def _hs_scan(p: JPoints) -> JPoints:
    """Hillis-Steele inclusive scan along the last axis at fixed width."""
    n = p.x.shape[-1]
    steps = max(1, (n - 1).bit_length())
    idx = torch.arange(n, device=p.x.device)
    inf = jinf(p.x.shape[1:], device=p.x.device)
    for s in range(steps):
        d = 1 << s
        rolled = jselect(idx >= d, _roll(p, d), inf)
        p = jadd(p, rolled)
    return p


def _hs_reduce(p: JPoints) -> JPoints:
    """Reduce a fixed-width vector to lane 0 via log-step shifted adds."""
    n = p.x.shape[-1]
    steps = (n - 1).bit_length()
    idx = torch.arange(n, device=p.x.device)
    inf = jinf(p.x.shape[1:], device=p.x.device)
    for s in range(steps):
        d = n >> (s + 1)
        rolled = jselect(idx < n - d, _roll(p, -d), inf)
        p = jadd(p, rolled)
    return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])


def pad_pow2(p: JPoints, min_width: int = 1) -> JPoints:
    """Pad the last axis with infinity up to the next power of two."""
    n = p.x.shape[-1]
    m = max(min_width, 1)
    while m < n:
        m *= 2
    if m == n:
        return p
    pad = jinf(p.x.shape[1:-1] + (m - n,), device=p.x.device)
    return JPoints(
        torch.cat([p.x, pad.x], dim=-1),
        torch.cat([p.y, pad.y], dim=-1),
        torch.cat([p.z, pad.z], dim=-1),
    )


def tree_reduce_hybrid(p: JPoints) -> JPoints:
    """Sum all lanes of the last axis (any width; padded internally)."""
    p = pad_pow2(p)
    n = p.x.shape[-1]
    if n == 1:
        return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])
    while n > SMALL_WIDTH:
        n //= 2
        lo = JPoints(p.x[..., :n], p.y[..., :n], p.z[..., :n])
        hi = JPoints(p.x[..., n:], p.y[..., n:], p.z[..., n:])
        p = jadd(lo, hi)
    return _hs_reduce(p)
