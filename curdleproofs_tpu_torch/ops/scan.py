"""Batched group reductions and prefix scans over point vectors.

The MSM engines (ops.msm) need three collective primitives over Jacobian
point vectors, all built purely from complete group adds (`g1.jadd`, which
is the CUDA point kernel on the card):

  * `_hs_scan`: fixed-width Hillis-Steele inclusive scan (the lane-offset
    stitch over the L scan lanes of the streaming MSM)
  * `tree_reduce_hybrid`: sum N points -> 1 (the bucket-boundary reduce)
  * `inclusive_scan`: P_j = p_0 + ... + p_j for all j, Blelloch-style, about
    2N adds (the prefix of the sort-based Pippenger engines): pair sums and
    recursion while the vector is wider than SMALL_WIDTH, `_hs_scan` below

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


def _interleave(a: JPoints, b: JPoints) -> JPoints:
    """[a0, b0, a1, b1, ...] along the last axis."""

    def go(x, y):
        return torch.stack([x, y], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))

    return JPoints(go(a.x, b.x), go(a.y, b.y), go(a.z, b.z))


def _split_even_odd(p: JPoints):
    ev = JPoints(p.x[..., 0::2], p.y[..., 0::2], p.z[..., 0::2])
    od = JPoints(p.x[..., 1::2], p.y[..., 1::2], p.z[..., 1::2])
    return ev, od


def _shift_in_inf(p: JPoints) -> JPoints:
    """Shift right by one along the last axis, shifting in infinity."""
    pad = jinf(p.x.shape[1:-1] + (1,), device=p.x.device)
    return JPoints(
        torch.cat([pad.x, p.x[..., :-1]], dim=-1),
        torch.cat([pad.y, p.y[..., :-1]], dim=-1),
        torch.cat([pad.z, p.z[..., :-1]], dim=-1),
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


def inclusive_scan(p: JPoints) -> JPoints:
    """Inclusive group-prefix-scan along the last axis (width = power of 2)."""
    n = p.x.shape[-1]
    if n & (n - 1):
        raise ValueError("inclusive_scan requires power-of-two width")
    if n <= SMALL_WIDTH:
        return _hs_scan(p)
    ev, od = _split_even_odd(p)
    pairs = jadd(ev, od)  # width n/2: sums of adjacent pairs
    sp = inclusive_scan(pairs)  # prefixes at odd positions
    evens = jadd(_shift_in_inf(sp), ev)  # prefixes at even positions
    return _interleave(evens, sp)
