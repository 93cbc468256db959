"""The plain reference that decides `correct`: BLS12-381 G1 in affine
coordinates on Python integers, and the expected value of an MSM whose bases
are known multiples of the generator.

It imports nothing of the program and takes nothing the program made. The
harness hands it the discrete logs b_i of the bases and the scalars it drew
from the seed, as (16, n) little-endian 16-bit limbs, and it works the
answer out again:

    sum_i s_i * (b_i * G) = (sum_i s_i * b_i mod r) * G

The limb dot product is exact in float64: a product of two 16-bit limbs is
below 2^32, and a block of at most 2^20 of them sums below 2^52, so every
partial sum is an integer that float64 holds, whatever order the matrix
product adds in. The curve constants are the published ones of BLS12-381
(draft-irtf-cfrg-pairing-friendly-curves, section 4.2.1), frozen here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B_COEFF = 4
GX = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GY = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

LIMB_BITS = 16
DOT_BLOCK = 1 << 20  # lanes a float64 block sums exactly

Affine = Optional[Tuple[int, int]]  # None is the point at infinity
G: Affine = (GX, GY)


def on_curve(pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_COEFF) % P == 0


def add(a: Affine, b: Affine) -> Affine:
    """The affine group law, every case spelled out."""
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def mul(k: int, pt: Affine) -> Affine:
    """k * pt by double-and-add, most significant bit first."""
    acc: Affine = None
    for bit in bin(k % R)[2:] if k % R else "":
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, pt)
    return acc


def limbs_to_int(col) -> int:
    """One (16,) column of little-endian 16-bit limbs -> int."""
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(col))


def dot_mod_r(s: np.ndarray, b: np.ndarray) -> int:
    """sum_i s_i * b_i mod r for (L, n) limb arrays of two scalar vectors."""
    L, n = s.shape
    if b.shape != (L, n):
        raise ValueError(f"limb arrays disagree: {s.shape} against {b.shape}")
    total = 0
    for lo in range(0, n, DOT_BLOCK):
        sb = s[:, lo : lo + DOT_BLOCK].astype(np.float64)
        bb = b[:, lo : lo + DOT_BLOCK].astype(np.float64)
        m = sb @ bb.T  # m[j, k] = sum_i s_ij * b_ik, exact
        for j in range(L):
            for k in range(L):
                total += int(m[j, k]) << (LIMB_BITS * (j + k))
    return total % R


def truncated(s: np.ndarray, bits: int) -> np.ndarray:
    """The scalars with every bit from `bits` up cleared (the control's
    broken guarantee: the top window dropped)."""
    out = s.astype(np.int64).copy()
    for i in range(out.shape[0]):
        lo = LIMB_BITS * i
        if lo >= bits:
            out[i] = 0
        elif lo + LIMB_BITS > bits:
            out[i] &= (1 << (bits - lo)) - 1
    return out
