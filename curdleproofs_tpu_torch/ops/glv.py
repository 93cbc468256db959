"""GLV endomorphism scalar decomposition for BLS12-381 G1.

BLS12-381 admits the efficient endomorphism phi(x, y) = (beta*x, y) with
phi(P) = lambda*P on G1, where beta is a primitive cube root of unity in Fq
and lambda = z^2 - 1 a primitive cube root of unity mod r. For BLS curves the
lattice is exact: r = lambda^2 + lambda + 1, which makes the Babai-rounding
decomposition particularly clean:

    c1 = floor((k*(lambda+1) + r//2) / r)        (exact rounded quotient)
    k2 = min(c1, lambda)                          (clamp the k ~ r-1 corner)
    k1 = k - k2*lambda                            (signed)
    k*P = k1*P + k2*phi(P)

Invariants (the GLV-split streaming MSM sizes its digit windows from them,
and a dual-table ladder can use them to prove that its table adds never hit
the add-formula doubling degeneracy):

  * unclamped: |k1| <= lambda/2 + 1, k2 <= lambda + 1 -> after clamping,
    the clamped case has 0 < k1 <= 1.51*lambda (positive!) and k2 = lambda.
  * always: |k1| < 2^129, 0 <= k2 <= lambda < 2^128 — both fit 9 16-bit
    limbs / 43 radix-8 windows.

The decomposition runs on the host: in the package's native library where
the machine has a C compiler (utils.host_native, 128-bit limb arithmetic),
else vectorized in NumPy 16-bit limb arithmetic (u64 accumulators, exact);
the two give identical arrays. A plain-int reference is kept for tests. Own
copy of the JAX package's `ops.glv`, bit-identical outputs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from curdleproofs_tpu_torch.fields import FR_MOD
from curdleproofs_tpu_torch.utils import host_native

Z_ABS = 0xD201000000010000  # |z|, the BLS12-381 curve parameter
LAMBDA = Z_ABS * Z_ABS - 1  # 128 bits; lambda^2 + lambda + 1 == r exactly
assert LAMBDA**2 + LAMBDA + 1 == FR_MOD
# beta with (beta*x, y) == lambda * (x, y) on G1 (verified vs host curve in
# tests; the other cube root pairs with lambda^2 = -lambda-1 mod r)
BETA = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC

GLV_LIMBS = 9  # 144 bits > 129-bit bound on |k1|, k2
GLV_WINDOWS = 43  # radix-8 windows covering 129 bits (43*3 = 129)

# Scalars at the corners of the decomposition and of the ladders' windows
# (zero, the ends of the range, around lambda, the clamped corner, a lone top
# bit); the tests and the GPU smoke run put them on lanes of their own.
EDGE_SCALARS = (
    0,
    1,
    2,
    7,
    FR_MOD - 1,
    FR_MOD - 2,
    FR_MOD - 7,
    LAMBDA,
    LAMBDA - 1,
    LAMBDA + 1,
    Z_ABS**2,
    (1 << 254) - 1,
    1 << 128,
    14 * LAMBDA,
)

_L = 16  # input Fr limbs
_LB = 16  # limb bits
_MASK = (1 << _LB) - 1

# Barrett reciprocal: M = floor(2^S / r); with S = 640 the estimate
# floor(num*M / 2^S) is in {q-1, q} for num < 2^384, fixed by one correction.
_S_LIMBS = 40  # shift = 640 bits
_HALF_R = FR_MOD // 2


def _int_to_limbs(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (_LB * i)) & _MASK for i in range(n)], dtype=np.uint64)

_M_BARRETT = _int_to_limbs((1 << (_S_LIMBS * _LB)) // FR_MOD, 25)
_R_LIMBS = _int_to_limbs(FR_MOD, 16)
_HALF_R_LIMBS = _int_to_limbs(_HALF_R, 16)
_LAM_LIMBS = _int_to_limbs(LAMBDA, 8)
_LAMP1_LIMBS = _int_to_limbs(LAMBDA + 1, 8)


def _conv(a: np.ndarray, b_const: np.ndarray, out_limbs: int) -> np.ndarray:
    """Column product of (La, n) limbs with a constant (Lb,) limb vector,
    carry-normalized to (out_limbs, n) u64 16-bit limbs. Column accumulators
    stay < min(La,Lb) * 2^32 < 2^37, exact in u64."""
    La, n = a.shape
    Lb = b_const.shape[0]
    cols = np.zeros((La + Lb, n), dtype=np.uint64)
    for j in range(Lb):
        bj = b_const[j]
        if bj == 0:
            continue
        cols[j : j + La] += a * bj
    return _carry(cols, out_limbs)


def _carry(cols: np.ndarray, out_limbs: int) -> np.ndarray:
    out = np.zeros((out_limbs, cols.shape[1]), dtype=np.uint64)
    carry = np.zeros(cols.shape[1], dtype=np.uint64)
    for i in range(out_limbs):
        v = (cols[i] if i < cols.shape[0] else 0) + carry
        out[i] = v & _MASK
        carry = v >> _LB
    return out


def _add_limbs(a: np.ndarray, b_const: np.ndarray, out_limbs: int) -> np.ndarray:
    cols = np.zeros((out_limbs, a.shape[1]), dtype=np.uint64)
    cols[: a.shape[0]] += a
    cols[: b_const.shape[0]] += b_const[:, None]
    return _carry(cols, out_limbs)


def _sub_limbs(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """a - b limb-wise (same shape), returns (diff mod 2^(16L), borrow_out)."""
    L, n = a.shape
    out = np.zeros_like(a)
    borrow = np.zeros(n, dtype=np.uint64)
    base = np.uint64(1 << _LB)
    for i in range(L):
        v = a[i] + base - b[i] - borrow
        out[i] = v & _MASK
        borrow = np.uint64(1) - (v >> _LB)
    return out, borrow


def _geq(a: np.ndarray, b_const: np.ndarray) -> np.ndarray:
    """a >= b (constant), limb arrays (L, n) vs (Lb,) with Lb <= L."""
    L, n = a.shape
    b = np.zeros(L, dtype=np.uint64)
    b[: b_const.shape[0]] = b_const
    ge = np.ones(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for i in range(L - 1, -1, -1):
        gt = a[i] > b[i]
        lt = a[i] < b[i]
        ge = np.where(~decided & gt, True, np.where(~decided & lt, False, ge))
        decided |= gt | lt
    return ge


def decompose(scalars: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(16, n) canonical Fr limbs (uint32/uint64, 16-bit values) ->
    (s1 (9, n) uint32, neg1 (n,) bool, s2 (9, n) uint32) with
    k = (-1)^neg1 * s1 + s2 * LAMBDA (mod r), |s1| < 2^130, s2 <= LAMBDA.

    The native batched decomposition where the machine can build it, else
    `decompose_numpy`; the same arrays either way."""
    if not host_native.available():
        return decompose_numpy(scalars)
    k1, neg, k2 = host_native.glv_decompose_batch(scalars)
    # 3 little-endian u64 per half = 12 u16 limbs, of which the first 9 are kept
    n = k1.shape[0]
    s1 = np.ascontiguousarray(k1.view("<u2").reshape(n, 12)[:, :GLV_LIMBS].T, dtype=np.uint32)
    s2 = np.ascontiguousarray(k2.view("<u2").reshape(n, 12)[:, :GLV_LIMBS].T, dtype=np.uint32)
    return s1, neg.astype(bool), s2


def decompose_numpy(scalars: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`decompose` in vectorized numpy: what the native call is held against,
    and what runs where the machine has no C compiler."""
    k = scalars.astype(np.uint64)
    n = k.shape[1]

    # num = k*(lambda+1) + r//2   (<= 384 bits)
    num = _conv(k, _LAMP1_LIMBS, 24)
    num = _add_limbs(num, _HALF_R_LIMBS, 24)

    # Barrett estimate of floor(num / r), then one exact correction step
    prod = _conv(num, _M_BARRETT, 49)
    c1 = prod[_S_LIMBS:]  # (9, n) candidate quotient (est or est-1)
    # rem = num - c1 * r ; if rem >= r then c1 += 1 (at most once)
    c1r = _conv(c1, _R_LIMBS, 25)
    num25 = np.zeros((25, n), dtype=np.uint64)
    num25[:24] = num
    rem, borrow = _sub_limbs(num25, c1r)
    assert not borrow.any(), "Barrett estimate exceeded true quotient"
    fix = _geq(rem, _R_LIMBS)
    bump = np.where(fix, np.uint64(1), np.uint64(0)) * _one_hot0(n)
    c1 = _carry(c1 + bump, GLV_LIMBS)

    # clamp c1 <= lambda (possible value lambda+1 only for k near r-1)
    over = _geq(c1, _int_to_limbs(LAMBDA + 1, GLV_LIMBS))
    lam9 = np.zeros((GLV_LIMBS, n), dtype=np.uint64)
    lam9[:8] = _LAM_LIMBS[:, None]
    c1 = np.where(over[None, :], lam9, c1)

    # k1 = k - c1*lambda  (signed; 17-limb window is exact: both < 2^257)
    c1lam = _conv(c1, _LAM_LIMBS, 17)
    k17 = np.zeros((17, n), dtype=np.uint64)
    k17[:16] = k
    d_pos, borrow = _sub_limbs(k17, c1lam)
    d_neg, _ = _sub_limbs(c1lam, k17)
    neg1 = borrow.astype(bool)
    mag = np.where(neg1[None, :], d_neg, d_pos)
    assert not mag[GLV_LIMBS:].any(), "|k1| exceeds 144-bit budget"

    s1 = mag[:GLV_LIMBS].astype(np.uint32)
    s2 = c1.astype(np.uint32)
    return s1, neg1, s2


def _one_hot0(n: int) -> np.ndarray:
    o = np.zeros((GLV_LIMBS, n), dtype=np.uint64)
    o[0] = 1
    return o


def decompose_int(k: int) -> Tuple[int, int]:
    """Plain-int reference: returns (k1 signed, k2) with
    k1 + k2*LAMBDA == k (mod r)."""
    c1 = (k * (LAMBDA + 1) + _HALF_R) // FR_MOD
    c1 = min(c1, LAMBDA)
    return k - c1 * LAMBDA, c1
