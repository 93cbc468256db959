"""Branchless multi-limb modular arithmetic on integer tensors (plain PyTorch).

Field elements are (L, *batch) int32 tensors of 16-bit limbs (limb-major; see
ops.fieldspec). Every function takes canonical residues in [0, p) and returns
canonical residues, so results are bit-identical to any other exact
implementation of the same function — in particular to the JAX package's
`ops.modarith` and to the CUDA device functions in csrc/fq.cuh, which hold the
same values as 12 x 32-bit words.

These are the *plain versions*: they run on whatever device the tensors lie
on, are exact, and make no attempt at speed. The GPU hot path goes through
the CUDA kernels (ops.cuda_g1, ops.stream_scan, ops.gather) instead.

Carry handling: a ripple over L limbs is L dependent tensor ops, so carries
and borrows are resolved with a carry-lookahead instead. Per limb a generate
bit g and a propagate bit p are packed into one integer per lane, and the
carry chain is read off an ordinary integer addition: with A = G | P and
B = G, the carries of A + B are exactly the limb carries, i.e.
(A + B) ^ A ^ B has bit i set iff a carry enters limb i.
"""
from __future__ import annotations

import torch

from curdleproofs_tpu_torch.ops.fieldspec import LIMB_BITS, LIMB_MASK, FieldSpec

_MASK = LIMB_MASK
_SHIFT = LIMB_BITS


def _col(vec_np, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """(L,) numpy limb constant -> (L, 1, ..) tensor broadcastable to `like`."""
    t = torch.as_tensor(vec_np.astype("int64"), device=like.device).to(
        dtype or like.dtype
    )
    return t.reshape((-1,) + (1,) * (like.ndim - 1))


def _bit_weights(n: int, like: torch.Tensor) -> torch.Tensor:
    w = torch.ones((), dtype=torch.int64, device=like.device) << torch.arange(
        n, dtype=torch.int64, device=like.device
    )
    return w.reshape((n,) + (1,) * (like.ndim - 1))


def _chain(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry/borrow chain c_{i+1} = g_i | (p_i & c_i), c_0 = 0, for (K, *B)
    boolean generate/propagate masks (mutually exclusive per limb).
    Returns (K + 1, *B) int64 of 0/1: entry i is the carry INTO limb i, entry
    K the carry out."""
    K = gen.shape[0]
    w = _bit_weights(K, gen)
    G = (gen.to(torch.int64) * w).sum(0)
    A = G | (prop.to(torch.int64) * w).sum(0)
    cin = (A + G) ^ A ^ G  # bit i = carry into limb i
    sh = torch.arange(K + 1, dtype=torch.int64, device=gen.device).reshape(
        (K + 1,) + (1,) * (gen.ndim - 1)
    )
    return (cin.unsqueeze(0) >> sh) & 1


def _resolve_carries(v: torch.Tensor):
    """(K, *B) int64 columns, each in [0, 2^17 - 2] -> ((K, *B) 16-bit limbs,
    carry out (*B,))."""
    c = _chain(v > _MASK, (v & _MASK) == _MASK)
    return (v + c[:-1]) & _MASK, c[-1]


def _sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a - b over 16-bit limbs -> ((K, *B) diff mod 2^(16K), borrow
    out (*B,)). int64 in and out."""
    c = _chain(a < b, a == b)
    return (a - b - c[:-1]) & _MASK, c[-1]


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, canonical in/out."""
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    s, c = _resolve_carries(a64 + b64)
    mod = _col(spec.mod_limbs, s).expand_as(s)
    d, brw = _sub_borrow(s, mod)
    use_d = (c == 1) | (brw == 0)
    return torch.where(use_d.unsqueeze(0), d, s).to(a.dtype)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, canonical in/out."""
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    d, brw = _sub_borrow(a64, b64)
    d2, _ = _resolve_carries(d + _col(spec.mod_limbs, d))
    return torch.where((brw == 1).unsqueeze(0), d2, d).to(a.dtype)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p."""
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Boolean mask (*B,): a == 0 (canonical representation assumed)."""
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field select: mask (*B,) -> a where True else b."""
    return torch.where(mask.unsqueeze(0), a, b)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^{-1} mod p, canonical in/out.

    Operand-scanning wide multiply into 2L + 1 int64 column accumulators
    (each < 2L * 2^32 < 2^38), word-by-word Montgomery reduction with the
    pivot carry pushed into the next column, then `_mont_finish`."""
    L = spec.nlimbs
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    modv = _col(spec.mod_limbs, a64)
    t = torch.zeros((2 * L + 1,) + a64.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(L):
        t[i : i + L] += a64[i].unsqueeze(0) * b64
    for i in range(L):
        m = (t[i] * spec.n0inv) & _MASK
        t[i : i + L] += m.unsqueeze(0) * modv
        # t[i] is now 0 mod 2^16; push its carry into the pivot column
        t[i + 1] += t[i] >> _SHIFT
    return _mont_finish(t, L, modv).to(a.dtype)


def _mont_finish(t: torch.Tensor, L: int, modv: torch.Tensor) -> torch.Tensor:
    """Normalize the surviving upper half of the accumulator and reduce to
    [0, p). The value t[L:] / R is < 2p by the Montgomery bound."""
    v = t[L:].clone()  # (L + 1, *B) columns < 2^38; the top one stays <= 1
    for _ in range(3):  # 2^38 -> 2^16 + 2^22 -> 2^16 + 2^7 -> <= 2^16
        hi = v[:-1] >> _SHIFT
        v[:-1] &= _MASK
        v[1:] += hi
    res, carry = _resolve_carries(v[:L])
    top = v[L] + carry
    d, brw = _sub_borrow(res, modv.expand_as(res))
    use_d = (top > 0) | (brw == 0)
    return torch.where(use_d.unsqueeze(0), d, res)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mont_pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery in/out) for a static exponent, MSB-first square and
    multiply. The exponent is static, so the multiply is simply skipped at a
    zero bit (the JAX package's scan computes and discards it): the same
    values at every step."""
    if e == 0:
        return _col(spec.one_mont, a).expand_as(a).clone()
    acc = a  # the first bit is always 1
    for i in range(e.bit_length() - 2, -1, -1):
        acc = mont_sqr(spec, acc)
        if (e >> i) & 1:
            acc = mont_mul(spec, acc, a)
    return acc


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched modular inverse via Fermat (a^(p-2)); 0 -> 0. Montgomery
    in/out."""
    return mont_pow_const(spec, a, spec.modulus - 2)
