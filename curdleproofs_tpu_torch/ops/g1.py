"""Batched BLS12-381 G1 group operations on integer tensors.

Points are structs-of-tensors of Fq limbs (limb-major (24, *B) int32,
Montgomery form):

  * `JPoints` — Jacobian (X, Y, Z), Z == 0 encodes infinity.
  * `APoints` — affine (x, y) plus an explicit infinity mask.

All group ops are *complete* and branchless: doubling, inverse and infinity
inputs are resolved with masked selects. Formulas are the standard EFD
Jacobian a=0 formulas (dbl-2009-l, add-2007-bl, madd-2007-bl), the same ones
and in the same order as the JAX package's `ops.g1`, and every field value is
canonical, so intermediates compare bit for bit.

The `_*_formulas` functions are the plain PyTorch versions. `jadd`, `jdbl`
and `jmadd` dispatch on where the tensors lie: CUDA tensors go to the
hand-written point kernel (ops.cuda_g1), CPU tensors to the plain version.

BLS12-381 G1 has prime order (no 2-torsion), so y == 0 never occurs for
finite curve points and the doubling formula needs no special case.
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import numpy as np
import torch

from curdleproofs_tpu_torch.curve import G1
from curdleproofs_tpu_torch.fields import Fr
from curdleproofs_tpu_torch.ops import modarith as ma
from curdleproofs_tpu_torch.ops.fieldspec import (
    FQ_SPEC,
    FR_SPEC,
    from_reference,
    ints_to_limbs,
    limbs_to_ints,
    to_reference,
)
from curdleproofs_tpu_torch.utils.device import DeviceArg

_add = partial(ma.add, FQ_SPEC)
_sub = partial(ma.sub, FQ_SPEC)
_mul = partial(ma.mont_mul, FQ_SPEC)
_sqr = partial(ma.mont_sqr, FQ_SPEC)
_neg = partial(ma.neg, FQ_SPEC)
_dbl = partial(ma.double, FQ_SPEC)
_is0 = partial(ma.is_zero, FQ_SPEC)
_fsel = ma.select

FQ_LIMBS = FQ_SPEC.nlimbs
FR_LIMBS = FR_SPEC.nlimbs


class JPoints(NamedTuple):
    x: torch.Tensor  # (24, *B) Montgomery
    y: torch.Tensor
    z: torch.Tensor  # z == 0 <=> infinity


class APoints(NamedTuple):
    x: torch.Tensor  # (24, *B) Montgomery
    y: torch.Tensor
    inf: torch.Tensor  # (*B,) bool


def jselect(mask, p: JPoints, q: JPoints) -> JPoints:
    """Per-lane select: p where mask else q."""
    return JPoints(_fsel(mask, p.x, q.x), _fsel(mask, p.y, q.y), _fsel(mask, p.z, q.z))


def jinf(batch_shape=(), device="cpu") -> JPoints:
    """The identity as the JAX package encodes it: (1, 1, 0) in raw limbs."""
    z = torch.zeros((FQ_LIMBS,) + tuple(batch_shape), dtype=torch.int32, device=device)
    one = z.clone()
    one[0] = 1
    return JPoints(one, one.clone(), z)


def is_inf(p: JPoints):
    return _is0(p.z)


def lift(a: APoints) -> JPoints:
    """Affine -> Jacobian (z = 1 in Montgomery form, masked by inf)."""
    one = ma._col(FQ_SPEC.one_mont, a.x)
    z = torch.where(a.inf.unsqueeze(0), torch.zeros_like(a.x), one.expand_as(a.x))
    return JPoints(a.x, a.y, z)


def _jdbl_formulas(p: JPoints) -> JPoints:
    """Jacobian doubling, complete (infinity passes through via z=0)."""
    a = _sqr(p.x)
    b = _sqr(p.y)
    c = _sqr(b)
    t = _add(p.x, b)
    d = _dbl(_sub(_sub(_sqr(t), a), c))
    e = _add(_add(a, a), a)
    f = _sqr(e)
    x3 = _sub(f, _dbl(d))
    c8 = _dbl(_dbl(_dbl(c)))
    y3 = _sub(_mul(e, _sub(d, x3)), c8)
    z3 = _dbl(_mul(p.y, p.z))
    return JPoints(x3, y3, z3)


def _jadd_formulas(p: JPoints, q: JPoints, handle_doubling: bool = True) -> JPoints:
    """Complete Jacobian + Jacobian addition.

    handle_doubling=False drops the p == q branch; only sound where that case
    is impossible. Cancellation (p == -q) stays handled for free via z3 = 0."""
    z1z1 = _sqr(p.z)
    z2z2 = _sqr(q.z)
    u1 = _mul(p.x, z2z2)
    u2 = _mul(q.x, z1z1)
    s1 = _mul(_mul(p.y, q.z), z2z2)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, u1)
    i = _sqr(_dbl(h))
    j = _mul(h, i)
    r = _dbl(_sub(s2, s1))
    v = _mul(u1, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(s1, j)))
    zz = _sub(_sub(_sqr(_add(p.z, q.z)), z1z1), z2z2)
    z3 = _mul(zz, h)  # h == 0 -> z3 == 0: P + (-P) lands on infinity for free
    res = JPoints(x3, y3, z3)

    if handle_doubling:
        dbl_case = _is0(h) & _is0(r) & ~is_inf(p) & ~is_inf(q)
        res = jselect(dbl_case, _jdbl_formulas(p), res)
    res = jselect(is_inf(q), p, res)
    res = jselect(is_inf(p), q, res)
    return res


def _jmadd_formulas(p: JPoints, q: APoints, handle_doubling: bool = True) -> JPoints:
    """Complete Jacobian + affine mixed addition (madd-2007-bl)."""
    z1z1 = _sqr(p.z)
    u2 = _mul(q.x, z1z1)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, p.x)
    hh = _sqr(h)
    i = _dbl(_dbl(hh))
    j = _mul(h, i)
    r = _dbl(_sub(s2, p.y))
    v = _mul(p.x, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(p.y, j)))
    z3 = _mul(_dbl(p.z), h)  # h == 0 -> infinity for free
    res = JPoints(x3, y3, z3)

    if handle_doubling:
        dbl_case = _is0(h) & _is0(r) & ~is_inf(p) & ~q.inf
        res = jselect(dbl_case, _jdbl_formulas(p), res)
    res = jselect(q.inf, p, res)
    res = jselect(is_inf(p), lift(q), res)
    return res


def _jmadd_formulas_flagged(p: JPoints, q: APoints):
    """Mixed add WITHOUT the doubling path, plus a per-lane flag.

    Returns (res, dbl_mask): res is WRONG (z3 == 0) exactly where dbl_mask is
    set (the running point equals the incoming one), and the caller must redo
    the affected work on a complete path. Cancellation p == -q and both
    infinity cases remain exact. The flag reads h and r off the formula's
    intermediates — no extra field multiplications."""
    z1z1 = _sqr(p.z)
    u2 = _mul(q.x, z1z1)
    s2 = _mul(_mul(q.y, p.z), z1z1)
    h = _sub(u2, p.x)
    hh = _sqr(h)
    i = _dbl(_dbl(hh))
    j = _mul(h, i)
    r = _dbl(_sub(s2, p.y))
    v = _mul(p.x, i)
    x3 = _sub(_sub(_sqr(r), j), _dbl(v))
    y3 = _sub(_mul(r, _sub(v, x3)), _dbl(_mul(p.y, j)))
    z3 = _mul(_dbl(p.z), h)
    res = JPoints(x3, y3, z3)
    dbl = _is0(h) & _is0(r) & ~is_inf(p) & ~q.inf
    res = jselect(q.inf, p, res)
    res = jselect(is_inf(p), lift(q), res)
    return res, dbl


def jdbl(p: JPoints) -> JPoints:
    """Jacobian doubling: the CUDA point kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if p.x.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return cuda_g1.jdbl(p)
    return _jdbl_formulas(p)


def jadd(p: JPoints, q: JPoints) -> JPoints:
    """Complete Jacobian add: the CUDA point kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if p.x.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return cuda_g1.jadd(p, q)
    return _jadd_formulas(p, q)


def jmadd(p: JPoints, q: APoints) -> JPoints:
    """Complete mixed add: the CUDA point kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if p.x.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return cuda_g1.jmadd(p, q)
    return _jmadd_formulas(p, q)


# ---------------------------------------------------------------------------
# host <-> device packing
# ---------------------------------------------------------------------------


def jpoints_to_host(p: JPoints) -> List[G1]:
    """Normalize Jacobian device points ((24,) or (24, n)) to host G1.

    The affine conversion happens host-side in exact int arithmetic — a
    handful of modmuls per point — so device outputs stay Jacobian."""
    pmod = FQ_SPEC.modulus
    rinv = pow(FQ_SPEC.r_mod, -1, pmod)
    single = p.x.ndim == 1
    xs = limbs_to_ints(p.x)
    ys = limbs_to_ints(p.y)
    zs = limbs_to_ints(p.z)
    if single:
        xs, ys, zs = [xs], [ys], [zs]
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(G1.identity())
            continue
        # take coords out of Montgomery, then normalize the Jacobian triple
        x, y, z = x * rinv % pmod, y * rinv % pmod, z * rinv % pmod
        zinv = pow(z, -1, pmod)
        zinv2 = zinv * zinv % pmod
        out.append(G1(x * zinv2 % pmod, y * zinv2 % pmod * zinv % pmod))
    return out


def pack_points(points: List[G1], device: DeviceArg = None) -> APoints:
    """Host G1 list -> device affine struct (Montgomery form)."""
    R = FQ_SPEC.r_mod
    p = FQ_SPEC.modulus
    xs = [pt.x * R % p if not pt.inf else 0 for pt in points]
    ys = [pt.y * R % p if not pt.inf else 0 for pt in points]
    inf = np.array([pt.inf for pt in points], dtype=bool)
    return APoints(
        from_reference(ints_to_limbs(xs, FQ_LIMBS), device),
        from_reference(ints_to_limbs(ys, FQ_LIMBS), device),
        from_reference(inf, device),
    )


def unpack_points(a: APoints) -> List[G1]:
    """Device affine struct -> host G1 list (out of Montgomery form)."""
    p = FQ_SPEC.modulus
    rinv = pow(FQ_SPEC.r_mod, -1, p)
    single = a.x.ndim == 1
    xs = limbs_to_ints(a.x)
    ys = limbs_to_ints(a.y)
    inf = np.atleast_1d(to_reference(a.inf))
    if single:
        xs, ys = [xs], [ys]
    return [
        G1.identity() if bool(i) else G1(x * rinv % p, y * rinv % p)
        for x, y, i in zip(xs, ys, inf)
    ]


def pack_scalars(scalars: List[Fr], device: DeviceArg = None) -> torch.Tensor:
    """Host Fr list -> (16, N) canonical limb tensor."""
    return from_reference(ints_to_limbs([s.v for s in scalars], FR_LIMBS), device)
