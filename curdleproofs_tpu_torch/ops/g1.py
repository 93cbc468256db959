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

The scalar multiplications work the same way. `scalar_mul_glv`, `scalar_mul`
and `scalar_mul_w1` hand CUDA tensors to the ladder kernels (ops.cuda_g1) and
CPU tensors to the plain ladders that stand here beside them:
`_scalar_mul_glv_plain` (the JAX package's `pallas_g1._build_glv_ladder_kernel`
and `_build_glv_ladder_w4_kernel`), `_scalar_mul_w3_plain`
(`pallas_g1.scalar_mul` over `_build_ladder_w3_kernel`) and `_scalar_mul_plain`
(`g1._scalar_mul_xla`, and `_build_ladder_kernel` when started from the zero
triple). They repeat the kernels' arithmetic step by step, so all three
Jacobian coordinates compare bit for bit.

BLS12-381 G1 has prime order (no 2-torsion), so y == 0 never occurs for
finite curve points and the doubling formula needs no special case.
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Optional, Sequence

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


def jneg(p: JPoints) -> JPoints:
    return JPoints(p.x, _neg(p.y), p.z)


def to_affine(p: JPoints) -> APoints:
    """Jacobian -> affine via batched Fermat inversion of Z (plain tensor
    code on whatever device the points lie on)."""
    zinv = ma.mont_inv(FQ_SPEC, p.z)
    zinv2 = _sqr(zinv)
    x = _mul(p.x, zinv2)
    y = _mul(p.y, _mul(zinv, zinv2))
    return APoints(x, y, is_inf(p))


# ---------------------------------------------------------------------------
# scalar multiplication / reduction
# ---------------------------------------------------------------------------

FR_BITS = 255


def window_digit(scalars: torch.Tensor, bitpos: int, width: int) -> torch.Tensor:
    """(k >> bitpos) & (2^width - 1) of (L, *B) scalars in 16-bit limbs ->
    (*B,) int64. A window may straddle two limbs; limbs past the top count
    as zero. width <= 16."""
    li, off = divmod(bitpos, 16)
    L = scalars.shape[0]
    zero = torch.zeros(scalars.shape[1:], dtype=torch.int64, device=scalars.device)
    lo = scalars[li].to(torch.int64) if li < L else zero
    hi = scalars[li + 1].to(torch.int64) if li + 1 < L else zero
    return ((lo | (hi << 16)) >> off) & ((1 << width) - 1)


def scalar_bit(scalars: torch.Tensor, t: int) -> torch.Tensor:
    """Bit t of canonical (16, *B) Fr limbs -> (*B,) of 0/1."""
    return window_digit(scalars, t, 1)


def _jzero(like: torch.Tensor) -> JPoints:
    """The all-zero triple (z == 0: infinity), where the ladder kernels start."""
    z = torch.zeros_like(like)
    return JPoints(z, z.clone(), z.clone())


def _table_select(table: Sequence[JPoints], d: torch.Tensor) -> JPoints:
    """table[d - 1] per lane for d >= 1 (table[0] where d == 0: the caller
    discards that lane's add)."""
    x, y, z = table[0]
    for k in range(2, len(table) + 1):
        hit = (d == k).unsqueeze(0)
        x = torch.where(hit, table[k - 1].x, x)
        y = torch.where(hit, table[k - 1].y, y)
        z = torch.where(hit, table[k - 1].z, z)
    return JPoints(x, y, z)


def _odd_even_table(base: APoints, entries: int, handle_doubling: bool) -> List[JPoints]:
    """[1*P, 2*P, ..., entries*P] by the chain T[2k] = 2*T[k],
    T[2k+1] = T[2k] + P (entries = 7 or 15)."""
    table: List[Optional[JPoints]] = [None] * (entries + 1)
    table[1] = lift(base)
    for k in range(1, (entries + 1) // 2):
        table[2 * k] = _jdbl_formulas(table[k])
        table[2 * k + 1] = _jmadd_formulas(table[2 * k], base, handle_doubling=handle_doubling)
    return table[1:]


def _scalar_mul_plain(points: APoints, scalars: torch.Tensor, acc0: Optional[JPoints] = None) -> JPoints:
    """Plain bitwise ladder: 255 times a doubling, a complete mixed add of
    the base, and a select by bit 254 - i. acc0 is the starting value: the
    (1, 1, 0) identity of `jinf` by default, as the JAX package's
    `_scalar_mul_xla`; the `ladder_w1` kernel starts from the zero triple
    (the two differ only in the x and y of lanes that stay at infinity)."""
    acc = jinf(points.x.shape[1:], device=points.x.device) if acc0 is None else acc0
    for t in range(FR_BITS - 1, -1, -1):
        acc = _jdbl_formulas(acc)
        cand = _jmadd_formulas(acc, points)
        acc = jselect(scalar_bit(scalars, t) == 1, cand, acc)
    return acc


def _scalar_mul_w3_plain(points: APoints, scalars: torch.Tensor) -> JPoints:
    """Plain 3-bit windowed ladder over (16, *B) Fr limbs: the table {1..7}P
    by complete doublings and mixed adds, then 85 times three doublings and
    one doubling-free table add by the digit at bit 252 - 3i."""
    table = _odd_even_table(points, 7, handle_doubling=True)
    acc = _jzero(points.x)
    for i in range(85):
        for _ in range(3):
            acc = _jdbl_formulas(acc)
        d = window_digit(scalars, 252 - 3 * i, 3)
        cand = _jadd_formulas(acc, _table_select(table, d), handle_doubling=False)
        acc = jselect(d == 0, acc, cand)
    return acc


def _beta_like(like: torch.Tensor) -> torch.Tensor:
    from curdleproofs_tpu_torch.ops.cuda_g1 import _beta_mont_limbs

    return ma._col(_beta_mont_limbs(), like).expand_as(like)


def _scalar_mul_glv_plain(
    points: APoints, s1: torch.Tensor, neg1: torch.Tensor, s2: torch.Tensor, w: int = 3
) -> JPoints:
    """Plain GLV dual-table ladder, k*P = k1*P + k2*phi(P) with
    phi(X, Y, Z) = (beta*X, Y, Z): s1, s2 (9, *B) limbs of |k1|, k2, neg1
    (*B,) the sign of k1. Table 1 holds {1..2^w - 1}(+-P) by that sign,
    table 2 its image under phi with y negated back where table 1 was
    negated (k2 >= 0). Then 43 (w = 3) or 33 (w = 4) times w doublings and
    two doubling-free table adds, digits at bit 126 - 3i or 128 - 4i."""
    if w not in (3, 4):
        raise ValueError(f"scalar_mul_glv: window width must be 3 or 4, got {w}")
    neg = neg1.to(torch.bool)
    base1 = APoints(points.x, _fsel(neg, _neg(points.y), points.y), points.inf)
    t1 = _odd_even_table(base1, (1 << w) - 1, handle_doubling=False)
    beta = _beta_like(points.x)
    t2 = [JPoints(_mul(t.x, beta), _fsel(neg, _neg(t.y), t.y), t.z) for t in t1]
    iters, top = (43, 126) if w == 3 else (33, 128)
    acc = _jzero(points.x)
    for i in range(iters):
        for _ in range(w):
            acc = _jdbl_formulas(acc)
        d1 = window_digit(s1, top - w * i, w)
        d2 = window_digit(s2, top - w * i, w)
        cand = _jadd_formulas(acc, _table_select(t1, d1), handle_doubling=False)
        acc = jselect(d1 == 0, acc, cand)
        cand = _jadd_formulas(acc, _table_select(t2, d2), handle_doubling=False)
        acc = jselect(d2 == 0, acc, cand)
    return acc


def scalar_mul_glv(
    points: APoints, s1: torch.Tensor, neg1: torch.Tensor, s2: torch.Tensor, w: Optional[int] = None
) -> JPoints:
    """Per-lane k_i * P_i from GLV-split scalars (`ops.glv.decompose`): the
    `ladder_glv_w3` / `ladder_glv_w4` kernel for CUDA tensors, the plain
    version for CPU tensors. w defaults to `cuda_g1.GLV_W`."""
    from curdleproofs_tpu_torch.ops import cuda_g1

    if points.x.is_cuda:
        return cuda_g1.scalar_mul_glv(points, s1, neg1, s2, w)
    return _scalar_mul_glv_plain(points, s1, neg1, s2, cuda_g1.GLV_W if w is None else w)


def scalar_mul(points: APoints, scalars: torch.Tensor) -> JPoints:
    """Per-lane k_i * P_i over (16, *B) canonical (non-Montgomery) Fr limbs
    with the 3-bit windowed ladder: the point kernel and `ladder_w3` for CUDA
    tensors, the plain version for CPU tensors."""
    if points.x.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return cuda_g1.scalar_mul(points, scalars)
    return _scalar_mul_w3_plain(points, scalars)


def scalar_mul_w1(points: APoints, scalars: torch.Tensor) -> JPoints:
    """The bitwise ladder, kept for cross-checking: the `ladder_w1` kernel for
    CUDA tensors, the plain version (from the zero triple, as the kernel
    starts) for CPU tensors."""
    if points.x.is_cuda:
        from curdleproofs_tpu_torch.ops import cuda_g1

        return cuda_g1.scalar_mul_w1(points, scalars)
    return _scalar_mul_plain(points, scalars, acc0=_jzero(points.x))


def tree_reduce(p: JPoints) -> JPoints:
    """Sum a (24, N) Jacobian vector down to a single point by log2(N)
    rounds of halving adds (padded with infinity to a power of two)."""
    n = p.x.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = jinf(p.x.shape[1:-1] + (m - n,), device=p.x.device)
        p = JPoints(*(torch.cat([a, b], dim=-1) for a, b in zip(p, pad)))
    while m > 1:
        m //= 2
        lo = JPoints(p.x[..., :m], p.y[..., :m], p.z[..., :m])
        hi = JPoints(p.x[..., m:], p.y[..., m:], p.z[..., m:])
        p = jadd(lo, hi)
    return JPoints(p.x[..., 0], p.y[..., 0], p.z[..., 0])


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


def unpack_scalars(arr) -> List[Fr]:
    """(16, N) or (16,) canonical limbs (tensor or numpy) -> host Fr list."""
    vals = limbs_to_ints(arr)
    if isinstance(vals, int):
        return [Fr(vals)]
    return [Fr(v) for v in vals]
