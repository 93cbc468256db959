// BLS12-381 G1 point formulas on the GPU (Jacobian, a = 0), per thread.
//
// The same EFD formulas, in the same order, as the plain PyTorch versions in
// ops/g1.py (dbl-2009-l, add-2007-bl, madd-2007-bl). Infinity is z == 0. The
// plain versions resolve the special cases with masked selects; a thread
// branches instead, which gives the same values.
#pragma once

#include "fq.cuh"

namespace curdle {

struct Jac {
  Fq x, y, z;
};

__device__ __forceinline__ Jac jac_zero() {
  Jac r;
  r.x = fq_zero();
  r.y = fq_zero();
  r.z = fq_zero();
  return r;
}

// Jacobian doubling; infinity passes through via z = 0.
__device__ __forceinline__ Jac jac_dbl(const Jac& p) {
  const Fq a = fq_sqr(p.x);
  const Fq b = fq_sqr(p.y);
  const Fq c = fq_sqr(b);
  const Fq t = fq_add(p.x, b);
  const Fq d = fq_dbl(fq_sub(fq_sub(fq_sqr(t), a), c));
  const Fq e = fq_add(fq_add(a, a), a);
  const Fq f = fq_sqr(e);
  Jac r;
  r.x = fq_sub(f, fq_dbl(d));
  const Fq c8 = fq_dbl(fq_dbl(fq_dbl(c)));
  r.y = fq_sub(fq_mul(e, fq_sub(d, r.x)), c8);
  r.z = fq_dbl(fq_mul(p.y, p.z));
  return r;
}

// Complete Jacobian + Jacobian addition.
__device__ __forceinline__ Jac jac_add(const Jac& p, const Jac& q) {
  const bool pinf = fq_is_zero(p.z);
  const bool qinf = fq_is_zero(q.z);
  const Fq z1z1 = fq_sqr(p.z);
  const Fq z2z2 = fq_sqr(q.z);
  const Fq u1 = fq_mul(p.x, z2z2);
  const Fq u2 = fq_mul(q.x, z1z1);
  const Fq s1 = fq_mul(fq_mul(p.y, q.z), z2z2);
  const Fq s2 = fq_mul(fq_mul(q.y, p.z), z1z1);
  const Fq h = fq_sub(u2, u1);
  const Fq i = fq_sqr(fq_dbl(h));
  const Fq j = fq_mul(h, i);
  const Fq r = fq_dbl(fq_sub(s2, s1));
  const Fq v = fq_mul(u1, i);
  Jac res;
  res.x = fq_sub(fq_sub(fq_sqr(r), j), fq_dbl(v));
  res.y = fq_sub(fq_mul(r, fq_sub(v, res.x)), fq_dbl(fq_mul(s1, j)));
  const Fq zz = fq_sub(fq_sub(fq_sqr(fq_add(p.z, q.z)), z1z1), z2z2);
  res.z = fq_mul(zz, h);  // h == 0 -> z3 == 0: P + (-P) is infinity for free
  if (fq_is_zero(h) && fq_is_zero(r) && !pinf && !qinf) res = jac_dbl(p);
  if (qinf) res = p;
  if (pinf) res = q;
  return res;
}

// Jacobian + affine mixed addition. COMPLETE resolves the p == q case by
// doubling; without it the result is wrong (z3 == 0) exactly where the
// returned flag is set, and the caller redoes that work on a complete path.
// Cancellation p == -q and both infinity cases are exact either way.
template <bool COMPLETE>
__device__ __forceinline__ bool jac_madd(Jac& out, const Jac& p, const Fq& qx, const Fq& qy,
                                         bool qinf) {
  const bool pinf = fq_is_zero(p.z);
  const Fq z1z1 = fq_sqr(p.z);
  const Fq u2 = fq_mul(qx, z1z1);
  const Fq s2 = fq_mul(fq_mul(qy, p.z), z1z1);
  const Fq h = fq_sub(u2, p.x);
  const Fq hh = fq_sqr(h);
  const Fq i = fq_dbl(fq_dbl(hh));
  const Fq j = fq_mul(h, i);
  const Fq r = fq_dbl(fq_sub(s2, p.y));
  const Fq v = fq_mul(p.x, i);
  Jac res;
  res.x = fq_sub(fq_sub(fq_sqr(r), j), fq_dbl(v));
  res.y = fq_sub(fq_mul(r, fq_sub(v, res.x)), fq_dbl(fq_mul(p.y, j)));
  res.z = fq_mul(fq_dbl(p.z), h);  // h == 0 -> infinity for free
  const bool dbl = fq_is_zero(h) && fq_is_zero(r) && !pinf && !qinf;
  if (COMPLETE && dbl) res = jac_dbl(p);
  if (qinf) res = p;
  if (pinf) {  // lift(q): z = 1 in Montgomery form, 0 where q is infinity
    res.x = qx;
    res.y = qy;
    res.z = qinf ? fq_zero() : fq_one();
  }
  out = res;
  return dbl;
}

}  // namespace curdle
