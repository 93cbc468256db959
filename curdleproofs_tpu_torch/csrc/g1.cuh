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

// Affine -> Jacobian: z = 1 in Montgomery form, 0 where the point is infinity.
__device__ __forceinline__ Jac jac_lift(const Fq& x, const Fq& y, bool inf) {
  Jac r;
  r.x = x;
  r.y = y;
  r.z = inf ? fq_zero() : fq_one();
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

// Jacobian + Jacobian addition. COMPLETE resolves the p == q case by
// doubling; without it that case yields z3 == 0, which is only sound where
// the caller knows it cannot occur (the table adds of the windowed ladders).
// Cancellation p == -q and both infinity cases are exact either way.
template <bool COMPLETE = true>
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
  if (COMPLETE && fq_is_zero(h) && fq_is_zero(r) && !pinf && !qinf) res = jac_dbl(p);
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
  if (pinf) res = jac_lift(qx, qy, qinf);
  out = res;
  return dbl;
}

// ---------------------------------------------------------------------------
// The same three formulas for a group of G neighbouring threads of a warp
// that serve one lane together (G = 1, 2 or 4; G = 1 is the functions above).
//
// Each formula is cut into rounds of independent products: a round needs
// only values from the rounds before it.
//   jac_dbl   {X^2, Y^2, Y*Z} {B^2, (X+B)^2, E^2} {E*(D-X3)}          3 rounds
//   jac_add   {Z1^2, Z2^2, Y1*Z2, Y2*Z1} {U1, U2, S1, S2}
//             {(2H)^2, R^2, (Z1+Z2)^2} {H*I, U1*I, ZZ*H}
//             {R*(V-X3), S1*J}                                      5 rounds
//   jac_madd  {Z1^2, Y2*Z1} {U2, S2} {H^2, R^2, 2Z1*H} {H*I, X1*I}
//             {R*(V-X3), Y1*J}                                      5 rounds
// Thread q of the group computes products q, q + G, ... of a round with the
// out-of-line fq_mul (fq_sqr where the whole round is squares: the second
// round of jac_dbl and the third of jac_add), and the group then exchanges
// them by warp shuffles, so every thread holds every product; each thread
// redoes the additions and subtractions itself. A lane's chain of dependent
// products shrinks from 7 / 16 / 11 to 3 / 5 / 5 at G = 4, and the card gets
// G times the warps. The field values are those of the one-thread formulas (products
// of canonical residues are canonical whatever their order), so the results
// are the same bit for bit.
//
// The callers keep every thread of a warp on one path: a lane past the end
// of the data computes a copy of a valid lane and skips its store, and a
// case that only some groups of a warp take (the doubling branch of a
// complete add, a ladder's zero digit) is run by the whole warp when any
// group needs it and selected per group. So every shuffle names the full
// warp.
// ---------------------------------------------------------------------------

constexpr unsigned FULL_WARP = 0xffffffffu;

// Store a Jacobian triple, each thread of a group its share: thread q writes
// the 32-bit words k with k % G == q (limb rows 2k and 2k + 1) of X, Y, Z.
template <int G>
__device__ __forceinline__ void jac_store_share(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                                uint32_t* __restrict__ oz, size_t stride,
                                                const Jac& a, int q) {
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    if (k % G != q) continue;
    ox[(size_t)(2 * k) * stride] = a.x.v[k] & 0xffffu;
    ox[(size_t)(2 * k + 1) * stride] = a.x.v[k] >> 16;
    oy[(size_t)(2 * k) * stride] = a.y.v[k] & 0xffffu;
    oy[(size_t)(2 * k + 1) * stride] = a.y.v[k] >> 16;
    oz[(size_t)(2 * k) * stride] = a.z.v[k] & 0xffffu;
    oz[(size_t)(2 * k + 1) * stride] = a.z.v[k] >> 16;
  }
}

// r[j] = a[j] * b[j] for j < N, by the G threads of a group side by side.
// q: this thread's place in its group. SQR: every product of the round is a
// square (b == a), so every thread calls fq_sqr; a round that mixes squares
// and products calls fq_mul for all, so the threads of a warp never take
// different calls.
template <int G, int N, bool SQR = false>
__device__ __forceinline__ void mul_round(Fq (&r)[N], const Fq (&a)[N], const Fq (&b)[N], int q) {
  if constexpr (G == 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = SQR ? fq_sqr(a[j]) : fq_mul(a[j], b[j]);
  } else {
    constexpr int S = (N + G - 1) / G;  // products a thread computes
    Fq mine[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // product s*G + q; a thread past the round's end repeats product s*G
      Fq x = a[s * G], y = b[s * G];
#pragma unroll
      for (int k = 1; k < G; ++k) {
        if (s * G + k < N && q == k) {
          x = a[s * G + k];
          y = b[s * G + k];
        }
      }
      mine[s] = SQR ? fq_sqr(x) : fq_mul(x, y);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int w = 0; w < FQ_WORDS; ++w)
        r[j].v[w] = __shfl_sync(FULL_WARP, mine[j / G].v[w], j % G, G);
    }
  }
}

template <int G>
__device__ __forceinline__ Jac jac_dbl_g(const Jac& p, int q) {
  if constexpr (G == 1) {
    return jac_dbl(p);
  } else {
    const Fq a1[3] = {p.x, p.y, p.y}, b1[3] = {p.x, p.y, p.z};
    Fq r1[3];  // A = X^2, B = Y^2, Y*Z
    mul_round<G, 3>(r1, a1, b1, q);
    const Fq t = fq_add(p.x, r1[1]);
    const Fq e = fq_add(fq_add(r1[0], r1[0]), r1[0]);
    const Fq a2[3] = {r1[1], t, e}, b2[3] = {r1[1], t, e};
    Fq r2[3];  // C = B^2, (X+B)^2, F = E^2
    mul_round<G, 3, true>(r2, a2, b2, q);
    const Fq d = fq_dbl(fq_sub(fq_sub(r2[1], r1[0]), r2[0]));
    Jac res;
    res.x = fq_sub(r2[2], fq_dbl(d));
    const Fq c8 = fq_dbl(fq_dbl(fq_dbl(r2[0])));
    const Fq a3[1] = {e}, b3[1] = {fq_sub(d, res.x)};
    Fq r3[1];
    mul_round<G, 1>(r3, a3, b3, q);
    res.y = fq_sub(r3[0], c8);
    res.z = fq_dbl(r1[2]);
    return res;
  }
}

// jac_add<COMPLETE> for a group.
template <int G, bool COMPLETE>
__device__ __forceinline__ Jac jac_add_g(const Jac& p, const Jac& q2, int q) {
  if constexpr (G == 1) {
    return jac_add<COMPLETE>(p, q2);
  } else {
    const bool pinf = fq_is_zero(p.z);
    const bool qinf = fq_is_zero(q2.z);
    const Fq a1[4] = {p.z, q2.z, p.y, q2.y}, b1[4] = {p.z, q2.z, q2.z, p.z};
    Fq r1[4];  // Z1Z1, Z2Z2, Y1*Z2, Y2*Z1
    mul_round<G, 4>(r1, a1, b1, q);
    const Fq a2[4] = {p.x, q2.x, r1[2], r1[3]}, b2[4] = {r1[1], r1[0], r1[1], r1[0]};
    Fq r2[4];  // U1, U2, S1, S2
    mul_round<G, 4>(r2, a2, b2, q);
    const Fq h = fq_sub(r2[1], r2[0]);
    const Fq r = fq_dbl(fq_sub(r2[3], r2[2]));
    const Fq h2 = fq_dbl(h), zs = fq_add(p.z, q2.z);
    const Fq a3[3] = {h2, r, zs}, b3[3] = {h2, r, zs};
    Fq r3[3];  // I = (2H)^2, R^2, (Z1+Z2)^2
    mul_round<G, 3, true>(r3, a3, b3, q);
    const Fq zz = fq_sub(fq_sub(r3[2], r1[0]), r1[1]);
    const Fq a4[3] = {h, r2[0], zz}, b4[3] = {r3[0], r3[0], h};
    Fq r4[3];  // J = H*I, V = U1*I, Z3 = ZZ*H
    mul_round<G, 3>(r4, a4, b4, q);
    Jac res;
    res.x = fq_sub(fq_sub(r3[1], r4[0]), fq_dbl(r4[1]));
    const Fq a5[2] = {r, r2[2]}, b5[2] = {fq_sub(r4[1], res.x), r4[0]};
    Fq r5[2];  // R*(V-X3), S1*J
    mul_round<G, 2>(r5, a5, b5, q);
    res.y = fq_sub(r5[0], fq_dbl(r5[1]));
    res.z = r4[2];  // h == 0 -> z3 == 0: P + (-P) is infinity for free
    if constexpr (COMPLETE) {
      const bool dbl = fq_is_zero(h) && fq_is_zero(r) && !pinf && !qinf;
      if (__any_sync(FULL_WARP, dbl)) {
        const Jac twice = jac_dbl_g<G>(p, q);
        if (dbl) res = twice;
      }
    }
    if (qinf) res = p;
    if (pinf) res = q2;
    return res;
  }
}

// jac_madd<COMPLETE> for a group; returns the same flag.
template <int G, bool COMPLETE>
__device__ __forceinline__ bool jac_madd_g(Jac& out, const Jac& p, const Fq& qx, const Fq& qy,
                                           bool qinf, int q) {
  if constexpr (G == 1) {
    return jac_madd<COMPLETE>(out, p, qx, qy, qinf);
  } else {
    const bool pinf = fq_is_zero(p.z);
    const Fq a1[2] = {p.z, qy}, b1[2] = {p.z, p.z};
    Fq r1[2];  // Z1Z1, Y2*Z1
    mul_round<G, 2>(r1, a1, b1, q);
    const Fq a2[2] = {qx, r1[1]}, b2[2] = {r1[0], r1[0]};
    Fq r2[2];  // U2, S2
    mul_round<G, 2>(r2, a2, b2, q);
    const Fq h = fq_sub(r2[0], p.x);
    const Fq r = fq_dbl(fq_sub(r2[1], p.y));
    const Fq a3[3] = {h, r, fq_dbl(p.z)}, b3[3] = {h, r, h};
    Fq r3[3];  // HH, R^2, Z3 = 2Z1*H
    mul_round<G, 3>(r3, a3, b3, q);
    const Fq i = fq_dbl(fq_dbl(r3[0]));
    const Fq a4[2] = {h, p.x}, b4[2] = {i, i};
    Fq r4[2];  // J = H*I, V = X1*I
    mul_round<G, 2>(r4, a4, b4, q);
    Jac res;
    res.x = fq_sub(fq_sub(r3[1], r4[0]), fq_dbl(r4[1]));
    const Fq a5[2] = {r, p.y}, b5[2] = {fq_sub(r4[1], res.x), r4[0]};
    Fq r5[2];  // R*(V-X3), Y1*J
    mul_round<G, 2>(r5, a5, b5, q);
    res.y = fq_sub(r5[0], fq_dbl(r5[1]));
    res.z = r3[2];  // h == 0 -> infinity for free
    const bool dbl = fq_is_zero(h) && fq_is_zero(r) && !pinf && !qinf;
    if constexpr (COMPLETE) {
      if (__any_sync(FULL_WARP, dbl)) {
        const Jac twice = jac_dbl_g<G>(p, q);
        if (dbl) res = twice;
      }
    }
    if (qinf) res = p;
    if (pinf) res = jac_lift(qx, qy, qinf);
    out = res;
    return dbl;
  }
}

}  // namespace curdle
