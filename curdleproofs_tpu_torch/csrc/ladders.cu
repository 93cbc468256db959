// The scalar-multiplication ladder kernels, with a plain C interface.
//
// Built like kernels.cu, into a shared library of its own (the two sources
// share only headers, so they compile side by side):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcurdle_ladders.so ladders.cu
// and loaded with ctypes (ops/cuda_g1.py). Every entry point launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// Four kernels, each computing k_i * P_i for every lane i, one thread per
// lane, the whole ladder inside the thread:
//
//   ladder_glv_w3, ladder_glv_w4   (one template over the window width)
//       replace ops/pallas_g1.py::_build_glv_ladder_kernel and
//       ::_build_glv_ladder_w4_kernel of the JAX package
//   ladder_w3   replaces ops/pallas_g1.py::_build_ladder_w3_kernel
//   ladder_w1   replaces ops/pallas_g1.py::_build_ladder_kernel
//
// All four are bound by operations: a lane reads two to twenty field
// elements and a scalar, writes three field elements, and in between runs a
// dependent chain of 2,300 to 4,600 Montgomery products. The formulas, their
// order and the special cases are those of the plain PyTorch versions in
// ops/g1.py (`_scalar_mul_glv_plain`, `_scalar_mul_w3_plain`,
// `_scalar_mul_plain`), so all three Jacobian coordinates come out bit for
// bit the same; where those select by mask, a thread branches.
//
// What the design does about the bound: nothing yet beyond keeping every
// intermediate in the thread. The callers offer 8,192 to 16,384 lanes, less
// than one warp per scheduler of the card, so blocks are one warp wide to
// spread the chains over all SMs. The point formulas are called through
// `__noinline__` shims: an iteration holds up to six point operations, and
// one shared body each keeps the build at seconds (see fq.cuh on fq_mul).
//
// Tables: table 1 of the GLV ladders ({1..7} or {1..15} times +-P, 1,008 or
// 2,160 bytes a thread) is indexed by a run-time digit and therefore lives
// in local memory. Table 2, the endomorphism image (beta*X, +-Y, Z), is not
// stored: the selected table-1 entry is mapped when it is needed (one
// Montgomery product and one conditional negation per add), which halves the
// local memory. ladder_w3 reads its table, built by the caller, from global
// memory at the selected entry.
//
// Tensors arrive in the package's layout: 32-bit containers holding 16-bit
// limbs, limb-major, lanes on the last axis (see kernels.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace curdle {

constexpr int LADDER_THREADS = 32;

// One shared body per point operation.
__device__ __noinline__ void lad_dbl(Jac& p) { p = jac_dbl(p); }

// acc += q without the doubling branch (see jac_add).
__device__ __noinline__ void lad_add(Jac& acc, const Jac& q) { acc = jac_add<false>(acc, q); }

template <bool COMPLETE>
__device__ __noinline__ void lad_madd(Jac& out, const Jac& p, const Fq& qx, const Fq& qy,
                                      bool qinf) {
  Jac r;
  jac_madd<COMPLETE>(r, p, qx, qy, qinf);
  out = r;
}

// A scalar of LIMBS 16-bit limbs as 32-bit words, with zero words on top so
// that a window may straddle the last limb.
template <int LIMBS>
struct Scalar {
  static constexpr int WORDS = (LIMBS + 1) / 2 + 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ base, size_t stride) {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const uint32_t lo = 2 * k < LIMBS ? base[(size_t)(2 * k) * stride] : 0u;
      const uint32_t hi = 2 * k + 1 < LIMBS ? base[(size_t)(2 * k + 1) * stride] : 0u;
      w[k] = (lo & 0xffffu) | (hi << 16);
    }
  }

  // (k >> bitpos) & (2^width - 1): a 64-bit funnel over two words.
  __device__ __forceinline__ uint32_t digit(int bitpos, int width) const {
    const int wi = bitpos >> 5;
    const uint64_t v = ((uint64_t)w[wi + 1] << 32) | (uint64_t)w[wi];
    return (uint32_t)(v >> (bitpos & 31)) & ((1u << width) - 1u);
  }
};

__device__ __forceinline__ void jac_store(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                          uint32_t* __restrict__ oz, size_t stride,
                                          const Jac& a) {
  fq_store(ox, stride, a.x);
  fq_store(oy, stride, a.y);
  fq_store(oz, stride, a.z);
}

// ---------------------------------------------------------------------------
// ladder_glv_w3 / ladder_glv_w4: k*P = k1*P + k2*phi(P), phi(X, Y, Z) =
// (beta*X, Y, Z), with |k1| < 2^129 signed and 0 <= k2 < 2^128.
//
// px, py (24, m) affine Montgomery; inf, neg (m,) flags (neg = sign of k1);
// s1, s2 (9, m) limbs of |k1|, k2 -> ox, oy, oz (24, m).
// Table 1 holds {1..2^W - 1} * (+-P) by the sign of k1, built by the
// doubling/mixed-add chain T[2k] = 2*T[k], T[2k+1] = T[2k] + (+-P). The
// table-2 entry is (beta*X, Y, Z) of the table-1 entry with y negated BACK
// where table 1 was negated, because k2 is never negative. Then ITERS times:
// W doublings, one table-1 add by the digit of k1, one table-2 add by the
// digit of k2, digits at bit TOP - W*i. A zero digit adds nothing.
// ---------------------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(LADDER_THREADS)
ladder_glv_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const int32_t* __restrict__ inf, const int32_t* __restrict__ neg,
                  const uint32_t* __restrict__ s1, const uint32_t* __restrict__ s2,
                  const Fq beta, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                  uint32_t* __restrict__ oz, int m) {
  constexpr int ENTRIES = (1 << W) - 1;
  constexpr int ITERS = W == 3 ? 43 : 33;
  constexpr int TOP = W == 3 ? 126 : 128;
  const int i = blockIdx.x * LADDER_THREADS + threadIdx.x;
  if (i >= m) return;
  const size_t stride = (size_t)m;

  const Fq bx = fq_load(px + i, stride);
  Fq by = fq_load(py + i, stride);
  const bool binf = inf[i] != 0;
  const bool ng = neg[i] != 0;
  if (ng) by = fq_neg(by);
  Scalar<9> k1, k2;
  k1.load(s1 + i, stride);
  k2.load(s2 + i, stride);

  Jac tab[ENTRIES];  // tab[k - 1] = k * (+-P)
  tab[0] = jac_lift(bx, by, binf);
#pragma unroll 1
  for (int k = 1; k < (1 << (W - 1)); ++k) {
    Jac t = tab[k - 1];
    lad_dbl(t);
    tab[2 * k - 1] = t;
    lad_madd<false>(tab[2 * k], t, bx, by, binf);
  }

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll 1
    for (int k = 0; k < W; ++k) lad_dbl(acc);
    const int bitpos = TOP - W * it;
    const uint32_t d1 = k1.digit(bitpos, W);
    const uint32_t d2 = k2.digit(bitpos, W);
    if (d1 != 0u) lad_add(acc, tab[d1 - 1]);
    if (d2 != 0u) {
      Jac t = tab[d2 - 1];
      t.x = fq_mul(t.x, beta);
      if (ng) t.y = fq_neg(t.y);
      lad_add(acc, t);
    }
  }
  jac_store(ox + i, oy + i, oz + i, stride, acc);
}

// ---------------------------------------------------------------------------
// ladder_w3: k*P over 16-limb scalars with 3-bit windows, the table
// {1..7}*P handed in by the caller (built with the point kernel).
//
// table (7, 72, m): entry k - 1 is the Jacobian triple of k*P (X rows 0-23,
// Y 24-47, Z 48-71); sc (16, m) -> ox, oy, oz (24, m). 85 times: three
// doublings, one doubling-free table add by the digit at bit 252 - 3*i.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(LADDER_THREADS)
ladder_w3_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ sc,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int m) {
  const int i = blockIdx.x * LADDER_THREADS + threadIdx.x;
  if (i >= m) return;
  const size_t stride = (size_t)m;
  Scalar<16> k;
  k.load(sc + i, stride);

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < 85; ++it) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) lad_dbl(acc);
    const uint32_t d = k.digit(252 - 3 * it, 3);
    if (d != 0u) {
      const uint32_t* e = table + (size_t)(d - 1) * 72 * stride + i;
      Jac t;
      t.x = fq_load(e, stride);
      t.y = fq_load(e + 24 * stride, stride);
      t.z = fq_load(e + 48 * stride, stride);
      lad_add(acc, t);
    }
  }
  jac_store(ox + i, oy + i, oz + i, stride, acc);
}

// ---------------------------------------------------------------------------
// ladder_w1: the bitwise ladder, 255 times a doubling and, where bit
// 254 - i of the scalar is set, a complete mixed add of the base.
//
// px, py (24, m), inf (m,), sc (16, m) -> ox, oy, oz (24, m).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(LADDER_THREADS)
ladder_w1_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const int32_t* __restrict__ inf, const uint32_t* __restrict__ sc,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int m) {
  const int i = blockIdx.x * LADDER_THREADS + threadIdx.x;
  if (i >= m) return;
  const size_t stride = (size_t)m;
  const Fq bx = fq_load(px + i, stride);
  const Fq by = fq_load(py + i, stride);
  const bool binf = inf[i] != 0;
  Scalar<16> k;
  k.load(sc + i, stride);

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < 255; ++it) {
    lad_dbl(acc);
    if (k.digit(254 - it, 1) != 0u) lad_madd<true>(acc, acc, bx, by, binf);
  }
  jac_store(ox + i, oy + i, oz + i, stride, acc);
}

}  // namespace curdle

using namespace curdle;

extern "C" {

// w: 3 or 4. beta: 12 host words, the endomorphism constant in Montgomery
// form, little-endian 32-bit words.
int curdle_ladder_glv(int w, const void* px, const void* py, const void* inf, const void* neg,
                      const void* s1, const void* s2, const uint32_t* beta, void* ox, void* oy,
                      void* oz, int m, void* stream) {
  Fq b;
  for (int k = 0; k < FQ_WORDS; ++k) b.v[k] = beta[k];
  const int blocks = (m + LADDER_THREADS - 1) / LADDER_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define CURDLE_GLV_ARGS                                                                     \
  (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)inf, (const int32_t*)neg,       \
      (const uint32_t*)s1, (const uint32_t*)s2, b, (uint32_t*)ox, (uint32_t*)oy,            \
      (uint32_t*)oz, m
  if (w == 3) {
    ladder_glv_kernel<3><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_GLV_ARGS);
  } else if (w == 4) {
    ladder_glv_kernel<4><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_GLV_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CURDLE_GLV_ARGS
  return (int)cudaGetLastError();
}

// table (7, 72, m), sc (16, m) -> ox, oy, oz (24, m).
int curdle_ladder_w3(const void* table, const void* sc, void* ox, void* oy, void* oz, int m,
                     void* stream) {
  const int blocks = (m + LADDER_THREADS - 1) / LADDER_THREADS;
  ladder_w3_kernel<<<blocks, LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)sc, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, m);
  return (int)cudaGetLastError();
}

// px, py (24, m), inf (m,), sc (16, m) -> ox, oy, oz (24, m).
int curdle_ladder_w1(const void* px, const void* py, const void* inf, const void* sc, void* ox,
                     void* oy, void* oz, int m, void* stream) {
  const int blocks = (m + LADDER_THREADS - 1) / LADDER_THREADS;
  ladder_w1_kernel<<<blocks, LADDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)inf, (const uint32_t*)sc,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
