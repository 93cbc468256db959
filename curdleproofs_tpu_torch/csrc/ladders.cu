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
// Four kernels, each computing k_i * P_i for every lane i, each lane served
// by a group of G threads (G = 1, 2 or 4):
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
// What the design does about the bound: the callers offer 124 to 16,384
// lanes, so blocks are one warp wide to spread the chains over all SMs.
// Where the lanes' warps leave the card's 528 schedulers idle, each ladder
// spreads a lane over a group of G threads that run a formula's independent
// products side by side (g1.cuh), which shortens the chain; where they do
// not, G = 1 and the chain runs in one thread. The caller picks G by width
// (ops/cuda_g1.ladder_glv_group, ladder_group, ladder_w1_group).
// At G = 1 the point formulas are called through `__noinline__` shims (an
// iteration holds up to six point operations, and one shared body each
// keeps the build at seconds; see fq.cuh on fq_mul); at G > 1 the group
// formulas are inlined into the loop (stack 864 -> 40 bytes for ladder_w3,
// 10 % faster on an H100 than through shims; PERF.md).
//
// Tables: table 1 of the GLV ladders ({1..7} or {1..15} times +-P, 1,008 or
// 2,160 bytes a thread) is indexed by a run-time digit and therefore lives
// in local memory, one copy per thread at every G (a group's threads hold
// the same values). Table 2, the endomorphism image (beta*X, +-Y, Z), is not
// stored: the selected table-1 entry is mapped when it is needed (one
// Montgomery product and one conditional negation per add), which halves the
// local memory (storing beta*X of each entry instead read 1 to 5 % slower on
// an H100 at the table's width; PERF.md). ladder_w3 reads its table, built by the caller, from global
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

// How a ladder loop calls its point formulas: G = 1 through the shims above,
// G > 1 with the group formulas inlined (see the head of this file).
template <int G>
__device__ __forceinline__ void grp_dbl(Jac& p, int q) {
  if constexpr (G == 1) {
    lad_dbl(p);
  } else {
    p = jac_dbl_g<G>(p, q);
  }
}

template <int G>
__device__ __forceinline__ void grp_add(Jac& acc, const Jac& b, int q) {
  if constexpr (G == 1) {
    lad_add(acc, b);
  } else {
    acc = jac_add_g<G, false>(acc, b, q);
  }
}

// COMPLETE: with the doubling branch, which a group runs on the whole warp
// when any group of it needs it (jac_madd_g).
template <int G, bool COMPLETE = false>
__device__ __forceinline__ void grp_madd(Jac& out, const Jac& p, const Fq& qx, const Fq& qy, bool qinf,
                                         int q) {
  if constexpr (G == 1) {
    lad_madd<COMPLETE>(out, p, qx, qy, qinf);
  } else {
    jac_madd_g<G, COMPLETE>(out, p, qx, qy, qinf, q);
  }
}

// Whether a warp runs a lane's branch: the lane's own condition at G = 1;
// at G > 1 whether any group of the warp needs it, so every shuffle of the
// group formulas meets the full warp (each group then keeps its own result).
template <int G>
__device__ __forceinline__ bool warp_takes(bool lane_needs) {
  if constexpr (G == 1) {
    return lane_needs;
  } else {
    return __any_sync(FULL_WARP, lane_needs);
  }
}

// ---------------------------------------------------------------------------
// ladder_glv_w3 / ladder_glv_w4: k*P = k1*P + k2*phi(P), phi(X, Y, Z) =
// (beta*X, Y, Z), with |k1| < 2^129 signed and 0 <= k2 < 2^128, G threads a
// lane.
//
// px, py (24, m) affine Montgomery; inf, neg (m,) flags (neg = sign of k1);
// s1, s2 (9, m) limbs of |k1|, k2 -> ox, oy, oz (24, m).
// Table 1 holds {1..2^W - 1} * (+-P) by the sign of k1, built by the
// doubling/mixed-add chain T[2k] = 2*T[k], T[2k+1] = T[2k] + (+-P). The
// table-2 entry is (beta*X, Y, Z) of the table-1 entry with y negated BACK
// where table 1 was negated, because k2 is never negative. Then ITERS times:
// W doublings, one table-1 add by the digit of k1, one table-2 add by the
// digit of k2, digits at bit TOP - W*i. A zero digit adds nothing.
//
// A lane's chain is the table (2^(W-1) - 1 doublings and mixed adds, of 7
// and 11 products) and ITERS * (7W + 2 * 16 + 1) products; at G = 4 the
// group formulas cut each doubling to 3 rounds and each add to 5. Thread t serves lane t / G
// as thread t % G; the G threads of a lane read the point and the scalars
// as one broadcast load, and each stores its share of the result; a thread
// past m computes lane m - 1 again and stores nothing. The digits are the
// lane's, so a group agrees on them; at G > 1 a warp runs each table add
// when any of its groups has a non-zero digit, and keeps it only in those
// groups.
// ---------------------------------------------------------------------------

template <int W, int G>
__global__ void __launch_bounds__(LADDER_THREADS)
ladder_glv_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  const int32_t* __restrict__ inf, const int32_t* __restrict__ neg,
                  const uint32_t* __restrict__ s1, const uint32_t* __restrict__ s2,
                  const Fq beta, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                  uint32_t* __restrict__ oz, int m) {
  constexpr int ENTRIES = (1 << W) - 1;
  constexpr int ITERS = W == 3 ? 43 : 33;
  constexpr int TOP = W == 3 ? 126 : 128;
  const int t = blockIdx.x * LADDER_THREADS + threadIdx.x;
  const int lane = t / G, q = t % G;
  if (G == 1 && lane >= m) return;  // no shuffles at G = 1
  const int i = lane < m ? lane : m - 1;
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
    Jac t2 = tab[k - 1];
    grp_dbl<G>(t2, q);
    tab[2 * k - 1] = t2;
    grp_madd<G>(tab[2 * k], t2, bx, by, binf, q);
  }

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll 1
    for (int k = 0; k < W; ++k) grp_dbl<G>(acc, q);
    const int bitpos = TOP - W * it;
    const uint32_t d1 = k1.digit(bitpos, W);
    const uint32_t d2 = k2.digit(bitpos, W);
    if (warp_takes<G>(d1 != 0u)) {
      Jac sum = acc;
      grp_add<G>(sum, tab[d1 != 0u ? d1 - 1 : 0], q);
      if (d1 != 0u) acc = sum;
    }
    if (warp_takes<G>(d2 != 0u)) {
      Jac t2 = tab[d2 != 0u ? d2 - 1 : 0];
      t2.x = fq_mul(t2.x, beta);
      if (ng) t2.y = fq_neg(t2.y);
      Jac sum = acc;
      grp_add<G>(sum, t2, q);
      if (d2 != 0u) acc = sum;
    }
  }
  if (lane < m) jac_store_share<G>(ox + i, oy + i, oz + i, stride, acc, q);
}

// ---------------------------------------------------------------------------
// ladder_w3: k*P over 16-limb scalars with 3-bit windows, the table
// {1..7}*P handed in by the caller (built with the point kernel), G threads
// a lane (1, 2 or 4, chosen by the caller from m: ops/cuda_g1.ladder_group).
//
// table (7, 72, m): entry k - 1 is the Jacobian triple of k*P (X rows 0-23,
// Y 24-47, Z 48-71); sc (16, m) -> ox, oy, oz (24, m). 85 times: three
// doublings, one doubling-free table add by the digit at bit 252 - 3*i.
//
// One thread a lane (G = 1) leaves schedulers idle: the vector ops launch it
// at 124 to 8,192 lanes, at most half a warp a scheduler, and an iteration
// is a chain of 3 * 7 + 16 = 37 dependent products. With the group formulas
// of g1.cuh the chain is 3 * 3 + 5 = 14 product rounds at G = 4 and 24 at
// G = 2, on G times the warps; past one warp a scheduler the extra work of a
// group costs more than the shorter chain saves (ops/cuda_g1.ladder_group).
// The digit is the lane's, so a group agrees on it; a warp runs
// the add when any of its groups has a non-zero digit (at G > 1) and keeps
// it only in those groups. The G threads of a lane read the scalar and the
// table entry as one broadcast load, and each stores its share of the
// result; a thread past m computes lane m - 1 again and stores nothing.
// ---------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(LADDER_THREADS)
ladder_w3_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ sc,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int m) {
  const int t = blockIdx.x * LADDER_THREADS + threadIdx.x;
  const int lane = t / G, q = t % G;
  const int i = lane < m ? lane : m - 1;
  const size_t stride = (size_t)m;
  Scalar<16> k;
  k.load(sc + i, stride);

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < 85; ++it) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) grp_dbl<G>(acc, q);
    const uint32_t d = k.digit(252 - 3 * it, 3);
    if (warp_takes<G>(d != 0u)) {
      const uint32_t* e = table + (size_t)(d != 0u ? d - 1 : 0) * 72 * stride + i;
      Jac b;
      b.x = fq_load(e, stride);
      b.y = fq_load(e + 24 * stride, stride);
      b.z = fq_load(e + 48 * stride, stride);
      Jac sum = acc;
      grp_add<G>(sum, b, q);
      if (d != 0u) acc = sum;
    }
  }
  if (lane < m) jac_store_share<G>(ox + i, oy + i, oz + i, stride, acc, q);
}

// ---------------------------------------------------------------------------
// ladder_w1: the bitwise ladder, 255 times a doubling and, where bit
// 254 - i of the scalar is set, a complete mixed add of the base; G threads
// a lane (1, 2 or 4, chosen by the caller from m: ops/cuda_g1.ladder_w1_group).
//
// px, py (24, m), inf (m,), sc (16, m) -> ox, oy, oz (24, m). The
// accumulator starts at the all-zero triple (infinity).
//
// A step is one dependent chain, 7 products for the doubling and 11 for the
// add, and the callers launch it at 124 to 8,192 lanes: at one thread a
// lane under half a warp a scheduler, so the time is one chain's latency.
// With the group formulas of g1.cuh a step is 3 + 5 = 8 product rounds at
// G = 4 and 11 at G = 2, on G times the warps, as in ladder_w3. The bit is
// the lane's, so a group agrees on it; a warp runs the add when any of its
// groups has the bit set (at G > 1) and keeps it only in those groups. The
// add is complete: its doubling branch (the prefix equals the base, as for
// k = r + 2 at the last bit) runs on the whole warp when any group meets it
// (jac_madd_g). The G threads of a lane read the point and the scalar as one
// broadcast load, and each stores its share of the result; a thread past m
// computes lane m - 1 again and stores nothing.
// ---------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(LADDER_THREADS)
ladder_w1_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const int32_t* __restrict__ inf, const uint32_t* __restrict__ sc,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 int m) {
  const int t = blockIdx.x * LADDER_THREADS + threadIdx.x;
  const int lane = t / G, q = t % G;
  if (G == 1 && lane >= m) return;  // no shuffles at G = 1
  const int i = lane < m ? lane : m - 1;
  const size_t stride = (size_t)m;
  const Fq bx = fq_load(px + i, stride);
  const Fq by = fq_load(py + i, stride);
  const bool binf = inf[i] != 0;
  Scalar<16> k;
  k.load(sc + i, stride);

  Jac acc = jac_zero();
#pragma unroll 1
  for (int it = 0; it < 255; ++it) {
    grp_dbl<G>(acc, q);
    const bool bit = k.digit(254 - it, 1) != 0u;
    if (warp_takes<G>(bit)) {
      Jac sum;
      grp_madd<G, true>(sum, acc, bx, by, binf, q);
      if (bit) acc = sum;
    }
  }
  if (lane < m) jac_store_share<G>(ox + i, oy + i, oz + i, stride, acc, q);
}

}  // namespace curdle

using namespace curdle;

extern "C" {

// w: 3 or 4. beta: 12 host words, the endomorphism constant in Montgomery
// form, little-endian 32-bit words. group: threads a lane, 1, 2 or 4;
// blocks of LADDER_THREADS, at least m * group threads in all.
int curdle_ladder_glv(int w, const void* px, const void* py, const void* inf, const void* neg,
                      const void* s1, const void* s2, const uint32_t* beta, void* ox, void* oy,
                      void* oz, int m, int group, int blocks, void* stream) {
  if (m < 1 || (long long)blocks * LADDER_THREADS < (long long)m * group)
    return (int)cudaErrorInvalidValue;
  Fq b;
  for (int k = 0; k < FQ_WORDS; ++k) b.v[k] = beta[k];
  cudaStream_t st = (cudaStream_t)stream;
#define CURDLE_GLV_LAUNCH(W, G)                                                                  \
  ladder_glv_kernel<W, G><<<blocks, LADDER_THREADS, 0, st>>>(                                    \
      (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)inf, (const int32_t*)neg,        \
      (const uint32_t*)s1, (const uint32_t*)s2, b, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, m)
  if (w == 3 && group == 1) {
    CURDLE_GLV_LAUNCH(3, 1);
  } else if (w == 3 && group == 2) {
    CURDLE_GLV_LAUNCH(3, 2);
  } else if (w == 3 && group == 4) {
    CURDLE_GLV_LAUNCH(3, 4);
  } else if (w == 4 && group == 1) {
    CURDLE_GLV_LAUNCH(4, 1);
  } else if (w == 4 && group == 2) {
    CURDLE_GLV_LAUNCH(4, 2);
  } else if (w == 4 && group == 4) {
    CURDLE_GLV_LAUNCH(4, 4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CURDLE_GLV_LAUNCH
  return (int)cudaGetLastError();
}

// table (7, 72, m), sc (16, m) -> ox, oy, oz (24, m); group: threads a lane,
// 1, 2 or 4; blocks of LADDER_THREADS, at least m * group threads in all.
int curdle_ladder_w3(const void* table, const void* sc, void* ox, void* oy, void* oz, int m,
                     int group, int blocks, void* stream) {
  if (m < 1 || (long long)blocks * LADDER_THREADS < (long long)m * group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CURDLE_W3_ARGS \
  (const uint32_t*)table, (const uint32_t*)sc, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, m
  if (group == 1) {
    ladder_w3_kernel<1><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W3_ARGS);
  } else if (group == 2) {
    ladder_w3_kernel<2><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W3_ARGS);
  } else if (group == 4) {
    ladder_w3_kernel<4><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W3_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CURDLE_W3_ARGS
  return (int)cudaGetLastError();
}

// px, py (24, m), inf (m,), sc (16, m) -> ox, oy, oz (24, m); group:
// threads a lane, 1, 2 or 4; blocks of LADDER_THREADS, at least m * group
// threads in all.
int curdle_ladder_w1(const void* px, const void* py, const void* inf, const void* sc, void* ox,
                     void* oy, void* oz, int m, int group, int blocks, void* stream) {
  if (m < 1 || (long long)blocks * LADDER_THREADS < (long long)m * group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CURDLE_W1_ARGS                                                                      \
  (const uint32_t*)px, (const uint32_t*)py, (const int32_t*)inf, (const uint32_t*)sc,       \
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, m
  if (group == 1) {
    ladder_w1_kernel<1><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W1_ARGS);
  } else if (group == 2) {
    ladder_w1_kernel<2><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W1_ARGS);
  } else if (group == 4) {
    ladder_w1_kernel<4><<<blocks, LADDER_THREADS, 0, st>>>(CURDLE_W1_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CURDLE_W1_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
