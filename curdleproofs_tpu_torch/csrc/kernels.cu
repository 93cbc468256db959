// The CUDA kernels of the streaming Pippenger MSM, with a plain C interface.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcurdle_kernels.so kernels.cu
// and loaded with ctypes (ops/cuda_g1.py). Every entry point launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// Tensors arrive in the package's layout: 32-bit containers holding 16-bit
// limbs, limb-major — a field element is 24 rows, a point record 49 rows
// (x, y, inf), a Jacobian triple 72 rows (X, Y, Z) — with the batch on the
// trailing axes. Neighbouring threads take neighbouring batch positions, so
// every row access of a warp is one coalesced line.
#include <cuda_runtime.h>
#include <stdint.h>

#include "g1.cuh"

namespace curdle {

// ---------------------------------------------------------------------------
// scan_sel / scan_full: per (window, lane) running Jacobian prefix over T
// sequential steps of one mixed add each.
//
// Replaces ops/stream_scan.py::_build_scan_sel and ::_build_scan of the JAX
// package, whose grid walked t in order with the running prefix in scratch
// memory. Here one thread owns one (window, lane), loops over t itself and
// keeps the running triple in registers. Bound by operations: each step is
// ~11 Montgomery products of 300 32-bit multiplies and reads only 49 words.
// A chunk offers just W * L threads, each a chain of T dependent adds, so
// blocks are one warp wide to spread the chains over all SMs.
//
// records (49, W*T*L): flat position w*T*L + t*L + l.
// SEL:  sel (W*T, S) lane ids (outside [0, L) = empty slot)
//       -> bsel (72, W, T*S) the fresh prefix of lane sel[w*T+t, s] at slot
//       t*S + s, zero for an empty slot; flags (W,) OR-ed with 1 where the
//       no-doubling add met p == q. The step's prefixes are staged through
//       shared memory and written slot-major, so the stores coalesce and a
//       lane named by several slots is written to each.
// FULL: prefix (72, W, T*L) every prefix, with the complete add.
// Both: totals (72, W, L) the lane's last prefix.
// ---------------------------------------------------------------------------

constexpr int SCAN_THREADS = 32;
constexpr int JAC_WORDS = 3 * FQ_WORDS;

template <bool SEL>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const uint32_t* __restrict__ rec, const int32_t* __restrict__ sel,
            uint32_t* __restrict__ out, uint32_t* __restrict__ tot, int32_t* __restrict__ flags,
            int W, int T, int L, int S) {
  const int w = blockIdx.y;
  const int lane0 = blockIdx.x * SCAN_THREADS;
  const int tid = threadIdx.x;
  const int lane = lane0 + tid;
  const bool active = lane < L;
  const size_t n_rec = (size_t)W * T * L;
  const size_t n_sel = (size_t)W * T * S;

  __shared__ uint32_t stage[SEL ? JAC_WORDS * SCAN_THREADS : 1];

  Jac acc = jac_zero();  // z == 0: the first add yields lift(q)
  bool flag = false;

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    if (active) {
      const size_t pos = (size_t)w * T * L + (size_t)t * L + lane;
      const uint32_t* r = rec + pos;
      const Fq qx = fq_load(r, n_rec);
      const Fq qy = fq_load(r + 24 * n_rec, n_rec);
      const bool qinf = r[48 * n_rec] != 0u;
      Jac res;
      flag |= jac_madd<!SEL>(res, acc, qx, qy, qinf);
      acc = res;
      if (!SEL) {
        uint32_t* o = out + pos;
        fq_store(o, n_rec, acc.x);
        fq_store(o + 24 * n_rec, n_rec, acc.y);
        fq_store(o + 48 * n_rec, n_rec, acc.z);
      }
    }
    if (SEL) {
      if (active) {
#pragma unroll
        for (int k = 0; k < FQ_WORDS; ++k) {
          stage[k * SCAN_THREADS + tid] = acc.x.v[k];
          stage[(FQ_WORDS + k) * SCAN_THREADS + tid] = acc.y.v[k];
          stage[(2 * FQ_WORDS + k) * SCAN_THREADS + tid] = acc.z.v[k];
        }
      }
      __syncthreads();
      const int32_t* srow = sel + ((size_t)w * T + t) * S;
      for (int s = tid; s < S; s += SCAN_THREADS) {
        const int ln = srow[s];
        uint32_t* o = out + (size_t)w * T * S + (size_t)t * S + s;
        const bool empty = ln < 0 || ln >= L;
        if (!empty && ln >= lane0 && ln < lane0 + SCAN_THREADS) {
          const int src = ln - lane0;
#pragma unroll 4
          for (int k = 0; k < JAC_WORDS; ++k) {
            const uint32_t word = stage[k * SCAN_THREADS + src];
            o[(size_t)(2 * k) * n_sel] = word & 0xffffu;
            o[(size_t)(2 * k + 1) * n_sel] = word >> 16;
          }
        } else if (empty && blockIdx.x == 0) {
#pragma unroll 4
          for (int k = 0; k < 2 * JAC_WORDS; ++k) o[(size_t)k * n_sel] = 0u;
        }
      }
      __syncthreads();
    }
  }

  if (active) {
    const size_t n_tot = (size_t)W * L;
    uint32_t* o = tot + (size_t)w * L + lane;
    fq_store(o, n_tot, acc.x);
    fq_store(o + 24 * n_tot, n_tot, acc.y);
    fq_store(o + 48 * n_tot, n_tot, acc.z);
    if (SEL && flag) atomicOr(&flags[w], 1);
  }
}

// ---------------------------------------------------------------------------
// gather_u32: out[r, w, j] = table[r, w, idx[w, j]], 0 where the index lies
// outside [0, N).
//
// Replaces ops/gather.py::_build and ::_build_wlead of the JAX package (a
// one-hot matrix product there, because that machine has no fast lane
// gather; a GPU thread simply loads from the address). Bound by bytes: every
// output word is one load and one store. One thread per (w, j) reads its
// index once and walks the R rows; stores coalesce over j, loads are as
// scattered as the indices.
// ---------------------------------------------------------------------------

constexpr int GATHER_THREADS = 256;

__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, int R, int W, int N, int M) {
  const int j = blockIdx.x * GATHER_THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (j >= M) return;
  const int i = idx[(size_t)w * M + j];
  const bool hit = i >= 0 && i < N;
  const size_t t_stride = (size_t)W * N;
  const size_t o_stride = (size_t)W * M;
  const uint32_t* src = table + (size_t)w * N + (hit ? i : 0);
  uint32_t* dst = out + (size_t)w * M + j;
#pragma unroll 8
  for (int r = 0; r < R; ++r) dst[(size_t)r * o_stride] = hit ? src[(size_t)r * t_stride] : 0u;
}

// ---------------------------------------------------------------------------
// point_op: elementwise point operation over m lanes, one thread per lane.
//
// Replaces ops/pallas_g1.py::_build_kernel of the JAX package (bodies jadd,
// jdbl, jmadd). Bound by operations (16 / 7 / 11 Montgomery products per
// lane against at most 9 field elements of traffic).
//   JADD:  (px, py, pz, qx, qy, qz)        -> p + q, complete
//   JDBL:  (px, py, pz)                    -> 2p
//   JMADD: (px, py, pz, qx, qy), qinf (m,) -> p + q, q affine, complete
// ---------------------------------------------------------------------------

constexpr int POINT_THREADS = 128;
enum PointBody { JADD = 0, JDBL = 1, JMADD = 2 };

template <int BODY>
__global__ void __launch_bounds__(POINT_THREADS)
point_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
             const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
             const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
             const int32_t* __restrict__ qinf, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int m) {
  const int i = blockIdx.x * POINT_THREADS + threadIdx.x;
  if (i >= m) return;
  const size_t stride = (size_t)m;
  Jac p;
  p.x = fq_load(px + i, stride);
  p.y = fq_load(py + i, stride);
  p.z = fq_load(pz + i, stride);
  Jac res;
  if (BODY == JADD) {
    Jac q;
    q.x = fq_load(qx + i, stride);
    q.y = fq_load(qy + i, stride);
    q.z = fq_load(qz + i, stride);
    res = jac_add(p, q);
  } else if (BODY == JDBL) {
    res = jac_dbl(p);
  } else {
    const Fq ax = fq_load(qx + i, stride);
    const Fq ay = fq_load(qy + i, stride);
    jac_madd<true>(res, p, ax, ay, qinf[i] != 0);
  }
  fq_store(ox + i, stride, res.x);
  fq_store(oy + i, stride, res.y);
  fq_store(oz + i, stride, res.z);
}

}  // namespace curdle

using namespace curdle;

extern "C" {

// records (49, W*T*L), sel (W*T, S) -> bsel (72, W, T*S), totals (72, W, L),
// flags (W,) which the caller has zeroed.
int curdle_scan_sel(const void* rec, const void* sel, void* bsel, void* tot, void* flags, int W,
                    int T, int L, int S, void* stream) {
  dim3 grid((L + SCAN_THREADS - 1) / SCAN_THREADS, W);
  scan_kernel<true><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rec, (const int32_t*)sel, (uint32_t*)bsel, (uint32_t*)tot, (int32_t*)flags,
      W, T, L, S);
  return (int)cudaGetLastError();
}

// records (49, W*T*L) -> prefix (72, W, T*L), totals (72, W, L).
int curdle_scan_full(const void* rec, void* prefix, void* tot, int W, int T, int L,
                     void* stream) {
  dim3 grid((L + SCAN_THREADS - 1) / SCAN_THREADS, W);
  scan_kernel<false><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rec, nullptr, (uint32_t*)prefix, (uint32_t*)tot, nullptr, W, T, L, 0);
  return (int)cudaGetLastError();
}

// table (R, W, N), idx (W, M) -> out (R, W, M).
int curdle_gather_u32(const void* table, const void* idx, void* out, int R, int W, int N, int M,
                      void* stream) {
  dim3 grid((M + GATHER_THREADS - 1) / GATHER_THREADS, W);
  gather_kernel<<<grid, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, R, W, N, M);
  return (int)cudaGetLastError();
}

// body: 0 jadd, 1 jdbl, 2 jmadd. Coordinate arrays are (24, m); unused
// inputs may be null.
int curdle_point_op(int body, const void* px, const void* py, const void* pz, const void* qx,
                    const void* qy, const void* qz, const void* qinf, void* ox, void* oy, void* oz,
                    int m, void* stream) {
  const int blocks = (m + POINT_THREADS - 1) / POINT_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define CURDLE_POINT_ARGS                                                                    \
  (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,        \
      (const uint32_t*)qy, (const uint32_t*)qz, (const int32_t*)qinf, (uint32_t*)ox,         \
      (uint32_t*)oy, (uint32_t*)oz, m
  if (body == JADD) {
    point_kernel<JADD><<<blocks, POINT_THREADS, 0, st>>>(CURDLE_POINT_ARGS);
  } else if (body == JDBL) {
    point_kernel<JDBL><<<blocks, POINT_THREADS, 0, st>>>(CURDLE_POINT_ARGS);
  } else if (body == JMADD) {
    point_kernel<JMADD><<<blocks, POINT_THREADS, 0, st>>>(CURDLE_POINT_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef CURDLE_POINT_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
