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
// The two streaming scans, one template: per (window, lane) running Jacobian
// prefix over T sequential steps of one mixed add each.
//
//   scan_sel (FULL = false): the mixed add WITHOUT the doubling branch, a
//       per-window flag where it met p == q, and only the prefixes the host
//       selected written. Replaces ops/stream_scan.py::_build_scan_sel of the
//       JAX package.
//   scan_full (FULL = true): the complete mixed add, every prefix written;
//       the redo path of scan_sel, taken when a flag fires or a selection
//       slot overflows (colliding inputs). Replaces ops/stream_scan.py::
//       _build_scan.
// The JAX package's grids walked t in order with the running prefix in
// scratch memory.
//
// Bound by operations: each step is 11 Montgomery products of 300 32-bit
// multiplies and reads only 49 words (scan_full also writes 72). What held
// the first versions back on this card was latency, not the multiplier: one
// thread per (window, lane) gave W * L = 5,120 threads (160 warps for 528
// warp schedulers), each a chain of T * 11 = 2,816 dependent products, with
// the product out of line and its operands in local memory. So:
//
//  * Each lane's T steps are split into K sub-chains of T/K steps, which
//    share a block (K a power of two dividing T, a kernel argument; K = 1 is
//    the unsplit scan, bit for bit):
//      A. each sub-chain sums its records from the identity;
//      B. an inclusive Hillis-Steele scan over the K sums in shared memory,
//         with the complete add, gives each sub-chain its offset (the sum of
//         the sub-chains before it; none for the first). It must be complete
//         in both scans: on colliding records two sums can be equal;
//      C. each sub-chain walks its steps again from its offset, so every
//         prefix is the same point as in the unsplit scan. scan_sel emits
//         the selected prefixes of the K steps in flight at once; scan_full
//         stores each step's prefix from registers to its flat position (a
//         block's threads of one sub-chain are LB neighbouring lanes, so every
//         limb row is one coalesced run), with no staging and no barrier.
//         The last sub-chain's end is the lane total; scan_sel's flag ORs
//         over A and C.
//    The chain is 2T/K adds plus log2(K) complete adds long, and there are K
//    times the threads; the price is twice the mixed adds, so neither scan
//    can come nearer than about twice its bound.
//  * The mixed add calls fq_mul and fq_sqr, the product and the square on
//    PTX carry chains, out of line with their operands in registers (fq.cuh).
//    No tensor cores: the work is exact 384-bit modular arithmetic with
//    carries, which wgmma does not do.
//  * scan_sel's registers capped for occupancy: __launch_bounds__ asks for
//    two blocks of SCAN_MAX_THREADS an SM, so at most 128 registers a
//    thread and 16 warps an SM. It spills some 1.2 KB a thread under the cap
//    and still ran 7-8 % faster at K = 16 on an H100 than uncapped (255
//    registers, 8 warps an SM). scan_full is not capped: capped it spilled
//    as much and ran 7 % slower (1.826 against 1.701 ms; uncapped 248
//    registers, no spill; PERF.md).
//  chip_smoke.py --product-variants times each scan with the other's cap
//  (CURDLE_SCAN_MIN_BLOCKS = 1, CURDLE_SCAN_FULL_MIN_BLOCKS = 2), with the
//  arithmetic before the carry chains, with the product's operands by
//  reference, and inlined; PERF.md has the readings. A prefetch of the next
//  step's record was not measured in any committed form.
//
// What bounds them now: the products, some 430 machine instructions each
// (1,180 before the carry chains), twice over for the split. Replacing
// phase C's second walk by one complete add per selected prefix halves
// scan_sel's mixed adds, but those adds are sparse and diverge across a
// warp, and measured slower (PERF.md).
//
// Blocks are LB lanes x K sub-chains, sub-chain-major, with LB >= 8 so a
// record row load or a prefix row store of a sub-chain covers whole 32-byte
// sectors; small blocks spread the W * L * K threads evenly over the SMs.
//
// records (49, W*T*L): flat position w*T*L + t*L + l; totals (72, W, L) the
// lane's last prefix.
// scan_sel: sel (W*T, S) lane ids (outside [0, L) = empty slot)
//   -> out (72, W, T*S) the prefix of lane sel[w*T+t, s] after step t at
//   slot t*S + s, zero for an empty slot; flags (W,) OR-ed with 1 where the
//   no-doubling add met p == q. The step's prefixes are staged through
//   shared memory and written slot-major, so the stores coalesce and a lane
//   named by several slots is written to each.
// scan_full: sel and flags unused -> out (72, W, T*L) every prefix, at the
//   record's flat position.
// ---------------------------------------------------------------------------

constexpr int JAC_WORDS = 3 * FQ_WORDS;
constexpr int SCAN_MAX_THREADS = 256;
// blocks of SCAN_MAX_THREADS an SM that scan_sel and scan_full ask for; the
// other value of each is a measured variant
#ifndef CURDLE_SCAN_MIN_BLOCKS
#define CURDLE_SCAN_MIN_BLOCKS 2
#endif
#ifndef CURDLE_SCAN_FULL_MIN_BLOCKS
#define CURDLE_SCAN_FULL_MIN_BLOCKS 1
#endif

struct Rec {
  Fq x, y;
  bool inf;
};

__device__ __forceinline__ Rec rec_load(const uint32_t* __restrict__ r, size_t n_rec) {
  Rec q;
  q.x = fq_load(r, n_rec);
  q.y = fq_load(r + 24 * n_rec, n_rec);
  q.inf = r[48 * n_rec] != 0u;
  return q;
}

__device__ __forceinline__ void jac_to_stage(uint32_t* stage, int bt, int slot, const Jac& p) {
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    stage[k * bt + slot] = p.x.v[k];
    stage[(FQ_WORDS + k) * bt + slot] = p.y.v[k];
    stage[(2 * FQ_WORDS + k) * bt + slot] = p.z.v[k];
  }
}

__device__ __forceinline__ Jac jac_from_stage(const uint32_t* stage, int bt, int slot) {
  Jac p;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    p.x.v[k] = stage[k * bt + slot];
    p.y.v[k] = stage[(FQ_WORDS + k) * bt + slot];
    p.z.v[k] = stage[(2 * FQ_WORDS + k) * bt + slot];
  }
  return p;
}

// A Jacobian triple to the 72 limb rows at `o`, rows `stride` apart.
__device__ __forceinline__ void jac_store_rows(uint32_t* __restrict__ o, size_t stride, const Jac& p) {
  fq_store(o, stride, p.x);
  fq_store(o + 24 * stride, stride, p.y);
  fq_store(o + 48 * stride, stride, p.z);
}

template <bool FULL>
__global__ void __launch_bounds__(SCAN_MAX_THREADS, FULL ? CURDLE_SCAN_FULL_MIN_BLOCKS : CURDLE_SCAN_MIN_BLOCKS)
scan_kernel(const uint32_t* __restrict__ rec, const int32_t* __restrict__ sel,
            uint32_t* __restrict__ out, uint32_t* __restrict__ tot, int32_t* __restrict__ flags,
            int W, int T, int L, int S, int K, int LB) {
  extern __shared__ uint32_t stage[];  // JAC_WORDS x (K * LB), word-major
  const int bt = K * LB;
  const int tid = threadIdx.x;
  const int sub = tid / LB;  // sub-chain k
  const int w = blockIdx.y;
  const int lane0 = blockIdx.x * LB;
  const int lane = lane0 + tid % LB;
  const bool active = lane < L;
  const int steps = T / K;
  const int t0 = sub * steps;
  const size_t n_rec = (size_t)W * T * L;
  const size_t n_sel = (size_t)W * T * S;
  const uint32_t* base = rec + (size_t)w * T * L + lane;

  Jac acc = jac_zero();  // z == 0: the first add yields lift(q)
  bool flag = false;

  // phase 0 = A (sums from the identity; skipped for K = 1), phase 1 = C
  // (from the offsets, emitting); one loop body for both
#pragma unroll 1
  for (int phase = K > 1 ? 0 : 1; phase < 2; ++phase) {
#pragma unroll 1
    for (int u = 0; u < steps; ++u) {
      if (active) {
        const Rec q = rec_load(base + (size_t)(t0 + u) * L, n_rec);
        Jac res;
        flag |= jac_madd<FULL>(res, acc, q.x, q.y, q.inf);
        acc = res;
        if (FULL && phase == 1)
          jac_store_rows(out + (size_t)w * T * L + (size_t)(t0 + u) * L + lane, n_rec, acc);
      }
      if (!FULL && phase == 1) {
        jac_to_stage(stage, bt, tid, acc);
        __syncthreads();
        for (int f = tid; f < K * S; f += bt) {
          const int k = f / S;
          const int s = f - k * S;
          const int t = k * steps + u;
          const int ln = sel[((size_t)w * T + t) * S + s];
          uint32_t* o = out + (size_t)w * T * S + (size_t)t * S + s;
          const bool empty = ln < 0 || ln >= L;
          if (!empty && ln >= lane0 && ln < lane0 + LB) {
            const int src = k * LB + (ln - lane0);
#pragma unroll 4
            for (int r = 0; r < JAC_WORDS; ++r) {
              const uint32_t word = stage[r * bt + src];
              o[(size_t)(2 * r) * n_sel] = word & 0xffffu;
              o[(size_t)(2 * r + 1) * n_sel] = word >> 16;
            }
          } else if (empty && blockIdx.x == 0) {
#pragma unroll 4
            for (int r = 0; r < 2 * JAC_WORDS; ++r) o[(size_t)r * n_sel] = 0u;
          }
        }
        __syncthreads();
      }
    }
    if (phase == 0 && K > 1) {
      // B: inclusive scan over the K sums of each lane, p = the earlier sum
      jac_to_stage(stage, bt, tid, acc);
      __syncthreads();
#pragma unroll 1
      for (int d = 1; d < K; d *= 2) {
        Jac mine = acc;
        if (sub >= d) mine = jac_add<true>(jac_from_stage(stage, bt, tid - d * LB), acc);
        __syncthreads();
        acc = mine;
        jac_to_stage(stage, bt, tid, acc);
        __syncthreads();
      }
      // C starts from the offset: the identity for the first sub-chain
      acc = sub > 0 ? jac_from_stage(stage, bt, tid - LB) : jac_zero();
      __syncthreads();
    }
  }

  if (active) {
    if (sub == K - 1) jac_store_rows(tot + (size_t)w * L + lane, (size_t)W * L, acc);
    if (!FULL && flag) atomicOr(&flags[w], 1);
  }
}

// The launch both scans share: K sub-chains a lane, a power of two dividing
// T, at most SCAN_MAX_THREADS / 8; LB lanes a block, 32, 32, 16, 8, 8, ...
// for K = 1, 2, 4, 8, 16, ...
template <bool FULL>
int scan_launch(const void* rec, const void* sel, void* out, void* tot, void* flags, int W, int T,
                int L, int S, int K, void* stream) {
  if (K < 1 || (K & (K - 1)) || T % K || 8 * K > SCAN_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int LB = K >= 8 ? 8 : 64 / K > 32 ? 32 : 64 / K;
  const int bt = K * LB;
  dim3 grid((L + LB - 1) / LB, W);
  const size_t smem = (size_t)JAC_WORDS * bt * sizeof(uint32_t);
  scan_kernel<FULL><<<grid, bt, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)rec, (const int32_t*)sel, (uint32_t*)out, (uint32_t*)tot, (int32_t*)flags,
      W, T, L, S, K, LB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gather_u32: out[r, w, j] = table[r, w, idx[w, j]], 0 where the index lies
// outside [0, N).
//
// Replaces ops/gather.py::_build and ::_build_wlead of the JAX package (a
// one-hot matrix product there, because that machine has no fast lane
// gather; a GPU thread simply loads from the address). One kernel serves a
// table shared by all windows (Wt = 1) and one table a window (Wt = W).
//
// Bound by bytes: every output word is one load and one store. In the
// package's limb-major layout (R, Wt, N) the R words of one record lie a
// table row apart, so each 4-byte load costs a whole 32-byte sector: eight
// times the bytes needed, which made the first version slower than
// torch.gather on the sorted-order gather of all n records. Two layouts,
// chosen by the wrapper from the shapes:
//  * RECORDS: the wrapper first copies the table to (Wt, N, RP): record i of
//    window w is RP words (R padded to whole 32-byte sectors; 56 for the
//    49-word point records) at one aligned address. A block takes GATHER_J
//    outputs of one window: its threads fetch the records with 16-byte
//    read-only vector loads, neighbouring threads on neighbouring chunks of
//    one record, into a shared-memory tile (R x GATHER_J, padded against
//    bank conflicts), and write each output row as one coalesced run over
//    j. Pays where most records are fetched (the copy reads the table once).
//  * limb-major, in place: one thread a j walks the R rows; stores coalesce,
//    loads cost a sector each. Pays where few records of a large table are
//    fetched (the stitch's boundary gathers), as the copy would cost more.
// No TMA: it copies tiles and has no row-gather mode, so plain loads are the
// tool.
// ---------------------------------------------------------------------------

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_J = 64;  // of 64, 128 and 256, the fastest on an H100
constexpr int GATHER_TILE = GATHER_J + 1;  // row pitch of the tile, in words

template <bool RECORDS>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, int R, int RP, int Wt, int W, int N, int M) {
  const int w = blockIdx.y;
  const size_t tw = Wt == 1 ? 0 : (size_t)w;
  const size_t o_stride = (size_t)W * M;
  if (!RECORDS) {
    const int j = blockIdx.x * GATHER_THREADS + threadIdx.x;
    if (j >= M) return;
    const int i = idx[(size_t)w * M + j];
    const bool hit = i >= 0 && i < N;
    const size_t t_stride = (size_t)Wt * N;
    const uint32_t* src = table + tw * N + (hit ? i : 0);
    uint32_t* dst = out + (size_t)w * M + j;
#pragma unroll 8
    for (int r = 0; r < R; ++r) dst[(size_t)r * o_stride] = hit ? src[(size_t)r * t_stride] : 0u;
    return;
  }
  extern __shared__ uint32_t tile[];  // R x GATHER_TILE
  const uint4* recs = reinterpret_cast<const uint4*>(table);
  const int j0 = blockIdx.x * GATHER_J;
  const int chunks = RP / 4;  // uint4 per record
  for (int f = threadIdx.x; f < GATHER_J * chunks; f += GATHER_THREADS) {
    const int jj = f / chunks;
    const int c = f - jj * chunks;
    const int j = j0 + jj;
    if (j >= M) continue;
    const int i = idx[(size_t)w * M + j];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 0 && i < N) v = __ldg(recs + (tw * N + i) * chunks + c);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * c + e;
      if (r < R) tile[r * GATHER_TILE + jj] = words[e];
    }
  }
  __syncthreads();
  const int mj = min(GATHER_J, M - j0);
  for (int f = threadIdx.x; f < R * GATHER_J; f += GATHER_THREADS) {
    const int r = f / GATHER_J;
    const int jj = f - r * GATHER_J;
    if (jj < mj) out[(size_t)r * o_stride + (size_t)w * M + j0 + jj] = tile[r * GATHER_TILE + jj];
  }
}

// ---------------------------------------------------------------------------
// point_op: elementwise point operation over m lanes, G threads a lane.
//
// Replaces ops/pallas_g1.py::_build_kernel of the JAX package (bodies jadd,
// jdbl, jmadd). Bound by operations (16 / 7 / 11 Montgomery products per
// lane against at most 9 field elements of traffic).
//   JADD:  (px, py, pz, qx, qy, qz)        -> p + q, complete
//   JDBL:  (px, py, pz)                    -> 2p
//   JMADD: (px, py, pz, qx, qy), qinf (m,) -> p + q, q affine, complete
//
// One thread a lane leaves most of the card idle at the widths the MSM and
// the vector ops launch it at (124 to 20,480 lanes: at most 1.2 warps a
// warp scheduler), and a warp of this arithmetic nearly fills its scheduler
// on its own, so a lane's time is one thread's chain of up to 16 dependent
// out-of-line products. So a group of G neighbouring threads serves a lane
// (G = 1, 2 or 4, chosen by the caller from m and the body:
// ops/cuda_g1.point_group) and runs each formula's independent products side
// by side (the group formulas of g1.cuh): the chain is 5 / 3 / 5 products
// long at G = 4, on G times the warps. Once the warps fill the schedulers a
// group only adds work (repeated products, additions redone by every thread,
// shuffles), so wide launches keep G = 1, the one-thread formula, unchanged.
//
// Thread t serves lane t / G as thread t % G of its group. A warp covers
// 32 / G neighbouring lanes: the G threads of a lane load the same words
// (one broadcast), and each stores its share of the words. A thread past
// m computes lane m - 1 again and stores nothing, so every warp stays whole
// for the shuffles.
// ---------------------------------------------------------------------------

constexpr int POINT_THREADS = 128;
enum PointBody { JADD = 0, JDBL = 1, JMADD = 2 };

template <int BODY, int G>
__global__ void __launch_bounds__(POINT_THREADS)
point_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
             const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
             const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
             const int32_t* __restrict__ qinf, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int m) {
  const int t = blockIdx.x * POINT_THREADS + threadIdx.x;
  const int lane = t / G, q = t % G;
  const int i = lane < m ? lane : m - 1;
  const size_t stride = (size_t)m;
  Jac p;
  p.x = fq_load(px + i, stride);
  p.y = fq_load(py + i, stride);
  p.z = fq_load(pz + i, stride);
  Jac res;
  if (BODY == JADD) {
    Jac b;
    b.x = fq_load(qx + i, stride);
    b.y = fq_load(qy + i, stride);
    b.z = fq_load(qz + i, stride);
    res = jac_add_g<G, true>(p, b, q);
  } else if (BODY == JDBL) {
    res = jac_dbl_g<G>(p, q);
  } else {
    const Fq ax = fq_load(qx + i, stride);
    const Fq ay = fq_load(qy + i, stride);
    jac_madd_g<G, true>(res, p, ax, ay, qinf[i] != 0, q);
  }
  if (lane < m) jac_store_share<G>(ox + i, oy + i, oz + i, stride, res, q);
}

using PointKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*,
                             const uint32_t*, const uint32_t*, const int32_t*, uint32_t*,
                             uint32_t*, uint32_t*, int);

// [body][0, 1, 2 for G = 1, 2, 4]
const PointKernel POINT_KERNELS[3][3] = {
    {point_kernel<JADD, 1>, point_kernel<JADD, 2>, point_kernel<JADD, 4>},
    {point_kernel<JDBL, 1>, point_kernel<JDBL, 2>, point_kernel<JDBL, 4>},
    {point_kernel<JMADD, 1>, point_kernel<JMADD, 2>, point_kernel<JMADD, 4>},
};

// ---------------------------------------------------------------------------
// point_kernel_strided: the point kernel's complete add, reading and writing
// by offset and stride, for the level schedule of the prefix scan
// (ops/scan.py::scan_schedule).
//
// The scan was the point kernel surrounded by copies: every level split its
// input into even and odd lanes, made them contiguous, shifted the prefixes
// by one with a concatenation, and interleaved the halves back with a stack,
// and every fixed-width step rolled the vector and selected the identity
// into its head. Those copies took twice the point kernel's time on the card
// and most of the host's time to enqueue. Here each launch finds its
// operands where they lie: lane j of row r of an operand is the column
// off + j * step of its buffer, limb rows `limb` containers apart, rows
// `row` apart. So a level reads the even and odd lanes of the level below in
// place, the shift is an offset of -1 or -d, and the interleave is a store
// at step 2 beside a copy at step 2.
//
//   out[j] = jadd(p[j], q[j]), complete, with jac_add_g<G, true>
//   copy_out[j] = copy[j] where copy is given
//
// An operand lane below `lo` is the identity as the package encodes it,
// (1, 1, 0) in raw limbs, and the whole add runs on it: an add with an
// identity operand returns the other operand's triple or, where both are
// the identity, the identity's, so every coordinate is the plain scan's. A
// record operand (49 rows: x, y, the infinity word) is lifted as it is read:
// z = 0 where the word is set, else one in Montgomery form (FQ_ONE, in
// constant memory).
//
// The add is the point kernel's, but a launch moves more bytes a lane: a
// level down reads a prefix, an even lane of the level below and the prefix
// it copies, and writes two columns. At the scan's widths the kernel runs
// with few warps a scheduler and waits on its loads, so its time follows
// the bytes it moves and its memory instructions (on the H100 a level down
// with one 4-byte access a limb row took twice the contiguous point
// kernel's time at its width). So there are three bodies, and the caller
// names one a launch (ops/scan.py, `Launch.kind`):
//   UP    p and q are columns 2j and 2j + 1 of one buffer (a level up): one
//         8-byte load a limb row gives both operands;
//   DOWN  p is the prefix at j - 1 (identity at j = 0), copy the prefix at
//         j, out and copy_out columns 2j and 2j + 1 of one buffer (a level
//         down): the copy is p of the lane G threads on, by warp shuffles
//         (loaded only at a warp's last group and a row's last lane), q
//         read as the first of an 8-byte pair, out and copy stored as one
//         8-byte pair a limb row;
//   ANY   any views and no copy (the fixed-width steps).
// The entry point refuses a launch whose views do not have its body's
// layout (`body_fits`).
//
// The caller guarantees that no launch writes a column that it reads, so
// the loads of one thread never meet another thread's stores. Threads,
// groups and the tail are the point kernel's: thread t serves lane t / G of
// the rows * lanes lanes, row-major.
// ---------------------------------------------------------------------------

struct PointView {
  uint32_t* base;  // null: no operand
  long long limb;  // containers between limb rows
  long long row;   // containers between rows
  long long off;   // column of lane 0
  long long step;  // columns between lanes
  long long lo;    // lanes below take the identity
  long long records;  // 49 rows (x, y, infinity word) instead of 72
};
constexpr int POINT_VIEW_WORDS = 7;
enum StridedBody { ANY = 0, UP = 1, DOWN = 2 };

__device__ __forceinline__ Jac jac_identity() {
  Jac r = jac_zero();
  r.x.v[0] = 1u;
  r.y.v[0] = 1u;
  return r;
}

__device__ __forceinline__ long long view_at(const PointView& v, int r, int j) {
  return (long long)r * v.row + v.off + (long long)j * v.step;
}

__device__ __forceinline__ Jac view_load(const PointView& v, int r, int j) {
  if (j < v.lo) return jac_identity();
  const uint32_t* a = v.base + view_at(v, r, j);
  const size_t s = (size_t)v.limb;
  Jac p;
  p.x = fq_load(a, s);
  p.y = fq_load(a + 24 * s, s);
  if (v.records) {
    p.z = a[48 * s] != 0u ? fq_zero() : fq_one();
  } else {
    p.z = fq_load(a + 48 * s, s);
  }
  return p;
}

// Lane j of v and, where BOTH, the column after it, one 8-byte load a limb
// row (v's base, off, limb and row even). A view of step 2 makes them lanes
// 2j and 2j + 1 of the buffer.
template <bool BOTH>
__device__ __forceinline__ void view_load_pair(const PointView& v, int r, int j, Jac& a, Jac& b) {
  const uint32_t* p = v.base + view_at(v, r, j);
  const size_t s = (size_t)v.limb;
  Fq* fa[3] = {&a.x, &a.y, &a.z};
  Fq* fb[3] = {&b.x, &b.y, &b.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c == 2 && v.records) break;
#pragma unroll
    for (int k = 0; k < FQ_WORDS; ++k) {
      const uint2 lo = *reinterpret_cast<const uint2*>(p + (size_t)(24 * c + 2 * k) * s);
      const uint2 hi = *reinterpret_cast<const uint2*>(p + (size_t)(24 * c + 2 * k + 1) * s);
      fa[c]->v[k] = (lo.x & 0xffffu) | (hi.x << 16);
      if (BOTH) fb[c]->v[k] = (lo.y & 0xffffu) | (hi.y << 16);
    }
  }
  if (v.records) {
    const uint2 w = *reinterpret_cast<const uint2*>(p + 48 * s);
    a.z = w.x != 0u ? fq_zero() : fq_one();
    if (BOTH) b.z = w.y != 0u ? fq_zero() : fq_one();
  }
}

template <int G, int BODY>
__global__ void __launch_bounds__(POINT_THREADS)
point_kernel_strided(PointView pv, PointView qv, PointView ov, PointView cv, PointView cov, int lanes,
                     int m) {
  const int t = blockIdx.x * POINT_THREADS + threadIdx.x;
  const int lane = t / G, q = t % G;
  const int i = lane < m ? lane : m - 1;
  const int r = i / lanes, j = i - r * lanes;
  Jac a, b;
  if (BODY == UP) {
    view_load_pair<true>(pv, r, j, a, b);
  } else {
    a = view_load(pv, r, j);
    if (BODY == DOWN) {
      view_load_pair<false>(qv, r, j, b, b);
    } else {
      b = view_load(qv, r, j);
    }
  }
  const Jac res = jac_add_g<G, true>(a, b, q);
  const size_t s = (size_t)ov.limb;
  if (BODY == DOWN) {
    Jac c;  // the prefix at j: what lane i + 1 read as its p
    Fq* fc[3] = {&c.x, &c.y, &c.z};
    const Fq* fa[3] = {&a.x, &a.y, &a.z};
#pragma unroll
    for (int co = 0; co < 3; ++co) {
#pragma unroll
      for (int k = 0; k < FQ_WORDS; ++k) fc[co]->v[k] = __shfl_down_sync(FULL_WARP, fa[co]->v[k], G);
    }
    if (j == lanes - 1 || (int)(threadIdx.x & 31) >= 32 - G) c = view_load(cv, r, j);
    if (lane >= m) return;
    uint32_t* o = ov.base + view_at(ov, r, j);
    const Fq* fr[3] = {&res.x, &res.y, &res.z};
#pragma unroll
    for (int co = 0; co < 3; ++co) {
#pragma unroll
      for (int k = 0; k < FQ_WORDS; ++k) {
        if (k % G != q) continue;
        const size_t row = (size_t)(24 * co + 2 * k);
        *reinterpret_cast<uint2*>(o + row * s) = make_uint2(fr[co]->v[k] & 0xffffu, fc[co]->v[k] & 0xffffu);
        *reinterpret_cast<uint2*>(o + (row + 1) * s) = make_uint2(fr[co]->v[k] >> 16, fc[co]->v[k] >> 16);
      }
    }
    return;
  }
  if (lane >= m) return;
  uint32_t* o = ov.base + view_at(ov, r, j);
  jac_store_share<G>(o, o + 24 * s, o + 48 * s, s, res, q);
}

using StridedKernel = void (*)(PointView, PointView, PointView, PointView, PointView, int, int);

// [body][0, 1, 2 for G = 1, 2, 4]
const StridedKernel STRIDED_KERNELS[3][3] = {
    {point_kernel_strided<1, ANY>, point_kernel_strided<2, ANY>, point_kernel_strided<4, ANY>},
    {point_kernel_strided<1, UP>, point_kernel_strided<2, UP>, point_kernel_strided<4, UP>},
    {point_kernel_strided<1, DOWN>, point_kernel_strided<2, DOWN>, point_kernel_strided<4, DOWN>},
};

// 8-byte pairs of columns at every lane of a step-2 view.
inline bool view_paired(const PointView& v) {
  return !((uintptr_t)v.base & 7) && !(v.off & 1) && !(v.limb & 1) && !(v.row & 1) && v.step == 2;
}

// b is the column after a, lane for lane, in the same rows.
inline bool next_column(const PointView& a, const PointView& b) {
  return a.base == b.base && a.limb == b.limb && a.row == b.row && a.records == b.records &&
         a.step == b.step && b.off == a.off + 1;
}

// Whether a launch's views have the layout its body reads and writes.
inline bool body_fits(int body, const PointView& p, const PointView& q, const PointView& o,
                      const PointView& c, const PointView& co) {
  switch (body) {
    case ANY:
      return !c.base;
    case UP:
      return !c.base && view_paired(p) && next_column(p, q) && !p.lo && !q.lo;
    case DOWN:
      return c.base && p.step == 1 && next_column(p, c) && p.lo == 1 && !c.lo && view_paired(q) && !q.lo &&
             view_paired(o) && next_column(o, co);
    default:
      return false;
  }
}

}  // namespace curdle

using namespace curdle;

extern "C" {

// records (49, W*T*L), sel (W*T, S) -> bsel (72, W, T*S), totals (72, W, L),
// flags (W,) which the caller has zeroed. K sub-chains a lane: a power of two
// dividing T, at most SCAN_MAX_THREADS / 8.
int curdle_scan_sel(const void* rec, const void* sel, void* bsel, void* tot, void* flags, int W,
                    int T, int L, int S, int K, void* stream) {
  return scan_launch<false>(rec, sel, bsel, tot, flags, W, T, L, S, K, stream);
}

// records (49, W*T*L) -> prefix (72, W, T*L), totals (72, W, L). K as for
// curdle_scan_sel.
int curdle_scan_full(const void* rec, void* prefix, void* tot, int W, int T, int L, int K,
                     void* stream) {
  return scan_launch<true>(rec, nullptr, prefix, tot, nullptr, W, T, L, 0, K, stream);
}

// records != 0: table (Wt, N, RP) record-major, RP a multiple of 4 and >= R;
// records == 0: table (R, Wt, N). Wt is 1 or W; idx (W, M) -> out (R, W, M).
int curdle_gather_u32(const void* table, const void* idx, void* out, int R, int RP, int Wt, int W,
                      int N, int M, int records, void* stream) {
  if (Wt != 1 && Wt != W) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!records) {
    dim3 grid((M + GATHER_THREADS - 1) / GATHER_THREADS, W);
    gather_kernel<false><<<grid, GATHER_THREADS, 0, st>>>(
        (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, R, RP, Wt, W, N, M);
    return (int)cudaGetLastError();
  }
  if (RP % 4 || RP < R) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * GATHER_TILE * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + GATHER_J - 1) / GATHER_J, W);
  gather_kernel<true><<<grid, GATHER_THREADS, smem, st>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, R, RP, Wt, W, N, M);
  return (int)cudaGetLastError();
}

// body: 0 jadd, 1 jdbl, 2 jmadd; group: threads a lane, 1, 2 or 4; blocks of
// POINT_THREADS, at least m * group threads in all. Coordinate arrays are
// (24, m); unused inputs may be null.
int curdle_point_op(int body, const void* px, const void* py, const void* pz, const void* qx,
                    const void* qy, const void* qz, const void* qinf, void* ox, void* oy, void* oz,
                    int m, int group, int blocks, void* stream) {
  const int gi = group == 1 ? 0 : group == 2 ? 1 : group == 4 ? 2 : -1;
  if (body < 0 || body > 2 || gi < 0 || m < 1 ||
      (long long)blocks * POINT_THREADS < (long long)m * group)
    return (int)cudaErrorInvalidValue;
  POINT_KERNELS[body][gi]<<<blocks, POINT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (const int32_t*)qinf, (uint32_t*)ox,
      (uint32_t*)oy, (uint32_t*)oz, m);
  return (int)cudaGetLastError();
}

// views: five groups of POINT_VIEW_WORDS 64-bit integers (the fields of
// PointView, the pointer first) for p, q, out, copy and copy_out, on the
// host; a copy pointer of 0 means no copy. body: ANY, UP or DOWN, refused
// where the views do not fit it. rows * lanes lanes, group threads a lane,
// blocks of POINT_THREADS, at least rows * lanes * group threads.
int curdle_point_strided(const void* views, int body, int lanes, int rows, int group, int blocks,
                         void* stream) {
  const int gi = group == 1 ? 0 : group == 2 ? 1 : group == 4 ? 2 : -1;
  const long long m = (long long)lanes * rows;
  if (views == nullptr || gi < 0 || body < ANY || body > DOWN || lanes < 1 || rows < 1 || m > 0x7fffffff ||
      (long long)blocks * POINT_THREADS < m * group)
    return (int)cudaErrorInvalidValue;
  const long long* w = (const long long*)views;
  PointView v[5];
  for (int k = 0; k < 5; ++k, w += POINT_VIEW_WORDS) {
    v[k].base = (uint32_t*)(uintptr_t)w[0];
    v[k].limb = w[1];
    v[k].row = w[2];
    v[k].off = w[3];
    v[k].step = w[4];
    v[k].lo = w[5];
    v[k].records = w[6];
  }
  if (!v[0].base || !v[1].base || !v[2].base || (v[3].base && !v[4].base) ||
      !body_fits(body, v[0], v[1], v[2], v[3], v[4]))
    return (int)cudaErrorInvalidValue;
  STRIDED_KERNELS[body][gi]<<<blocks, POINT_THREADS, 0, (cudaStream_t)stream>>>(v[0], v[1], v[2], v[3],
                                                                               v[4], lanes, (int)m);
  return (int)cudaGetLastError();
}

}  // extern "C"
