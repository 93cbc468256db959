// The elementwise field programs of the package, with a plain C interface:
// the batched point decompression and compression, and the GLV stream
// records.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcurdle_field_kernels.so field_kernels.cu
// and loaded with ctypes (ops/cuda_g1.py). Every entry point launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
// These replace three programs that the JAX package compiles with jax.jit
// (XLA, no Pallas kernel): ops/compress.py::_decompress_device and
// ::_compress_device, and ops/msm.py::_glv_stream_packed. The plain PyTorch
// versions of the same functions (ops/compress.py::_decompress_plain,
// ::_compress_plain, ops/msm.py::_glv_stream_packed_plain) run a few
// hundred to a few hundred thousand small tensor ops a call; here each is one
// launch, one thread a point, neighbouring threads on neighbouring points so
// that every limb row a warp touches is one coalesced line.
//
// Field elements arrive as 24 rows of 16-bit limbs in 32-bit containers
// (fq_load / fq_store re-pair them); flags as 1-byte bools. Every value stays
// a canonical residue in [0, p) (fq.cuh), so every lane equals the plain
// version bit for bit whatever addition chain computes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

namespace curdle {

constexpr int FIELD_THREADS = 128;

// The constants, little-endian 32-bit words (tests/test_torch_field_kernels.py
// parses them and checks each against fields.FQ_MOD and glv.BETA).
// R^2 mod p: to_mont(a) = fq_mul(a, R^2).
__device__ __constant__ uint32_t FQ_R2[FQ_WORDS] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
    0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
// 4 R mod p: the curve's b = 4 in Montgomery form.
__device__ __constant__ uint32_t FQ_FOUR_MONT[FQ_WORDS] = {
    0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au,
    0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
// (p - 1) / 2 + 1: canonical y > (p - 1) / 2 iff y - this does not borrow.
__device__ __constant__ uint32_t FQ_HALF_P1[FQ_WORDS] = {
    0xffffd556u, 0xdcff7fffu, 0x58a9ffffu, 0x0f55ffffu, 0x7b587b12u, 0xb3986950u,
    0x79c2895fu, 0xb23ba5c2u, 0x21a5d66bu, 0x258dd3dbu, 0x1cbff34du, 0x0d0088f5u};
// beta R mod p: the GLV endomorphism's cube root of unity in Montgomery form
// (the words ops/cuda_g1.py::_beta_words hands the GLV ladder).
__device__ __constant__ uint32_t FQ_BETA_MONT[FQ_WORDS] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
    0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u};
// The square-root exponent (p + 1) / 4 (p = 3 mod 4) as a 5-bit sliding
// window chain, most significant window first: y = rhs^FQ_SQRT_DIGIT[0], then
// at each later step FQ_SQRT_SHIFT[s] squares and, where the digit is not 0,
// one product with rhs^FQ_SQRT_DIGIT[s] (odd, < 32). 375 squares and 66
// products, plus 1 square and 15 products for the odd powers, against 378
// squares and 228 products bit by bit.
constexpr int FQ_SQRT_STEPS = 67;
constexpr int FQ_SQRT_ODD_POWERS = 16;  // rhs^1, rhs^3, ..., rhs^31
__device__ __constant__ uint8_t FQ_SQRT_SHIFT[FQ_SQRT_STEPS] = {
    0, 13, 7, 4, 6, 7, 5, 5, 3, 6, 6, 3, 8, 3, 6, 6, 3, 8, 7, 5, 6, 6, 4, 8, 4, 7, 9, 5, 2, 7, 7,
    6, 5, 5, 5, 8, 7, 9, 5, 3, 8, 3, 7, 9, 6, 6, 5, 5, 4, 3, 8, 7, 5, 5, 4, 4, 7, 5, 5, 5, 5, 5, 5,
    5, 4, 6, 5};
__device__ __constant__ uint8_t FQ_SQRT_DIGIT[FQ_SQRT_STEPS] = {
    13, 17, 15, 5, 7, 23, 31, 25, 5, 13, 9, 3, 27, 5, 15, 27, 1, 13, 23, 11, 13, 29, 9, 29, 13, 23,
    19, 25, 3, 5, 9, 23, 29, 19, 19, 13, 21, 15, 13, 3, 15, 3, 9, 15, 21, 31, 31, 31, 13, 3, 21,
    31, 31, 31, 15, 7, 31, 29, 31, 31, 31, 31, 31, 31, 13, 21, 11};

__device__ __forceinline__ Fq fq_const(const uint32_t (&c)[FQ_WORDS]) {
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = c[i];
  return r;
}

// Montgomery form -> canonical integer: one product with the plain 1.
__device__ __forceinline__ Fq fq_from_mont(const Fq& a) {
  Fq one = fq_zero();
  one.v[0] = 1u;
  return fq_mul(a, one);
}

__device__ __forceinline__ bool fq_equal(const Fq& a, const Fq& b) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0u;
}

// Canonical y > (p - 1) / 2: no borrow out of y - ((p - 1) / 2 + 1).
__device__ __forceinline__ bool fq_is_largest(const Fq& y) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    const uint64_t t = (uint64_t)y.v[i] - (uint64_t)FQ_HALF_P1[i] - (uint64_t)borrow;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow == 0u;
}

// ---------------------------------------------------------------------------
// decompress: x (24, n) canonical, sign (n,) -> xm, ym (24, n) Montgomery,
// ok (n,). y^2 = x^3 + 4, y = (x^3 + 4)^((p+1)/4), ok where y squares back,
// y negated where its lexicographic sign differs from the flag. A lane whose
// x has no root (ok false) still gets the chain's y, as the plain version
// gives it.
//
// Replaces the JAX package's jitted ops/compress.py::_decompress_device
// (curdleproofs_tpu/ops/compress.py:33). Bound by operations: 378 squares
// and 84 products a lane (the chain above, to_mont, x^3, y^2, from_mont)
// against 24 words read and 48 written, 0.215 ms at the batched verifier's
// 31,753 lanes (31,744 trackers and 9 edge lanes) on an H100. Each lane is
// one dependent chain of those 462 operations, so below about one warp a
// scheduler the chain's latency sets the time (0.38 ms from 1,024 to 16,384
// lanes) and at 31,753 the instruction rate of two warps a scheduler
// (0.55 ms). Splitting each product over a group of 2 or 4 threads costs
// about as many instructions a thread as one thread's whole product: it was
// 18 % faster at 1,024-4,096 lanes and twice as slow at 31,753, where the
// batched verifier runs, so one thread a lane stays (PERF.md).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FIELD_THREADS)
decompress_kernel(const uint32_t* __restrict__ x, const uint8_t* __restrict__ sign,
                  uint32_t* __restrict__ xm_out, uint32_t* __restrict__ ym_out,
                  uint8_t* __restrict__ ok, int n) {
  const int i = blockIdx.x * FIELD_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t stride = (size_t)n;
  const Fq xm = fq_mul(fq_load(x + i, stride), fq_const(FQ_R2));
  const Fq rhs = fq_add(fq_mul(fq_sqr(xm), xm), fq_const(FQ_FOUR_MONT));
  // the odd powers of rhs in local memory, indexed by the chain's digits
  Fq odd[FQ_SQRT_ODD_POWERS];
  odd[0] = rhs;
  const Fq rhs2 = fq_sqr(rhs);
#pragma unroll 1
  for (int j = 1; j < FQ_SQRT_ODD_POWERS; ++j) odd[j] = fq_mul(odd[j - 1], rhs2);
  Fq y = odd[FQ_SQRT_DIGIT[0] >> 1];
#pragma unroll 1
  for (int s = 1; s < FQ_SQRT_STEPS; ++s) {
#pragma unroll 1
    for (int b = 0; b < FQ_SQRT_SHIFT[s]; ++b) y = fq_sqr(y);
    if (FQ_SQRT_DIGIT[s]) y = fq_mul(y, odd[FQ_SQRT_DIGIT[s] >> 1]);
  }
  ok[i] = fq_equal(fq_sqr(y), rhs) ? 1 : 0;
  if (fq_is_largest(fq_from_mont(y)) != (sign[i] != 0)) y = fq_neg(y);
  fq_store(xm_out + i, stride, xm);
  fq_store(ym_out + i, stride, y);
}

// ---------------------------------------------------------------------------
// compress: x, y (24, n) Montgomery -> x (24, n) canonical, largest (n,):
// canonical y > (p - 1) / 2. Bound by bytes: two products a lane against 48
// words read and 24 words and a byte written.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FIELD_THREADS)
compress_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                uint32_t* __restrict__ xc_out, uint8_t* __restrict__ largest, int n) {
  const int i = blockIdx.x * FIELD_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t stride = (size_t)n;
  fq_store(xc_out + i, stride, fq_from_mont(fq_load(x + i, stride)));
  largest[i] = fq_is_largest(fq_from_mont(fq_load(y + i, stride))) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// glv_records: px, py (24, n) Montgomery, inf (n,), neg1 (n,) -> records
// (49, 2n): column i is [px, neg1 ? -py : py, inf], column n + i is
// [beta px, py, inf], each written in place (the plain version builds them
// with two concatenations). The coordinates are copied as the containers
// hold them; only -py and beta px pass through the field arithmetic.
//
// Bound by bytes: about 586 bytes a point moved (48 words and two flags read,
// 98 words written) against one product and at most one negation.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FIELD_THREADS)
glv_records_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                   const uint8_t* __restrict__ inf, const uint8_t* __restrict__ neg1,
                   uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * FIELD_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t stride = (size_t)n, ostride = 2 * (size_t)n;
  uint32_t* left = out + i;
  uint32_t* right = out + n + i;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    const uint32_t xr = px[(size_t)r * stride + i];
    const uint32_t yr = py[(size_t)r * stride + i];
    left[(size_t)r * ostride] = xr;
    right[(size_t)(24 + r) * ostride] = yr;
  }
  const bool negate = neg1[i] != 0;
  if (negate) {
    fq_store(left + 24 * ostride, ostride, fq_neg(fq_load(py + i, stride)));
  } else {
#pragma unroll
    for (int r = 0; r < 24; ++r) left[(size_t)(24 + r) * ostride] = py[(size_t)r * stride + i];
  }
  fq_store(right, ostride, fq_mul(fq_load(px + i, stride), fq_const(FQ_BETA_MONT)));
  const uint32_t f = inf[i] != 0 ? 1u : 0u;
  left[48 * ostride] = f;
  right[48 * ostride] = f;
}

// An empty kernel: the fixed cost of one launch, which chip_smoke.py times
// beside compress and glv_records. On no path.
__global__ void launch_floor_kernel() {}

inline int field_blocks(int n) { return (n + FIELD_THREADS - 1) / FIELD_THREADS; }

}  // namespace curdle

using namespace curdle;

extern "C" {

// x (24, n) canonical, sign (n,) bool -> xm, ym (24, n) Montgomery, ok (n,) bool.
int curdle_decompress(const void* x, const void* sign, void* xm, void* ym, void* ok, int n,
                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  decompress_kernel<<<field_blocks(n), FIELD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint8_t*)sign, (uint32_t*)xm, (uint32_t*)ym, (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}

// One launch of the empty kernel.
int curdle_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// x, y (24, n) Montgomery -> xc (24, n) canonical, largest (n,) bool.
int curdle_compress(const void* x, const void* y, void* xc, void* largest, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  compress_kernel<<<field_blocks(n), FIELD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)xc, (uint8_t*)largest, n);
  return (int)cudaGetLastError();
}

// px, py (24, n) Montgomery, inf (n,) bool, neg1 (n,) bool -> records (49, 2n).
int curdle_glv_records(const void* px, const void* py, const void* inf, const void* neg1,
                       void* records, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  glv_records_kernel<<<field_blocks(n), FIELD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint8_t*)inf, (const uint8_t*)neg1,
      (uint32_t*)records, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
