// The row-local batched gather of the routed gather, with a plain C interface.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcurdle_gather.so gather.cu
// and loaded with ctypes (ops/cuda_g1.py). The entry point launches on the
// stream it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace curdle {

// ---------------------------------------------------------------------------
// rowwise_gather: out[g, r, m] = table[g, r, idx[g, m]], 0 where the index
// lies outside [0, K). table (G, R, K), idx (G, M), out (G, R, M).
//
// Replaces ops/gather.py::_build_rowwise of the JAX package: there every
// group's gather is a one-hot (K, BM) matrix product over byte planes,
// because that machine has no fast lane gather, and K <= 512 so the one-hot
// fits a block. A GPU thread loads from the address, so none of that
// carries over: no one-hot, no planes, no bound on K.
//
// Bound by bytes: every output word is one load and one store, no
// arithmetic. One block takes one group and 256 neighbouring m; a thread
// reads its index once and walks the R rows. Stores coalesce over m. Loads
// are as scattered as the indices, but inside one K-word table row (1 to
// 2 KB on the routed gather's stages), which all threads of the block read
// at the same step, so every fetched line is used by the block from L1. A
// stage of the routed gather whose groups are narrow (M = 256) gets one
// block per group, 2,560 to 5,120 blocks a launch.
// ---------------------------------------------------------------------------

constexpr int ROWWISE_THREADS = 256;

__global__ void __launch_bounds__(ROWWISE_THREADS)
rowwise_gather_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                      uint32_t* __restrict__ out, int R, int K, int M) {
  const int m = blockIdx.y * ROWWISE_THREADS + threadIdx.x;
  const size_t g = blockIdx.x;
  if (m >= M) return;
  const int i = idx[g * M + m];
  const bool hit = i >= 0 && i < K;
  const uint32_t* src = table + g * R * K + (hit ? i : 0);
  uint32_t* dst = out + g * R * M + m;
#pragma unroll 7
  for (int r = 0; r < R; ++r) dst[(size_t)r * M] = hit ? src[(size_t)r * K] : 0u;
}

}  // namespace curdle

using namespace curdle;

extern "C" {

// table (G, R, K), idx (G, M) -> out (G, R, M).
int curdle_rowwise_gather(const void* table, const void* idx, void* out, int G, int R, int K, int M,
                          void* stream) {
  const int tiles = (M + ROWWISE_THREADS - 1) / ROWWISE_THREADS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(G, tiles);
  rowwise_gather_kernel<<<grid, ROWWISE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, R, K, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
