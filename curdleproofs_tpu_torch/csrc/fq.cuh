// BLS12-381 base field Fq on the GPU: 384-bit Montgomery arithmetic over
// 12 x 32-bit words held in registers.
//
// The package's tensors carry a field element as 24 limb rows of 16 bits in
// 32-bit containers (limb-major, Montgomery R = 2^384). A kernel re-pairs two
// neighbouring limbs into one 32-bit word on load (fq_load) and splits them
// again on store (fq_store); R is 2^384 in both views, so values are
// unchanged. Every function takes canonical residues in [0, p) and returns
// canonical residues, so results equal the plain PyTorch versions in
// ops/modarith.py bit for bit.
//
// Right first: the multiply is a word-serial CIOS Montgomery product written
// with 64-bit accumulation; its loops are fully unrolled so the word arrays
// stay in registers inside it.
#pragma once

#include <stdint.h>

namespace curdle {

constexpr int FQ_WORDS = 12;

struct Fq {
  uint32_t v[FQ_WORDS];
};

// p, little-endian 32-bit words (checked against fields.FQ_MOD by the tests).
__device__ __constant__ uint32_t FQ_P[FQ_WORDS] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// R mod p = Montgomery one.
__device__ __constant__ uint32_t FQ_ONE[FQ_WORDS] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// -p^{-1} mod 2^32.
constexpr uint32_t FQ_N0INV = 0xfffcfffdu;

__device__ __forceinline__ Fq fq_zero() {
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = 0u;
  return r;
}

__device__ __forceinline__ Fq fq_one() {
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = FQ_ONE[i];
  return r;
}

__device__ __forceinline__ bool fq_is_zero(const Fq& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) acc |= a.v[i];
  return acc == 0u;
}

// Load one element whose 24 limb rows lie `stride` containers apart.
__device__ __forceinline__ Fq fq_load(const uint32_t* __restrict__ base, size_t stride) {
  Fq r;
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    const uint32_t lo = base[(size_t)(2 * k) * stride];
    const uint32_t hi = base[(size_t)(2 * k + 1) * stride];
    r.v[k] = (lo & 0xffffu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fq_store(uint32_t* __restrict__ base, size_t stride, const Fq& a) {
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    base[(size_t)(2 * k) * stride] = a.v[k] & 0xffffu;
    base[(size_t)(2 * k + 1) * stride] = a.v[k] >> 16;
  }
}

// d = a - b over 384 bits; returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t fq_sub_words(Fq& d, const Fq& a, const uint32_t* b) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - (uint64_t)b[i] - (uint64_t)borrow;
    d.v[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// a in [0, 2p) -> a mod p.
__device__ __forceinline__ Fq fq_reduce_once(const Fq& a) {
  uint32_t pw[FQ_WORDS];
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) pw[i] = FQ_P[i];
  Fq d;
  const uint32_t borrow = fq_sub_words(d, a, pw);
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = borrow ? a.v[i] : d.v[i];
  return r;
}

__device__ __forceinline__ Fq fq_add(const Fq& a, const Fq& b) {
  // a + b < 2p < 2^382: no carry leaves the 384 bits
  Fq s;
  uint64_t c = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    c += (uint64_t)a.v[i] + (uint64_t)b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return fq_reduce_once(s);
}

__device__ __forceinline__ Fq fq_dbl(const Fq& a) { return fq_add(a, a); }

__device__ __forceinline__ Fq fq_sub(const Fq& a, const Fq& b) {
  Fq d;
  const uint32_t borrow = fq_sub_words(d, a, b.v);
  // add p back where the subtraction wrapped
  Fq r;
  uint64_t c = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    c += (uint64_t)d.v[i] + (uint64_t)(borrow ? FQ_P[i] : 0u);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// -a mod p. Results are canonical, so -0 is 0 and not p.
__device__ __forceinline__ Fq fq_neg(const Fq& a) { return fq_sub(fq_zero(), a); }

// Montgomery product a * b * 2^-384 mod p (CIOS, one word of b at a time).
// With a, b < p < 2^381 the running value stays below 2p, so 13 words hold
// every intermediate.
//
// Deliberately NOT inlined: a point formula calls it 7 to 16 times, and one
// shared body keeps the kernels small and the build at seconds (fully
// inlined, nvcc 12.8 took 47 s over the point kernels and crashed on the
// scan kernels). The price is operands passed through local memory.
__device__ __noinline__ Fq fq_mul(const Fq& a, const Fq& b) {
  uint32_t t[FQ_WORDS + 2];
#pragma unroll
  for (int i = 0; i < FQ_WORDS + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < FQ_WORDS; ++j) {
      const uint64_t s = (uint64_t)a.v[j] * (uint64_t)b.v[i] + (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FQ_WORDS] + c;
    t[FQ_WORDS] = (uint32_t)s;
    t[FQ_WORDS + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * FQ_N0INV;
    s = (uint64_t)m * (uint64_t)FQ_P[0] + (uint64_t)t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FQ_WORDS; ++j) {
      s = (uint64_t)m * (uint64_t)FQ_P[j] + (uint64_t)t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FQ_WORDS] + c;
    t[FQ_WORDS - 1] = (uint32_t)s;
    t[FQ_WORDS] = t[FQ_WORDS + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p < 2^384, so t[12] == 0 here
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = t[i];
  return fq_reduce_once(r);
}

__device__ __forceinline__ Fq fq_sqr(const Fq& a) { return fq_mul(a, a); }

}  // namespace curdle
