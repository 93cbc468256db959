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
// The arithmetic runs on inline PTX carry chains over the 32-bit words:
// additions and subtractions as add.cc / sub.cc chains, the Montgomery
// product and the square as mad.lo.cc / madc.hi.cc chains with two
// accumulators in flight, one for the even and one for the odd word
// products, and one word of reduction a step; kernels call the product and
// the square out of line as fq_mul and fq_sqr. tests/test_torch_fq_schedule.py
// runs every asm statement of this file on the CPU, in the order the
// functions call them. The arithmetic that came before (64-bit accumulation,
// a word-serial product) stays as a build variant, CURDLE_FQ_CIOS64, to be
// timed beside it.
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

#if defined(CURDLE_FQ_CIOS64)

// The field arithmetic as it was before the carry chains, kept as a build
// variant to be timed beside them (chip_smoke.py --product-variants): the
// additions with 64-bit accumulation, the word-serial product, the square
// as a product.

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

// One word of the CIOS Montgomery product, 64-bit accumulation:
// t = (t + a * bi + m * p) / 2^32 with m chosen to clear the low word. With
// a, b < p < 2^381 the running value stays below 2p, so 13 words hold every
// intermediate.
__device__ __forceinline__ void fq_mont_word(uint32_t (&t)[FQ_WORDS + 2], const Fq& a, uint32_t bi) {
  uint64_t c = 0u;
#pragma unroll
  for (int j = 0; j < FQ_WORDS; ++j) {
    const uint64_t s = (uint64_t)a.v[j] * (uint64_t)bi + (uint64_t)t[j] + c;
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

// Montgomery product a * b * 2^-384 mod p (CIOS, one word of b at a time).
__device__ __forceinline__ Fq fq_mont(const Fq& a, const Fq& b) {
  uint32_t t[FQ_WORDS + 2];
#pragma unroll
  for (int i = 0; i < FQ_WORDS + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) fq_mont_word(t, a, b.v[i]);
  // t < 2p < 2^384, so t[12] == 0 here
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = t[i];
  return fq_reduce_once(r);
}

#else

// The additions on carry chains too: a 384-bit add or subtract is one chain
// of 12 add.cc / sub.cc, the final subtraction one chain and one mask.
// d -= s over 384 bits; returns the borrow out as a mask, 0 or all ones.
__device__ __forceinline__ uint32_t sub_mask(uint32_t (&d)[FQ_WORDS], const uint32_t (&s)[FQ_WORDS]) {
  uint32_t mask;
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(mask)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(s[8]), "r"(s[9]), "r"(s[10]), "r"(s[11]));
  return mask;
}

// d += s over 384 bits; a carry out falls (fq_sub's add-back wraps by design).
__device__ __forceinline__ void add_wrap(uint32_t (&d)[FQ_WORDS], const uint32_t (&s)[FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.cc.u32 %11, %11, %23;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(s[8]), "r"(s[9]), "r"(s[10]), "r"(s[11]));
}

// a in [0, 2p) -> a mod p.
__device__ __forceinline__ Fq fq_reduce_once(const Fq& a) {
  uint32_t pw[FQ_WORDS], d[FQ_WORDS];
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) {
    pw[i] = FQ_P[i];
    d[i] = a.v[i];
  }
  const uint32_t keep = sub_mask(d, pw);  // all ones where a < p
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = (a.v[i] & keep) | (d[i] & ~keep);
  return r;
}

__device__ __forceinline__ Fq fq_add(const Fq& a, const Fq& b) {
  Fq s = a;
  add_wrap(s.v, b.v);  // a + b < 2p < 2^382: nothing wraps
  return fq_reduce_once(s);
}

__device__ __forceinline__ Fq fq_sub(const Fq& a, const Fq& b) {
  Fq d = a;
  const uint32_t wrapped = sub_mask(d.v, b.v);
  uint32_t pm[FQ_WORDS];
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) pm[i] = FQ_P[i] & wrapped;
  add_wrap(d.v, pm);  // add p back where the subtraction wrapped
  return d;
}

// The product on carry chains. A step of fq_mont adds a * b_i and then m * p
// (m = the low word times -p^-1, which clears it) and drops the low word.
// The running value is held as even + odd * 2^32 in two 12-word
// accumulators: `even` takes the word products a_j * b_i of even j (their
// lo/hi word pairs do not overlap, so one carry chain adds all six), `odd`
// those of odd j. So a step is two independent chains of 13 instructions, and
// dropping the low word swaps the two roles: the old odd accumulator becomes
// the even one, and the old even one, shifted down two words, the odd one
// (rshift_pairs, fused with the next step's products). This is the layout of
// Supranational's sppark `mont_t::mul`. With a < p < 2^381 the running value
// stays below 2p, so the odd accumulator never reaches 2^384: the carries the
// schedule lets fall are zero (asserted in tests/test_torch_fq_schedule.py).
// The compiler keeps no carry flag from one asm statement to the next, so
// each chain is one asm statement.
namespace mont {

// acc[2j], acc[2j + 1] = a[S + 2j] * bi, j < 6: disjoint word pairs, no carry.
template <int S>
__device__ __forceinline__ void mul_pairs(uint32_t (&acc)[FQ_WORDS], const uint32_t (&a)[FQ_WORDS],
                                          uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    acc[2 * j] = a[S + 2 * j] * bi;
    acc[2 * j + 1] = __umulhi(a[S + 2 * j], bi);
  }
}

// acc += sum_j a[S + 2j] * bi * 2^(64j); the chain's carry out is zero.
template <int S>
__device__ __forceinline__ void cmad_pairs(uint32_t (&acc)[FQ_WORDS], const uint32_t (&a)[FQ_WORDS],
                                           uint32_t bi) {
  asm("mad.lo.cc.u32 %0, %12, %18, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %18, %7;\n\t"
      "madc.lo.cc.u32 %8, %16, %18, %8;\n\t"
      "madc.hi.cc.u32 %9, %16, %18, %9;\n\t"
      "madc.lo.cc.u32 %10, %17, %18, %10;\n\t"
      "madc.hi.u32 %11, %17, %18, %11;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11])
      : "r"(a[S + 0]), "r"(a[S + 2]), "r"(a[S + 4]), "r"(a[S + 6]), "r"(a[S + 8]), "r"(a[S + 10]),
        "r"(bi));
}

// The same, the chain's carry added into top (the odd accumulator's last
// word, which sits at 2^384 beside the even one).
template <int S>
__device__ __forceinline__ void cmad_pairs_top(uint32_t (&acc)[FQ_WORDS], const uint32_t (&a)[FQ_WORDS],
                                               uint32_t bi, uint32_t& top) {
  asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), "+r"(acc[5]),
        "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(top)
      : "r"(a[S + 0]), "r"(a[S + 2]), "r"(a[S + 4]), "r"(a[S + 6]), "r"(a[S + 8]), "r"(a[S + 10]),
        "r"(bi));
}

// The low word dropped, fused with a step's odd products: e0 += o[1] (both
// now at word 0), then o = (o >> 64) + sum_j a[2j + 1] * bi * 2^(64j) with
// that carry in at word 1.
__device__ __forceinline__ void rshift_pairs(uint32_t& e0, uint32_t (&o)[FQ_WORDS],
                                             const uint32_t (&a)[FQ_WORDS], uint32_t bi) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
      "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
      "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
      "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
      "madc.hi.u32 %12, %18, %19, 0;"
      : "+r"(e0), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]), "r"(bi));
}

// e += o >> 32, after the last step (o[0] is zero there).
__device__ __forceinline__ void merge_shift(uint32_t (&e)[FQ_WORDS], const uint32_t (&o)[FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(o[8]),
        "r"(o[9]), "r"(o[10]), "r"(o[11]));
}

// e += h; the sum stays below 2p.
__device__ __forceinline__ void add_words(uint32_t (&e)[FQ_WORDS], const uint32_t (&h)[FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11])
      : "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "r"(h[4]), "r"(h[5]), "r"(h[6]), "r"(h[7]),
        "r"(h[8]), "r"(h[9]), "r"(h[10]), "r"(h[11]));
}

// One step: acc = (acc + a * bi + m * p) / 2^32 in the (e, o) roles.
template <bool FIRST>
__device__ __forceinline__ void mul_step(uint32_t (&e)[FQ_WORDS], uint32_t (&o)[FQ_WORDS],
                                         const uint32_t (&a)[FQ_WORDS], const uint32_t (&pw)[FQ_WORDS],
                                         uint32_t bi) {
  if constexpr (FIRST) {
    mul_pairs<0>(e, a, bi);
    mul_pairs<1>(o, a, bi);
  } else {
    rshift_pairs(e[0], o, a, bi);
    cmad_pairs_top<0>(e, a, bi, o[FQ_WORDS - 1]);
  }
  const uint32_t m = e[0] * FQ_N0INV;
  cmad_pairs<1>(o, pw, m);
  cmad_pairs_top<0>(e, pw, m, o[FQ_WORDS - 1]);  // e[0] is now 0
}

// The squaring's reduction step: the same without a product, so the low
// word comes from e0 + o[1] before rshift_pairs adds them.
template <bool FIRST>
__device__ __forceinline__ void redc_step(uint32_t (&e)[FQ_WORDS], uint32_t (&o)[FQ_WORDS],
                                          const uint32_t (&pw)[FQ_WORDS]) {
  if constexpr (FIRST) {
    const uint32_t m = e[0] * FQ_N0INV;
    mul_pairs<1>(o, pw, m);
    cmad_pairs_top<0>(e, pw, m, o[FQ_WORDS - 1]);
  } else {
    const uint32_t m = (e[0] + o[1]) * FQ_N0INV;
    rshift_pairs(e[0], o, pw, m);
    cmad_pairs_top<0>(e, pw, m, o[FQ_WORDS - 1]);
  }
}

// One row of the squaring's off-diagonal products, bi = a_i against
// a[J], a[J + 2], ... (L of them, all j > i of one parity): their word pairs
// added at acc[S ..], the chain's carry into acc[S + 2L], which no earlier
// row has reached.
template <int S, int J, int L>
__device__ __forceinline__ void row_pairs(uint32_t (&acc)[2 * FQ_WORDS], const uint32_t (&a)[FQ_WORDS],
                                          uint32_t bi) {
  if constexpr (L == 1) {
    asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2])
        : "r"(a[J + 0]), "r"(bi));
  } else if constexpr (L == 2) {
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2]), "+r"(acc[S + 3]), "+r"(acc[S + 4])
        : "r"(a[J + 0]), "r"(a[J + 2]), "r"(bi));
  } else if constexpr (L == 3) {
    asm("mad.lo.cc.u32 %0, %7, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2]), "+r"(acc[S + 3]), "+r"(acc[S + 4]),
          "+r"(acc[S + 5]), "+r"(acc[S + 6])
        : "r"(a[J + 0]), "r"(a[J + 2]), "r"(a[J + 4]), "r"(bi));
  } else if constexpr (L == 4) {
    asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2]), "+r"(acc[S + 3]), "+r"(acc[S + 4]),
          "+r"(acc[S + 5]), "+r"(acc[S + 6]), "+r"(acc[S + 7]), "+r"(acc[S + 8])
        : "r"(a[J + 0]), "r"(a[J + 2]), "r"(a[J + 4]), "r"(a[J + 6]), "r"(bi));
  } else if constexpr (L == 5) {
    asm("mad.lo.cc.u32 %0, %11, %16, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %16, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %16, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %16, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %14, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %15, %16, %8;\n\t"
        "madc.hi.cc.u32 %9, %15, %16, %9;\n\t"
        "addc.u32 %10, %10, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2]), "+r"(acc[S + 3]), "+r"(acc[S + 4]),
          "+r"(acc[S + 5]), "+r"(acc[S + 6]), "+r"(acc[S + 7]), "+r"(acc[S + 8]), "+r"(acc[S + 9]),
          "+r"(acc[S + 10])
        : "r"(a[J + 0]), "r"(a[J + 2]), "r"(a[J + 4]), "r"(a[J + 6]), "r"(a[J + 8]), "r"(bi));
  } else if constexpr (L == 6) {
    asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(acc[S + 0]), "+r"(acc[S + 1]), "+r"(acc[S + 2]), "+r"(acc[S + 3]), "+r"(acc[S + 4]),
          "+r"(acc[S + 5]), "+r"(acc[S + 6]), "+r"(acc[S + 7]), "+r"(acc[S + 8]), "+r"(acc[S + 9]),
          "+r"(acc[S + 10]), "+r"(acc[S + 11]), "+r"(acc[S + 12])
        : "r"(a[J + 0]), "r"(a[J + 2]), "r"(a[J + 4]), "r"(a[J + 6]), "r"(a[J + 8]), "r"(a[J + 10]),
          "r"(bi));
  }
}

// Row I: the products a_I * a_j of odd j - I land on odd words (the odd
// wide accumulator, whose word k sits at word k + 1), those of even j - I on
// even words.
template <int I>
__device__ __forceinline__ void sqr_rows(uint32_t (&e)[2 * FQ_WORDS], uint32_t (&o)[2 * FQ_WORDS],
                                         const uint32_t (&a)[FQ_WORDS]) {
  row_pairs<2 * I, I + 1, (10 - I) / 2 + 1>(o, a, a[I]);
  if constexpr (I < 10) {
    row_pairs<2 * I + 2, I + 2, (9 - I) / 2 + 1>(e, a, a[I]);
    sqr_rows<I + 1>(e, o, a);
  }
}

// e[1..23] += o[0..22]: the off-diagonal sum in one 24-word number.
__device__ __forceinline__ void merge_wide(uint32_t (&e)[2 * FQ_WORDS], const uint32_t (&o)[2 * FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %23;\n\t"
      "addc.cc.u32 %1, %1, %24;\n\t"
      "addc.cc.u32 %2, %2, %25;\n\t"
      "addc.cc.u32 %3, %3, %26;\n\t"
      "addc.cc.u32 %4, %4, %27;\n\t"
      "addc.cc.u32 %5, %5, %28;\n\t"
      "addc.cc.u32 %6, %6, %29;\n\t"
      "addc.cc.u32 %7, %7, %30;\n\t"
      "addc.cc.u32 %8, %8, %31;\n\t"
      "addc.cc.u32 %9, %9, %32;\n\t"
      "addc.cc.u32 %10, %10, %33;\n\t"
      "addc.cc.u32 %11, %11, %34;\n\t"
      "addc.cc.u32 %12, %12, %35;\n\t"
      "addc.cc.u32 %13, %13, %36;\n\t"
      "addc.cc.u32 %14, %14, %37;\n\t"
      "addc.cc.u32 %15, %15, %38;\n\t"
      "addc.cc.u32 %16, %16, %39;\n\t"
      "addc.cc.u32 %17, %17, %40;\n\t"
      "addc.cc.u32 %18, %18, %41;\n\t"
      "addc.cc.u32 %19, %19, %42;\n\t"
      "addc.cc.u32 %20, %20, %43;\n\t"
      "addc.cc.u32 %21, %21, %44;\n\t"
      "addc.u32 %22, %22, %45;"
      : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]), "+r"(e[14]),
        "+r"(e[15]), "+r"(e[16]), "+r"(e[17]), "+r"(e[18]), "+r"(e[19]), "+r"(e[20]), "+r"(e[21]),
        "+r"(e[22]), "+r"(e[23])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]),
        "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]), "r"(o[14]),
        "r"(o[15]), "r"(o[16]), "r"(o[17]), "r"(o[18]), "r"(o[19]), "r"(o[20]), "r"(o[21]),
        "r"(o[22]));
}

// w += the squares a_j^2 at words 2j, 2j + 1 (w holds twice the
// off-diagonal sum; the whole square is below 2^762).
__device__ __forceinline__ void add_squares(uint32_t (&w)[2 * FQ_WORDS], const uint32_t (&a)[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %24, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %24, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %25, %25, %2;\n\t"
      "madc.hi.cc.u32 %3, %25, %25, %3;\n\t"
      "madc.lo.cc.u32 %4, %26, %26, %4;\n\t"
      "madc.hi.cc.u32 %5, %26, %26, %5;\n\t"
      "madc.lo.cc.u32 %6, %27, %27, %6;\n\t"
      "madc.hi.cc.u32 %7, %27, %27, %7;\n\t"
      "madc.lo.cc.u32 %8, %28, %28, %8;\n\t"
      "madc.hi.cc.u32 %9, %28, %28, %9;\n\t"
      "madc.lo.cc.u32 %10, %29, %29, %10;\n\t"
      "madc.hi.cc.u32 %11, %29, %29, %11;\n\t"
      "madc.lo.cc.u32 %12, %30, %30, %12;\n\t"
      "madc.hi.cc.u32 %13, %30, %30, %13;\n\t"
      "madc.lo.cc.u32 %14, %31, %31, %14;\n\t"
      "madc.hi.cc.u32 %15, %31, %31, %15;\n\t"
      "madc.lo.cc.u32 %16, %32, %32, %16;\n\t"
      "madc.hi.cc.u32 %17, %32, %32, %17;\n\t"
      "madc.lo.cc.u32 %18, %33, %33, %18;\n\t"
      "madc.hi.cc.u32 %19, %33, %33, %19;\n\t"
      "madc.lo.cc.u32 %20, %34, %34, %20;\n\t"
      "madc.hi.cc.u32 %21, %34, %34, %21;\n\t"
      "madc.lo.cc.u32 %22, %35, %35, %22;\n\t"
      "madc.hi.u32 %23, %35, %35, %23;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]),
        "+r"(w[7]), "+r"(w[8]), "+r"(w[9]), "+r"(w[10]), "+r"(w[11]), "+r"(w[12]), "+r"(w[13]),
        "+r"(w[14]), "+r"(w[15]), "+r"(w[16]), "+r"(w[17]), "+r"(w[18]), "+r"(w[19]), "+r"(w[20]),
        "+r"(w[21]), "+r"(w[22]), "+r"(w[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
}

__device__ __forceinline__ void load_p(uint32_t (&pw)[FQ_WORDS]) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) pw[i] = FQ_P[i];
}

}  // namespace mont

// Montgomery product a * b * 2^-384 mod p: 12 steps of one word of b.
__device__ __forceinline__ Fq fq_mont(const Fq& a, const Fq& b) {
  uint32_t pw[FQ_WORDS], even[FQ_WORDS], odd[FQ_WORDS];
  mont::load_p(pw);
  mont::mul_step<true>(even, odd, a.v, pw, b.v[0]);
  mont::mul_step<false>(odd, even, a.v, pw, b.v[1]);
#pragma unroll
  for (int i = 2; i < FQ_WORDS; i += 2) {
    mont::mul_step<false>(even, odd, a.v, pw, b.v[i]);
    mont::mul_step<false>(odd, even, a.v, pw, b.v[i + 1]);
  }
  mont::merge_shift(even, odd);
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = even[i];
  return fq_reduce_once(r);
}

// Montgomery square a^2 * 2^-384 mod p: the 66 off-diagonal word products
// once (rows into an even and an odd 24-word accumulator), doubled, plus the
// 12 squares, for 78 word products against fq_mont's 144; then the low half
// reduced by the same 12 one-word steps and the high half added.
__device__ __forceinline__ Fq fq_mont_sqr(const Fq& x) {
  uint32_t e[2 * FQ_WORDS], o[2 * FQ_WORDS];
#pragma unroll
  for (int k = 0; k < 2 * FQ_WORDS; ++k) e[k] = o[k] = 0u;
  mont::sqr_rows<0>(e, o, x.v);
  mont::merge_wide(e, o);
  uint32_t w[2 * FQ_WORDS];
  w[0] = e[0] << 1;
#pragma unroll
  for (int k = 1; k < 2 * FQ_WORDS; ++k) w[k] = __funnelshift_l(e[k - 1], e[k], 1);
  mont::add_squares(w, x.v);
  uint32_t pw[FQ_WORDS], lo[FQ_WORDS], hi[FQ_WORDS], odd[FQ_WORDS];
  mont::load_p(pw);
#pragma unroll
  for (int k = 0; k < FQ_WORDS; ++k) {
    lo[k] = w[k];
    hi[k] = w[FQ_WORDS + k];
  }
  mont::redc_step<true>(lo, odd, pw);
  mont::redc_step<false>(odd, lo, pw);
#pragma unroll
  for (int i = 2; i < FQ_WORDS; i += 2) {
    mont::redc_step<false>(lo, odd, pw);
    mont::redc_step<false>(odd, lo, pw);
  }
  mont::merge_shift(lo, odd);
  mont::add_words(lo, hi);
  Fq r;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; ++i) r.v[i] = lo[i];
  return fq_reduce_once(r);
}

#endif  // CURDLE_FQ_CIOS64

__device__ __forceinline__ Fq fq_dbl(const Fq& a) { return fq_add(a, a); }

// -a mod p. Results are canonical, so -0 is 0 and not p.
__device__ __forceinline__ Fq fq_neg(const Fq& a) { return fq_sub(fq_zero(), a); }

// The product and the square every kernel calls: out of line (a point
// formula calls them 7 to 16 times, and one shared body each keeps a
// kernel's loop small and its build at seconds), operands by value, so a
// call passes them in registers and not through local memory. Build-time
// variants exist only to be measured against this (chip_smoke.py
// --product-variants, figures in PERF.md): CURDLE_FQ_CIOS64 the arithmetic
// before the carry chains (above); CURDLE_FQ_MUL_BY_REF takes the operands
// by reference; CURDLE_FQ_MUL_INLINE inlines both at every call (two to four
// times the machine code and slower on an H100; nvcc 12.8 crashed on
// kernels.cu with the word-serial product inlined).
#if defined(CURDLE_FQ_MUL_INLINE)
#define CURDLE_FQ_MUL_LINKAGE __forceinline__
#else
#define CURDLE_FQ_MUL_LINKAGE __noinline__
#endif

#if defined(CURDLE_FQ_MUL_BY_REF)
__device__ CURDLE_FQ_MUL_LINKAGE Fq fq_mul(const Fq& a, const Fq& b) { return fq_mont(a, b); }
#else
__device__ CURDLE_FQ_MUL_LINKAGE Fq fq_mul(Fq a, Fq b) { return fq_mont(a, b); }
#endif

#if defined(CURDLE_FQ_CIOS64)
__device__ __forceinline__ Fq fq_sqr(const Fq& a) { return fq_mul(a, a); }
#elif defined(CURDLE_FQ_MUL_BY_REF)
__device__ CURDLE_FQ_MUL_LINKAGE Fq fq_sqr(const Fq& a) { return fq_mont_sqr(a); }
#else
__device__ CURDLE_FQ_MUL_LINKAGE Fq fq_sqr(Fq a) { return fq_mont_sqr(a); }
#endif

}  // namespace curdle
