/* The GLV split shared by host_prep.c and g1_host.c, as static functions so
 * each file keeps its own copy and the library links with no duplicate
 * symbol.
 *
 * k = (-1)^neg1 * |k1| + k2 * lambda (mod r) with |k1| < 2^130 and
 * 0 <= k2 <= lambda, lambda the eigenvalue of the endomorphism
 * phi(x, y) = (beta * x, y) on G1.
 */
#ifndef CURDLE_GLV_HOST_H
#define CURDLE_GLV_HOST_H

#include <stdint.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* the order r of BLS12-381 G1, little-endian 64-bit limbs */
static const u64 FR_ORDER[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                                0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

/* GLV constants: r = lambda^2 + lambda + 1 (the BLS lattice is exact).
 * GLV_MU = floor(2^256 / lambda), the Barrett reciprocal of lambda. */
static const u64 GLV_MU[3] = {0x63f6e522f6cfee30ULL, 0x7c6becf1e01faaddULL, 0x0000000000000001ULL};
static const u64 GLV_LAMP1[2] = {0x0000000100000000ULL, 0xac45a4010001a402ULL};
static const u64 GLV_LAM[2] = {0x00000000ffffffffULL, 0xac45a4010001a402ULL};
static const u64 GLV_HALF_R[4] = {0x7fffffff80000000ULL, 0xa9ded2017fff2dffULL,
                                  0x199cec0404d0ec02ULL, 0x39f6d3a994cebea4ULL};

/* 2 x 2 limbs -> 4 limbs */
static inline void mul2x2(const u64 *a, const u64 *b, u64 *out) {
    u128 t = (u128)a[0] * b[0];
    out[0] = (u64)t;
    u128 m1 = (u128)a[0] * b[1] + (u64)(t >> 64);
    u128 m2 = (u128)a[1] * b[0] + (u64)m1;
    out[1] = (u64)m2;
    u128 h = (u128)a[1] * b[1] + (u64)(m1 >> 64) + (u64)(m2 >> 64);
    out[2] = (u64)h;
    out[3] = (u64)(h >> 64);
}

/* x (2 limbs) >= lambda */
static inline int ge_lambda(const u64 *x) {
    return x[1] > GLV_LAM[1] || (x[1] == GLV_LAM[1] && x[0] >= GLV_LAM[0]);
}

/* k (4 LE limbs, canonical < r) -> neg1, |k1| (3 limbs), k2 (3 limbs) with
 * k = (-1)^neg1 * |k1| + k2 * lambda (mod r), |k1| < 2^130, 0 <= k2 <= lambda:
 * k2 = c1 = floor((k*(lambda+1) + floor(r/2)) / r), clamped to lambda.
 * With k = a*lambda + b (0 <= b < lambda) and r = lambda*(lambda+1) + 1,
 * k*(lambda+1) = a*r + b*(lambda+1) - a, where a <= lambda + 1 and
 * 0 < b*(lambda+1) - a + floor(r/2) < 2r: so c1 = a + 1 when that sum is
 * at least r, else a. a and b come from one Barrett division by lambda
 * (2^127 < lambda < 2^128: the estimate is at most 2 below a). */
static void glv_decompose(const u64 *k, int *neg1, u64 *k1, u64 *k2) {
    /* a_est = floor(floor(k / 2^64) * mu / 2^192) < 2^128 */
    u64 p[6];
    for (int j = 0; j < 6; j++) p[j] = 0;
    for (int i = 0; i < 3; i++) {
        u64 c = 0;
        for (int j = 0; j < 3; j++) {
            u128 s = (u128)k[i + 1] * GLV_MU[j] + p[i + j] + c;
            p[i + j] = (u64)s;
            c = (u64)(s >> 64);
        }
        p[i + 3] = c;
    }
    u64 a[2] = {p[3], p[4]};
    /* b = k - a*lambda < 3*lambda < 2^130: two limbs and a third for the
     * excess, then at most two corrections */
    u64 al[4], b[3];
    mul2x2(a, GLV_LAM, al);
    u64 borrow = 0;
    for (int j = 0; j < 3; j++) {
        u128 s = (u128)k[j] - al[j] - borrow;
        b[j] = (u64)s;
        borrow = (s >> 64) ? 1 : 0;
    }
    while (b[2] || ge_lambda(b)) {
        borrow = 0;
        for (int j = 0; j < 3; j++) {
            u128 s = (u128)b[j] - (j < 2 ? GLV_LAM[j] : 0) - borrow;
            b[j] = (u64)s;
            borrow = (s >> 64) ? 1 : 0;
        }
        if (++a[0] == 0) a[1]++;
    }
    /* d = b*(lambda+1) + floor(r/2) - a (< 2^256); c1 = a + [d >= r] */
    u64 d[4];
    mul2x2(b, GLV_LAMP1, d);
    u64 c = 0;
    for (int j = 0; j < 4; j++) {
        u128 s = (u128)d[j] + GLV_HALF_R[j] + c;
        d[j] = (u64)s;
        c = (u64)(s >> 64);
    }
    borrow = 0;
    for (int j = 0; j < 4; j++) {
        u128 s = (u128)d[j] - (j < 2 ? a[j] : 0) - borrow;
        d[j] = (u64)s;
        borrow = (s >> 64) ? 1 : 0;
    }
    int ge = 1; /* d >= r */
    for (int j = 3; j >= 0; j--) {
        if (d[j] != FR_ORDER[j]) { ge = d[j] > FR_ORDER[j]; break; }
    }
    u64 q[2] = {a[0], a[1]};
    if (ge && ++q[0] == 0) q[1]++;
    /* clamp q <= lambda */
    if (q[1] > GLV_LAM[1] || (q[1] == GLV_LAM[1] && q[0] > GLV_LAM[0])) {
        q[0] = GLV_LAM[0];
        q[1] = GLV_LAM[1];
    }
    k2[0] = q[0]; k2[1] = q[1]; k2[2] = 0;
    /* k1 = k - q*lambda (signed; magnitude < 2^130, 3 limbs) */
    u64 ql[4], e[4];
    mul2x2(q, GLV_LAM, ql);
    borrow = 0;
    for (int j = 0; j < 4; j++) {
        u128 s = (u128)k[j] - ql[j] - borrow;
        e[j] = (u64)s;
        borrow = (s >> 64) ? 1 : 0;
    }
    *neg1 = (int)borrow;
    if (borrow) { /* magnitude = q*lambda - k */
        u64 b2 = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)ql[j] - k[j] - b2;
            e[j] = (u64)s;
            b2 = (s >> 64) ? 1 : 0;
        }
    }
    k1[0] = e[0]; k1[1] = e[1]; k1[2] = e[2];
}

static void load_scalar(u64 *k, const uint8_t *le32) {
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int b = 7; b >= 0; b--) v = (v << 8) | le32[8 * i + b];
        k[i] = v;
    }
}

#endif /* CURDLE_GLV_HOST_H */
