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
 * GLV_M = floor(2^640 / r), the Barrett reciprocal. */
static const u64 GLV_M[7] = {0xdb7b86bbf1d4d267ULL, 0x101613ce4457858fULL,
                             0x42737a020c0d6393ULL, 0x65043eb4be4bad71ULL,
                             0x38b5dcb707e08ed3ULL, 0x355094edfede377cULL,
                             0x0000000000000002ULL};
static const u64 GLV_LAMP1[2] = {0x0000000100000000ULL, 0xac45a4010001a402ULL};
static const u64 GLV_LAM[2] = {0x00000000ffffffffULL, 0xac45a4010001a402ULL};
static const u64 GLV_HALF_R[4] = {0x7fffffff80000000ULL, 0xa9ded2017fff2dffULL,
                                  0x199cec0404d0ec02ULL, 0x39f6d3a994cebea4ULL};

/* k (4 LE limbs, canonical < r) -> neg1, |k1| (3 limbs), k2 (3 limbs) with
 * k = (-1)^neg1 * |k1| + k2 * lambda (mod r), |k1| < 2^130, 0 <= k2 <= lambda:
 * c1 = floor((k*(lambda+1) + r/2) / r) by Barrett (shift 2^640, one
 * correction step), clamped to lambda. */
static void glv_decompose(const u64 *k, int *neg1, u64 *k1, u64 *k2) {
    /* num = k*(lambda+1) + r/2  (< 2^384, 6 limbs; buffer 7) */
    u64 num[7] = {0};
    for (int i = 0; i < 4; i++) {
        u64 c = 0;
        for (int j = 0; j < 2; j++) {
            u128 s = (u128)k[i] * GLV_LAMP1[j] + num[i + j] + c;
            num[i + j] = (u64)s;
            c = (u64)(s >> 64);
        }
        for (int t = i + 2; c && t < 7; t++) {
            u128 s = (u128)num[t] + c;
            num[t] = (u64)s;
            c = (u64)(s >> 64);
        }
    }
    u64 c = 0;
    for (int j = 0; j < 7; j++) {
        u128 s = (u128)num[j] + (j < 4 ? GLV_HALF_R[j] : 0) + c;
        num[j] = (u64)s;
        c = (u64)(s >> 64);
    }
    /* Barrett: q_est = floor(num*M / 2^640) in {q-1, q} */
    u64 prod[14] = {0};
    for (int i = 0; i < 7; i++) {
        u64 cc = 0;
        for (int j = 0; j < 7; j++) {
            u128 s = (u128)num[i] * GLV_M[j] + prod[i + j] + cc;
            prod[i + j] = (u64)s;
            cc = (u64)(s >> 64);
        }
        for (int t = i + 7; cc && t < 14; t++) {
            u128 s = (u128)prod[t] + cc;
            prod[t] = (u64)s;
            cc = (u64)(s >> 64);
        }
    }
    u64 q[3] = {prod[10], prod[11], prod[12]};
    /* rem = num - q*r; if rem >= r then q += 1 */
    u64 qr[8] = {0};
    for (int i = 0; i < 3; i++) {
        u64 cc = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)q[i] * FR_ORDER[j] + qr[i + j] + cc;
            qr[i + j] = (u64)s;
            cc = (u64)(s >> 64);
        }
        qr[i + 4] += cc;
    }
    u64 rem[7];
    u64 borrow = 0;
    for (int j = 0; j < 7; j++) {
        u128 s = (u128)num[j] - qr[j] - borrow;
        rem[j] = (u64)s;
        borrow = (s >> 64) ? 1 : 0;
    }
    int ge = 1; /* rem >= r ? (rem has at most 5 meaningful limbs) */
    if (!(rem[4] || rem[5] || rem[6])) {
        for (int j = 3; j >= 0; j--) {
            if (rem[j] > FR_ORDER[j]) { ge = 1; break; }
            if (rem[j] < FR_ORDER[j]) { ge = 0; break; }
        }
    }
    if (ge) {
        u128 s = (u128)q[0] + 1;
        q[0] = (u64)s;
        if (s >> 64) { s = (u128)q[1] + 1; q[1] = (u64)s; q[2] += (u64)(s >> 64); }
    }
    /* clamp q <= lambda */
    int over = (q[2] != 0) || (q[1] > GLV_LAM[1]) ||
               (q[1] == GLV_LAM[1] && q[0] > GLV_LAM[0]);
    if (over) { q[0] = GLV_LAM[0]; q[1] = GLV_LAM[1]; q[2] = 0; }
    k2[0] = q[0]; k2[1] = q[1]; k2[2] = 0;
    /* k1 = k - q*lambda (signed; magnitude < 2^130, 3 limbs) */
    u64 ql[5] = {0};
    for (int i = 0; i < 3; i++) {
        u64 cc = 0;
        for (int j = 0; j < 2; j++) {
            u128 s = (u128)q[i] * GLV_LAM[j] + ql[i + j] + cc;
            ql[i + j] = (u64)s;
            cc = (u64)(s >> 64);
        }
        if (i + 2 < 5) ql[i + 2] += cc;
    }
    u64 k5[5] = {k[0], k[1], k[2], k[3], 0};
    u64 d[5];
    borrow = 0;
    for (int j = 0; j < 5; j++) {
        u128 s = (u128)k5[j] - ql[j] - borrow;
        d[j] = (u64)s;
        borrow = (s >> 64) ? 1 : 0;
    }
    *neg1 = (int)borrow;
    if (borrow) { /* magnitude = ql - k */
        u64 b2 = 0;
        for (int j = 0; j < 5; j++) {
            u128 s = (u128)ql[j] - k5[j] - b2;
            d[j] = (u64)s;
            b2 = (s >> 64) ? 1 : 0;
        }
    }
    k1[0] = d[0]; k1[1] = d[1]; k1[2] = d[2];
}

static void load_scalar(u64 *k, const uint8_t *le32) {
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int b = 7; b >= 0; b--) v = (v << 8) | le32[8 * i + b];
        k[i] = v;
    }
}

#endif /* CURDLE_GLV_HOST_H */
