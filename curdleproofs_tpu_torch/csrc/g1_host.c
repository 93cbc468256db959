/* Host BLS12-381 G1 backend of curdleproofs_tpu_torch, with a plain C
 * interface: the exact curve arithmetic of the protocol at its own sizes
 * (the vectors of a shuffle proof, window combines, serde), where a launch
 * on the card costs more than the whole computation.
 *
 * Arithmetic: 6x64-bit-limb Montgomery representation for Fq (CIOS
 * multiplication with unsigned __int128 accumulators), Jacobian
 * coordinates for G1, GLV-split 4-bit-window scalar multiplication,
 * Pippenger MSM with per-size window choice, batched point compression and
 * decompression (sqrt via a^((p+1)/4), p = 3 mod 4).
 *
 * Built with host_prep.c and route.c into one library at first use and
 * loaded with ctypes (utils/host_native.py). The caller allocates every
 * buffer. Byte formats are those of curve.py: affine points are 96 bytes
 * (x || y, each 48-byte big-endian canonical) plus a 1-byte infinity flag;
 * scalars are 32-byte little-endian canonical integers (< r); compressed
 * points are the 48-byte ZCash encoding. Every entry point returns 0 on
 * success; the decoders and the subgroup check return -(1 + i) for the
 * first bad element i; 1 means out of memory.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "glv_host.h"

/* ------------------------------------------------------------------ Fq */

typedef struct { u64 l[6]; } fp;

static const fp FP_P = {{0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL,
                         0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                         0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL}};
static const u64 FP_N0 = 0x89f3fffcfffcfffdULL; /* -p^-1 mod 2^64 */
static const fp FP_R2 = {{0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL,
                          0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL,
                          0x9a793e85b519952dULL, 0x11988fe592cae3aaULL}};
static const fp FP_ONE = {{0x760900000002fffdULL, 0xebf4000bc40c0002ULL,
                           0x5f48985753c758baULL, 0x77ce585370525745ULL,
                           0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}};
/* exponent chains (canonical integers, little-endian limbs) */
static const u64 FP_SQRT_EXP[6] = {0xee7fbfffffffeaabULL, 0x07aaffffac54ffffULL,
                                   0xd9cc34a83dac3d89ULL, 0xd91dd2e13ce144afULL,
                                   0x92c6e9ed90d2eb35ULL, 0x0680447a8e5ff9a6ULL};
static const u64 FP_PM2[6] = {0xb9feffffffffaaa9ULL, 0x1eabfffeb153ffffULL,
                              0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL,
                              0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static const u64 FP_PM1H[6] = {0xdcff7fffffffd555ULL, 0x0f55ffff58a9ffffULL,
                               0xb39869507b587b12ULL, 0xb23ba5c279c2895fULL,
                               0x258dd3db21a5d66bULL, 0x0d0088f51cbff34dULL};

static int fp_is_zero(const fp *a) {
    u64 acc = 0;
    for (int i = 0; i < 6; i++) acc |= a->l[i];
    return acc == 0;
}

static int fp_eq(const fp *a, const fp *b) {
    u64 acc = 0;
    for (int i = 0; i < 6; i++) acc |= a->l[i] ^ b->l[i];
    return acc == 0;
}

/* returns 1 if a >= b (canonical limb compare) */
static int fp_geq(const u64 *a, const u64 *b) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static void fp_sub_raw(u64 *r, const u64 *a, const u64 *b) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        r[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
}

static void fp_add(fp *r, const fp *a, const fp *b) {
    u64 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = (u128)a->l[i] + b->l[i] + carry;
        r->l[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    if (carry || fp_geq(r->l, FP_P.l)) fp_sub_raw(r->l, r->l, FP_P.l);
}

static void fp_sub(fp *r, const fp *a, const fp *b) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a->l[i] - b->l[i] - borrow;
        r->l[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
    if (borrow) {
        u64 carry = 0;
        for (int i = 0; i < 6; i++) {
            u128 s = (u128)r->l[i] + FP_P.l[i] + carry;
            r->l[i] = (u64)s;
            carry = (u64)(s >> 64);
        }
    }
}

static void fp_neg(fp *r, const fp *a) {
    if (fp_is_zero(a)) { *r = *a; return; }
    fp_sub_raw(r->l, FP_P.l, a->l);
}

static void fp_dbl(fp *r, const fp *a) { fp_add(r, a, a); }

/* CIOS Montgomery multiplication */
static void fp_mul(fp *r, const fp *a, const fp *b) {
    u64 t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 6; i++) {
        u64 c = 0;
        u64 ai = a->l[i];
        for (int j = 0; j < 6; j++) {
            u128 s = (u128)ai * b->l[j] + t[j] + c;
            t[j] = (u64)s;
            c = (u64)(s >> 64);
        }
        u128 s = (u128)t[6] + c;
        t[6] = (u64)s;
        t[7] = (u64)(s >> 64);
        u64 m = t[0] * FP_N0;
        u128 s2 = (u128)m * FP_P.l[0] + t[0];
        c = (u64)(s2 >> 64);
        for (int j = 1; j < 6; j++) {
            s2 = (u128)m * FP_P.l[j] + t[j] + c;
            t[j - 1] = (u64)s2;
            c = (u64)(s2 >> 64);
        }
        s2 = (u128)t[6] + c;
        t[5] = (u64)s2;
        t[6] = t[7] + (u64)(s2 >> 64);
        t[7] = 0;
    }
    if (t[6] || fp_geq(t, FP_P.l)) fp_sub_raw(t, t, FP_P.l);
    memcpy(r->l, t, 48);
}

static void fp_sqr(fp *r, const fp *a) { fp_mul(r, a, a); }

/* MSB-first square-and-multiply; exp = canonical little-endian limbs */
static void fp_pow(fp *r, const fp *base, const u64 *exp, int nlimbs) {
    fp acc = FP_ONE;
    int started = 0;
    for (int i = nlimbs - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) fp_sqr(&acc, &acc);
            if ((exp[i] >> b) & 1) {
                fp_mul(&acc, &acc, base);
                started = 1;
            }
        }
    }
    *r = acc;
}

static void fp_inv(fp *r, const fp *a) { fp_pow(r, a, FP_PM2, 6); }

/* sqrt in Montgomery domain; returns 0 if non-residue */
static int fp_sqrt(fp *r, const fp *a) {
    fp s, chk;
    fp_pow(&s, a, FP_SQRT_EXP, 6);
    fp_sqr(&chk, &s);
    if (!fp_eq(&chk, a)) return 0;
    *r = s;
    return 1;
}

/* canonical 48-byte big-endian <-> Montgomery */
static void fp_from_be(fp *r, const uint8_t *be) {
    fp c;
    for (int i = 0; i < 6; i++) {
        u64 v = 0;
        const uint8_t *p = be + 48 - 8 * (i + 1);
        for (int k = 0; k < 8; k++) v = (v << 8) | p[k];
        c.l[i] = v;
    }
    fp_mul(r, &c, &FP_R2);
}

static void fp_to_be(uint8_t *be, const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}}, c;
    fp_mul(&c, a, &one); /* Montgomery reduce to canonical */
    for (int i = 0; i < 6; i++) {
        u64 v = c.l[i];
        uint8_t *p = be + 48 - 8 * (i + 1);
        for (int k = 7; k >= 0; k--) { p[k] = (uint8_t)v; v >>= 8; }
    }
}

/* canonical compare against (p-1)/2 for the compression sign bit:
 * returns 1 if canonical(a) > (p-1)/2 */
static int fp_is_lex_largest(const fp *a) {
    fp one = {{1, 0, 0, 0, 0, 0}}, c;
    fp_mul(&c, a, &one);
    for (int i = 5; i >= 0; i--) {
        if (c.l[i] > FP_PM1H[i]) return 1;
        if (c.l[i] < FP_PM1H[i]) return 0;
    }
    return 0; /* equal -> not larger */
}

/* ------------------------------------------------------------------ G1 */

typedef struct { fp x, y, z; } jpt; /* Jacobian; z == 0 => infinity */

static const jpt JINF = {{{0}}, {{0}}, {{0}}};

static int j_is_inf(const jpt *p) { return fp_is_zero(&p->z); }

/* dbl-2009-l style doubling for a = 0 (2M + 5S) — same formula as the
 * Python oracle in curve.py:_jdbl */
static void j_dbl(jpt *r, const jpt *p) {
    if (j_is_inf(p)) { *r = JINF; return; }
    fp a, b, c, t, d, e, f, x3, y3, z3, tmp;
    fp_sqr(&a, &p->x);
    fp_sqr(&b, &p->y);
    fp_sqr(&c, &b);
    fp_add(&t, &p->x, &b);
    fp_sqr(&t, &t);
    fp_sub(&t, &t, &a);
    fp_sub(&t, &t, &c);
    fp_dbl(&d, &t);
    fp_dbl(&e, &a);
    fp_add(&e, &e, &a);
    fp_sqr(&f, &e);
    fp_dbl(&tmp, &d);
    fp_sub(&x3, &f, &tmp);
    fp_sub(&tmp, &d, &x3);
    fp_mul(&y3, &e, &tmp);
    fp_dbl(&tmp, &c);
    fp_dbl(&tmp, &tmp);
    fp_dbl(&tmp, &tmp);
    fp_sub(&y3, &y3, &tmp);
    fp_mul(&z3, &p->y, &p->z);
    fp_dbl(&z3, &z3);
    r->x = x3; r->y = y3; r->z = z3;
}

/* complete Jacobian addition (handles inf / equal / negated) —
 * add-2007-bl, mirrors curve.py:_jadd */
static void j_add(jpt *r, const jpt *p1, const jpt *p2) {
    if (j_is_inf(p1)) { *r = *p2; return; }
    if (j_is_inf(p2)) { *r = *p1; return; }
    fp z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, x3, y3, z3, tmp;
    fp_sqr(&z1z1, &p1->z);
    fp_sqr(&z2z2, &p2->z);
    fp_mul(&u1, &p1->x, &z2z2);
    fp_mul(&u2, &p2->x, &z1z1);
    fp_mul(&s1, &p1->y, &p2->z);
    fp_mul(&s1, &s1, &z2z2);
    fp_mul(&s2, &p2->y, &p1->z);
    fp_mul(&s2, &s2, &z1z1);
    if (fp_eq(&u1, &u2)) {
        if (fp_eq(&s1, &s2)) { j_dbl(r, p1); return; }
        *r = JINF;
        return;
    }
    fp_sub(&h, &u2, &u1);
    fp_dbl(&i, &h);
    fp_sqr(&i, &i);
    fp_mul(&j, &h, &i);
    fp_sub(&rr, &s2, &s1);
    fp_dbl(&rr, &rr);
    fp_mul(&v, &u1, &i);
    fp_sqr(&x3, &rr);
    fp_sub(&x3, &x3, &j);
    fp_sub(&x3, &x3, &v);
    fp_sub(&x3, &x3, &v);
    fp_sub(&tmp, &v, &x3);
    fp_mul(&y3, &rr, &tmp);
    fp_mul(&tmp, &s1, &j);
    fp_dbl(&tmp, &tmp);
    fp_sub(&y3, &y3, &tmp);
    fp_add(&z3, &p1->z, &p2->z);
    fp_sqr(&z3, &z3);
    fp_sub(&z3, &z3, &z1z1);
    fp_sub(&z3, &z3, &z2z2);
    fp_mul(&z3, &z3, &h);
    r->x = x3; r->y = y3; r->z = z3;
}

static void j_neg(jpt *r, const jpt *p) {
    r->x = p->x;
    fp_neg(&r->y, &p->y);
    r->z = p->z;
}

/* ------------------------------------------------- GLV endomorphism ----
 * phi(X, Y, Z) = (beta*X, Y, Z) acts as multiplication by lambda on G1,
 * with r = lambda^2 + lambda + 1 (BLS lattice is exact). Scalars split as
 * k = (-1)^neg1 * |k1| + k2*lambda with |k1| < 2^130, 0 <= k2 <= lambda,
 * by glv_decompose (glv_host.h), the same split as ops/glv.py. */

static const fp FP_BETA_M = {{0xcd03c9e48671f071ULL, 0x5dab22461fcda5d2ULL,
                              0x587042afd3851b95ULL, 0x8eb60ebe01bacb9eULL,
                              0x03f97d6e83d050d2ULL, 0x18f0206554638741ULL}};

static void j_phi(jpt *r, const jpt *p) {
    fp_mul(&r->x, &p->x, &FP_BETA_M);
    r->y = p->y;
    r->z = p->z;
}

/* r = (-1)^neg1 * |k1| * P + k2 * phi(P); k1, k2 = 3 LE limbs (< 2^132) */
static void j_mul_glv(jpt *r, const jpt *p, int neg1, const u64 *k1,
                      const u64 *k2) {
    if (j_is_inf(p)) { *r = JINF; return; }
    jpt tu[16], t2[16];
    tu[1] = *p;
    for (int i = 2; i < 16; i++) j_add(&tu[i], &tu[i - 1], p);
    for (int i = 1; i < 16; i++) j_phi(&t2[i], &tu[i]);
    if (neg1)
        for (int i = 1; i < 16; i++) j_neg(&tu[i], &tu[i]);
    jpt acc = JINF;
    for (int shift = 128; shift >= 0; shift -= 4) {
        if (!j_is_inf(&acc)) {
            j_dbl(&acc, &acc); j_dbl(&acc, &acc);
            j_dbl(&acc, &acc); j_dbl(&acc, &acc);
        }
        int limb = shift / 64, off = shift % 64;
        u64 d1 = k1[limb] >> off, d2 = k2[limb] >> off;
        if (off > 60 && limb < 2) {
            d1 |= k1[limb + 1] << (64 - off);
            d2 |= k2[limb + 1] << (64 - off);
        }
        d1 &= 0xF; d2 &= 0xF;
        if (d1) j_add(&acc, &acc, &tu[d1]);
        if (d2) j_add(&acc, &acc, &t2[d2]);
    }
    *r = acc;
}

/* 4-bit-window scalar multiplication; scalar = 4 canonical LE limbs */
static void j_mul(jpt *r, const jpt *p, const u64 *k) {
    int bits = 0;
    for (int i = 3; i >= 0; i--) {
        if (k[i]) { bits = 64 * i + 64; while (!((k[i] >> (bits - 64 * i - 1)) & 1)) bits--; break; }
    }
    if (bits == 0 || j_is_inf(p)) { *r = JINF; return; }
    jpt tbl[16];
    tbl[0] = JINF;
    tbl[1] = *p;
    for (int i = 2; i < 16; i++) j_add(&tbl[i], &tbl[i - 1], p);
    jpt acc = JINF;
    int top = ((bits + 3) / 4) * 4 - 4;
    int started = 0;
    for (int shift = top; shift >= 0; shift -= 4) {
        if (started) { j_dbl(&acc, &acc); j_dbl(&acc, &acc); j_dbl(&acc, &acc); j_dbl(&acc, &acc); }
        int limb = shift / 64, off = shift % 64;
        u64 w = (k[limb] >> off);
        if (off > 60 && limb < 3) w |= k[limb + 1] << (64 - off);
        w &= 0xF;
        if (w) { j_add(&acc, &acc, &tbl[w]); started = 1; }
    }
    *r = acc;
}

static void j_to_affine(const jpt *p, fp *x, fp *y, int *inf) {
    if (j_is_inf(p)) { *inf = 1; memset(x, 0, sizeof(fp)); memset(y, 0, sizeof(fp)); return; }
    *inf = 0;
    fp zi, zi2;
    fp_inv(&zi, &p->z);
    fp_sqr(&zi2, &zi);
    fp_mul(x, &p->x, &zi2);
    fp_mul(y, &p->y, &zi2);
    fp_mul(y, y, &zi);
}

/* ------------------------------------------------- byte-level helpers */

static void load_affine(jpt *p, const uint8_t *xy96, uint8_t inf) {
    if (inf) { *p = JINF; return; }
    fp_from_be(&p->x, xy96);
    fp_from_be(&p->y, xy96 + 48);
    p->z = FP_ONE;
}

static void store_affine(uint8_t *xy96, uint8_t *inf, const jpt *p) {
    fp x, y;
    int isinf;
    j_to_affine(p, &x, &y, &isinf);
    *inf = (uint8_t)isinf;
    if (isinf) { memset(xy96, 0, 96); return; }
    fp_to_be(xy96, &x);
    fp_to_be(xy96 + 48, &y);
}

/* --------------------------------------------------------------- MSM */

/* window size minimizing W(c)*(n + 2*2^c) for nbits-wide scalars */
static int msm_window_bits(size_t n, int nbits) {
    int best_c = 4;
    double best = 1e30;
    for (int c = 2; c <= 16; c++) {
        double W = (double)((nbits + c - 1) / c);
        double cost = W * ((double)n + 2.0 * (double)((size_t)1 << c));
        if (cost < best) { best = cost; best_c = c; }
    }
    return best_c;
}

/* Pippenger over preloaded Jacobian points; scalars have `slimbs` 64-bit
 * limbs each and at most `nbits` significant bits. */
static void msm_jpts_w(jpt *out, const jpt *pts, const u64 *scalars,
                       size_t n, int slimbs, int nbits) {
    if (n == 0) { *out = JINF; return; }
    int c = msm_window_bits(n, nbits);
    int W = (nbits + c - 1) / c;
    size_t B = (size_t)1 << c;
    jpt *wins = (jpt *)malloc((size_t)W * sizeof(jpt));
    /* windows are independent until the final Horner combine — OpenMP
     * across them (the merged MSM of K-proof batched verification is a
     * single large host MSM on CPU backends) */
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) if (n >= 4096)
#endif
    for (int w = 0; w < W; w++) {
        jpt *buckets = (jpt *)malloc(B * sizeof(jpt));
        for (size_t t = 0; t < B; t++) buckets[t] = JINF;
        int bit0 = w * c;
        for (size_t i = 0; i < n; i++) {
            int limb = bit0 / 64, off = bit0 % 64;
            u64 d = scalars[slimbs * i + limb] >> off;
            if (off + c > 64 && limb < slimbs - 1)
                d |= scalars[slimbs * i + limb + 1] << (64 - off);
            d &= (B - 1);
            if (d) j_add(&buckets[d], &buckets[d], &pts[i]);
        }
        /* triangle sum: sum_t t * bucket_t */
        jpt run = JINF, tot = JINF;
        for (size_t t = B - 1; t >= 1; t--) {
            j_add(&run, &run, &buckets[t]);
            j_add(&tot, &tot, &run);
        }
        wins[w] = tot;
        free(buckets);
    }
    jpt acc = JINF;
    for (int w = W - 1; w >= 0; w--) {
        if (!j_is_inf(&acc))
            for (int b = 0; b < c; b++) j_dbl(&acc, &acc);
        j_add(&acc, &acc, &wins[w]);
    }
    free(wins);
    *out = acc;
}

/* Full-width MSM: GLV-split every (point, scalar) pair into
 * (+-P, |k1|) and (phi(P), k2), then one 132-bit Pippenger over 2n pairs
 * — halves the window count for the same bucket cost. */
static void msm_jpts(jpt *out, const jpt *pts, const u64 *scalars, size_t n) {
    if (n == 0) { *out = JINF; return; }
    if (n == 1) {
        int neg1;
        u64 k1[3], k2[3];
        glv_decompose(scalars, &neg1, k1, k2);
        j_mul_glv(out, &pts[0], neg1, k1, k2);
        return;
    }
    jpt *pts2 = (jpt *)malloc(2 * n * sizeof(jpt));
    u64 *sc2 = (u64 *)malloc(2 * n * 3 * sizeof(u64));
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 4096)
#endif
    for (size_t i = 0; i < n; i++) {
        int neg1;
        glv_decompose(&scalars[4 * i], &neg1, &sc2[6 * i], &sc2[6 * i + 3]);
        if (neg1) j_neg(&pts2[2 * i], &pts[i]);
        else pts2[2 * i] = pts[i];
        if (j_is_inf(&pts[i])) pts2[2 * i + 1] = JINF;
        else j_phi(&pts2[2 * i + 1], &pts[i]);
    }
    msm_jpts_w(out, pts2, sc2, 2 * n, 3, 132);
    free(pts2);
    free(sc2);
}

/* ------------------------------------------------------- C interface */

/* out = sum_i s_i * P_i over n points (pts96, inf) and scalars (sc32) */
int curdle_g1_msm(const uint8_t *pts96, const uint8_t *inf, const uint8_t *sc32,
                  int64_t n, uint8_t *out96, uint8_t *out_inf) {
    if (n < 0) return 1;
    jpt *pts = (jpt *)malloc(n > 0 ? (size_t)n * sizeof(jpt) : 1);
    u64 *scs = (u64 *)malloc(n > 0 ? (size_t)n * 32 : 1);
    if (!pts || !scs) { free(pts); free(scs); return 1; }
    for (int64_t i = 0; i < n; i++) {
        load_affine(&pts[i], pts96 + 96 * i, inf[i]);
        load_scalar(&scs[4 * i], sc32 + 32 * i);
    }
    jpt out;
    msm_jpts(&out, pts, scs, (size_t)n);
    free(pts); free(scs);
    store_affine(out96, out_inf, &out);
    return 0;
}

/* out[i] = s_i * P_i */
int curdle_g1_mul_batch(const uint8_t *pts96, const uint8_t *inf, const uint8_t *sc32,
                        int64_t n, uint8_t *out96, uint8_t *out_inf) {
    for (int64_t i = 0; i < n; i++) {
        jpt p, r;
        u64 k[4], k1[3], k2[3];
        int neg1;
        load_affine(&p, pts96 + 96 * i, inf[i]);
        load_scalar(k, sc32 + 32 * i);
        glv_decompose(k, &neg1, k1, k2);
        j_mul_glv(&r, &p, neg1, k1, k2);
        store_affine(out96 + 96 * i, &out_inf[i], &r);
    }
    return 0;
}

/* out[i] = A_i + B_i */
int curdle_g1_add_batch(const uint8_t *a96, const uint8_t *ainf, const uint8_t *b96,
                        const uint8_t *binf, int64_t n, uint8_t *out96, uint8_t *out_inf) {
    for (int64_t i = 0; i < n; i++) {
        jpt p, q, r;
        load_affine(&p, a96 + 96 * i, ainf[i]);
        load_affine(&q, b96 + 96 * i, binf[i]);
        j_add(&r, &p, &q);
        store_affine(out96 + 96 * i, &out_inf[i], &r);
    }
    return 0;
}

/* out = sum_i P_i */
int curdle_g1_sum(const uint8_t *pts96, const uint8_t *inf, int64_t n, uint8_t *out96,
                  uint8_t *out_inf) {
    jpt acc = JINF;
    for (int64_t i = 0; i < n; i++) {
        jpt p;
        load_affine(&p, pts96 + 96 * i, inf[i]);
        j_add(&acc, &acc, &p);
    }
    store_affine(out96, out_inf, &acc);
    return 0;
}

/* 48-byte compressed encodings of n affine points */
int curdle_g1_compress_batch(const uint8_t *pts96, const uint8_t *inf, int64_t n,
                             uint8_t *out48) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t *d = out48 + 48 * i;
        if (inf[i]) {
            memset(d, 0, 48);
            d[0] = 0xC0;
            continue;
        }
        memcpy(d, pts96 + 96 * i, 48); /* x is already canonical BE */
        d[0] |= 0x80;
        fp y;
        fp_from_be(&y, pts96 + 96 * i + 48);
        if (fp_is_lex_largest(&y)) d[0] |= 0x20;
    }
    return 0;
}

/* n compressed encodings -> affine points; with check, each also in the
 * prime-order subgroup. Stops at the first bad encoding i and returns
 * -(1 + i): not compressed, a malformed infinity, x not canonical, x not on
 * the curve, or (check) outside the subgroup. */
int curdle_g1_decompress_batch(const uint8_t *comp48, int64_t n, int check, uint8_t *out96,
                               uint8_t *out_inf) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *d = comp48 + 48 * i;
        uint8_t flags = d[0];
        if (!(flags & 0x80)) return (int)(-1 - i);
        if (flags & 0x40) {
            int nz = (flags & 0x3F) != 0;
            for (int k = 1; k < 48; k++) nz |= d[k] != 0;
            if (nz) return (int)(-1 - i);
            memset(out96 + 96 * i, 0, 96);
            out_inf[i] = 1;
            continue;
        }
        uint8_t xbe[48];
        memcpy(xbe, d, 48);
        xbe[0] &= 0x1F;
        /* canonical range check: x < p */
        u64 xl[6];
        for (int t = 0; t < 6; t++) {
            u64 v = 0;
            const uint8_t *q = xbe + 48 - 8 * (t + 1);
            for (int k = 0; k < 8; k++) v = (v << 8) | q[k];
            xl[t] = v;
        }
        if (fp_geq(xl, FP_P.l)) return (int)(-1 - i);
        fp x, x3b, y;
        fp_from_be(&x, xbe);
        fp_sqr(&x3b, &x);
        fp_mul(&x3b, &x3b, &x);
        /* + b = 4 */
        fp four;
        fp_dbl(&four, &FP_ONE);
        fp_dbl(&four, &four);
        fp_add(&x3b, &x3b, &four);
        if (!fp_sqrt(&y, &x3b)) return (int)(-1 - i);
        int largest = fp_is_lex_largest(&y);
        if (((flags >> 5) & 1) != largest) fp_neg(&y, &y);
        if (check) {
            jpt p = {x, y, FP_ONE}, r;
            j_mul(&r, &p, FR_ORDER);
            if (!j_is_inf(&r)) return (int)(-1 - i);
        }
        fp_to_be(out96 + 96 * i, &x);
        fp_to_be(out96 + 96 * i + 48, &y);
        out_inf[i] = 0;
    }
    return 0;
}

/* n Jacobian points (X || Y || Z, each 48-byte big-endian canonical) ->
 * affine points */
int curdle_g1_jacobian_to_affine_batch(const uint8_t *xyz144, int64_t n, uint8_t *out96,
                                       uint8_t *out_inf) {
    for (int64_t i = 0; i < n; i++) {
        jpt p;
        fp_from_be(&p.x, xyz144 + 144 * i);
        fp_from_be(&p.y, xyz144 + 144 * i + 48);
        fp_from_be(&p.z, xyz144 + 144 * i + 96);
        store_affine(out96 + 96 * i, &out_inf[i], &p);
    }
    return 0;
}

/* 0 when r * P_i is the identity for every i, else -(1 + the first i
 * where it is not) */
int curdle_g1_subgroup_check_batch(const uint8_t *pts96, const uint8_t *inf, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        jpt p, r;
        load_affine(&p, pts96 + 96 * i, inf[i]);
        if (j_is_inf(&p)) continue;
        j_mul(&r, &p, FR_ORDER);
        if (!j_is_inf(&r)) return (int)(-1 - i);
    }
    return 0;
}
