/* Native host prep of the streaming Pippenger MSM, with a plain C interface.
 *
 * Built with the machine's C compiler at first use
 *   cc -O3 -fPIC -shared -fopenmp -o libcurdle_host.so host_prep.c route.c
 * and loaded with ctypes (utils/host_native.py): no Python.h, the caller
 * allocates every output as a numpy array and passes pointers. ctypes drops
 * the interpreter lock for the length of a call.
 *
 * Two entry points:
 *   curdle_glv_decompose_batch  the Babai-rounding GLV split of ops/glv.py
 *   curdle_msm_prep_batch       one call for the numpy chain glv.decompose ->
 *                               host_digits -> stream_host_prep -> _build_sel
 *                               of ops/msm.py: GLV split, c-bit digits over
 *                               the doubled [|k1| | k2] lane set, per-window
 *                               stable counting sort with the bucket-boundary
 *                               ranks read off the count prefix, column-major
 *                               relabel for the scan layout, and the
 *                               distinct-rank boundary-selection schedule.
 * Both give the arrays of the numpy chain bit for bit (stable sorts of equal
 * keys); the tests hold one against the other.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#ifdef _OPENMP
#include <omp.h>
#endif

#include "glv_host.h"

/* scalars split a block at a time before their digits are stored */
#define DIG_BLOCK 256

/* digit w (c bits) of a 3x64-limb little-endian value */
static inline uint32_t digit_at(const u64 *k, int w, int c) {
    int b0 = w * c;
    int limb = b0 >> 6, off = b0 & 63;
    u64 v = k[limb] >> off;
    if (off + c > 64 && limb + 1 < 3) v |= k[limb + 1] << (64 - off);
    return (uint32_t)(v & ((1u << c) - 1));
}

/* OpenMP threads a parallel region would get; 0 when built without OpenMP. */
int curdle_host_openmp_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 0;
#endif
}

/* scalars32_le: n canonical scalars of 32 little-endian bytes each.
 * k1_out, k2_out: 3 little-endian 64-bit limbs per scalar; neg_out: n bytes. */
int curdle_glv_decompose_batch(const uint8_t *scalars32_le, int64_t n, uint64_t *k1_out,
                               uint8_t *neg_out, uint64_t *k2_out) {
    if (n < 0) return -1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 4096)
#endif
    for (int64_t i = 0; i < n; i++) {
        u64 k[4];
        int neg;
        load_scalar(k, scalars32_le + 32 * i);
        glv_decompose(k, &neg, k1_out + 3 * i, k2_out + 3 * i);
        neg_out[i] = (uint8_t)neg;
    }
    return 0;
}

/* The streaming-MSM host prep over n scalars (2n GLV lanes), window bits c,
 * L scan lanes (L divides 2n; T = 2n / L steps), W = ceil(130 / c) windows,
 * B = 2^c buckets.
 *
 *   neg_out   (n,)        u8   sign of k1
 *   order_cm  (W, 2n)     i32  digit-sort order, column-major: flat position
 *                              t*L + l holds sorted rank l*T + t
 *   bidx      (W, B-1)    i32  flat position of each bucket-boundary prefix,
 *                              -1 for an empty prefix
 *   lidx      (W, B-1)    i32  lane(e) - 1, -1 where lane(e) == 0 or empty
 *   slot_options          the selection-slot capacities to try, ascending
 *   sel       capacity W*T*max(slot_options); the first W*T*S entries are the
 *                              (W*T, S) lane ids, -1 = empty slot
 *   bpos      (W, B-1)    i32  t*S + slot into the window's selected table
 *   S_out                 the smallest option that fits every (window, step),
 *                              0 when none does (sel and bpos then unwritten)
 *
 * Returns 0, -1 on bad arguments, -2 when out of memory. */
int curdle_msm_prep_batch(const uint8_t *scalars32_le, int64_t n_in, int c, int L,
                          const int32_t *slot_options, int n_options, uint8_t *neg_out,
                          int32_t *order_cm, int32_t *bidx, int32_t *lidx, int32_t *sel,
                          int32_t *bpos, int32_t *S_out) {
    if (n_in <= 0 || c < 1 || c > 16 || L <= 0 || n_options < 0) return -1;
    const size_t n = (size_t)n_in, n2 = 2 * n;
    if (n2 % (size_t)L || n2 > 0x7fffffffu) return -1;
    const int W = (130 + c - 1) / c;
    const int B = 1 << c;
    const size_t T = n2 / (size_t)L;

    uint16_t *dig = (uint16_t *)malloc(2 * (size_t)W * n2);
    int32_t *earr = (int32_t *)malloc(4 * (size_t)W * (B - 1) + 4);
    int32_t *slotc = (int32_t *)malloc(4 * T);
    if (!dig || !earr || !slotc) {
        free(dig); free(earr); free(slotc);
        return -2;
    }
    int32_t maxocc = 0;
    int oom = 0;

    /* the split a block of DIG_BLOCK scalars at a time, then the block's
     * digits window by window, so each window's row is written in runs:
     * rows n2 apart share cache sets */
    const size_t nblocks = (n + DIG_BLOCK - 1) / DIG_BLOCK;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t blk = 0; blk < nblocks; blk++) {
        u64 k1[DIG_BLOCK][3], k2[DIG_BLOCK][3];
        const size_t i0 = blk * DIG_BLOCK;
        const size_t m = n - i0 < DIG_BLOCK ? n - i0 : DIG_BLOCK;
        for (size_t j = 0; j < m; j++) {
            u64 k[4];
            int neg;
            load_scalar(k, scalars32_le + 32 * (i0 + j));
            glv_decompose(k, &neg, k1[j], k2[j]);
            neg_out[i0 + j] = (uint8_t)neg;
        }
        for (int w = 0; w < W; w++) {
            uint16_t *d1 = dig + (size_t)w * n2 + i0, *d2 = d1 + n;
            for (size_t j = 0; j < m; j++) {
                d1[j] = (uint16_t)digit_at(k1[j], w, c);
                d2[j] = (uint16_t)digit_at(k2[j], w, c);
            }
        }
    }
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        /* per-thread scratch (windows are independent) */
        int32_t *cnt_t = (int32_t *)malloc(4 * (size_t)B);
        int32_t *incl_t = (int32_t *)malloc(4 * (size_t)B);
        int32_t *slotc_t = (int32_t *)malloc(4 * T);
        const int ok = cnt_t && incl_t && slotc_t;
        if (!ok) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
            oom = 1;
        }
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int w = 0; w < W; w++) {
            if (!ok) continue;
            const uint16_t *dw = dig + (size_t)w * n2;
            memset(cnt_t, 0, 4 * (size_t)B);
            for (size_t i = 0; i < n2; i++) cnt_t[dw[i]]++;
            int32_t run = 0;
            for (int b = 0; b < B; b++) {
                int32_t cb = cnt_t[b];
                cnt_t[b] = run; /* exclusive prefix: placement cursor */
                run += cb;
                incl_t[b] = run;
            }
            /* stable counting-sort placement, straight into the column-major
             * layout: sorted rank r lands at flat position (r % T) * L + r / T */
            int32_t *oc = order_cm + (size_t)w * n2;
            for (size_t i = 0; i < n2; i++) {
                const size_t r = (size_t)cnt_t[dw[i]]++;
                oc[(r % T) * (size_t)L + r / T] = (int32_t)i;
            }
            /* bucket-boundary ranks + full-prefix index tables */
            int32_t *ew = earr + (size_t)w * (B - 1);
            int32_t *bw = bidx + (size_t)w * (B - 1);
            int32_t *lw = lidx + (size_t)w * (B - 1);
            for (int t = 0; t < B - 1; t++) {
                int32_t e = incl_t[t] - 1;
                ew[t] = e;
                if (e >= 0) {
                    int32_t te = e % (int32_t)T, le = e / (int32_t)T;
                    bw[t] = te * L + le;
                    lw[t] = le > 0 ? le - 1 : -1;
                } else {
                    bw[t] = -1;
                    lw[t] = -1;
                }
            }
            /* boundary-selection occupancy pre-pass (distinct ranks/step) */
            memset(slotc_t, 0, 4 * T);
            int32_t prev = -1, mo = 0;
            for (int t = 0; t < B - 1; t++) {
                int32_t e = ew[t];
                if (e >= 0 && e != prev) {
                    int32_t occ = ++slotc_t[e % (int32_t)T];
                    if (occ > mo) mo = occ;
                    prev = e;
                }
            }
#ifdef _OPENMP
#pragma omp critical
#endif
            if (mo > maxocc) maxocc = mo;
        }
        free(cnt_t); free(incl_t); free(slotc_t);
    }
    if (oom) {
        free(dig); free(earr); free(slotc);
        return -2;
    }

    /* the smallest selection-slot capacity that fits (0 = overflow: the
     * caller takes the full-prefix path through bidx / lidx) */
    int S = 0;
    for (int i = 0; i < n_options; i++)
        if (maxocc <= slot_options[i]) { S = slot_options[i]; break; }
    *S_out = S;
    if (S) {
        memset(sel, 0xFF, 4 * (size_t)W * T * S); /* -1 = empty slot */
        for (int w = 0; w < W; w++) {
            const int32_t *ew = earr + (size_t)w * (B - 1);
            int32_t *bw = bpos + (size_t)w * (B - 1);
            int32_t *sw = sel + (size_t)w * T * S;
            memset(slotc, 0, 4 * T);
            int32_t prev = -1, prevpos = -1;
            for (int t = 0; t < B - 1; t++) {
                int32_t e = ew[t];
                if (e < 0) {
                    bw[t] = -1;
                } else {
                    if (e != prev) {
                        int32_t ut = e % (int32_t)T;
                        int32_t slot = slotc[ut]++;
                        sw[(size_t)ut * S + slot] = e / (int32_t)T;
                        prevpos = ut * S + slot;
                        prev = e;
                    }
                    bw[t] = prevpos;
                }
            }
        }
    }
    free(dig); free(earr); free(slotc);
    return 0;
}
