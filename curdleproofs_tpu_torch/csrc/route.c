/* Benes/Hall 3-stage permutation routing (host side of the routed gather),
 * with a plain C interface.
 *
 * Built with host_prep.c into one shared library by the machine's C compiler
 * at first use and loaded with ctypes (utils/host_native.py): no Python.h,
 * the caller allocates the three output tables. ctypes drops the interpreter
 * lock for the length of a call, so solves of different windows run side by
 * side on a thread pool (ops/msm.py).
 *
 * Writing the n positions as an (r x c) matrix (n = r*c), Hall's theorem
 * gives every permutation a 3-stage factorization
 *
 *     within-rows  o  within-columns  o  within-rows
 *
 * so a permutation gather becomes three row-local gathers with table widths
 * c, r, c (ops/gather.py::routed_gather is the device half).
 *
 * The routing itself: build the bipartite multigraph with an edge
 * (source row -> destination row) per element; it is c-regular, so it
 * splits into c perfect matchings (Koenig).  color(e) = matching index,
 * computed by recursive Euler splitting: walk Euler circuits assigning
 * alternate edges to the two halves (even circuits, since the graph is
 * bipartite), halving the regular degree per level - O(n log c) total.
 * Element e then routes (row_s, col_s) -> (row_s, color) -> (row_d, color)
 * -> (row_d, col_d), each hop inside one row/column.
 *
 * Implementation notes:
 *   * The circuit walk is a pointer chase: one or two random cache accesses
 *     per edge visit.  The recursion therefore runs BREADTH-FIRST and walks
 *     up to ILV independent circuits (different groups of one window) in
 *     LOCKSTEP from one thread, so several misses are outstanding at once.
 *     Level 0 of a window has only one group (no interleave).
 *   * Each circuit step is ONE fused load: u64 eid|twin for big groups,
 *     u32 for groups with m <= 32768.
 *   * The per-level stable partition ping-pongs between two (grp, uv)
 *     buffer pairs instead of copying back; frame regions are disjoint
 *     [off, off+m) slices of per-window arrays, so all frames of a level
 *     coexist.
 *   * uv packs row_s | row_d << 16, so r <= 65535.
 *
 * See ops/route.py for the exact gather semantics and the pure-Python twin
 * that the tests hold this against.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ILV 8 /* interleaved circuit walkers per thread */

typedef struct { /* per-window state */
    int32_t *row_s, *col_s, *color;
    int32_t *grp[2]; /* ping-pong: original edge id per group slot */
    int32_t *uv[2];  /* ping-pong: row_s | (row_d << 16) per slot */
    uint8_t *ub;     /* bit1 = used, bit0 = parity (frame-local + off) */
    int32_t *firstpos;
    uint64_t *pair64; /* 2 half-edge slots per edge; frames use the
                         disjoint region [2*off, 2*(off+m)) (u64 view) or
                         [4*off, 4*off + 2m) (u32 view, small frames) */
} wwin;

typedef struct {
    int32_t win, off, m, base;
} bframe;

typedef struct {
    int alive, narrow;
    uint64_t *P64;
    uint32_t *P32;
    uint8_t *ub;
    int32_t *firstpos;
    int32_t m, i0;
    uint32_t p, p0;
    uint8_t parity;
} walker;

/* Build one frame's CSR twin-chain arrays (sequential, streaming).
 * start/cur are shared scratch of 2r+1 / 2r int32. */
static void frame_build(wwin *W, const bframe *f, int32_t r, int buf,
                        int32_t *start, int32_t *cur) {
    const int32_t *uv = W->uv[buf] + f->off;
    const int32_t m = f->m;
    const int32_t nn = 2 * r;
    uint8_t *ub = W->ub + f->off;
    int32_t *fp = W->firstpos + f->off;
    memset(start, 0, (size_t)(nn + 1) * sizeof(int32_t));
    for (int32_t i = 0; i < m; i++) {
        int32_t p = uv[i];
        start[(p & 0xFFFF) + 1]++;
        start[r + (p >> 16) + 1]++;
    }
    for (int32_t i = 0; i < nn; i++) start[i + 1] += start[i];
    memcpy(cur, start, (size_t)nn * sizeof(int32_t));
    if (m <= 32768) { /* u32 fused pairs: position and eid fit 16 bits */
        uint32_t *P = (uint32_t *)W->pair64 + 4 * (size_t)f->off;
        for (int32_t i = 0; i < m; i++) {
            int32_t p = uv[i];
            int32_t u = p & 0xFFFF;
            int32_t v = r + (p >> 16);
            int32_t pu = cur[u]++, pv = cur[v]++;
            P[pu] = (uint32_t)i | ((uint32_t)pv << 16);
            P[pv] = (uint32_t)i | ((uint32_t)pu << 16);
            fp[i] = pu;
            ub[i] = 0;
        }
    } else {
        uint64_t *P = W->pair64 + 2 * (size_t)f->off;
        for (int32_t i = 0; i < m; i++) {
            int32_t p = uv[i];
            int32_t u = p & 0xFFFF;
            int32_t v = r + (p >> 16);
            int32_t pu = cur[u]++, pv = cur[v]++;
            P[pu] = (uint64_t)(uint32_t)i | ((uint64_t)(uint32_t)pv << 32);
            P[pv] = (uint64_t)(uint32_t)i | ((uint64_t)(uint32_t)pu << 32);
            fp[i] = pu;
            ub[i] = 0;
        }
    }
}

static void walker_bind(walker *wk, wwin *W, const bframe *f) {
    wk->narrow = f->m <= 32768;
    wk->P64 = W->pair64 + 2 * (size_t)f->off;
    wk->P32 = (uint32_t *)W->pair64 + 4 * (size_t)f->off;
    wk->ub = W->ub + f->off;
    wk->firstpos = W->firstpos + f->off;
    wk->m = f->m;
    wk->i0 = 0;
    wk->alive = f->m > 0;
    if (wk->alive) {
        wk->p0 = wk->p = (uint32_t)wk->firstpos[0];
        wk->parity = 0;
    }
}

/* One circuit step: cross the current half-edge's twin and leave through
 * its pair partner (^1: node half-edge lists start even — every degree is
 * even at every level — so consecutive position pairs stay in one node).
 * Each circuit is traversed once; the used bit set along it suppresses
 * the reverse direction. */
static inline void walker_step(walker *wk) {
    uint32_t e, tw;
    if (wk->narrow) {
        uint32_t pe = wk->P32[wk->p];
        e = pe & 0xFFFF;
        tw = pe >> 16;
    } else {
        uint64_t pe = wk->P64[wk->p];
        e = (uint32_t)pe;
        tw = (uint32_t)(pe >> 32);
    }
    wk->ub[e] = (uint8_t)(2 | wk->parity);
    wk->parity ^= 1;
    wk->p = tw ^ 1;
    if (wk->p == wk->p0) { /* circuit closed: start the next one */
        int32_t i = wk->i0;
        const int32_t m = wk->m;
        while (i < m && (wk->ub[i] & 2)) i++;
        wk->i0 = i;
        if (i >= m) {
            wk->alive = 0;
            return;
        }
        wk->p0 = wk->p = (uint32_t)wk->firstpos[i];
        wk->parity = 0;
    }
}

/* Color all windows' edges with c colors (distinct within every source
 * row and every dest row), walking up to ILV groups in lockstep. */
static int color_edges_batch(wwin *wins, int nw, int32_t n, int32_t r,
                             int32_t c, int32_t cshift) {
    for (int w = 0; w < nw; w++) {
        wwin *W = &wins[w];
        for (int32_t e = 0; e < n; e++) {
            W->grp[0][e] = e;
            W->uv[0][e] = W->row_s[e] | ((e >> cshift) << 16);
        }
        if (c == 1) memset(W->color, 0, (size_t)n * sizeof(int32_t));
    }
    if (c == 1) return 0;

    int levels = 0;
    for (int32_t k = c; k > 1; k >>= 1) levels++;
    size_t maxframes = (size_t)nw * (size_t)(c > 1 ? c : 1);
    bframe *cur_f = malloc(maxframes * sizeof(bframe));
    bframe *next_f = malloc(maxframes * sizeof(bframe));
    int32_t *start = malloc((size_t)(2 * r + 1) * sizeof(int32_t));
    int32_t *curs = malloc((size_t)(2 * r) * sizeof(int32_t));
    if (!cur_f || !next_f || !start || !curs) {
        free(cur_f);
        free(next_f);
        free(start);
        free(curs);
        return -1;
    }
    size_t nf = 0;
    for (int w = 0; w < nw; w++)
        cur_f[nf++] = (bframe){w, 0, n, 0};

    int32_t k = c;
    int buf = 0;
    for (int lvl = 0; lvl < levels; lvl++, k >>= 1, buf ^= 1) {
        /* phase A: sequential CSR builds (streaming, bandwidth-bound) */
        for (size_t i = 0; i < nf; i++)
            frame_build(&wins[cur_f[i].win], &cur_f[i], r, buf, start, curs);
        /* phase B: interleaved circuit walks (latency-bound).  Round-robin
         * one step per live walker per sweep; a walker that finishes its
         * frame rebinds to the next pending frame.  Exits when a full
         * sweep performs no step (all walkers dead, no frames left). */
        {
            walker wks[ILV];
            size_t next = 0;
            int nb = (int)(nf < ILV ? nf : ILV);
            for (int i = 0; i < nb; i++)
                walker_bind(&wks[i], &wins[cur_f[next].win], &cur_f[next]),
                    next++;
            int done = nb == 0;
            while (!done) {
                done = 1;
                for (int i = 0; i < nb; i++) {
                    if (!wks[i].alive) {
                        if (next < nf) {
                            walker_bind(&wks[i], &wins[cur_f[next].win],
                                        &cur_f[next]);
                            next++;
                        }
                        if (!wks[i].alive) continue;
                    }
                    walker_step(&wks[i]);
                    done = 0;
                }
            }
        }
        /* phase C: stable partitions + next level's frames; at the LAST
         * level the color is just base + parity, so the partition passes
         * are skipped entirely */
        size_t nnf = 0;
        int32_t k2 = k / 2;
        for (size_t i = 0; i < nf; i++) {
            bframe *f = &cur_f[i];
            wwin *W = &wins[f->win];
            const uint8_t *ub = W->ub + f->off;
            int32_t *grp = W->grp[buf], *uv = W->uv[buf];
            if (k2 == 1) {
                for (int32_t j = 0; j < f->m; j++)
                    W->color[grp[f->off + j]] = f->base + (ub[j] & 1);
                continue;
            }
            int32_t *ogrp = W->grp[buf ^ 1], *ouv = W->uv[buf ^ 1];
            int32_t lo = f->off, hi;
            for (int32_t j = 0; j < f->m; j++)
                if (!(ub[j] & 1)) {
                    ogrp[lo] = grp[f->off + j];
                    ouv[lo++] = uv[f->off + j];
                }
            hi = lo;
            for (int32_t j = 0; j < f->m; j++)
                if (ub[j] & 1) {
                    ogrp[hi] = grp[f->off + j];
                    ouv[hi++] = uv[f->off + j];
                }
            int32_t mlo = lo - f->off;
            next_f[nnf++] = (bframe){f->win, f->off, mlo, f->base};
            next_f[nnf++] = (bframe){f->win, lo, f->m - mlo, f->base + k2};
        }
        bframe *tmp = cur_f;
        cur_f = next_f;
        next_f = tmp;
        nf = nnf;
    }
    free(cur_f);
    free(next_f);
    free(start);
    free(curs);
    return 0;
}

static int is_pow2(int32_t v) { return v > 0 && (v & (v - 1)) == 0; }

static void wwin_free(wwin *Wn) {
    free(Wn->row_s);
    free(Wn->col_s);
    free(Wn->color);
    free(Wn->grp[0]);
    free(Wn->grp[1]);
    free(Wn->uv[0]);
    free(Wn->uv[1]);
    free(Wn->ub);
    free(Wn->firstpos);
    free(Wn->pair64);
}

/* Route W permutations of n = r*c elements.
 * src[w*n + d] = source position of the element that must end at d.
 * idx1 (W, r, c), idx2 (W, c, r), idx3 (W, r, c) int32, caller-allocated,
 * with, per window:
 *   stage1[a][j]  = in  [a*c + idx1[a*c + j]]        (within source rows)
 *   stage2[j][a2] = st1 [idx2[j*r + a2] ... col j]   (within columns)
 *   stage3[a2][b] = st2 [a2 ... col idx3[a2*c + b]]  (within dest rows)
 * so that stage3[a2][b] = in[src[a2*c + b]].
 * Returns 0, -1 on bad arguments (c not a power of two, r outside
 * [1, 65535], n over 2^31, W < 1, src not within [0, n)), -2 when out of
 * memory. */
int curdle_route_decompose(int r, int c, int W, const int32_t *src, int32_t *idx1,
                           int32_t *idx2, int32_t *idx3) {
    if (!is_pow2(c) || r <= 0 || r > 65535 || W <= 0) return -1;
    if ((int64_t)r * c > 0x7fffffff) return -1;
    const int32_t n = (int32_t)((int64_t)r * c);
    int32_t cshift = 0;
    for (int32_t cc = c; cc > 1; cc >>= 1) cshift++;
    for (int64_t i = 0; i < (int64_t)W * n; i++)
        if (src[i] < 0 || src[i] >= n) return -1;

    /* one window at a time: a window's frames at any level total n edges
     * regardless of depth, so the interleave within a window adds
     * memory-level parallelism without growing the working set */
    wwin Wn;
    memset(&Wn, 0, sizeof(Wn));
    Wn.row_s = malloc((size_t)n * sizeof(int32_t));
    Wn.col_s = malloc((size_t)n * sizeof(int32_t));
    Wn.color = malloc((size_t)n * sizeof(int32_t));
    Wn.grp[0] = malloc((size_t)n * sizeof(int32_t));
    Wn.grp[1] = malloc((size_t)n * sizeof(int32_t));
    Wn.uv[0] = malloc((size_t)n * sizeof(int32_t));
    Wn.uv[1] = malloc((size_t)n * sizeof(int32_t));
    Wn.ub = malloc((size_t)n);
    Wn.firstpos = malloc((size_t)n * sizeof(int32_t));
    Wn.pair64 = malloc((size_t)(2 * (int64_t)n) * sizeof(uint64_t));
    int oom = !Wn.row_s || !Wn.col_s || !Wn.color || !Wn.grp[0] || !Wn.grp[1] ||
              !Wn.uv[0] || !Wn.uv[1] || !Wn.ub || !Wn.firstpos || !Wn.pair64;
    for (int w = 0; w < W && !oom; w++) {
        const int32_t *s = src + (size_t)w * n;
        for (int32_t d = 0; d < n; d++) {
            Wn.row_s[d] = s[d] >> cshift;
            Wn.col_s[d] = s[d] & (c - 1);
        }
        if (color_edges_batch(&Wn, 1, n, r, c, cshift) != 0) {
            oom = 1;
            break;
        }
        int32_t *w1 = idx1 + (size_t)w * n, *w2 = idx2 + (size_t)w * n,
                *w3 = idx3 + (size_t)w * n;
        for (int32_t d = 0; d < n; d++) {
            int32_t col = Wn.color[d];
            int32_t a = Wn.row_s[d], a2 = d >> cshift, b = d & (c - 1);
            w1[(size_t)a * c + col] = Wn.col_s[d];
            w2[(size_t)col * r + a2] = a;
            w3[(size_t)a2 * c + b] = col;
        }
    }
    wwin_free(&Wn);
    return oom ? -2 : 0;
}
