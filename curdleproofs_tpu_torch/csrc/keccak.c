/* Keccak-f[1600], the STROBE-128 duplex (the subset Merlin uses) and the
 * Merlin transcript framing of curdleproofs_tpu_torch, with a plain C
 * interface: the native twin of transcript/keccak.py, transcript/strobe.py
 * and transcript/oracle.py, bit for bit (the Rust merlin crate's
 * conformance vectors pin both).
 *
 * Built into the host library with g1_host.c at first use and loaded with
 * ctypes (utils/host_native.py). The duplex state is a writable 203-byte
 * buffer owned by the caller:
 *   [0:200] keccak state | [200] pos | [201] pos_begin | [202] cur_flags
 * One C call per logical Merlin operation, or per batch (write_many,
 * challenge_scalars): transcript replay is the largest per-proof host cost
 * of batched verification once the MSMs are merged. Every entry point
 * returns 0, or a positive STROBE_E* code.
 */
#include <stdint.h>
#include <string.h>

#define ROTL64(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* rho rotation offsets and pi lane sources for the flat i = x + 5y layout */
static const int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

static void keccakf(uint64_t a[25]) {
  uint64_t b[25], c[5], d[5];
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTL64(c[(x + 1) % 5], 1);
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    /* rho + pi: B[y][(2x+3y)%5] = rot(A[x][y]) */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        int r = RHO[5 * y + x];
        b[dst] = r ? ROTL64(a[src], r) : a[src];
      }
    /* chi */
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    /* iota */
    a[0] ^= RC[round];
  }
}

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A 2
#define FLAG_C 4
#define FLAG_T 8
#define FLAG_M 16
#define FLAG_K 32

/* error codes; the Python side raises the ValueError of strobe.py */
#define STROBE_EFLAGS 1     /* continuation with mismatched flags */
#define STROBE_ETRANSPORT 2 /* transport flags not supported */
#define STROBE_EOPCODE 3    /* no such operation */
#define STROBE_EARG 4       /* bad length */

typedef struct {
    uint8_t *st;   /* 200-byte keccak state */
    uint8_t *pos;  /* &buf[200] */
    uint8_t *posb; /* &buf[201] */
    uint8_t *flg;  /* &buf[202] */
} strobe;

static strobe strobe_bind(uint8_t *b) {
    strobe s = {b, b + 200, b + 201, b + 202};
    return s;
}

static void strobe_run_f(strobe *s) {
    s->st[*s->pos] ^= *s->posb;
    s->st[*s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    uint64_t lanes[25];
    memcpy(lanes, s->st, 200); /* little-endian hosts only (x86/arm64) */
    keccakf(lanes);
    memcpy(s->st, lanes, 200);
    *s->pos = 0;
    *s->posb = 0;
}

static void strobe_absorb(strobe *s, const uint8_t *data, int64_t n) {
    int64_t off = 0;
    while (off < n) {
        int64_t take = STROBE_R - *s->pos;
        if (take > n - off) take = n - off;
        uint8_t *dst = s->st + *s->pos;
        for (int64_t i = 0; i < take; i++) dst[i] ^= data[off + i];
        *s->pos = (uint8_t)(*s->pos + take);
        off += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_overwrite(strobe *s, const uint8_t *data, int64_t n) {
    int64_t off = 0;
    while (off < n) {
        int64_t take = STROBE_R - *s->pos;
        if (take > n - off) take = n - off;
        memcpy(s->st + *s->pos, data + off, (size_t)take);
        *s->pos = (uint8_t)(*s->pos + take);
        off += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static void strobe_squeeze(strobe *s, uint8_t *out, int64_t n) {
    int64_t got = 0;
    while (got < n) {
        int64_t take = STROBE_R - *s->pos;
        if (take > n - got) take = n - got;
        memcpy(out + got, s->st + *s->pos, (size_t)take);
        memset(s->st + *s->pos, 0, (size_t)take);
        *s->pos = (uint8_t)(*s->pos + take);
        got += take;
        if (*s->pos == STROBE_R) strobe_run_f(s);
    }
}

static int strobe_begin_op(strobe *s, uint8_t flags, int more) {
    if (more) return *s->flg != flags ? STROBE_EFLAGS : 0;
    if (flags & FLAG_T) return STROBE_ETRANSPORT;
    uint8_t old_begin = *s->posb;
    *s->posb = (uint8_t)(*s->pos + 1);
    *s->flg = flags;
    uint8_t hdr[2] = {old_begin, flags};
    strobe_absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && *s->pos != 0) strobe_run_f(s);
    return 0;
}

/* Keccak-f[1600] in place on a 200-byte state (little-endian lanes) */
int curdle_keccak_f1600(uint8_t *state200) {
    uint64_t lanes[25];
    memcpy(lanes, state200, 200);
    keccakf(lanes);
    memcpy(state200, lanes, 200);
    return 0;
}

/* a fresh duplex in state203, its protocol label absorbed */
int curdle_strobe_init(const uint8_t *label, int64_t n, uint8_t *state203) {
    memset(state203, 0, 203);
    uint8_t *buf = state203;
    buf[0] = 1; buf[1] = STROBE_R + 2; buf[2] = 1; buf[3] = 0; buf[4] = 1;
    buf[5] = 96;
    memcpy(buf + 6, "STROBEv1.0.2", 12);
    curdle_keccak_f1600(buf);
    strobe s = strobe_bind(buf);
    strobe_begin_op(&s, FLAG_M | FLAG_A, 0);
    strobe_absorb(&s, label, n);
    return 0;
}

/* one STROBE operation: opcode 0 meta_ad, 1 ad, 2 key (each over data[0:n]),
 * 3 prf (n bytes into out) */
int curdle_strobe_op(uint8_t *state203, int opcode, const uint8_t *data, int64_t n, int more,
                     uint8_t *out) {
    static const uint8_t flags[4] = {FLAG_M | FLAG_A, FLAG_A, FLAG_A | FLAG_C,
                                     FLAG_I | FLAG_A | FLAG_C};
    if (opcode < 0 || opcode > 3) return STROBE_EOPCODE;
    if (n < 0) return STROBE_EARG;
    strobe s = strobe_bind(state203);
    int rc = strobe_begin_op(&s, flags[opcode], more);
    if (rc) return rc;
    if (opcode == 2) strobe_overwrite(&s, data, n);
    else if (opcode == 3) strobe_squeeze(&s, out, n);
    else strobe_absorb(&s, data, n);
    return 0;
}

/* merlin framing: meta_ad(label) ; meta_ad(len_le32, more) */
static void merlin_meta_len(strobe *s, const uint8_t *label, int64_t ll, uint32_t n) {
    strobe_begin_op(s, FLAG_M | FLAG_A, 0);
    strobe_absorb(s, label, ll);
    uint8_t le[4] = {(uint8_t)n, (uint8_t)(n >> 8), (uint8_t)(n >> 16), (uint8_t)(n >> 24)};
    strobe_absorb(s, le, 4); /* continuation of the same meta_ad op */
}

static void merlin_write_raw(strobe *s, const uint8_t *label, int64_t ll, const uint8_t *msg,
                             int64_t n) {
    merlin_meta_len(s, label, ll, (uint32_t)n);
    strobe_begin_op(s, FLAG_A, 0);
    strobe_absorb(s, msg, n);
}

/* message msg[0:n] under label */
int curdle_merlin_write(uint8_t *state203, const uint8_t *label, int64_t ll,
                        const uint8_t *msg, int64_t n) {
    if (ll < 0 || n < 0) return STROBE_EARG;
    strobe s = strobe_bind(state203);
    merlin_write_raw(&s, label, ll, msg, n);
    return 0;
}

/* each item_size slice of blob[0:n] as its own message under label (a whole
 * point or scalar vector in one call) */
int curdle_merlin_write_many(uint8_t *state203, const uint8_t *label, int64_t ll,
                             const uint8_t *blob, int64_t n, int64_t item_size) {
    if (ll < 0 || n < 0 || item_size <= 0 || n % item_size) return STROBE_EARG;
    strobe s = strobe_bind(state203);
    for (int64_t off = 0; off < n; off += item_size)
        merlin_write_raw(&s, label, ll, blob + off, item_size);
    return 0;
}

/* n challenge bytes under label into out */
int curdle_merlin_read(uint8_t *state203, const uint8_t *label, int64_t ll, uint8_t *out,
                       int64_t n) {
    if (ll < 0 || n < 0) return STROBE_EARG;
    strobe s = strobe_bind(state203);
    merlin_meta_len(&s, label, ll, (uint32_t)n);
    strobe_begin_op(&s, FLAG_I | FLAG_A | FLAG_C, 0);
    strobe_squeeze(&s, out, n);
    return 0;
}

/* r (BLS12-381 scalar field order), little-endian u64 limbs */
static const uint64_t MERLIN_R[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                                     0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

/* count Fr challenges under label into out (32 little-endian bytes each):
 * each a draw of 32 bytes, retried while zero or >= r, the accepted bytes
 * written back as a message under the same label */
int curdle_merlin_challenge_scalars(uint8_t *state203, const uint8_t *label, int64_t ll,
                                    int64_t count, uint8_t *out) {
    if (ll < 0 || count < 0) return STROBE_EARG;
    strobe s = strobe_bind(state203);
    for (int64_t i = 0; i < count; i++) {
        for (;;) {
            uint8_t raw[32];
            merlin_meta_len(&s, label, ll, 32);
            strobe_begin_op(&s, FLAG_I | FLAG_A | FLAG_C, 0);
            strobe_squeeze(&s, raw, 32);
            uint64_t v[4];
            memcpy(v, raw, 32);
            int ok = 0; /* 0 < v < r */
            for (int j = 3; j >= 0; j--) {
                if (v[j] < MERLIN_R[j]) { ok = 1; break; }
                if (v[j] > MERLIN_R[j]) { ok = 0; break; }
            }
            int nz = (v[0] | v[1] | v[2] | v[3]) != 0;
            if (ok && nz) {
                merlin_write_raw(&s, label, ll, raw, 32);
                memcpy(out + 32 * i, raw, 32);
                break;
            }
        }
    }
    return 0;
}
