/* BLS12-446 group arithmetic hot loops (CRS power generation and
 * multi-scalar multiplication) for the ZK proof surface.
 *
 * The reference implements these in Rust/arkworks-style field code
 * (tfhe-zk-pok/src/curve_446); the pure-Python fallback in
 * tfhe_tpu_torch/zk/curve.py is the spec, this file is the speed path: a
 * 7x64-limb Montgomery field, Jacobian points, windowed fixed-base
 * tables and Pippenger MSM for G1 (Fq) and G2 (Fq2).
 *
 * Layout conventions at the ctypes boundary (all little-endian u64
 * limbs, NORMAL (non-Montgomery) representation, canonical < p):
 *   Fq:      7 limbs            Fq2:    14 limbs (c0 then c1)
 *   G1 aff:  14 limbs (x, y)    G2 aff: 28 limbs
 *   scalar:  5 limbs (< 2^320; callers pass values reduced mod r)
 * Points at infinity ride a separate u8 flag array (1 = infinity).
 *
 * Build: cc -O3 -shared -fPIC, at first use (tfhe_tpu_torch/_build.py::
 * bls_lib, into tfhe_tpu_torch/_build/libbls446.so).
 */

#include <stdlib.h>
#include <string.h>

typedef unsigned long long u64;
typedef __uint128_t u128;

#define NL 7
#define SL 5 /* scalar limbs */

static const u64 P[NL] = {
    0x311c0026aab0aaabULL, 0x56ee4528c573b5ccULL, 0x824e6dc3e23acdeeULL,
    0x0f75a64bbac71602ULL, 0x0095a4b78a02fe32ULL, 0x200fc34965aad640ULL,
    0x3cdee0fb28c5e535ULL};
static const u64 NINV = 0xcd63fd900035fffdULL;
static const u64 R2[NL] = {
    0x2aff01dddc752b45ULL, 0x92c772a7421ccf5bULL, 0x140eef29c347dad6ULL,
    0xf5a1400c22ea595eULL, 0x99d91c9fec145218ULL, 0x3bb6537f90143d4bULL,
    0x3627854c9be7974fULL};
static const u64 ONEM[NL] = {
    0x3b8fff65553d5554ULL, 0xa446eb5cea3128cfULL, 0xf6c648f07714c846ULL,
    0xc22966d114e3a7f5ULL, 0xfda96d21d7f40737ULL, 0x7fc0f2da6954a6ffULL,
    0x0c847c135ce86b2bULL};
static const u64 PM2[NL] = {
    0x311c0026aab0aaa9ULL, 0x56ee4528c573b5ccULL, 0x824e6dc3e23acdeeULL,
    0x0f75a64bbac71602ULL, 0x0095a4b78a02fe32ULL, 0x200fc34965aad640ULL,
    0x3cdee0fb28c5e535ULL};

/* ------------------------------------------------------------------ Fq */

static inline int fq_is_zero(const u64 *a) {
  u64 acc = 0;
  for (int i = 0; i < NL; i++) acc |= a[i];
  return acc == 0;
}

static inline int fq_ge_p(const u64 *a) {
  for (int i = NL - 1; i >= 0; i--) {
    if (a[i] > P[i]) return 1;
    if (a[i] < P[i]) return 0;
  }
  return 1;
}

static inline void fq_sub_p(u64 *a) {
  u128 bor = 0;
  for (int i = 0; i < NL; i++) {
    u128 cur = (u128)a[i] - P[i] - bor;
    a[i] = (u64)cur;
    bor = (cur >> 64) & 1;
  }
}

static inline void fq_add(u64 *r, const u64 *a, const u64 *b) {
  u128 c = 0;
  for (int i = 0; i < NL; i++) {
    c += (u128)a[i] + b[i];
    r[i] = (u64)c;
    c >>= 64;
  }
  if (c || fq_ge_p(r)) fq_sub_p(r);
}

static inline void fq_sub(u64 *r, const u64 *a, const u64 *b) {
  u128 bor = 0;
  for (int i = 0; i < NL; i++) {
    u128 cur = (u128)a[i] - b[i] - bor;
    r[i] = (u64)cur;
    bor = (cur >> 64) & 1;
  }
  if (bor) { /* add P back */
    u128 c = 0;
    for (int i = 0; i < NL; i++) {
      c += (u128)r[i] + P[i];
      r[i] = (u64)c;
      c >>= 64;
    }
  }
}

static inline void fq_neg(u64 *r, const u64 *a) {
  if (fq_is_zero(a)) {
    memset(r, 0, NL * 8);
    return;
  }
  u128 bor = 0;
  for (int i = 0; i < NL; i++) {
    u128 cur = (u128)P[i] - a[i] - bor;
    r[i] = (u64)cur;
    bor = (cur >> 64) & 1;
  }
}

/* CIOS Montgomery multiplication; inputs canonical < P, output < P. */
static void fq_mul(u64 *rr, const u64 *a, const u64 *b) {
  u64 t[NL + 2];
  memset(t, 0, sizeof(t));
  for (int i = 0; i < NL; i++) {
    u128 c = 0;
    for (int j = 0; j < NL; j++) {
      c += (u128)t[j] + (u128)a[i] * b[j];
      t[j] = (u64)c;
      c >>= 64;
    }
    c += t[NL];
    t[NL] = (u64)c;
    t[NL + 1] = (u64)(c >> 64);

    u64 m = t[0] * NINV;
    c = (u128)t[0] + (u128)m * P[0];
    c >>= 64;
    for (int j = 1; j < NL; j++) {
      c += (u128)t[j] + (u128)m * P[j];
      t[j - 1] = (u64)c;
      c >>= 64;
    }
    c += t[NL];
    t[NL - 1] = (u64)c;
    t[NL] = t[NL + 1] + (u64)(c >> 64);
    t[NL + 1] = 0;
  }
  if (t[NL] || fq_ge_p(t)) fq_sub_p(t);
  memcpy(rr, t, NL * 8);
}

static inline void fq_sqr(u64 *r, const u64 *a) { fq_mul(r, a, a); }

static void fq_to_mont(u64 *r, const u64 *a) { fq_mul(r, a, R2); }
static void fq_from_mont(u64 *r, const u64 *a) {
  u64 one[NL] = {1, 0, 0, 0, 0, 0, 0};
  fq_mul(r, a, one);
}

/* Fermat inversion (Montgomery in, Montgomery out). */
static void fq_inv(u64 *r, const u64 *a) {
  u64 acc[NL], base[NL];
  memcpy(acc, ONEM, NL * 8);
  memcpy(base, a, NL * 8);
  for (int i = 0; i < NL; i++) {
    u64 e = PM2[i];
    for (int b = 0; b < 64; b++) {
      if (e & 1) fq_mul(acc, acc, base);
      fq_sqr(base, base);
      e >>= 1;
    }
  }
  memcpy(r, acc, NL * 8);
}

/* ----------------------------------------------------------------- Fq2 */
/* c0 + c1 i with i^2 = -1; element = 2*NL limbs. */

#define F2L (2 * NL)

static inline int fq2_is_zero(const u64 *a) {
  return fq_is_zero(a) && fq_is_zero(a + NL);
}

static inline void fq2_add(u64 *r, const u64 *a, const u64 *b) {
  fq_add(r, a, b);
  fq_add(r + NL, a + NL, b + NL);
}

static inline void fq2_sub(u64 *r, const u64 *a, const u64 *b) {
  fq_sub(r, a, b);
  fq_sub(r + NL, a + NL, b + NL);
}

static inline void fq2_neg(u64 *r, const u64 *a) {
  fq_neg(r, a);
  fq_neg(r + NL, a + NL);
}

static void fq2_mul(u64 *r, const u64 *a, const u64 *b) {
  u64 t0[NL], t1[NL], sa[NL], sb[NL], m[NL];
  fq_mul(t0, a, b);
  fq_mul(t1, a + NL, b + NL);
  fq_add(sa, a, a + NL);
  fq_add(sb, b, b + NL);
  fq_mul(m, sa, sb);
  fq_sub(m, m, t0);
  fq_sub(m, m, t1); /* a0 b1 + a1 b0 */
  fq_sub(r, t0, t1);
  memcpy(r + NL, m, NL * 8);
}

static inline void fq2_sqr(u64 *r, const u64 *a) { fq2_mul(r, a, a); }

static void fq2_inv(u64 *r, const u64 *a) {
  u64 n0[NL], n1[NL], d[NL];
  fq_sqr(n0, a);
  fq_sqr(n1, a + NL);
  fq_add(d, n0, n1);
  fq_inv(d, d);
  fq_mul(r, a, d);
  u64 t[NL];
  fq_neg(t, a + NL);
  fq_mul(r + NL, t, d);
}

static void fq2_to_mont(u64 *r, const u64 *a) {
  fq_to_mont(r, a);
  fq_to_mont(r + NL, a + NL);
}
static void fq2_from_mont(u64 *r, const u64 *a) {
  fq_from_mont(r, a);
  fq_from_mont(r + NL, a + NL);
}

/* ------------------------------------------------------- Jacobian points
 * A point is (X, Y, Z) contiguous field elements; Z == 0 <=> infinity.
 * The formulas mirror tfhe_tpu_torch/zk/curve.py (_jac_double/_jac_add_affine/
 * _jac_add) for both curves (a = 0).
 */

#define DEF_POINT_OPS(pre, FE, WORDS, fe_add, fe_sub, fe_neg, fe_mul,       \
                      fe_sqr, fe_is_zero)                                   \
  static void pre##_dbl(u64 *o, const u64 *j) {                             \
    const u64 *X = j, *Y = j + WORDS, *Z = j + 2 * WORDS;                   \
    if (fe_is_zero(Z) || fe_is_zero(Y)) {                                   \
      memset(o, 0, 3 * WORDS * 8);                                          \
      return;                                                               \
    }                                                                       \
    u64 A[WORDS], B[WORDS], C[WORDS], t[WORDS], D[WORDS], E[WORDS],         \
        F[WORDS], X3[WORDS], Y3[WORDS], Z3[WORDS];                          \
    fe_sqr(A, X);                                                           \
    fe_sqr(B, Y);                                                           \
    fe_sqr(C, B);                                                           \
    fe_add(t, X, B);                                                        \
    fe_sqr(t, t);                                                           \
    fe_sub(t, t, A);                                                        \
    fe_sub(D, t, C);                                                        \
    fe_add(D, D, D);                                                        \
    fe_add(E, A, A);                                                        \
    fe_add(E, E, A);                                                        \
    fe_sqr(F, E);                                                           \
    fe_add(t, D, D);                                                        \
    fe_sub(X3, F, t);                                                       \
    fe_add(C, C, C);                                                        \
    fe_add(C, C, C);                                                        \
    fe_add(C, C, C);                                                        \
    fe_sub(t, D, X3);                                                       \
    fe_mul(Y3, E, t);                                                       \
    fe_sub(Y3, Y3, C);                                                      \
    fe_add(t, Y, Y);                                                        \
    fe_mul(Z3, t, Z);                                                       \
    memcpy(o, X3, WORDS * 8);                                               \
    memcpy(o + WORDS, Y3, WORDS * 8);                                       \
    memcpy(o + 2 * WORDS, Z3, WORDS * 8);                                   \
  }                                                                         \
  /* o = j + affine(a); all Montgomery form. */                             \
  static void pre##_madd(u64 *o, const u64 *j, const u64 *a) {              \
    const u64 *Z1 = j + 2 * WORDS;                                          \
    if (fe_is_zero(Z1)) {                                                   \
      memcpy(o, a, 2 * WORDS * 8);                                          \
      memcpy(o + 2 * WORDS, ONEM_##pre, WORDS * 8);                         \
      return;                                                               \
    }                                                                       \
    u64 Z1Z1[WORDS], U2[WORDS], S2[WORDS], H[WORDS], Rr[WORDS], H2[WORDS],  \
        H3[WORDS], V[WORDS], t[WORDS], X3[WORDS], Y3[WORDS], Z3[WORDS];     \
    fe_sqr(Z1Z1, Z1);                                                       \
    fe_mul(U2, a, Z1Z1);                                                    \
    fe_mul(t, a + WORDS, Z1Z1);                                             \
    fe_mul(S2, t, Z1);                                                      \
    fe_sub(H, U2, j);                                                       \
    fe_sub(Rr, S2, j + WORDS);                                              \
    if (fe_is_zero(H)) {                                                    \
      if (fe_is_zero(Rr)) {                                                 \
        pre##_dbl(o, j);                                                    \
      } else {                                                              \
        memset(o, 0, 3 * WORDS * 8);                                        \
      }                                                                     \
      return;                                                               \
    }                                                                       \
    fe_sqr(H2, H);                                                          \
    fe_mul(H3, H2, H);                                                      \
    fe_mul(V, j, H2);                                                       \
    fe_sqr(X3, Rr);                                                         \
    fe_sub(X3, X3, H3);                                                     \
    fe_add(t, V, V);                                                        \
    fe_sub(X3, X3, t);                                                      \
    fe_sub(t, V, X3);                                                       \
    fe_mul(Y3, Rr, t);                                                      \
    fe_mul(t, j + WORDS, H3);                                               \
    fe_sub(Y3, Y3, t);                                                      \
    fe_mul(Z3, Z1, H);                                                      \
    memcpy(o, X3, WORDS * 8);                                               \
    memcpy(o + WORDS, Y3, WORDS * 8);                                       \
    memcpy(o + 2 * WORDS, Z3, WORDS * 8);                                   \
  }                                                                         \
  /* o = p + q, both Jacobian Montgomery. */                                \
  static void pre##_add(u64 *o, const u64 *p, const u64 *q) {               \
    if (fe_is_zero(p + 2 * WORDS)) {                                        \
      memcpy(o, q, 3 * WORDS * 8);                                          \
      return;                                                               \
    }                                                                       \
    if (fe_is_zero(q + 2 * WORDS)) {                                        \
      memcpy(o, p, 3 * WORDS * 8);                                          \
      return;                                                               \
    }                                                                       \
    u64 Z1Z1[WORDS], Z2Z2[WORDS], U1[WORDS], U2[WORDS], S1[WORDS],          \
        S2[WORDS], H[WORDS], Rr[WORDS], t[WORDS], I[WORDS], J[WORDS],       \
        V[WORDS], X3[WORDS], Y3[WORDS], Z3[WORDS];                          \
    fe_sqr(Z1Z1, p + 2 * WORDS);                                            \
    fe_sqr(Z2Z2, q + 2 * WORDS);                                            \
    fe_mul(U1, p, Z2Z2);                                                    \
    fe_mul(U2, q, Z1Z1);                                                    \
    fe_mul(t, q + 2 * WORDS, Z2Z2);                                         \
    fe_mul(S1, p + WORDS, t);                                               \
    fe_mul(t, p + 2 * WORDS, Z1Z1);                                         \
    fe_mul(S2, q + WORDS, t);                                               \
    fe_sub(H, U2, U1);                                                      \
    fe_sub(Rr, S2, S1);                                                     \
    if (fe_is_zero(H)) {                                                    \
      if (fe_is_zero(Rr)) {                                                 \
        pre##_dbl(o, p);                                                    \
      } else {                                                              \
        memset(o, 0, 3 * WORDS * 8);                                        \
      }                                                                     \
      return;                                                               \
    }                                                                       \
    fe_add(t, H, H);                                                        \
    fe_sqr(I, t);                                                           \
    fe_mul(J, H, I);                                                        \
    fe_add(Rr, Rr, Rr);                                                     \
    fe_mul(V, U1, I);                                                       \
    fe_sqr(X3, Rr);                                                         \
    fe_sub(X3, X3, J);                                                      \
    fe_add(t, V, V);                                                        \
    fe_sub(X3, X3, t);                                                      \
    fe_sub(t, V, X3);                                                       \
    fe_mul(Y3, Rr, t);                                                      \
    fe_add(S1, S1, S1);                                                     \
    fe_mul(t, S1, J);                                                       \
    fe_sub(Y3, Y3, t);                                                      \
    fe_add(t, p + 2 * WORDS, q + 2 * WORDS);                                \
    fe_sqr(t, t);                                                           \
    fe_sub(t, t, Z1Z1);                                                     \
    fe_sub(t, t, Z2Z2);                                                     \
    fe_mul(Z3, t, H);                                                       \
    memcpy(o, X3, WORDS * 8);                                               \
    memcpy(o + WORDS, Y3, WORDS * 8);                                       \
    memcpy(o + 2 * WORDS, Z3, WORDS * 8);                                   \
  }

static const u64 *ONEM_g1 = ONEM;
static u64 ONEM_g2[F2L];
static int onem_g2_init = 0;
static void ensure_onem_g2(void) {
  if (!onem_g2_init) {
    memcpy(ONEM_g2, ONEM, NL * 8);
    memset(ONEM_g2 + NL, 0, NL * 8);
    onem_g2_init = 1;
  }
}

DEF_POINT_OPS(g1, fq, NL, fq_add, fq_sub, fq_neg, fq_mul, fq_sqr, fq_is_zero)
DEF_POINT_OPS(g2, fq2, F2L, fq2_add, fq2_sub, fq2_neg, fq2_mul, fq2_sqr,
              fq2_is_zero)

/* -------------------------------------------- batch normalize (affine) */

#define DEF_BATCH_NORM(pre, WORDS, fe_mul, fe_sqr, fe_inv, fe_is_zero)      \
  static void pre##_batch_affine(const u64 *jacs, long long n, u64 *out,    \
                                 unsigned char *inf) {                      \
    u64 *prefix = (u64 *)malloc((size_t)n * WORDS * 8);                     \
    u64 acc[WORDS], tmp[WORDS], zinv[WORDS], zi2[WORDS];                    \
    memcpy(acc, ONEM_##pre, WORDS * 8);                                     \
    for (long long i = 0; i < n; i++) {                                     \
      const u64 *Z = jacs + i * 3 * WORDS + 2 * WORDS;                      \
      if (!fe_is_zero(Z)) fe_mul(acc, acc, Z);                              \
      memcpy(prefix + i * WORDS, acc, WORDS * 8);                           \
    }                                                                       \
    u64 inv_all[WORDS];                                                     \
    fe_inv(inv_all, acc);                                                   \
    for (long long i = n - 1; i >= 0; i--) {                                \
      const u64 *jp = jacs + i * 3 * WORDS;                                 \
      const u64 *Z = jp + 2 * WORDS;                                        \
      if (fe_is_zero(Z)) {                                                  \
        inf[i] = 1;                                                         \
        memset(out + i * 2 * WORDS, 0, 2 * WORDS * 8);                      \
        continue;                                                           \
      }                                                                     \
      inf[i] = 0;                                                           \
      if (i == 0) {                                                         \
        memcpy(zinv, inv_all, WORDS * 8);                                   \
      } else {                                                              \
        fe_mul(zinv, inv_all, prefix + (i - 1) * WORDS);                    \
      }                                                                     \
      fe_mul(inv_all, inv_all, Z);                                          \
      fe_sqr(zi2, zinv);                                                    \
      fe_mul(out + i * 2 * WORDS, jp, zi2);                                 \
      fe_mul(tmp, zi2, zinv);                                               \
      fe_mul(out + i * 2 * WORDS + WORDS, jp + WORDS, tmp);                 \
    }                                                                       \
    free(prefix);                                                           \
  }

DEF_BATCH_NORM(g1, NL, fq_mul, fq_sqr, fq_inv, fq_is_zero)
DEF_BATCH_NORM(g2, F2L, fq2_mul, fq2_sqr, fq2_inv, fq2_is_zero)

/* -------------------------------------------------- fixed-base powers */

#define DEF_FIXED_POWERS(pre, WORDS, fe_is_zero, to_mont, from_mont)        \
  void pre##_fixed_powers(const u64 *base_aff, const u64 *scalars,          \
                          long long count, int window, u64 *out,            \
                          unsigned char *inf) {                             \
    ensure_onem_g2();                                                       \
    int nwin = (320 + window - 1) / window;                                 \
    long long per = (1LL << window) - 1;                                    \
    u64 *tab_j = (u64 *)malloc((size_t)nwin * per * 3 * WORDS * 8);         \
    u64 base_m[2 * WORDS], cur[3 * WORDS];                                  \
    to_mont(base_m, base_aff);                                              \
    to_mont(base_m + WORDS, base_aff + WORDS);                              \
    memcpy(cur, base_m, 2 * WORDS * 8);                                     \
    memcpy(cur + 2 * WORDS, ONEM_##pre, WORDS * 8);                         \
    for (int w = 0; w < nwin; w++) {                                        \
      u64 *row = tab_j + (size_t)w * per * 3 * WORDS;                       \
      memcpy(row, cur, 3 * WORDS * 8);                                      \
      for (long long b = 1; b < per; b++)                                   \
        pre##_add(row + b * 3 * WORDS, row + (b - 1) * 3 * WORDS, cur);     \
      pre##_add(cur, row + (per - 1) * 3 * WORDS, cur);                     \
    }                                                                       \
    u64 *tab_a = (u64 *)malloc((size_t)nwin * per * 2 * WORDS * 8);         \
    unsigned char *tab_inf = (unsigned char *)malloc((size_t)nwin * per);   \
    pre##_batch_affine(tab_j, nwin * per, tab_a, tab_inf);                  \
    free(tab_j);                                                            \
    u64 *outs_j = (u64 *)malloc((size_t)count * 3 * WORDS * 8);             \
    u64 mask = (window >= 64) ? ~0ULL : ((1ULL << window) - 1);             \
    for (long long s = 0; s < count; s++) {                                 \
      u64 *acc = outs_j + s * 3 * WORDS;                                    \
      memset(acc, 0, 3 * WORDS * 8);                                        \
      const u64 *k = scalars + s * SL;                                      \
      for (int w = 0; w < nwin; w++) {                                      \
        int bitpos = w * window;                                            \
        int limb = bitpos >> 6, off = bitpos & 63;                          \
        u64 b = k[limb] >> off;                                             \
        if (off + window > 64 && limb + 1 < SL)                             \
          b |= k[limb + 1] << (64 - off);                                   \
        b &= mask;                                                          \
        if (b && !tab_inf[(size_t)w * per + b - 1])                         \
          pre##_madd(acc, acc,                                              \
                     tab_a + ((size_t)w * per + b - 1) * 2 * WORDS);        \
      }                                                                     \
    }                                                                       \
    free(tab_a);                                                            \
    free(tab_inf);                                                          \
    u64 *outs_m = (u64 *)malloc((size_t)count * 2 * WORDS * 8);             \
    pre##_batch_affine(outs_j, count, outs_m, inf);                         \
    free(outs_j);                                                           \
    for (long long s = 0; s < count; s++) {                                 \
      from_mont(out + s * 2 * WORDS, outs_m + s * 2 * WORDS);               \
      from_mont(out + s * 2 * WORDS + WORDS,                                \
                outs_m + s * 2 * WORDS + WORDS);                            \
    }                                                                       \
    free(outs_m);                                                           \
  }

DEF_FIXED_POWERS(g1, NL, fq_is_zero, fq_to_mont, fq_from_mont)
DEF_FIXED_POWERS(g2, F2L, fq2_is_zero, fq2_to_mont, fq2_from_mont)

/* --------------------------------------------------------- Pippenger */

#define DEF_MSM(pre, WORDS, to_mont, from_mont, fe_is_zero)                 \
  void pre##_msm(const u64 *pts, const unsigned char *inf_in,               \
                 const u64 *scalars, long long count, u64 *out,             \
                 unsigned char *out_inf) {                                  \
    ensure_onem_g2();                                                       \
    /* pick window by the usual cost model */                               \
    int c = 2;                                                              \
    double best = 1e300;                                                    \
    for (int w = 2; w <= 16; w++) {                                         \
      double cost = ((320.0 + w - 1) / w) * ((double)count +                \
                                             1.2 * (double)(1LL << w));     \
      if (cost < best) {                                                    \
        best = cost;                                                        \
        c = w;                                                              \
      }                                                                     \
    }                                                                       \
    int nwin = (320 + c - 1) / c;                                           \
    long long nb = (1LL << c) - 1;                                          \
    u64 *pm = (u64 *)malloc((size_t)count * 2 * WORDS * 8);                 \
    for (long long i = 0; i < count; i++) {                                 \
      to_mont(pm + i * 2 * WORDS, pts + i * 2 * WORDS);                     \
      to_mont(pm + i * 2 * WORDS + WORDS, pts + i * 2 * WORDS + WORDS);     \
    }                                                                       \
    u64 *buckets = (u64 *)malloc((size_t)nb * 3 * WORDS * 8);               \
    u64 total[3 * WORDS], run[3 * WORDS], wsum[3 * WORDS], t[3 * WORDS];    \
    memset(total, 0, sizeof(total));                                        \
    u64 mask = (c >= 64) ? ~0ULL : ((1ULL << c) - 1);                       \
    for (int w = nwin - 1; w >= 0; w--) {                                   \
      if (!fe_is_zero(total + 2 * WORDS))                                   \
        for (int d = 0; d < c; d++) pre##_dbl(total, total);                \
      memset(buckets, 0, (size_t)nb * 3 * WORDS * 8);                       \
      int bitpos = w * c;                                                   \
      int limb = bitpos >> 6, off = bitpos & 63;                            \
      for (long long i = 0; i < count; i++) {                               \
        if (inf_in[i]) continue;                                            \
        const u64 *k = scalars + i * SL;                                    \
        u64 b = k[limb] >> off;                                             \
        if (off + c > 64 && limb + 1 < SL) b |= k[limb + 1] << (64 - off);  \
        b &= mask;                                                          \
        if (b)                                                              \
          pre##_madd(buckets + (b - 1) * 3 * WORDS,                         \
                     buckets + (b - 1) * 3 * WORDS, pm + i * 2 * WORDS);    \
      }                                                                     \
      memset(run, 0, sizeof(run));                                          \
      memset(wsum, 0, sizeof(wsum));                                        \
      for (long long b = nb - 1; b >= 0; b--) {                             \
        pre##_add(t, run, buckets + b * 3 * WORDS);                         \
        memcpy(run, t, 3 * WORDS * 8);                                      \
        pre##_add(t, wsum, run);                                            \
        memcpy(wsum, t, 3 * WORDS * 8);                                     \
      }                                                                     \
      pre##_add(t, total, wsum);                                            \
      memcpy(total, t, 3 * WORDS * 8);                                      \
    }                                                                       \
    free(buckets);                                                          \
    free(pm);                                                               \
    u64 aff[2 * WORDS];                                                     \
    unsigned char inf1;                                                     \
    pre##_batch_affine(total, 1, aff, &inf1);                               \
    *out_inf = inf1;                                                        \
    if (!inf1) {                                                            \
      from_mont(out, aff);                                                  \
      from_mont(out + WORDS, aff + WORDS);                                  \
    } else {                                                                \
      memset(out, 0, 2 * WORDS * 8);                                        \
    }                                                                       \
  }

DEF_MSM(g1, NL, fq_to_mont, fq_from_mont, fq_is_zero)
DEF_MSM(g2, F2L, fq2_to_mont, fq2_from_mont, fq2_is_zero)

/* The bucket-madd above stores its accumulator in Jacobian form but the
 * madd expects an affine second operand — pm entries ARE affine (x, y)
 * Montgomery pairs, so this is consistent. Buckets start at infinity
 * (all-zero Z) and madd handles that case. */

/* ================================================================ pairing
 * Fq6 = Fq2[v]/(v^3 - xi), xi = 1 + i; Fq12 = Fq6[w]/(w^2 - v).
 *
 * Mirrors tfhe_tpu_torch/zk/curve.py EXACTLY (the spec): generic-Miller ate
 * pairing — G2 untwisted into E(Fq12), lines evaluated in full Fq12 with
 * numerator/denominator accumulation, final power (p^12-1)/r supplied by
 * the caller — so the native values are point-for-point comparable to
 * the Python ones (reference construction: tfhe-zk-pok/src/curve_446).
 * Degenerate line cases (2-torsion / equal-x chords) cannot occur for
 * order-r inputs; if ever hit, functions return -1 and the caller falls
 * back to the Python path. */

#define F6L (3 * F2L)
#define F12L (2 * F6L)

/* xi * a for xi = 1 + i: (a0 - a1) + (a0 + a1) i */
static void fq2_mul_xi(u64 *r, const u64 *a) {
  u64 t0[NL], t1[NL];
  fq_sub(t0, a, a + NL);
  fq_add(t1, a, a + NL);
  memcpy(r, t0, NL * 8);
  memcpy(r + NL, t1, NL * 8);
}

static void fq6_add(u64 *r, const u64 *a, const u64 *b) {
  for (int i = 0; i < 3; i++) fq2_add(r + i * F2L, a + i * F2L, b + i * F2L);
}
static void fq6_sub(u64 *r, const u64 *a, const u64 *b) {
  for (int i = 0; i < 3; i++) fq2_sub(r + i * F2L, a + i * F2L, b + i * F2L);
}
static void fq6_neg(u64 *r, const u64 *a) {
  for (int i = 0; i < 3; i++) fq2_neg(r + i * F2L, a + i * F2L);
}
static int fq6_is_zero(const u64 *a) {
  return fq2_is_zero(a) && fq2_is_zero(a + F2L) && fq2_is_zero(a + 2 * F2L);
}

static void fq6_mul(u64 *r, const u64 *a, const u64 *b) {
  u64 c[5][F2L], t[F2L], x[F2L];
  memset(c, 0, sizeof(c));
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      fq2_mul(t, a + i * F2L, b + j * F2L);
      fq2_add(c[i + j], c[i + j], t);
    }
  fq2_mul_xi(x, c[3]);
  fq2_add(r, c[0], x);
  fq2_mul_xi(x, c[4]);
  fq2_add(r + F2L, c[1], x);
  memcpy(r + 2 * F2L, c[2], F2L * 8);
}

static void fq6_mul_by_v(u64 *r, const u64 *a) {
  u64 t[F2L];
  fq2_mul_xi(t, a + 2 * F2L);
  /* alias-safe order (r may be a): a2 is saved in t, shift up, then c0 */
  memmove(r + 2 * F2L, a + F2L, F2L * 8);
  memmove(r + F2L, a, F2L * 8);
  memcpy(r, t, F2L * 8);
}

static void fq6_inv(u64 *r, const u64 *a) {
  const u64 *a0 = a, *a1 = a + F2L, *a2 = a + 2 * F2L;
  u64 t0[F2L], t1[F2L], t2[F2L], u[F2L], v[F2L], norm[F2L], ninv[F2L];
  fq2_mul(t0, a0, a0);
  fq2_mul(u, a1, a2); fq2_mul_xi(v, u); fq2_sub(t0, t0, v);
  fq2_mul(u, a2, a2); fq2_mul_xi(t1, u);
  fq2_mul(u, a0, a1); fq2_sub(t1, t1, u);
  fq2_mul(t2, a1, a1);
  fq2_mul(u, a0, a2); fq2_sub(t2, t2, u);
  fq2_mul(u, a2, t1); fq2_mul(v, a1, t2); fq2_add(u, u, v);
  fq2_mul_xi(v, u);
  fq2_mul(u, a0, t0); fq2_add(norm, u, v);
  fq2_inv(ninv, norm);
  fq2_mul(r, t0, ninv);
  fq2_mul(r + F2L, t1, ninv);
  fq2_mul(r + 2 * F2L, t2, ninv);
}

static void fq12_add(u64 *r, const u64 *a, const u64 *b) {
  fq6_add(r, a, b);
  fq6_add(r + F6L, a + F6L, b + F6L);
}
static void fq12_sub(u64 *r, const u64 *a, const u64 *b) {
  fq6_sub(r, a, b);
  fq6_sub(r + F6L, a + F6L, b + F6L);
}

static void fq12_mul(u64 *r, const u64 *a, const u64 *b) {
  u64 t0[F6L], t1[F6L], sa[F6L], sb[F6L], mid[F6L], v[F6L];
  fq6_mul(t0, a, b);
  fq6_mul(t1, a + F6L, b + F6L);
  fq6_add(sa, a, a + F6L);
  fq6_add(sb, b, b + F6L);
  fq6_mul(mid, sa, sb);
  fq6_sub(mid, mid, t0);
  fq6_sub(mid, mid, t1);
  fq6_mul_by_v(v, t1);
  fq6_add(r, t0, v);
  memcpy(r + F6L, mid, F6L * 8);
}
static void fq12_sqr(u64 *r, const u64 *a) { fq12_mul(r, a, a); }

static void fq12_inv(u64 *r, const u64 *a) {
  u64 n0[F6L], n1[F6L], norm[F6L], ninv[F6L], t[F6L];
  fq6_mul(n0, a, a);
  fq6_mul(n1, a + F6L, a + F6L);
  fq6_mul_by_v(t, n1);
  fq6_sub(norm, n0, t);
  fq6_inv(ninv, norm);
  fq6_mul(r, a, ninv);
  fq6_mul(t, a + F6L, ninv);
  fq6_neg(r + F6L, t);
}

static void fq12_one(u64 *r) {
  memset(r, 0, F12L * 8);
  memcpy(r, ONEM, NL * 8);
}

static int fq12_eq(const u64 *a, const u64 *b) {
  return memcmp(a, b, F12L * 8) == 0;
}
static int fq12_is_zero(const u64 *a) {
  return fq6_is_zero(a) && fq6_is_zero(a + F6L);
}

/* untwist constants 1/w^2, 1/w^3 (Montgomery), built once */
static u64 W2INV[F12L], W3INV[F12L];
static int pairing_init_done = 0;
static void ensure_pairing_init(void) {
  if (pairing_init_done) return;
  u64 w2[F12L], w3[F12L];
  memset(w2, 0, sizeof(w2));
  memcpy(w2 + F2L, ONEM, NL * 8);          /* w^2 = v: c0 limb d1 */
  memset(w3, 0, sizeof(w3));
  memcpy(w3 + F6L + F2L, ONEM, NL * 8);    /* w^3 = v w: c1 limb d1 */
  fq12_inv(W2INV, w2);
  fq12_inv(W3INV, w3);
  pairing_init_done = 1;
}

/* line through a=(tx,ty) and b (tangent if dbl) evaluated at p=(px,py);
 * advances (tx,ty) to a+b. Returns -1 on a degenerate case. */
static int f12_line(u64 *tx, u64 *ty, const u64 *bx, const u64 *by, int dbl,
                    const u64 *px, const u64 *py, u64 *num, u64 *den) {
  u64 lam[F12L], t0[F12L], t1[F12L], x3[F12L], y3[F12L];
  if (dbl) {
    if (fq12_is_zero(ty)) return -1;
    fq12_sqr(t0, tx);
    fq12_add(t1, t0, t0);
    fq12_add(t0, t1, t0);               /* 3 x^2 */
    fq12_add(t1, ty, ty);
    fq12_inv(t1, t1);
    fq12_mul(lam, t0, t1);
    bx = tx;
    by = ty;
  } else {
    if (fq12_eq(tx, bx)) return -1;
    fq12_sub(t0, by, ty);
    fq12_sub(t1, bx, tx);
    fq12_inv(t1, t1);
    fq12_mul(lam, t0, t1);
  }
  /* num = (py - ty) - lam (px - tx) */
  fq12_sub(t0, px, tx);
  fq12_mul(t0, lam, t0);
  fq12_sub(t1, py, ty);
  fq12_sub(num, t1, t0);
  /* t <- a + b; den = px - x3 */
  fq12_sqr(t0, lam);
  fq12_sub(t0, t0, tx);
  fq12_sub(x3, t0, bx);
  fq12_sub(t0, tx, x3);
  fq12_mul(t0, lam, t0);
  fq12_sub(y3, t0, ty);
  fq12_sub(den, px, x3);
  memcpy(tx, x3, F12L * 8);
  memcpy(ty, y3, F12L * 8);
  return 0;
}

#define X_ABS_HI 0x600ULL
#define X_ABS_LO 0x8204000000020001ULL
#define X_ABS_BITS 75

static int x_abs_bit(int i) {
  return i < 64 ? (int)((X_ABS_LO >> i) & 1) : (int)((X_ABS_HI >> (i - 64)) & 1);
}

/* f_{X_ABS, Q}(P), Q=(qx,qy) and P=(px,py) in E(Fq12) affine Montgomery */
static int f12_miller(const u64 *qx, const u64 *qy, const u64 *px,
                      const u64 *py, u64 *out) {
  u64 fn[F12L], fd[F12L], tx[F12L], ty[F12L];
  u64 num[F12L], den[F12L], t[F12L];
  fq12_one(fn);
  fq12_one(fd);
  memcpy(tx, qx, F12L * 8);
  memcpy(ty, qy, F12L * 8);
  for (int i = X_ABS_BITS - 2; i >= 0; i--) {
    if (f12_line(tx, ty, NULL, NULL, 1, px, py, num, den)) return -1;
    fq12_sqr(t, fn); fq12_mul(fn, t, num);
    fq12_sqr(t, fd); fq12_mul(fd, t, den);
    if (x_abs_bit(i)) {
      if (f12_line(tx, ty, qx, qy, 0, px, py, num, den)) return -1;
      fq12_mul(t, fn, num); memcpy(fn, t, F12L * 8);
      fq12_mul(t, fd, den); memcpy(fd, t, F12L * 8);
    }
  }
  fq12_inv(t, fd);
  fq12_mul(out, fn, t);
  return 0;
}

static void fq12_pow_limbs(u64 *r, const u64 *a, const u64 *e, int nlimbs) {
  u64 t[F12L];
  fq12_one(r);
  int started = 0;
  for (int li = nlimbs - 1; li >= 0; li--)
    for (int b = 63; b >= 0; b--) {
      if (started) { fq12_sqr(t, r); memcpy(r, t, F12L * 8); }
      if ((e[li] >> b) & 1) {
        fq12_mul(t, r, a);
        memcpy(r, t, F12L * 8);
        started = 1;
      }
    }
}

/* embed affine G1 (normal domain, 2*NL limbs) into E(Fq12) Montgomery */
static void embed_g1(const u64 *g1, u64 *px, u64 *py) {
  memset(px, 0, F12L * 8);
  memset(py, 0, F12L * 8);
  fq_to_mont(px, g1);
  fq_to_mont(py, g1 + NL);
}

/* untwist affine G2 (normal domain, 2*F2L limbs): x/w^2, y/w^3 */
static void untwist_g2(const u64 *g2, u64 *qx, u64 *qy) {
  u64 e[F12L];
  memset(e, 0, sizeof(e));
  fq2_to_mont(e, g2);
  fq12_mul(qx, e, W2INV);
  memset(e, 0, sizeof(e));
  fq2_to_mont(e, g2 + F2L);
  fq12_mul(qy, e, W3INV);
}

/* prod_i e(P_i, Q_i) == 1, one shared final exponentiation.
 * exp = (p^12-1)/r as little-endian u64 limbs. Returns 0 ok / -1 fall back. */
int pairing_product_is_one(const u64 *g1s, const unsigned char *g1_inf,
                           const u64 *g2s, const unsigned char *g2_inf,
                           long long n, const u64 *exp_limbs, int exp_nlimbs,
                           unsigned char *out_is_one) {
  ensure_pairing_init();
  u64 acc[F12L], m[F12L], t[F12L];
  u64 px[F12L], py[F12L], qx[F12L], qy[F12L];
  fq12_one(acc);
  int nontrivial = 0;
  for (long long i = 0; i < n; i++) {
    if (g1_inf[i] || g2_inf[i]) continue;
    embed_g1(g1s + i * 2 * NL, px, py);
    untwist_g2(g2s + i * 2 * F2L, qx, qy);
    if (f12_miller(qx, qy, px, py, m)) return -1;
    fq12_mul(t, acc, m);
    memcpy(acc, t, F12L * 8);
    nontrivial = 1;
  }
  if (!nontrivial) {
    *out_is_one = 1;
    return 0;
  }
  fq12_pow_limbs(t, acc, exp_limbs, exp_nlimbs);
  u64 one[F12L];
  fq12_one(one);
  *out_is_one = (unsigned char)fq12_eq(t, one);
  return 0;
}

/* e(P, Q) full pairing value, normal domain out (12 Fq coeffs in the
 * (c0.(d0,d1,d2), c1.(d0,d1,d2)) fq2-flattened order) — cross-check vs
 * the Python spec's pairing(). */
int pairing_eval(const u64 *g1, const u64 *g2, const u64 *exp_limbs,
                 int exp_nlimbs, u64 *out) {
  ensure_pairing_init();
  u64 px[F12L], py[F12L], qx[F12L], qy[F12L], m[F12L], f[F12L];
  embed_g1(g1, px, py);
  untwist_g2(g2, qx, qy);
  if (f12_miller(qx, qy, px, py, m)) return -1;
  fq12_pow_limbs(f, m, exp_limbs, exp_nlimbs);
  for (int i = 0; i < 12; i++) fq_from_mont(out + i * NL, f + i * NL);
  return 0;
}
