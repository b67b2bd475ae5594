/* hostmath: native host-side bigint field + short-Weierstrass curve ops.
 *
 * This is the framework's native analog of the arkworks ark-ff/ark-ec
 * host arithmetic the reference delegates to (SURVEY.md section 2.3):
 * generic N-limb Montgomery prime fields (up to 768 bits, covering
 * BLS12-381/377 Fp, Fr, and BW6-761), degree-1/2 extensions, and
 * Jacobian scalar multiplication / Pippenger MSM over y^2 = x^3 + b
 * curves (G1 over Fp, G2 over Fp2).
 *
 * The device (GPU) compute path lives in ripp_tpu_torch/ops as PyTorch/CUDA
 * kernels; this library serves the *host* side: fixture generation,
 * verifier single-point ops, and ground-truth cross-checks, replacing
 * pure-Python bigint loops. Exposed via ctypes (ripp_tpu_torch/native/
 * hostmath.py); everything here has a pure-Python fallback.
 *
 * Conventions:
 *   - limbs are uint64, little-endian, NL limbs per base-field element
 *   - an extension element of degree d is d consecutive base elements
 *   - all exported I/O is in PLAIN (non-Montgomery) canonical form;
 *     Montgomery form is internal only
 *   - points are affine (x, y, inf_flag) at the ABI; Jacobian inside
 */

#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define MAX_NL 12   /* 768 bits */
#define MAX_DEG 2
#define MAX_EL (MAX_NL * MAX_DEG)

typedef struct {
    int nl;
    u64 p[MAX_NL];
    u64 inv;           /* -p^{-1} mod 2^64 */
    u64 r2[MAX_NL];    /* R^2 mod p, R = 2^(64*nl) */
    u64 one_m[MAX_NL]; /* R mod p (Montgomery 1) */
} FpCtx;

/* ---------------- base field ---------------- */

static int fp_cmp(const FpCtx *c, const u64 *a, const u64 *b) {
    for (int i = c->nl - 1; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static void fp_zero(const FpCtx *c, u64 *a) {
    memset(a, 0, (size_t)c->nl * 8);
}

static int fp_is_zero(const FpCtx *c, const u64 *a) {
    for (int i = 0; i < c->nl; i++)
        if (a[i]) return 0;
    return 1;
}

/* a + b, returns carry */
static u64 raw_add(int nl, const u64 *a, const u64 *b, u64 *out) {
    u128 t = 0;
    for (int i = 0; i < nl; i++) {
        t += (u128)a[i] + b[i];
        out[i] = (u64)t;
        t >>= 64;
    }
    return (u64)t;
}

/* a - b, returns borrow */
static u64 raw_sub(int nl, const u64 *a, const u64 *b, u64 *out) {
    u128 borrow = 0;
    for (int i = 0; i < nl; i++) {
        u128 t = (u128)a[i] - b[i] - (u64)borrow;
        out[i] = (u64)t;
        borrow = (t >> 64) ? 1 : 0;
    }
    return (u64)borrow;
}

static void fp_add(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    u64 carry = raw_add(c->nl, a, b, out);
    if (carry || fp_cmp(c, out, c->p) >= 0) {
        u64 tmp[MAX_NL];
        raw_sub(c->nl, out, c->p, tmp);
        memcpy(out, tmp, (size_t)c->nl * 8);
    }
}

static void fp_sub(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    u64 borrow = raw_sub(c->nl, a, b, out);
    if (borrow) {
        u64 tmp[MAX_NL];
        raw_add(c->nl, out, c->p, tmp);
        memcpy(out, tmp, (size_t)c->nl * 8);
    }
}

static void fp_neg(const FpCtx *c, const u64 *a, u64 *out) {
    if (fp_is_zero(c, a)) {
        fp_zero(c, out);
    } else {
        raw_sub(c->nl, c->p, a, out);
    }
}

/* CIOS Montgomery multiplication: out = a*b*R^{-1} mod p */
static void mont_mul(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    int nl = c->nl;
    u64 t[MAX_NL + 2];
    memset(t, 0, sizeof(u64) * (size_t)(nl + 2));
    for (int i = 0; i < nl; i++) {
        u128 carry = 0;
        for (int j = 0; j < nl; j++) {
            carry += (u128)t[j] + (u128)a[j] * b[i];
            t[j] = (u64)carry;
            carry >>= 64;
        }
        carry += t[nl];
        t[nl] = (u64)carry;
        t[nl + 1] = (u64)(carry >> 64);

        u64 m = t[0] * c->inv;
        carry = (u128)t[0] + (u128)m * c->p[0];
        carry >>= 64;
        for (int j = 1; j < nl; j++) {
            carry += (u128)t[j] + (u128)m * c->p[j];
            t[j - 1] = (u64)carry;
            carry >>= 64;
        }
        carry += t[nl];
        t[nl - 1] = (u64)carry;
        t[nl] = t[nl + 1] + (u64)(carry >> 64);
    }
    if (t[nl] || fp_cmp(c, t, c->p) >= 0) {
        u64 tmp[MAX_NL];
        raw_sub(nl, t, c->p, tmp);
        memcpy(out, tmp, (size_t)nl * 8);
    } else {
        memcpy(out, t, (size_t)nl * 8);
    }
}

static void to_mont(const FpCtx *c, const u64 *a, u64 *out) {
    mont_mul(c, a, c->r2, out);
}

static void from_mont(const FpCtx *c, const u64 *a, u64 *out) {
    u64 one[MAX_NL];
    fp_zero(c, one);
    one[0] = 1;
    mont_mul(c, a, one, out);
}

/* Montgomery-domain exponentiation: out = a^e (a, out in Montgomery form),
 * e is a plain bigint of e_nl limbs. */
static void mont_pow(const FpCtx *c, const u64 *a, const u64 *e, int e_nl,
                     u64 *out) {
    u64 base[MAX_NL], acc[MAX_NL];
    memcpy(base, a, (size_t)c->nl * 8);
    memcpy(acc, c->one_m, (size_t)c->nl * 8);
    int topbit = -1;
    for (int i = e_nl * 64 - 1; i >= 0; i--) {
        if ((e[i / 64] >> (i % 64)) & 1) { topbit = i; break; }
    }
    for (int i = topbit; i >= 0; i--) {
        mont_mul(c, acc, acc, acc);
        if ((e[i / 64] >> (i % 64)) & 1)
            mont_mul(c, acc, base, acc);
    }
    memcpy(out, acc, (size_t)c->nl * 8);
}

/* a^{-1} = a^{p-2} (p prime), Montgomery domain in/out */
static void mont_inv(const FpCtx *c, const u64 *a, u64 *out) {
    u64 e[MAX_NL];
    u64 two[MAX_NL];
    fp_zero(c, two);
    two[0] = 2;
    raw_sub(c->nl, c->p, two, e);
    mont_pow(c, a, e, c->nl, out);
}

/* ---------------- context setup ---------------- */

int hm_ctx_init(FpCtx *c, int nl, const u64 *p) {
    if (nl < 1 || nl > MAX_NL || !(p[0] & 1)) return -1;
    memset(c, 0, sizeof(*c));
    c->nl = nl;
    memcpy(c->p, p, (size_t)nl * 8);
    /* inv = -p^{-1} mod 2^64 by Newton iteration */
    u64 pinv = p[0];             /* correct mod 2^3 */
    for (int i = 0; i < 6; i++)  /* doubles precision each step */
        pinv *= 2 - p[0] * pinv;
    c->inv = (u64)(0 - pinv);
    /* one_m = R mod p: start from p's complement trick — compute
     * 2^(64*nl) mod p by repeated doubling of 1 */
    u64 acc[MAX_NL];
    fp_zero(c, acc);
    acc[0] = 1;
    /* reduce 1 into [0,p): p > 1 always, fine */
    for (int i = 0; i < 64 * nl; i++) fp_add(c, acc, acc, acc);
    memcpy(c->one_m, acc, (size_t)nl * 8);
    /* r2 = R^2 mod p: double one_m another 64*nl times */
    for (int i = 0; i < 64 * nl; i++) fp_add(c, acc, acc, acc);
    memcpy(c->r2, acc, (size_t)nl * 8);
    return 0;
}

int hm_ctx_size(void) { return (int)sizeof(FpCtx); }

/* ---------------- exported plain-form field ops ---------------- */

void hm_fp_mul(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    u64 am[MAX_NL];
    to_mont(c, a, am);
    mont_mul(c, am, b, out); /* (aR)*b*R^{-1} = a*b */
}

void hm_fp_add(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    fp_add(c, a, b, out);
}

void hm_fp_sub(const FpCtx *c, const u64 *a, const u64 *b, u64 *out) {
    fp_sub(c, a, b, out);
}

void hm_fp_pow(const FpCtx *c, const u64 *a, const u64 *e, int e_nl,
               u64 *out) {
    u64 am[MAX_NL], rm[MAX_NL];
    to_mont(c, a, am);
    mont_pow(c, am, e, e_nl, rm);
    from_mont(c, rm, out);
}

void hm_fp_inv(const FpCtx *c, const u64 *a, u64 *out) {
    u64 am[MAX_NL], rm[MAX_NL];
    to_mont(c, a, am);
    mont_inv(c, am, rm);
    from_mont(c, rm, out);
}

/* Batch inversion (Montgomery trick), plain form, n elements of nl limbs.
 * Zero inputs map to zero outputs (matching the Python host model). */
void hm_fp_batch_inv(const FpCtx *c, const u64 *xs, long n, u64 *out) {
    int nl = c->nl;
    /* prefix products over nonzero entries, Montgomery domain */
    u64 *pref = out; /* reuse out as scratch for prefixes */
    u64 acc[MAX_NL], tmp[MAX_NL];
    memcpy(acc, c->one_m, (size_t)nl * 8);
    for (long i = 0; i < n; i++) {
        memcpy(&pref[i * nl], acc, (size_t)nl * 8);
        if (!fp_is_zero(c, &xs[i * nl])) {
            to_mont(c, &xs[i * nl], tmp);
            mont_mul(c, acc, tmp, acc);
        }
    }
    u64 inv_all[MAX_NL];
    mont_inv(c, acc, inv_all);
    for (long i = n - 1; i >= 0; i--) {
        if (fp_is_zero(c, &xs[i * nl])) {
            fp_zero(c, &out[i * nl]);
        } else {
            u64 xm[MAX_NL], r[MAX_NL];
            to_mont(c, &xs[i * nl], xm);
            /* inv(x_i) = pref_i * inv_all ; then peel x_i off inv_all */
            mont_mul(c, &pref[i * nl], inv_all, r);
            mont_mul(c, inv_all, xm, inv_all);
            from_mont(c, r, &out[i * nl]);
        }
    }
}

/* ---------------- extension field (degree 1 or 2) ----------------
 * Degree-2: elements a0 + a1*u with u^2 = beta (beta in Montgomery
 * form, stored in the ExtCtx). All ext ops are Montgomery-domain.
 */

typedef struct {
    const FpCtx *fp;
    int deg;
    u64 beta[MAX_NL]; /* Montgomery form; unused for deg 1 */
} ExtCtx;

static void ext_add(const ExtCtx *e, const u64 *a, const u64 *b, u64 *out) {
    for (int k = 0; k < e->deg; k++)
        fp_add(e->fp, a + k * e->fp->nl, b + k * e->fp->nl,
               out + k * e->fp->nl);
}

static void ext_sub(const ExtCtx *e, const u64 *a, const u64 *b, u64 *out) {
    for (int k = 0; k < e->deg; k++)
        fp_sub(e->fp, a + k * e->fp->nl, b + k * e->fp->nl,
               out + k * e->fp->nl);
}

static int ext_is_zero(const ExtCtx *e, const u64 *a) {
    for (int k = 0; k < e->deg; k++)
        if (!fp_is_zero(e->fp, a + k * e->fp->nl)) return 0;
    return 1;
}

static void ext_mul(const ExtCtx *e, const u64 *a, const u64 *b, u64 *out) {
    const FpCtx *c = e->fp;
    int nl = c->nl;
    if (e->deg == 1) {
        mont_mul(c, a, b, out);
        return;
    }
    /* (a0 + a1 u)(b0 + b1 u) = a0b0 + beta a1b1 + (a0b1 + a1b0) u */
    u64 t0[MAX_NL], t1[MAX_NL], t2[MAX_NL], t3[MAX_NL];
    mont_mul(c, a, b, t0);                     /* a0b0 */
    mont_mul(c, a + nl, b + nl, t1);           /* a1b1 */
    mont_mul(c, a, b + nl, t2);                /* a0b1 */
    mont_mul(c, a + nl, b, t3);                /* a1b0 */
    u64 bt[MAX_NL];
    mont_mul(c, t1, e->beta, bt);
    fp_add(c, t0, bt, out);
    fp_add(c, t2, t3, out + nl);
}

static void ext_sqr(const ExtCtx *e, const u64 *a, u64 *out) {
    ext_mul(e, a, a, out);
}

static void ext_inv(const ExtCtx *e, const u64 *a, u64 *out) {
    const FpCtx *c = e->fp;
    int nl = c->nl;
    if (e->deg == 1) {
        mont_inv(c, a, out);
        return;
    }
    /* (a0 + a1 u)^{-1} = (a0 - a1 u) / (a0^2 - beta a1^2) */
    u64 n0[MAX_NL], n1[MAX_NL], d[MAX_NL], di[MAX_NL];
    mont_mul(c, a, a, n0);
    mont_mul(c, a + nl, a + nl, n1);
    mont_mul(c, n1, e->beta, n1);
    fp_sub(c, n0, n1, d);
    mont_inv(c, d, di);
    mont_mul(c, a, di, out);
    u64 neg[MAX_NL];
    fp_neg(c, a + nl, neg);
    mont_mul(c, neg, di, out + nl);
}

/* small-int multiple via repeated additions (n <= 8 here) */
static void ext_mul_small(const ExtCtx *e, const u64 *a, int n, u64 *out) {
    u64 acc[MAX_EL];
    int bytes = e->deg * e->fp->nl * 8;
    memset(acc, 0, (size_t)bytes);
    for (int i = 0; i < n; i++) ext_add(e, acc, a, acc);
    memcpy(out, acc, (size_t)bytes);
}

/* ---------------- Jacobian curve ops (y^2 = x^3 + b) ----------------
 * Point = (X, Y, Z) with x = X/Z^2, y = Y/Z^3; identity <=> Z == 0.
 * Formulas: standard Jacobian dbl-2009-l and add-2007-bl (EFD), valid
 * for a = 0 curves; host-side, so branches are fine.
 */

typedef struct {
    ExtCtx ext;
    u64 b[MAX_EL]; /* Montgomery form */
} CurveCtx;

typedef struct {
    u64 X[MAX_EL], Y[MAX_EL], Z[MAX_EL];
} JPoint;

static void jp_set_identity(const CurveCtx *cv, JPoint *p) {
    int bytes = cv->ext.deg * cv->ext.fp->nl * 8;
    memset(p, 0, sizeof(*p));
    /* X = Y = mont 1, Z = 0 (arbitrary valid identity encoding) */
    for (int k = 0; k < 1; k++) {
        memcpy(p->X, cv->ext.fp->one_m, (size_t)cv->ext.fp->nl * 8);
        memcpy(p->Y, cv->ext.fp->one_m, (size_t)cv->ext.fp->nl * 8);
    }
    (void)bytes;
}

static int jp_is_identity(const CurveCtx *cv, const JPoint *p) {
    return ext_is_zero(&cv->ext, p->Z);
}

static void jp_double(const CurveCtx *cv, const JPoint *p, JPoint *out) {
    const ExtCtx *e = &cv->ext;
    if (jp_is_identity(cv, p) || ext_is_zero(e, p->Y)) {
        jp_set_identity(cv, out);
        return;
    }
    u64 A[MAX_EL], B[MAX_EL], C[MAX_EL], D[MAX_EL], E8[MAX_EL], F[MAX_EL];
    u64 t[MAX_EL], t2[MAX_EL], Z3[MAX_EL];
    /* Z3 = 2*Y*Z first: out may alias p and Y3 is written before Z3 */
    ext_mul(e, p->Y, p->Z, Z3);
    ext_add(e, Z3, Z3, Z3);
    /* A = X^2, B = Y^2, C = B^2 */
    ext_sqr(e, p->X, A);
    ext_sqr(e, p->Y, B);
    ext_sqr(e, B, C);
    /* D = 2*((X+B)^2 - A - C) */
    ext_add(e, p->X, B, t);
    ext_sqr(e, t, t);
    ext_sub(e, t, A, t);
    ext_sub(e, t, C, t);
    ext_add(e, t, t, D);
    /* E = 3A, F = E^2 */
    ext_add(e, A, A, t2);
    ext_add(e, t2, A, E8);
    ext_sqr(e, E8, F);
    /* X3 = F - 2D */
    ext_add(e, D, D, t);
    ext_sub(e, F, t, out->X);
    /* Y3 = E*(D - X3) - 8C */
    ext_sub(e, D, out->X, t);
    ext_mul(e, E8, t, t);
    ext_mul_small(e, C, 8, t2);
    ext_sub(e, t, t2, out->Y);
    memcpy(out->Z, Z3, (size_t)(e->deg * e->fp->nl) * 8);
}

static void jp_add(const CurveCtx *cv, const JPoint *p, const JPoint *q,
                   JPoint *out) {
    const ExtCtx *e = &cv->ext;
    if (jp_is_identity(cv, p)) { *out = *q; return; }
    if (jp_is_identity(cv, q)) { *out = *p; return; }
    u64 Z1Z1[MAX_EL], Z2Z2[MAX_EL], U1[MAX_EL], U2[MAX_EL];
    u64 S1[MAX_EL], S2[MAX_EL], H[MAX_EL], I[MAX_EL], J[MAX_EL];
    u64 r[MAX_EL], V[MAX_EL], t[MAX_EL], t2[MAX_EL];
    ext_sqr(e, p->Z, Z1Z1);
    ext_sqr(e, q->Z, Z2Z2);
    ext_mul(e, p->X, Z2Z2, U1);
    ext_mul(e, q->X, Z1Z1, U2);
    ext_mul(e, p->Y, q->Z, t);
    ext_mul(e, t, Z2Z2, S1);
    ext_mul(e, q->Y, p->Z, t);
    ext_mul(e, t, Z1Z1, S2);
    ext_sub(e, U2, U1, H);
    ext_sub(e, S2, S1, r);
    if (ext_is_zero(e, H)) {
        if (ext_is_zero(e, r)) { jp_double(cv, p, out); return; }
        jp_set_identity(cv, out);
        return;
    }
    /* I = (2H)^2, J = H*I, r = 2(S2-S1), V = U1*I */
    ext_add(e, H, H, t);
    ext_sqr(e, t, I);
    ext_mul(e, H, I, J);
    ext_add(e, r, r, r);
    ext_mul(e, U1, I, V);
    /* X3 = r^2 - J - 2V */
    ext_sqr(e, r, t);
    ext_sub(e, t, J, t);
    ext_add(e, V, V, t2);
    ext_sub(e, t, t2, out->X);
    /* Y3 = r*(V - X3) - 2*S1*J */
    ext_sub(e, V, out->X, t);
    ext_mul(e, r, t, t);
    ext_mul(e, S1, J, t2);
    ext_add(e, t2, t2, t2);
    ext_sub(e, t, t2, out->Y);
    /* Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H */
    ext_add(e, p->Z, q->Z, t);
    ext_sqr(e, t, t);
    ext_sub(e, t, Z1Z1, t);
    ext_sub(e, t, Z2Z2, t);
    ext_mul(e, t, H, out->Z);
}

static void jp_from_affine(const CurveCtx *cv, const u64 *x, const u64 *y,
                           int inf, JPoint *out) {
    const ExtCtx *e = &cv->ext;
    const FpCtx *c = e->fp;
    int nl = c->nl;
    if (inf) { jp_set_identity(cv, out); return; }
    for (int k = 0; k < e->deg; k++) {
        to_mont(c, x + k * nl, out->X + k * nl);
        to_mont(c, y + k * nl, out->Y + k * nl);
        fp_zero(c, out->Z + k * nl);
    }
    memcpy(out->Z, c->one_m, (size_t)nl * 8); /* Z = 1 (mont) */
}

static void jp_to_affine(const CurveCtx *cv, const JPoint *p, u64 *x,
                         u64 *y, int *inf) {
    const ExtCtx *e = &cv->ext;
    const FpCtx *c = e->fp;
    int nl = c->nl;
    int bytes = e->deg * nl * 8;
    if (jp_is_identity(cv, p)) {
        *inf = 1;
        memset(x, 0, (size_t)bytes);
        memset(y, 0, (size_t)bytes);
        return;
    }
    *inf = 0;
    u64 zi[MAX_EL], zi2[MAX_EL], zi3[MAX_EL], xm[MAX_EL], ym[MAX_EL];
    ext_inv(e, p->Z, zi);
    ext_sqr(e, zi, zi2);
    ext_mul(e, zi2, zi, zi3);
    ext_mul(e, p->X, zi2, xm);
    ext_mul(e, p->Y, zi3, ym);
    for (int k = 0; k < e->deg; k++) {
        from_mont(c, xm + k * nl, x + k * nl);
        from_mont(c, ym + k * nl, y + k * nl);
    }
}

static void jp_scalar_mul(const CurveCtx *cv, const JPoint *p, const u64 *k,
                          int k_nl, JPoint *out) {
    JPoint acc;
    jp_set_identity(cv, &acc);
    int top = -1;
    for (int i = k_nl * 64 - 1; i >= 0; i--)
        if ((k[i / 64] >> (i % 64)) & 1) { top = i; break; }
    for (int i = top; i >= 0; i--) {
        jp_double(cv, &acc, &acc);
        if ((k[i / 64] >> (i % 64)) & 1)
            jp_add(cv, &acc, p, &acc);
    }
    *out = acc;
}

/* ---------------- exported curve API ----------------
 * A curve is described per-call by (fp_ctx, deg, beta_plain, unused b):
 * the group law above never uses b, so it isn't passed.
 * Element layout: deg*nl limbs. Points: x, y buffers + int inf flag.
 */

static void make_curve(const FpCtx *c, int deg, const u64 *beta_plain,
                       CurveCtx *cv) {
    cv->ext.fp = c;
    cv->ext.deg = deg;
    if (deg == 2)
        to_mont(c, beta_plain, cv->ext.beta);
}

void hm_sw_scalar_mul(const FpCtx *c, int deg, const u64 *beta,
                      const u64 *x, const u64 *y, int inf,
                      const u64 *k, int k_nl,
                      u64 *ox, u64 *oy, int *oinf) {
    CurveCtx cv;
    make_curve(c, deg, beta, &cv);
    JPoint p, r;
    jp_from_affine(&cv, x, y, inf, &p);
    jp_scalar_mul(&cv, &p, k, k_nl, &r);
    jp_to_affine(&cv, &r, ox, oy, oinf);
}

/* n independent scalar muls of the SAME base point (fixture generation:
 * gen * k_i). xs/ys are n outputs; ks is n scalars of k_nl limbs. */
void hm_sw_scalar_mul_batch(const FpCtx *c, int deg, const u64 *beta,
                            const u64 *x, const u64 *y, int inf,
                            const u64 *ks, int k_nl, long n,
                            u64 *oxs, u64 *oys, int *oinfs) {
    CurveCtx cv;
    make_curve(c, deg, beta, &cv);
    JPoint p;
    jp_from_affine(&cv, x, y, inf, &p);
    int el = deg * c->nl;
    for (long i = 0; i < n; i++) {
        JPoint r;
        jp_scalar_mul(&cv, &p, ks + i * (long)k_nl, k_nl, &r);
        jp_to_affine(&cv, &r, oxs + i * el, oys + i * el, &oinfs[i]);
    }
}

/* Pippenger MSM: out = sum_i k_i * P_i. Window chosen from n. */
void hm_sw_msm(const FpCtx *c, int deg, const u64 *beta,
               const u64 *xs, const u64 *ys, const int *infs,
               const u64 *ks, int k_nl, long n,
               u64 *ox, u64 *oy, int *oinf) {
    CurveCtx cv;
    make_curve(c, deg, beta, &cv);
    int el = deg * c->nl;
    int w = 4;
    if (n >= 32) w = 8;
    if (n >= 4096) w = 12;
    int nbits = k_nl * 64;
    int nwin = (nbits + w - 1) / w;
    long nbuckets = (1L << w) - 1;
    JPoint *buckets = (JPoint *)__builtin_malloc(
        sizeof(JPoint) * (size_t)nbuckets);
    JPoint total;
    jp_set_identity(&cv, &total);
    for (int win = nwin - 1; win >= 0; win--) {
        for (long j = 0; j < nbuckets; j++)
            jp_set_identity(&cv, &buckets[j]);
        for (long i = 0; i < n; i++) {
            if (infs[i]) continue;
            int lo = win * w;
            u64 digit = 0;
            for (int b = w - 1; b >= 0; b--) {
                int bit = lo + b;
                digit <<= 1;
                if (bit < nbits)
                    digit |= (ks[i * (long)k_nl + bit / 64] >> (bit % 64)) & 1;
            }
            if (!digit) continue;
            JPoint p;
            jp_from_affine(&cv, xs + i * el, ys + i * el, 0, &p);
            jp_add(&cv, &buckets[digit - 1], &p, &buckets[digit - 1]);
        }
        /* windows: total = total*2^w + sum_j j*bucket_j (suffix sums) */
        if (win != nwin - 1) {
            for (int b = 0; b < w; b++) jp_double(&cv, &total, &total);
        }
        JPoint run, sum;
        jp_set_identity(&cv, &run);
        jp_set_identity(&cv, &sum);
        for (long j = nbuckets - 1; j >= 0; j--) {
            jp_add(&cv, &run, &buckets[j], &run);
            jp_add(&cv, &sum, &run, &sum);
        }
        jp_add(&cv, &total, &sum, &total);
    }
    __builtin_free(buckets);
    jp_to_affine(&cv, &total, ox, oy, oinf);
}
