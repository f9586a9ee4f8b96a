/* Native host-side BLS12-381 G1 backend.
 *
 * Role in the framework: the host "L0" curve backend — the analog of the
 * reference's py_arkworks_bls12381 Rust/PyO3 wheel
 * (reference curdleproofs/py_arkworks_bls12381-stubs/__init__.pyi:5-54).
 * The device engines (curdleproofs_jax/ops/*) own throughput-critical
 * large MSMs; this module owns latency-critical small batches (protocol
 * glue at ell=124 scale, window combines, serde, test oracles) where a
 * device dispatch round-trip costs more than the whole computation.
 *
 * Arithmetic: 6x64-bit-limb Montgomery representation for Fq (CIOS
 * multiplication with unsigned __int128 accumulators), Jacobian
 * coordinates for G1, 4-bit-window scalar multiplication, Pippenger MSM
 * with per-size window choice, batched point compression/decompression
 * (sqrt via a^((p+1)/4), p = 3 mod 4).
 *
 * External byte formats match curdleproofs_jax.curve: affine points are
 * 96 bytes (x || y, each 48-byte big-endian canonical) plus a 1-byte
 * infinity flag; scalars are 32-byte little-endian canonical integers
 * (< r); compressed points are the 48-byte ZCash encoding.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

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
/* group order r as a scalar (for subgroup checks) */
static const u64 FR_ORDER[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                                0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

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
 * Python oracle in curdleproofs_jax/curve.py:_jdbl */
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
 * add-2007-bl, mirrors curdleproofs_jax/curve.py:_jadd */
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
 * via Babai rounding c1 = floor((k*(lambda+1) + r/2) / r) (Barrett, shift
 * 2^640, one correction step) — the same construction as the numpy
 * decomposition (curdleproofs_jax/ops/glv.py:decompose). */

static const fp FP_BETA_M = {{0xcd03c9e48671f071ULL, 0x5dab22461fcda5d2ULL,
                              0x587042afd3851b95ULL, 0x8eb60ebe01bacb9eULL,
                              0x03f97d6e83d050d2ULL, 0x18f0206554638741ULL}};
static const u64 GLV_M[7] = {0xdb7b86bbf1d4d267ULL, 0x101613ce4457858fULL,
                             0x42737a020c0d6393ULL, 0x65043eb4be4bad71ULL,
                             0x38b5dcb707e08ed3ULL, 0x355094edfede377cULL,
                             0x0000000000000002ULL};
static const u64 GLV_LAMP1[2] = {0x0000000100000000ULL, 0xac45a4010001a402ULL};
static const u64 GLV_LAM[2] = {0x00000000ffffffffULL, 0xac45a4010001a402ULL};
static const u64 GLV_HALF_R[4] = {0x7fffffff80000000ULL, 0xa9ded2017fff2dffULL,
                                  0x199cec0404d0ec02ULL, 0x39f6d3a994cebea4ULL};

static void j_phi(jpt *r, const jpt *p) {
    fp_mul(&r->x, &p->x, &FP_BETA_M);
    r->y = p->y;
    r->z = p->z;
}

/* k (4 LE limbs, canonical < r) -> neg1, |k1| (3 limbs), k2 (3 limbs) */
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
    if (rem[4] || rem[5] || rem[6]) {
        ge = 1;
    } else {
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

static void load_scalar(u64 *k, const uint8_t *le32) {
    for (int i = 0; i < 4; i++) {
        u64 v = 0;
        for (int b = 7; b >= 0; b--) v = (v << 8) | le32[8 * i + b];
        k[i] = v;
    }
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

/* ------------------------------------------------------ Python module */

static PyObject *value_error(const char *msg) {
    PyErr_SetString(PyExc_ValueError, msg);
    return NULL;
}

/* msm(points96, inf_flags, scalars32_le) -> (out96, out_inf:int) */
static PyObject *py_msm(PyObject *self, PyObject *args) {
    Py_buffer bp, bi, bs;
    if (!PyArg_ParseTuple(args, "y*y*y*", &bp, &bi, &bs)) return NULL;
    size_t n = (size_t)bi.len;
    if ((size_t)bp.len != 96 * n || (size_t)bs.len != 32 * n) {
        PyBuffer_Release(&bp); PyBuffer_Release(&bi); PyBuffer_Release(&bs);
        return value_error("msm: buffer length mismatch");
    }
    jpt *pts = (jpt *)malloc(n * sizeof(jpt) > 0 ? n * sizeof(jpt) : 1);
    u64 *scs = (u64 *)malloc(n * 32 > 0 ? n * 32 : 1);
    const uint8_t *pb = (const uint8_t *)bp.buf;
    const uint8_t *ib = (const uint8_t *)bi.buf;
    const uint8_t *sb = (const uint8_t *)bs.buf;
    jpt out;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        load_affine(&pts[i], pb + 96 * i, ib[i]);
        load_scalar(&scs[4 * i], sb + 32 * i);
    }
    msm_jpts(&out, pts, scs, n);
    Py_END_ALLOW_THREADS
    free(pts); free(scs);
    PyBuffer_Release(&bp); PyBuffer_Release(&bi); PyBuffer_Release(&bs);
    uint8_t o96[96], oinf;
    store_affine(o96, &oinf, &out);
    return Py_BuildValue("(y#i)", (char *)o96, (Py_ssize_t)96, (int)oinf);
}

/* mul_batch(points96, inf, scalars32) -> (out96*n, inf*n): out[i]=P_i*s_i */
static PyObject *py_mul_batch(PyObject *self, PyObject *args) {
    Py_buffer bp, bi, bs;
    if (!PyArg_ParseTuple(args, "y*y*y*", &bp, &bi, &bs)) return NULL;
    size_t n = (size_t)bi.len;
    if ((size_t)bp.len != 96 * n || (size_t)bs.len != 32 * n) {
        PyBuffer_Release(&bp); PyBuffer_Release(&bi); PyBuffer_Release(&bs);
        return value_error("mul_batch: buffer length mismatch");
    }
    PyObject *outp = PyBytes_FromStringAndSize(NULL, 96 * n);
    PyObject *outi = PyBytes_FromStringAndSize(NULL, n);
    if (!outp || !outi) { Py_XDECREF(outp); Py_XDECREF(outi); return NULL; }
    uint8_t *op = (uint8_t *)PyBytes_AS_STRING(outp);
    uint8_t *oi = (uint8_t *)PyBytes_AS_STRING(outi);
    const uint8_t *pb = (const uint8_t *)bp.buf;
    const uint8_t *ib = (const uint8_t *)bi.buf;
    const uint8_t *sb = (const uint8_t *)bs.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        jpt p, r;
        u64 k[4], k1[3], k2[3];
        int neg1;
        load_affine(&p, pb + 96 * i, ib[i]);
        load_scalar(k, sb + 32 * i);
        glv_decompose(k, &neg1, k1, k2);
        j_mul_glv(&r, &p, neg1, k1, k2);
        store_affine(op + 96 * i, &oi[i], &r);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bp); PyBuffer_Release(&bi); PyBuffer_Release(&bs);
    return Py_BuildValue("(NN)", outp, outi);
}

/* add_batch(a96, ainf, b96, binf) -> (out96*n, inf*n) */
static PyObject *py_add_batch(PyObject *self, PyObject *args) {
    Py_buffer ba, bai, bb, bbi;
    if (!PyArg_ParseTuple(args, "y*y*y*y*", &ba, &bai, &bb, &bbi)) return NULL;
    size_t n = (size_t)bai.len;
    if ((size_t)ba.len != 96 * n || (size_t)bb.len != 96 * n || (size_t)bbi.len != n) {
        PyBuffer_Release(&ba); PyBuffer_Release(&bai); PyBuffer_Release(&bb); PyBuffer_Release(&bbi);
        return value_error("add_batch: buffer length mismatch");
    }
    PyObject *outp = PyBytes_FromStringAndSize(NULL, 96 * n);
    PyObject *outi = PyBytes_FromStringAndSize(NULL, n);
    if (!outp || !outi) { Py_XDECREF(outp); Py_XDECREF(outi); return NULL; }
    uint8_t *op = (uint8_t *)PyBytes_AS_STRING(outp);
    uint8_t *oi = (uint8_t *)PyBytes_AS_STRING(outi);
    const uint8_t *ab = (const uint8_t *)ba.buf, *aib = (const uint8_t *)bai.buf;
    const uint8_t *bbuf = (const uint8_t *)bb.buf, *bib = (const uint8_t *)bbi.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        jpt p, q, r;
        load_affine(&p, ab + 96 * i, aib[i]);
        load_affine(&q, bbuf + 96 * i, bib[i]);
        j_add(&r, &p, &q);
        store_affine(op + 96 * i, &oi[i], &r);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&ba); PyBuffer_Release(&bai); PyBuffer_Release(&bb); PyBuffer_Release(&bbi);
    return Py_BuildValue("(NN)", outp, outi);
}

/* sum(points96, inf) -> (out96, inf:int) */
static PyObject *py_sum(PyObject *self, PyObject *args) {
    Py_buffer bp, bi;
    if (!PyArg_ParseTuple(args, "y*y*", &bp, &bi)) return NULL;
    size_t n = (size_t)bi.len;
    if ((size_t)bp.len != 96 * n) {
        PyBuffer_Release(&bp); PyBuffer_Release(&bi);
        return value_error("sum: buffer length mismatch");
    }
    const uint8_t *pb = (const uint8_t *)bp.buf;
    const uint8_t *ib = (const uint8_t *)bi.buf;
    jpt acc;
    Py_BEGIN_ALLOW_THREADS
    acc = JINF;
    for (size_t i = 0; i < n; i++) {
        jpt p;
        load_affine(&p, pb + 96 * i, ib[i]);
        j_add(&acc, &acc, &p);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bp); PyBuffer_Release(&bi);
    uint8_t o96[96], oinf;
    store_affine(o96, &oinf, &acc);
    return Py_BuildValue("(y#i)", (char *)o96, (Py_ssize_t)96, (int)oinf);
}

/* linear_combine(points96, inf, scalars32) one mul per point then running
 * sum — same as msm but returns each partial? No: msm covers it. */

/* decompress_batch(comp48*n, check:int) -> (out96*n, inf*n); raises on bad */
static PyObject *py_decompress_batch(PyObject *self, PyObject *args) {
    Py_buffer bc;
    int check;
    if (!PyArg_ParseTuple(args, "y*i", &bc, &check)) return NULL;
    if (bc.len % 48 != 0) {
        PyBuffer_Release(&bc);
        return value_error("decompress: length not a multiple of 48");
    }
    size_t n = (size_t)bc.len / 48;
    PyObject *outp = PyBytes_FromStringAndSize(NULL, 96 * n);
    PyObject *outi = PyBytes_FromStringAndSize(NULL, n);
    if (!outp || !outi) { Py_XDECREF(outp); Py_XDECREF(outi); return NULL; }
    uint8_t *op = (uint8_t *)PyBytes_AS_STRING(outp);
    uint8_t *oi = (uint8_t *)PyBytes_AS_STRING(outi);
    const uint8_t *cb = (const uint8_t *)bc.buf;
    long bad = -1;
    const char *why = "";
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n && bad < 0; i++) {
        const uint8_t *d = cb + 48 * i;
        uint8_t flags = d[0];
        if (!(flags & 0x80)) { bad = (long)i; why = "uncompressed G1 encodings are not supported"; break; }
        if (flags & 0x40) {
            int nz = (flags & 0x3F) != 0;
            for (int k = 1; k < 48; k++) nz |= d[k] != 0;
            if (nz) { bad = (long)i; why = "malformed infinity encoding"; break; }
            memset(op + 96 * i, 0, 96);
            oi[i] = 1;
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
        if (fp_geq(xl, FP_P.l)) { bad = (long)i; why = "x coordinate not canonical"; break; }
        fp x, x3b, y;
        fp_from_be(&x, xbe);
        fp_sqr(&x3b, &x);
        fp_mul(&x3b, &x3b, &x);
        /* + b = 4 */
        fp four;
        fp_dbl(&four, &FP_ONE);
        fp_dbl(&four, &four);
        fp_add(&x3b, &x3b, &four);
        if (!fp_sqrt(&y, &x3b)) { bad = (long)i; why = "x is not on the curve"; break; }
        int largest = fp_is_lex_largest(&y);
        if (((flags >> 5) & 1) != largest) fp_neg(&y, &y);
        if (check) {
            jpt p = {x, y, FP_ONE}, r;
            j_mul(&r, &p, FR_ORDER);
            if (!j_is_inf(&r)) { bad = (long)i; why = "point not in the prime-order subgroup"; break; }
        }
        fp_to_be(op + 96 * i, &x);
        fp_to_be(op + 96 * i + 48, &y);
        oi[i] = 0;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bc);
    if (bad >= 0) {
        Py_DECREF(outp); Py_DECREF(outi);
        PyErr_Format(PyExc_ValueError, "%s (element %ld)", why, bad);
        return NULL;
    }
    return Py_BuildValue("(NN)", outp, outi);
}

/* compress_batch(points96, inf) -> comp48*n */
static PyObject *py_compress_batch(PyObject *self, PyObject *args) {
    Py_buffer bp, bi;
    if (!PyArg_ParseTuple(args, "y*y*", &bp, &bi)) return NULL;
    size_t n = (size_t)bi.len;
    if ((size_t)bp.len != 96 * n) {
        PyBuffer_Release(&bp); PyBuffer_Release(&bi);
        return value_error("compress: buffer length mismatch");
    }
    PyObject *out = PyBytes_FromStringAndSize(NULL, 48 * n);
    if (!out) { PyBuffer_Release(&bp); PyBuffer_Release(&bi); return NULL; }
    uint8_t *ob = (uint8_t *)PyBytes_AS_STRING(out);
    const uint8_t *pb = (const uint8_t *)bp.buf;
    const uint8_t *ib = (const uint8_t *)bi.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        uint8_t *d = ob + 48 * i;
        if (ib[i]) {
            memset(d, 0, 48);
            d[0] = 0xC0;
            continue;
        }
        memcpy(d, pb + 96 * i, 48); /* x is already canonical BE */
        d[0] |= 0x80;
        fp y;
        fp_from_be(&y, pb + 96 * i + 48);
        if (fp_is_lex_largest(&y)) d[0] |= 0x20;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bp); PyBuffer_Release(&bi);
    return out;
}

/* jacobian_to_affine_batch(xyz 144*n canonical BE) -> (out96*n, inf*n) */
static PyObject *py_jac_to_affine(PyObject *self, PyObject *args) {
    Py_buffer bj;
    if (!PyArg_ParseTuple(args, "y*", &bj)) return NULL;
    if (bj.len % 144 != 0) {
        PyBuffer_Release(&bj);
        return value_error("jacobian buffer length not a multiple of 144");
    }
    size_t n = (size_t)bj.len / 144;
    PyObject *outp = PyBytes_FromStringAndSize(NULL, 96 * n);
    PyObject *outi = PyBytes_FromStringAndSize(NULL, n);
    if (!outp || !outi) { Py_XDECREF(outp); Py_XDECREF(outi); return NULL; }
    uint8_t *op = (uint8_t *)PyBytes_AS_STRING(outp);
    uint8_t *oi = (uint8_t *)PyBytes_AS_STRING(outi);
    const uint8_t *jb = (const uint8_t *)bj.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        jpt p;
        fp_from_be(&p.x, jb + 144 * i);
        fp_from_be(&p.y, jb + 144 * i + 48);
        fp_from_be(&p.z, jb + 144 * i + 96);
        store_affine(op + 96 * i, &oi[i], &p);
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bj);
    return Py_BuildValue("(NN)", outp, outi);
}

/* subgroup_check_batch(points96, inf) -> first bad index or -1 */
static PyObject *py_subgroup_check(PyObject *self, PyObject *args) {
    Py_buffer bp, bi;
    if (!PyArg_ParseTuple(args, "y*y*", &bp, &bi)) return NULL;
    size_t n = (size_t)bi.len;
    if ((size_t)bp.len != 96 * n) {
        PyBuffer_Release(&bp); PyBuffer_Release(&bi);
        return value_error("subgroup_check: buffer length mismatch");
    }
    const uint8_t *pb = (const uint8_t *)bp.buf;
    const uint8_t *ib = (const uint8_t *)bi.buf;
    long bad = -1;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        jpt p, r;
        load_affine(&p, pb + 96 * i, ib[i]);
        if (j_is_inf(&p)) continue;
        j_mul(&r, &p, FR_ORDER);
        if (!j_is_inf(&r)) { bad = (long)i; break; }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bp); PyBuffer_Release(&bi);
    return PyLong_FromLong(bad);
}


/* glv_decompose_batch(scalars32_le*n) -> (k1_24le*n, neg1_u8*n, k2_24le*n):
 * batched Babai-rounding GLV split k = (-1)^neg1*|k1| + k2*lambda (mod r);
 * |k1| < 2^130, 0 <= k2 <= lambda, each emitted as 3 LE u64 limbs. Host
 * twin of curdleproofs_jax/ops/glv.py:decompose (the numpy fallback). */
static PyObject *py_glv_decompose_batch(PyObject *self, PyObject *args) {
    Py_buffer bs;
    if (!PyArg_ParseTuple(args, "y*", &bs)) return NULL;
    if (bs.len % 32) {
        PyBuffer_Release(&bs);
        return value_error("glv_decompose_batch: buffer length % 32");
    }
    size_t n = (size_t)bs.len / 32;
    PyObject *o1 = PyBytes_FromStringAndSize(NULL, 24 * n);
    PyObject *on = PyBytes_FromStringAndSize(NULL, n);
    PyObject *o2 = PyBytes_FromStringAndSize(NULL, 24 * n);
    if (!o1 || !on || !o2) {
        Py_XDECREF(o1); Py_XDECREF(on); Py_XDECREF(o2);
        PyBuffer_Release(&bs);
        return NULL;
    }
    uint8_t *p1 = (uint8_t *)PyBytes_AS_STRING(o1);
    uint8_t *pn = (uint8_t *)PyBytes_AS_STRING(on);
    uint8_t *p2 = (uint8_t *)PyBytes_AS_STRING(o2);
    const uint8_t *sb = (const uint8_t *)bs.buf;
    Py_BEGIN_ALLOW_THREADS
    for (size_t i = 0; i < n; i++) {
        u64 k[4], k1[3], k2[3];
        int neg;
        load_scalar(k, sb + 32 * i);
        glv_decompose(k, &neg, k1, k2);
        memcpy(p1 + 24 * i, k1, 24);
        memcpy(p2 + 24 * i, k2, 24);
        pn[i] = (uint8_t)neg;
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&bs);
    PyObject *ret = Py_BuildValue("(OOO)", o1, on, o2);
    Py_DECREF(o1); Py_DECREF(on); Py_DECREF(o2);
    return ret;
}

/* ---- streaming-MSM host prep ------------------------------------------
 *
 * One call replacing the numpy chain glv.decompose -> host_digits ->
 * stream_host_prep on the stream engine's critical path
 * (curdleproofs_jax/ops/msm.py): GLV split, c-bit digit extraction over
 * the doubled [|k1| | k2] lane set, per-window stable counting sort with
 * bucket-boundary ranks read straight off the count prefix, and the
 * column-major relabel for the device scan layout. It also still emits a
 * distinct-rank boundary selection schedule, which the engine no longer
 * reads. All O(W*(n + B)) integer passes, far cheaper than the numpy
 * pipeline (argsort + searchsorted per window).
 */

/* digit w (c bits) of a 3x64-limb little-endian value */
static inline uint32_t digit_at(const u64 *k, int w, int c) {
    int b0 = w * c;
    int limb = b0 >> 6, off = b0 & 63;
    u64 v = k[limb] >> off;
    if (off + c > 64 && limb + 1 < 3) v |= k[limb + 1] << (64 - off);
    return (uint32_t)(v & ((1u << c) - 1));
}

static PyObject *py_msm_prep_batch(PyObject *self, PyObject *args) {
    Py_buffer bs;
    int c, L;
    if (!PyArg_ParseTuple(args, "y*ii", &bs, &c, &L)) return NULL;
    if (bs.len % 32) {
        PyBuffer_Release(&bs);
        return value_error("msm_prep_batch: buffer length % 32");
    }
    size_t n = (size_t)bs.len / 32, n2 = 2 * n;
    if (c < 1 || c > 16 || L <= 0 || n2 % (size_t)L) {
        PyBuffer_Release(&bs);
        return value_error("msm_prep_batch: bad c/L");
    }
    int W = (130 + c - 1) / c;
    int B = 1 << c;
    size_t T = n2 / (size_t)L;

    PyObject *on = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)n);
    PyObject *oord = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(4 * W * n2));
    PyObject *obidx =
        PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(4 * W * (B - 1)));
    PyObject *olidx =
        PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(4 * W * (B - 1)));
    uint16_t *dig = (uint16_t *)malloc(2 * (size_t)W * n2);
    int32_t *earr = (int32_t *)malloc(4 * (size_t)W * (B - 1));
    int32_t *slotc = (int32_t *)malloc(4 * T);
    if (!on || !oord || !obidx || !olidx || !dig || !earr || !slotc) {
        Py_XDECREF(on); Py_XDECREF(oord); Py_XDECREF(obidx); Py_XDECREF(olidx);
        free(dig); free(earr); free(slotc);
        PyBuffer_Release(&bs);
        return PyErr_NoMemory();
    }
    uint8_t *pn = (uint8_t *)PyBytes_AS_STRING(on);
    int32_t *ocm = (int32_t *)PyBytes_AS_STRING(oord);
    int32_t *obx = (int32_t *)PyBytes_AS_STRING(obidx);
    int32_t *olx = (int32_t *)PyBytes_AS_STRING(olidx);
    const uint8_t *sb = (const uint8_t *)bs.buf;
    int32_t maxocc = 0;

    Py_BEGIN_ALLOW_THREADS
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
        u64 k[4], k1[3], k2[3];
        int neg;
        load_scalar(k, sb + 32 * i);
        glv_decompose(k, &neg, k1, k2);
        pn[i] = (uint8_t)neg;
        for (int w = 0; w < W; w++) {
            dig[(size_t)w * n2 + i] = (uint16_t)digit_at(k1, w, c);
            dig[(size_t)w * n2 + n + i] = (uint16_t)digit_at(k2, w, c);
        }
    }
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        /* per-thread scratch (windows are independent) */
        int32_t *ord_t = (int32_t *)malloc(4 * n2);
        int32_t *cnt_t = (int32_t *)malloc(4 * (size_t)B);
        int32_t *incl_t = (int32_t *)malloc(4 * (size_t)B);
        int32_t *slotc_t = (int32_t *)malloc(4 * T);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int w = 0; w < W; w++) {
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
            /* stable counting-sort placement */
            for (size_t i = 0; i < n2; i++)
                ord_t[cnt_t[dw[i]]++] = (int32_t)i;
            /* column-major relabel (cache-blocked transpose of the (L, T)
             * rank matrix): device flat pos t*L + l = sorted rank l*T + t */
            int32_t *oc = ocm + (size_t)w * n2;
            const size_t BT = 64;
            for (size_t l0 = 0; l0 < (size_t)L; l0 += BT)
                for (size_t t0 = 0; t0 < T; t0 += BT) {
                    size_t l1 = l0 + BT < (size_t)L ? l0 + BT : (size_t)L;
                    size_t t1 = t0 + BT < T ? t0 + BT : T;
                    for (size_t l = l0; l < l1; l++)
                        for (size_t t = t0; t < t1; t++)
                            oc[t * (size_t)L + l] = ord_t[l * T + t];
                }
            /* bucket-boundary ranks + full-prefix index tables */
            int32_t *ew = earr + (size_t)w * (B - 1);
            int32_t *bw = obx + (size_t)w * (B - 1);
            int32_t *lw = olx + (size_t)w * (B - 1);
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
        free(ord_t); free(cnt_t); free(incl_t); free(slotc_t);
    }
    Py_END_ALLOW_THREADS

    /* pick the smallest selection-slot capacity that fits (0 = overflow:
     * caller falls back to the full-prefix path via bidx/lidx) */
    int S = maxocc <= 128 ? 128 : (maxocc <= 256 ? 256 : 0);
    PyObject *osel = NULL, *obpos = NULL;
    if (S) {
        osel = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(4 * W * T * S));
        obpos = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(4 * W * (B - 1)));
    } else {
        osel = PyBytes_FromStringAndSize(NULL, 0);
        obpos = PyBytes_FromStringAndSize(NULL, 0);
    }
    if (!osel || !obpos) {
        Py_DECREF(on); Py_DECREF(oord); Py_DECREF(obidx); Py_DECREF(olidx);
        Py_XDECREF(osel); Py_XDECREF(obpos);
        free(dig); free(earr); free(slotc);
        PyBuffer_Release(&bs);
        return NULL;
    }
    if (S) {
        int32_t *sel = (int32_t *)PyBytes_AS_STRING(osel);
        int32_t *bp = (int32_t *)PyBytes_AS_STRING(obpos);
        Py_BEGIN_ALLOW_THREADS
        memset(sel, 0xFF, 4 * (size_t)W * T * S); /* -1 = empty slot */
        for (int w = 0; w < W; w++) {
            const int32_t *ew = earr + (size_t)w * (B - 1);
            int32_t *bw = bp + (size_t)w * (B - 1);
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
        Py_END_ALLOW_THREADS
    }
    free(dig); free(earr); free(slotc);
    PyBuffer_Release(&bs);
    PyObject *ret = Py_BuildValue("(OOOOOOii)", on, oord, obidx, olidx, osel,
                                  obpos, S, W);
    Py_DECREF(on); Py_DECREF(oord); Py_DECREF(obidx); Py_DECREF(olidx);
    Py_DECREF(osel); Py_DECREF(obpos);
    return ret;
}

static PyMethodDef Methods[] = {
    {"msm", py_msm, METH_VARARGS,
     "msm(points96, inf_flags, scalars32_le) -> (affine96, inf)"},
    {"mul_batch", py_mul_batch, METH_VARARGS,
     "mul_batch(points96, inf, scalars32) -> (affine96*n, inf*n)"},
    {"add_batch", py_add_batch, METH_VARARGS,
     "add_batch(a96, ainf, b96, binf) -> (affine96*n, inf*n)"},
    {"sum", py_sum, METH_VARARGS, "sum(points96, inf) -> (affine96, inf)"},
    {"decompress_batch", py_decompress_batch, METH_VARARGS,
     "decompress_batch(comp48*n, check) -> (affine96*n, inf*n)"},
    {"compress_batch", py_compress_batch, METH_VARARGS,
     "compress_batch(points96, inf) -> comp48*n"},
    {"jacobian_to_affine_batch", py_jac_to_affine, METH_VARARGS,
     "jacobian_to_affine_batch(xyz144*n) -> (affine96*n, inf*n)"},
    {"subgroup_check_batch", py_subgroup_check, METH_VARARGS,
     "subgroup_check_batch(points96, inf) -> first bad index or -1"},
    {"glv_decompose_batch", py_glv_decompose_batch, METH_VARARGS,
     "glv_decompose_batch(scalars32_le) -> (k1_24le*n, neg1*n, k2_24le*n)"},
    {"msm_prep_batch", py_msm_prep_batch, METH_VARARGS,
     "msm_prep_batch(scalars32_le, c, L) -> (neg1*n, order_cm_i32[W,2n],\n"
     "bidx_i32[W,B-1], lidx_i32[W,B-1], sel_i32[W*T,S], bpos_i32[W,B-1],\n"
     "S, W) — GLV-split streaming-Pippenger host prep in one pass"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_g1_native",
    "Native BLS12-381 G1 host backend (Montgomery Fq, Jacobian G1, Pippenger MSM)",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__g1_native(void) { return PyModule_Create(&moduledef); }
