// BN254 host-side native backend: Fq Montgomery arithmetic, G1 ops,
// the Fq12 tower, and the optimal-ate pairing product.
//
// Role: halo2curves' CPU curve/pairing layer (reference Cargo.lock:
// halo2curves 0.6.1) for the VERIFIER path — proving runs on the TPU,
// but verification is O(proof size) host scalar math and a serving
// deployment verifies far more often than it proves.  The Python
// bigint implementation (backend/pairing.py, ops/curve.py py_*) stays
// as the correctness oracle; this module mirrors it operation for
// operation (same Fq12 polynomial representation x^12 - 18 x^6 + 82,
// same Miller loop structure) so the two are differentially testable.
//
// All boundary values are 4x64-bit little-endian limbs, plain (non-
// Montgomery) form; conversions happen inside.  Curve constants (q,
// Montgomery parameters, exponent bit strings) are injected once via
// bn254_init from Python bigints — nothing numeric is hardcoded, so a
// transcription bug is impossible by construction.
//
// Build: g++ -O2 -shared -fPIC (see native/__init__.py; cached by
// source hash, silent fallback to the Python path if unavailable).

#include <cstdint>
#include <cstring>

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint8_t u8;

// ---------------------------------------------------------------------------
// Fq: 4x64 Montgomery
// ---------------------------------------------------------------------------

struct Fq {
    u64 v[4];
};

static Fq Q;        // modulus
static u64 N0INV;   // -q^-1 mod 2^64
static Fq R2;       // 2^512 mod q (to-Montgomery factor)
static Fq ONE_M;    // 2^256 mod q (Montgomery one)

// exponent bit strings (msb-first), set by bn254_init
static u8 Q_M2_BITS[256];  // q - 2 (Fq inversion)
static int Q_M2_LEN;
static u8 Q_BITS[256];     // q (Frobenius x^q)
static int Q_LEN;
static u8 HARD_BITS[1024]; // (q^4 - q^2 + 1) / r (final exponentiation)
static int HARD_LEN;
static u8 ATE_BITS[80];    // 6u + 2 (Miller loop)
static int ATE_LEN;

static inline bool fq_eq(const Fq &a, const Fq &b) {
    return !memcmp(a.v, b.v, 32);
}

static inline bool fq_is_zero(const Fq &a) {
    return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

static inline int fq_cmp(const Fq &a, const Fq &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] < b.v[i]) return -1;
        if (a.v[i] > b.v[i]) return 1;
    }
    return 0;
}

static inline void fq_sub_raw(Fq &o, const Fq &a, const Fq &b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        o.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fq_add(Fq &o, const Fq &a, const Fq &b) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        o.v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || fq_cmp(o, Q) >= 0) fq_sub_raw(o, o, Q);
}

static inline void fq_sub(Fq &o, const Fq &a, const Fq &b) {
    if (fq_cmp(a, b) >= 0) {
        fq_sub_raw(o, a, b);
    } else {
        Fq t;
        fq_sub_raw(t, b, a);
        fq_sub_raw(o, Q, t);
    }
}

static inline void fq_neg(Fq &o, const Fq &a) {
    if (fq_is_zero(a)) { o = a; return; }
    fq_sub_raw(o, Q, a);
}

// CIOS Montgomery multiplication
static void fq_mul(Fq &out, const Fq &a, const Fq &b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 c = 0;
        for (int j = 0; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + c;
            t[j] = (u64)s;
            c = s >> 64;
        }
        u128 s4 = (u128)t[4] + c;
        t[4] = (u64)s4;
        t[5] = (u64)(s4 >> 64);

        u64 m = t[0] * N0INV;
        c = ((u128)t[0] + (u128)m * Q.v[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 s = (u128)t[j] + (u128)m * Q.v[j] + c;
            t[j - 1] = (u64)s;
            c = s >> 64;
        }
        u128 s4b = (u128)t[4] + c;
        t[3] = (u64)s4b;
        t[4] = t[5] + (u64)(s4b >> 64);
    }
    Fq r;
    memcpy(r.v, t, 32);
    if (t[4] || fq_cmp(r, Q) >= 0) fq_sub_raw(r, r, Q);
    out = r;
}

static inline void fq_sqr(Fq &o, const Fq &a) { fq_mul(o, a, a); }

static void fq_pow_bits(Fq &out, const Fq &base, const u8 *bits, int len) {
    Fq acc = ONE_M;
    for (int i = 0; i < len; ++i) {
        fq_sqr(acc, acc);
        if (bits[i]) fq_mul(acc, acc, base);
    }
    out = acc;
}

static inline void fq_inv(Fq &o, const Fq &a) {
    fq_pow_bits(o, a, Q_M2_BITS, Q_M2_LEN);
}

static inline void fq_to_mont(Fq &o, const Fq &plain) { fq_mul(o, plain, R2); }

static inline void fq_from_mont(Fq &o, const Fq &m) {
    Fq one_plain;
    one_plain.v[0] = 1; one_plain.v[1] = one_plain.v[2] = one_plain.v[3] = 0;
    fq_mul(o, m, one_plain);
}

static Fq fq_from_u64(u64 x) {
    Fq p;
    p.v[0] = x; p.v[1] = p.v[2] = p.v[3] = 0;
    Fq m;
    fq_to_mont(m, p);
    return m;
}

// ---------------------------------------------------------------------------
// G1 (Jacobian over Fq, Montgomery coords)
// ---------------------------------------------------------------------------

struct G1 {
    Fq x, y, z;   // z == 0 <=> infinity
};

static void g1_set_inf(G1 &p) {
    memset(&p, 0, sizeof(p));
    p.x = ONE_M;
    p.y = ONE_M;
}

static inline bool g1_is_inf(const G1 &p) { return fq_is_zero(p.z); }

static void g1_from_affine(G1 &o, const Fq &xm, const Fq &ym) {
    o.x = xm; o.y = ym; o.z = ONE_M;
}

static void g1_double(G1 &o, const G1 &p) {
    if (g1_is_inf(p)) { o = p; return; }
    Fq a, b, c, d, e, f, t;
    fq_sqr(a, p.x);                 // A = X^2
    fq_sqr(b, p.y);                 // B = Y^2
    fq_sqr(c, b);                   // C = B^2
    fq_add(d, p.x, b);
    fq_sqr(d, d);
    fq_sub(d, d, a);
    fq_sub(d, d, c);
    fq_add(d, d, d);                // D = 2((X+B)^2 - A - C)
    fq_add(e, a, a);
    fq_add(e, e, a);                // E = 3A
    fq_sqr(f, e);                   // F = E^2
    fq_sub(o.x, f, d);
    fq_sub(o.x, o.x, d);            // X3 = F - 2D
    fq_sub(t, d, o.x);
    fq_mul(t, e, t);
    Fq c8;
    fq_add(c8, c, c);
    fq_add(c8, c8, c8);
    fq_add(c8, c8, c8);             // 8C
    Fq yz;
    fq_mul(yz, p.y, p.z);
    fq_sub(o.y, t, c8);             // Y3 = E(D - X3) - 8C
    fq_add(o.z, yz, yz);            // Z3 = 2YZ
}

static void g1_add(G1 &o, const G1 &p, const G1 &q) {
    if (g1_is_inf(p)) { o = q; return; }
    if (g1_is_inf(q)) { o = p; return; }
    Fq z1z1, z2z2, u1, u2, s1, s2;
    fq_sqr(z1z1, p.z);
    fq_sqr(z2z2, q.z);
    fq_mul(u1, p.x, z2z2);
    fq_mul(u2, q.x, z1z1);
    fq_mul(s1, p.y, q.z);
    fq_mul(s1, s1, z2z2);
    fq_mul(s2, q.y, p.z);
    fq_mul(s2, s2, z1z1);
    if (fq_eq(u1, u2)) {
        if (fq_eq(s1, s2)) { g1_double(o, p); return; }
        g1_set_inf(o);
        return;
    }
    Fq h, i, j, r, v, t;
    fq_sub(h, u2, u1);
    fq_add(i, h, h);
    fq_sqr(i, i);                   // I = (2H)^2
    fq_mul(j, h, i);                // J = H*I
    fq_sub(r, s2, s1);
    fq_add(r, r, r);                // r = 2(S2-S1)
    fq_mul(v, u1, i);               // V = U1*I
    fq_sqr(o.x, r);
    fq_sub(o.x, o.x, j);
    fq_sub(o.x, o.x, v);
    fq_sub(o.x, o.x, v);            // X3 = r^2 - J - 2V
    fq_sub(t, v, o.x);
    fq_mul(t, r, t);
    Fq s1j;
    fq_mul(s1j, s1, j);
    fq_add(s1j, s1j, s1j);
    fq_sub(o.y, t, s1j);            // Y3 = r(V-X3) - 2 S1 J
    Fq zz;
    fq_add(zz, p.z, q.z);
    fq_sqr(zz, zz);
    fq_sub(zz, zz, z1z1);
    fq_sub(zz, zz, z2z2);
    fq_mul(o.z, zz, h);             // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
}

static void g1_mul_u256(G1 &o, const G1 &p, const u64 *k) {
    G1 acc;
    g1_set_inf(acc);
    G1 base = p;
    for (int limb = 0; limb < 4; ++limb) {
        for (int b = 0; b < 64; ++b) {
            if ((k[limb] >> b) & 1) g1_add(acc, acc, base);
            g1_double(base, base);
        }
    }
    o = acc;
}

static void g1_to_affine(const G1 &p, Fq &xo, Fq &yo, u8 &inf) {
    if (g1_is_inf(p)) { inf = 1; memset(&xo, 0, 32); memset(&yo, 0, 32); return; }
    inf = 0;
    Fq zi, zi2, zi3;
    fq_inv(zi, p.z);
    fq_sqr(zi2, zi);
    fq_mul(zi3, zi2, zi);
    fq_mul(xo, p.x, zi2);
    fq_mul(yo, p.y, zi3);
}

// ---------------------------------------------------------------------------
// Fq12: 12 Fq coefficients modulo x^12 - 18 x^6 + 82  (Montgomery coeffs)
// ---------------------------------------------------------------------------

struct Fq12 {
    Fq c[12];
};

static Fq12 FQ12_ONE_V;
static Fq C18, C82;
static Fq12 FROB_BASIS[12];   // image of x^i under x -> x^q

static void fq12_set_zero(Fq12 &o) { memset(&o, 0, sizeof(o)); }

static void fq12_set_one(Fq12 &o) {
    fq12_set_zero(o);
    o.c[0] = ONE_M;
}

static bool fq12_eq(const Fq12 &a, const Fq12 &b) {
    return !memcmp(&a, &b, sizeof(Fq12));
}

static void fq12_add(Fq12 &o, const Fq12 &a, const Fq12 &b) {
    for (int i = 0; i < 12; ++i) fq_add(o.c[i], a.c[i], b.c[i]);
}

static void fq12_sub(Fq12 &o, const Fq12 &a, const Fq12 &b) {
    for (int i = 0; i < 12; ++i) fq_sub(o.c[i], a.c[i], b.c[i]);
}

static void fq12_neg(Fq12 &o, const Fq12 &a) {
    for (int i = 0; i < 12; ++i) fq_neg(o.c[i], a.c[i]);
}

static void fq12_scalar(Fq12 &o, const Fq12 &a, const Fq &s) {
    for (int i = 0; i < 12; ++i) fq_mul(o.c[i], a.c[i], s);
}

static void fq12_mul(Fq12 &o, const Fq12 &a, const Fq12 &b) {
    Fq c[23];
    memset(c, 0, sizeof(c));
    Fq t;
    for (int i = 0; i < 12; ++i) {
        if (fq_is_zero(a.c[i])) continue;
        for (int j = 0; j < 12; ++j) {
            fq_mul(t, a.c[i], b.c[j]);
            fq_add(c[i + j], c[i + j], t);
        }
    }
    for (int k = 22; k > 11; --k) {
        if (fq_is_zero(c[k])) continue;
        fq_mul(t, c[k], C18);
        fq_add(c[k - 6], c[k - 6], t);
        fq_mul(t, c[k], C82);
        fq_sub(c[k - 12], c[k - 12], t);
    }
    memcpy(&o, c, sizeof(Fq12));
}

static void fq12_sqr(Fq12 &o, const Fq12 &a) { fq12_mul(o, a, a); }

static void fq12_pow_bits(Fq12 &o, const Fq12 &a, const u8 *bits, int len) {
    Fq12 acc;
    fq12_set_one(acc);
    for (int i = 0; i < len; ++i) {
        fq12_sqr(acc, acc);
        if (bits[i]) fq12_mul(acc, acc, a);
    }
    o = acc;
}

// f -> f^(q^6): negate odd coefficients
static void fq12_conj(Fq12 &o, const Fq12 &a) {
    for (int i = 0; i < 12; ++i) {
        if (i & 1) fq_neg(o.c[i], a.c[i]);
        else o.c[i] = a.c[i];
    }
}

static void fq12_frobenius(Fq12 &o, const Fq12 &a) {
    Fq12 acc, t;
    fq12_set_zero(acc);
    for (int i = 0; i < 12; ++i) {
        if (fq_is_zero(a.c[i])) continue;
        fq12_scalar(t, FROB_BASIS[i], a.c[i]);
        fq12_add(acc, acc, t);
    }
    o = acc;
}

// extended Euclid over Fq[x] modulo x^12 - 18 x^6 + 82
// (mirror of backend/pairing.py fq12_inv, itself after py_ecc — MIT)
struct Poly13 {
    Fq c[13];
};

static int poly_deg(const Poly13 &p) {
    int d = 12;
    while (d > 0 && fq_is_zero(p.c[d])) --d;
    return d;
}

static void poly_rounded_div(Poly13 &out, const Poly13 &x_in, const Poly13 &y) {
    int dx = poly_deg(x_in), dy = poly_deg(y);
    Poly13 x = x_in;
    memset(&out, 0, sizeof(out));
    Fq ydinv, t;
    fq_inv(ydinv, y.c[dy]);
    for (int i = dx - dy; i >= 0; --i) {
        fq_mul(t, x.c[dy + i], ydinv);
        fq_add(out.c[i], out.c[i], t);
        for (int cc = 0; cc <= dy; ++cc) {
            Fq u;
            fq_mul(u, out.c[i], y.c[cc]);
            fq_sub(x.c[cc + i], x.c[cc + i], u);
        }
    }
}

static void fq12_inv(Fq12 &o, const Fq12 &a) {
    Poly13 lm, hm, low, high;
    memset(&lm, 0, sizeof(lm));
    memset(&hm, 0, sizeof(hm));
    lm.c[0] = ONE_M;
    memset(&low, 0, sizeof(low));
    memcpy(low.c, a.c, sizeof(a.c));
    memset(&high, 0, sizeof(high));
    high.c[0] = C82;
    fq_neg(high.c[6], C18);
    high.c[12] = ONE_M;

    while (poly_deg(low) > 0) {
        Poly13 r;
        poly_rounded_div(r, high, low);
        Poly13 nm = hm, nw = high;
        Fq t;
        for (int i = 0; i <= 12; ++i) {
            int jm = i < 12 ? i : 12;
            for (int j = 0; j <= jm; ++j) {
                if (fq_is_zero(r.c[j])) continue;
                fq_mul(t, lm.c[i - j], r.c[j]);
                fq_sub(nm.c[i], nm.c[i], t);
                fq_mul(t, low.c[i - j], r.c[j]);
                fq_sub(nw.c[i], nw.c[i], t);
            }
        }
        hm = lm; high = low; lm = nm; low = nw;
    }
    Fq inv0;
    fq_inv(inv0, low.c[0]);
    for (int i = 0; i < 12; ++i) fq_mul(o.c[i], lm.c[i], inv0);
}

// ---------------------------------------------------------------------------
// pairing: twist embedding + Miller loop + final exponentiation
// ---------------------------------------------------------------------------

struct PtFq12 {
    Fq12 x, y;
};

// G2 affine (Fq2 as Montgomery pairs) -> Fq12 curve point
static void twist(PtFq12 &o, const Fq *x2, const Fq *y2) {
    Fq nine = fq_from_u64(9);
    Fq t;
    Fq12 nx, ny;
    fq12_set_zero(nx);
    fq12_set_zero(ny);
    fq_mul(t, nine, x2[1]);
    fq_sub(nx.c[0], x2[0], t);      // x0 - 9 x1
    nx.c[6] = x2[1];
    fq_mul(t, nine, y2[1]);
    fq_sub(ny.c[0], y2[0], t);
    ny.c[6] = y2[1];
    // multiply by w^2 (shift 2) and w^3 (shift 3): coeffs 0,6 shift to
    // 2,8 and 3,9 — no reduction needed (max degree 9)
    fq12_set_zero(o.x);
    o.x.c[2] = nx.c[0];
    o.x.c[8] = nx.c[6];
    fq12_set_zero(o.y);
    o.y.c[3] = ny.c[0];
    o.y.c[9] = ny.c[6];
}

static void embed_g1(PtFq12 &o, const Fq &xm, const Fq &ym) {
    fq12_set_zero(o.x);
    fq12_set_zero(o.y);
    o.x.c[0] = xm;
    o.y.c[0] = ym;
}

static bool pt_eq(const PtFq12 &a, const PtFq12 &b) {
    return fq12_eq(a.x, b.x) && fq12_eq(a.y, b.y);
}

static void linefunc(Fq12 &o, const PtFq12 &p1, const PtFq12 &p2,
                     const PtFq12 &t) {
    Fq12 m, tmp, tmp2;
    if (!fq12_eq(p1.x, p2.x)) {
        fq12_sub(tmp, p2.y, p1.y);
        fq12_sub(tmp2, p2.x, p1.x);
        fq12_inv(tmp2, tmp2);
        fq12_mul(m, tmp, tmp2);
    } else if (fq12_eq(p1.y, p2.y)) {
        fq12_sqr(tmp, p1.x);
        Fq three = fq_from_u64(3);
        fq12_scalar(tmp, tmp, three);
        fq12_add(tmp2, p1.y, p1.y);
        fq12_inv(tmp2, tmp2);
        fq12_mul(m, tmp, tmp2);
    } else {
        fq12_sub(o, t.x, p1.x);
        return;
    }
    fq12_sub(tmp, t.x, p1.x);
    fq12_mul(tmp, m, tmp);
    fq12_sub(tmp2, t.y, p1.y);
    fq12_sub(o, tmp, tmp2);
}

static void ec_double(PtFq12 &o, const PtFq12 &p) {
    Fq12 m, tmp, tmp2;
    fq12_sqr(tmp, p.x);
    Fq three = fq_from_u64(3);
    fq12_scalar(tmp, tmp, three);
    fq12_add(tmp2, p.y, p.y);
    fq12_inv(tmp2, tmp2);
    fq12_mul(m, tmp, tmp2);
    Fq12 nx, ny;
    fq12_sqr(nx, m);
    fq12_add(tmp, p.x, p.x);
    fq12_sub(nx, nx, tmp);
    fq12_sub(tmp, p.x, nx);
    fq12_mul(tmp, m, tmp);
    fq12_sub(ny, tmp, p.y);
    o.x = nx;
    o.y = ny;
}

static void ec_add(PtFq12 &o, const PtFq12 &p, const PtFq12 &q) {
    if (pt_eq(p, q)) { ec_double(o, p); return; }
    Fq12 m, tmp, tmp2;
    fq12_sub(tmp, q.y, p.y);
    fq12_sub(tmp2, q.x, p.x);
    fq12_inv(tmp2, tmp2);
    fq12_mul(m, tmp, tmp2);
    Fq12 nx, ny;
    fq12_sqr(nx, m);
    fq12_add(tmp, p.x, q.x);
    fq12_sub(nx, nx, tmp);
    fq12_sub(tmp, p.x, nx);
    fq12_mul(tmp, m, tmp);
    fq12_sub(ny, tmp, p.y);
    o.x = nx;
    o.y = ny;
}

// Miller loop (NOT final-exponentiated); q2/g1 coords Montgomery affine
static void miller_loop(Fq12 &f, const Fq *q2x, const Fq *q2y,
                        const Fq &p1x, const Fq &p1y) {
    PtFq12 qt, pt, r;
    twist(qt, q2x, q2y);
    embed_g1(pt, p1x, p1y);
    r = qt;
    fq12_set_one(f);
    Fq12 line;
    // ATE_BITS is msb-first; skip the leading 1 (start from bit_length-2)
    for (int i = 1; i < ATE_LEN; ++i) {
        fq12_sqr(f, f);
        linefunc(line, r, r, pt);
        fq12_mul(f, f, line);
        ec_double(r, r);
        if (ATE_BITS[i]) {
            linefunc(line, r, qt, pt);
            fq12_mul(f, f, line);
            ec_add(r, r, qt);
        }
    }
    PtFq12 q1, nq2;
    fq12_frobenius(q1.x, qt.x);
    fq12_frobenius(q1.y, qt.y);
    fq12_frobenius(nq2.x, q1.x);
    fq12_frobenius(nq2.y, q1.y);
    fq12_neg(nq2.y, nq2.y);
    linefunc(line, r, q1, pt);
    fq12_mul(f, f, line);
    ec_add(r, r, q1);
    linefunc(line, r, nq2, pt);
    fq12_mul(f, f, line);
}

static void final_exponentiation(Fq12 &o, const Fq12 &f_in) {
    Fq12 f, c, inv, t;
    fq12_conj(c, f_in);
    fq12_inv(inv, f_in);
    fq12_mul(f, c, inv);                 // f^(q^6 - 1)
    fq12_frobenius(t, f);
    fq12_frobenius(t, t);
    fq12_mul(f, t, f);                   // ^(q^2 + 1)
    fq12_pow_bits(o, f, HARD_BITS, HARD_LEN);
}

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// All limb pointers: 4 little-endian u64 per field element, PLAIN form.
void bn254_init(const u64 *q_limbs, u64 n0inv, const u64 *r2_limbs,
                const u8 *q_bits, int q_len,
                const u8 *hard_bits, int hard_len,
                const u8 *ate_bits, int ate_len) {
    memcpy(Q.v, q_limbs, 32);
    N0INV = n0inv;
    memcpy(R2.v, r2_limbs, 32);
    memcpy(Q_BITS, q_bits, q_len);
    Q_LEN = q_len;
    memcpy(HARD_BITS, hard_bits, hard_len);
    HARD_LEN = hard_len;
    memcpy(ATE_BITS, ate_bits, ate_len);
    ATE_LEN = ate_len;
    // derived constants
    Fq one_plain;
    memset(&one_plain, 0, sizeof(one_plain));
    one_plain.v[0] = 1;
    fq_mul(ONE_M, one_plain, R2);        // Montgomery one
    // q - 2 bits (msb-first) for Fermat inversion
    Fq qm2 = Q;
    // subtract 2 with borrow
    if (qm2.v[0] >= 2) qm2.v[0] -= 2;
    else {
        qm2.v[0] = qm2.v[0] - 2;         // wraps
        int i = 1;
        while (qm2.v[i] == 0) { qm2.v[i] -= 1; ++i; }
        qm2.v[i] -= 1;
    }
    int len = 0;
    bool started = false;
    for (int bit = 255; bit >= 0; --bit) {
        int b = (qm2.v[bit / 64] >> (bit % 64)) & 1;
        if (!started && !b) continue;
        started = true;
        Q_M2_BITS[len++] = (u8)b;
    }
    Q_M2_LEN = len;
    C18 = fq_from_u64(18);
    C82 = fq_from_u64(82);
    fq12_set_one(FQ12_ONE_V);
    // Frobenius basis: x^q via pow, then powers of it
    Fq12 x;
    fq12_set_zero(x);
    x.c[1] = ONE_M;
    Fq12 xp;
    fq12_pow_bits(xp, x, Q_BITS, Q_LEN);
    fq12_set_one(FROB_BASIS[0]);
    for (int i = 1; i < 12; ++i) fq12_mul(FROB_BASIS[i], FROB_BASIS[i - 1], xp);
}

// out_xy: 8 u64 (x then y, plain); returns 1 if result is infinity.
int g1_msm(const u64 *xs, const u64 *ys, const u8 *inf,
           const u64 *scalars, int n, u64 *out_xy) {
    G1 acc;
    g1_set_inf(acc);
    for (int i = 0; i < n; ++i) {
        if (inf[i]) continue;
        Fq xp, yp, xm, ym;
        memcpy(xp.v, xs + 4 * i, 32);
        memcpy(yp.v, ys + 4 * i, 32);
        fq_to_mont(xm, xp);
        fq_to_mont(ym, yp);
        G1 p, t;
        g1_from_affine(p, xm, ym);
        g1_mul_u256(t, p, scalars + 4 * i);
        g1_add(acc, acc, t);
    }
    Fq xo, yo;
    u8 is_inf;
    g1_to_affine(acc, xo, yo, is_inf);
    if (is_inf) return 1;
    Fq xpl, ypl;
    fq_from_mont(xpl, xo);
    fq_from_mont(ypl, yo);
    memcpy(out_xy, xpl.v, 32);
    memcpy(out_xy + 4, ypl.v, 32);
    return 0;
}

// pairs: n G1 points (x,y plain, g1_inf flags) and n G2 points
// (x0,x1,y0,y1 plain each, g2_inf flags).  Returns 1 iff the pairing
// product equals one.
int pairing_product_is_one(const u64 *g1_xy, const u8 *g1_inf,
                           const u64 *g2_coords, const u8 *g2_inf, int n) {
    Fq12 f, ml;
    fq12_set_one(f);
    for (int i = 0; i < n; ++i) {
        if (g1_inf[i] || g2_inf[i]) continue;
        Fq p1x, p1y;
        memcpy(p1x.v, g1_xy + 8 * i, 32);
        memcpy(p1y.v, g1_xy + 8 * i + 4, 32);
        fq_to_mont(p1x, p1x);
        fq_to_mont(p1y, p1y);
        Fq q2x[2], q2y[2];
        memcpy(q2x[0].v, g2_coords + 16 * i, 32);
        memcpy(q2x[1].v, g2_coords + 16 * i + 4, 32);
        memcpy(q2y[0].v, g2_coords + 16 * i + 8, 32);
        memcpy(q2y[1].v, g2_coords + 16 * i + 12, 32);
        fq_to_mont(q2x[0], q2x[0]);
        fq_to_mont(q2x[1], q2x[1]);
        fq_to_mont(q2y[0], q2y[0]);
        fq_to_mont(q2y[1], q2y[1]);
        miller_loop(ml, q2x, q2y, p1x, p1y);
        fq12_mul(f, f, ml);
    }
    Fq12 out;
    final_exponentiation(out, f);
    return fq12_eq(out, FQ12_ONE_V) ? 1 : 0;
}

}  // extern "C"
