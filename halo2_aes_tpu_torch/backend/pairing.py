"""BN254 pairing on host (pure python bigints).

Role of halo2curves' pairing in the verifier's final KZG/SHPLONK check
(SURVEY.md section 2.13; the reference crate itself never verifies —
building a verifier is a deliberate capability addition, SURVEY.md §7
step 7).  Verification is O(proof size), so it is host-side by design:
the TPU does proving, the transcript/pairing layer is python ints.

Representations:
  * Fq2 = Fq[i]/(i^2+1) as (a, b) tuples.
  * Fq12 as 12-coefficient tuples over Fq modulo x^12 - 18 x^6 + 82
    (the polynomial encoding of the tower Fq2[v]/(v^3 - (9+i)),
    Fq6[w]/(w^2 - v); i = x^6 - 9).
  * G2 points affine over Fq2 on the D-twist y^2 = x^3 + 3/(9+i).

Optimal ate pairing: Miller loop over 6u+2 = 29793968203157093288
(u = 4965661367192848881), two Frobenius line steps, final
exponentiation (p^12-1)/r with the easy part done via conjugation.
"""

from __future__ import annotations

import functools

from halo2_aes_tpu_torch.ops.field import FQ, FR

Q = FQ.modulus
R = FR.modulus
U = 4965661367192848881
ATE_LOOP_COUNT = 6 * U + 2

# --------------------------------------------------------------------------
# Fq2
# --------------------------------------------------------------------------

FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)


def fq2_add(x, y):
    return ((x[0] + y[0]) % Q, (x[1] + y[1]) % Q)


def fq2_sub(x, y):
    return ((x[0] - y[0]) % Q, (x[1] - y[1]) % Q)


def fq2_neg(x):
    return (-x[0] % Q, -x[1] % Q)


def fq2_mul(x, y):
    a = x[0] * y[0] % Q
    b = x[1] * y[1] % Q
    c = (x[0] + x[1]) * (y[0] + y[1]) % Q
    return ((a - b) % Q, (c - a - b) % Q)


def fq2_inv(x):
    norm_inv = pow(x[0] * x[0] + x[1] * x[1], -1, Q)
    return (x[0] * norm_inv % Q, -x[1] * norm_inv % Q)


def fq2_scalar(x, s: int):
    return (x[0] * s % Q, x[1] * s % Q)


def fq2_pow(x, e: int):
    acc = FQ2_ONE
    while e:
        if e & 1:
            acc = fq2_mul(acc, x)
        x = fq2_mul(x, x)
        e >>= 1
    return acc


# twist coefficient b' = 3 / (9 + i)
B2 = fq2_mul((3, 0), fq2_inv((9, 1)))

# G2 generator (halo2curves bn256 / alt_bn128 standard)
G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)
G2 = (G2_X, G2_Y)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fq2_sub(fq2_mul(y, y), fq2_add(fq2_mul(fq2_mul(x, x), x), B2)) == FQ2_ZERO


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_mul(x1, x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


def g2_neg(p):
    return None if p is None else (p[0], fq2_neg(p[1]))


# --------------------------------------------------------------------------
# Fq12 (polynomial form, x^12 = 18 x^6 - 82)
# --------------------------------------------------------------------------

FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12


def fq12_add(a, b):
    return tuple((x + y) % Q for x, y in zip(a, b))


def fq12_sub(a, b):
    return tuple((x - y) % Q for x, y in zip(a, b))


def fq12_neg(a):
    return tuple(-x % Q for x in a)


def fq12_scalar(a, s: int):
    return tuple(x * s % Q for x in a)


def fq12_mul(a, b):
    c = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                c[i + j] += ai * bj
    for k in range(22, 11, -1):
        ck = c[k]
        if ck:
            c[k - 6] += 18 * ck
            c[k - 12] -= 82 * ck
    return tuple(x % Q for x in c[:12])


def fq12_inv(a):
    """Extended Euclid over Fq[x] for a modulo x^12 - 18 x^6 + 82.

    Structure follows the classic polynomial extended-Euclid inverse from
    the MIT-licensed py_ecc library (ethereum/py_ecc, ``FQP.__div__`` /
    ``prime_field_inv``) — a host-side oracle used only off the hot path."""
    lm, hm = [1] + [0] * 12, [0] * 13
    low = list(a) + [0]
    high = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0, 1]

    def deg(p):
        d = len(p) - 1
        while d and p[d] % Q == 0:
            d -= 1
        return d

    def poly_rounded_div(x, y):
        dx, dy = deg(x), deg(y)
        x = list(x)
        out = [0] * len(x)
        yd_inv = pow(y[dy], -1, Q)
        for i in range(dx - dy, -1, -1):
            out[i] = (out[i] + x[dy + i] * yd_inv) % Q
            for c in range(dy + 1):
                x[c + i] = (x[c + i] - out[i] * y[c]) % Q
        return out[: deg(out) + 1]

    while deg(low):
        r = poly_rounded_div(high, low)
        r += [0] * (13 - len(r))
        nm = [(hm[i] - sum(lm[i - j] * r[j] for j in range(min(i, 12) + 1))) % Q
              for i in range(13)]
        new = [(high[i] - sum(low[i - j] * r[j] for j in range(min(i, 12) + 1))) % Q
               for i in range(13)]
        lm, low, hm, high = nm, new, lm, low
    inv0 = pow(low[0], -1, Q)
    return tuple(lm[i] * inv0 % Q for i in range(12))


def fq12_pow(a, e: int):
    acc = FQ12_ONE
    while e:
        if e & 1:
            acc = fq12_mul(acc, a)
        a = fq12_mul(a, a)
        e >>= 1
    return acc


def fq12_conj(a):
    """Conjugation f -> f^(p^6): negate odd coefficients (x^6 part)."""
    return tuple(x if i % 2 == 0 else -x % Q for i, x in enumerate(a))


def fq12_frobenius(a):
    """f -> f^p via coefficient map x^i -> FROB[i] * x^i ... computed as
    a @ precomputed basis images."""
    out = FQ12_ZERO
    for i, ai in enumerate(a):
        if ai:
            out = fq12_add(out, fq12_scalar(_FROB_BASIS[i], ai))
    return out


@functools.lru_cache(maxsize=1)
def _frob_basis():
    # image of x^i under x -> x^p: x^(p mod ...) reduced; p is huge, so
    # compute x^p once by fq12_pow, then powers of it.
    xp = fq12_pow((0, 1) + (0,) * 10, Q)
    out = [FQ12_ONE]
    for _ in range(11):
        out.append(fq12_mul(out[-1], xp))
    return tuple(out)


class _FrobBasis:
    def __getitem__(self, i):
        return _frob_basis()[i]


_FROB_BASIS = _FrobBasis()


# --------------------------------------------------------------------------
# twist embedding + Miller loop
# --------------------------------------------------------------------------

_W2 = (0, 0, 1) + (0,) * 9   # w^2
_W3 = (0, 0, 0, 1) + (0,) * 8  # w^3


def embed_fq(x: int):
    return (x % Q,) + (0,) * 11


def twist(pt):
    """G2 affine (Fq2) -> curve point over Fq12 (untwisting embedding)."""
    if pt is None:
        return None
    (x0, x1), (y0, y1) = pt
    nx = ((x0 - 9 * x1) % Q,) + (0,) * 5 + (x1,) + (0,) * 5
    ny = ((y0 - 9 * y1) % Q,) + (0,) * 5 + (y1,) + (0,) * 5
    return (fq12_mul(nx, _W2), fq12_mul(ny, _W3))


def embed_g1(pt):
    if pt is None:
        return None
    return (embed_fq(pt[0]), embed_fq(pt[1]))


def _linefunc(p1, p2, t):
    """Line through p1, p2 (Fq12 curve points) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3), fq12_inv(fq12_scalar(y1, 2)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def _ec_double(p):
    x, y = p
    m = fq12_mul(fq12_scalar(fq12_mul(x, x), 3), fq12_inv(fq12_scalar(y, 2)))
    nx = fq12_sub(fq12_mul(m, m), fq12_scalar(x, 2))
    ny = fq12_sub(fq12_mul(m, fq12_sub(x, nx)), y)
    return (nx, ny)


def _ec_add(p, q):
    if p[0] == q[0] and p[1] == q[1]:
        return _ec_double(p)
    m = fq12_mul(fq12_sub(q[1], p[1]), fq12_inv(fq12_sub(q[0], p[0])))
    nx = fq12_sub(fq12_mul(m, m), fq12_add(p[0], q[0]))
    ny = fq12_sub(fq12_mul(m, fq12_sub(p[0], nx)), p[1])
    return (nx, ny)


def miller_loop(q_g2, p_g1):
    """Miller loop value f (NOT final-exponentiated).  q_g2: G2 affine
    Fq2 pair; p_g1: G1 affine int pair.  Either None -> 1."""
    if q_g2 is None or p_g1 is None:
        return FQ12_ONE
    qt = twist(q_g2)
    pt = embed_g1(p_g1)
    r = qt
    f = FQ12_ONE
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = fq12_mul(fq12_mul(f, f), _linefunc(r, r, pt))
        r = _ec_double(r)
        if (ATE_LOOP_COUNT >> i) & 1:
            f = fq12_mul(f, _linefunc(r, qt, pt))
            r = _ec_add(r, qt)
    # Frobenius steps: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = (fq12_frobenius(qt[0]), fq12_frobenius(qt[1]))
    nq2 = (fq12_frobenius(fq12_frobenius(qt[0])),
           fq12_neg(fq12_frobenius(fq12_frobenius(qt[1]))))
    f = fq12_mul(f, _linefunc(r, q1, pt))
    r = _ec_add(r, q1)
    f = fq12_mul(f, _linefunc(r, nq2, pt))
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r); easy part via conjugate/inverse, hard part naive."""
    # easy: f^(p^6-1) = conj(f) / f ; then ^(p^2+1)
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    f = fq12_mul(fq12_frobenius(fq12_frobenius(f)), f)
    # hard: ^((p^4 - p^2 + 1) / r)
    hard = (Q**4 - Q**2 + 1) // R
    return fq12_pow(f, hard)


def pairing(p_g1, q_g2):
    """e(P, Q) in Fq12."""
    return final_exponentiation(miller_loop(q_g2, p_g1))


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with a single shared final exponentiation.

    The KZG check e(W, [tau]_2) = e(L, [1]_2) is phrased as
    pairing_product_is_one([(L, G2), (-W, [tau]_2)]).  Routes through
    the native C++ library (halo2_aes_tpu_torch.native) on the native
    host route; this python-bigint path is the correctness oracle and
    the route taken on request.
    """
    from halo2_aes_tpu_torch import native

    if native.route() == "native":
        return native.pairing_product_is_one(pairs)
    native.CALLS["python"] += 1
    f = FQ12_ONE
    for p_g1, q_g2 in pairs:
        f = fq12_mul(f, miller_loop(q_g2, p_g1))
    return final_exponentiation(f) == FQ12_ONE
