"""BN254 G1 arithmetic on Fq limb tensors: the port of ``ops/curve.py``.

Points are homogeneous projective triples (X, Y, Z), each ``(..., 16)``
int32 Montgomery limbs; the identity has Z == 0.  ``add`` is the
Renes-Costello-Batina complete adder and ``double`` / ``double_n`` the
RCB complete doubling (``ops/cuda_curve.py``: the K3 kernels on CUDA
tensors, their plain versions on CPU tensors).  The ``py_*`` functions
are the python-bigint host
oracle the verifier and SRS setup use.

Curve: y^2 z = x^3 + 3 z^3 over Fq, prime order r (= Fr modulus).
"""

from __future__ import annotations

import torch

from halo2_aes_tpu_torch.ops import cuda_curve
from halo2_aes_tpu_torch.ops import field as F

FQ = F.FQ

G1_X = 1
G1_Y = 2
B_COEFF = 3


def identity(shape=(), device="cpu"):
    z = torch.zeros((*shape, F.LIMBS), dtype=torch.int32, device=device)
    one = F.const(FQ, "one", torch.device(device)).expand(*shape, F.LIMBS)
    return (z, one.clone(), z.clone())


def affine_to_proj(xy):
    x, y = xy
    return (x, y, F.const(FQ, "one", x.device).expand(x.shape).clone())


# the reference's name (from its Jacobian days; coordinates are projective)
affine_to_jacobian = affine_to_proj


def is_identity(p):
    return F.is_zero(p[2])


def neg(p):
    x, y, z = p
    return (x, F.neg(FQ, y), z)


add = cuda_curve.add
fold = cuda_curve.fold
masked_add = cuda_curve.masked_add


def double(p):
    """RCB complete doubling (alg. 9, a=0, b3=9).  Identity-safe."""
    return cuda_curve.double_n(p, 1)


double_n = cuda_curve.double_n


def to_affine_host(p) -> list:
    """Batched projective limbs -> list of (x, y) plain ints, identity ->
    None (host side; for transcripts and tests)."""
    X, Y, Z = (F.limbs_to_ints(c) for c in p)
    out = []
    q = FQ.modulus
    for x, y, z in zip(X, Y, Z):
        z = FQ.from_mont_host(z)
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, q)
        out.append((FQ.from_mont_host(x) * zinv % q,
                    FQ.from_mont_host(y) * zinv % q))
    return out


def affine_from_ints(points, device="cpu") -> tuple:
    """List of (x, y) plain ints -> affine Montgomery limb tensors."""
    return (F.encode(FQ, [x for x, _ in points], device),
            F.encode(FQ, [y for _, y in points], device))


# ---------------------------------------------------------------------------
# host oracle (python bigints)
# ---------------------------------------------------------------------------

def py_add(p, q, mod=FQ.modulus):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % mod == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def py_mul(p, k: int):
    acc = None
    while k:
        if k & 1:
            acc = py_add(acc, p)
        p = py_add(p, p)
        k >>= 1
    return acc


def py_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    q = FQ.modulus
    return (y * y - x * x * x - B_COEFF) % q == 0


def _jdouble(p, mod=FQ.modulus):
    """Jacobian doubling (dbl-2009-l, a = 0); None is the identity."""
    if p is None or p[1] == 0:
        return None
    X, Y, Z = p
    A = X * X % mod
    B = Y * Y % mod
    C = B * B % mod
    D = 2 * ((X + B) * (X + B) - A - C) % mod
    E = 3 * A % mod
    X3 = (E * E - 2 * D) % mod
    return (X3, (E * (D - X3) - 8 * C) % mod, 2 * Y * Z % mod)


def _jadd(p, q, mod=FQ.modulus):
    """Jacobian addition (add-2007-bl) with the equal/opposite cases."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % mod
    Z2Z2 = Z2 * Z2 % mod
    U1 = X1 * Z2Z2 % mod
    S1 = Y1 * Z2 * Z2Z2 % mod
    H = (X2 * Z1Z1 - U1) % mod
    r = (Y2 * Z1 * Z1Z1 - S1) % mod
    if H == 0:
        return _jdouble(p) if r == 0 else None
    II = 4 * H * H % mod
    J = H * II % mod
    r = 2 * r % mod
    V = U1 * II % mod
    X3 = (r * r - J - 2 * V) % mod
    Y3 = (r * (V - X3) - 2 * S1 * J) % mod
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % mod
    return (X3, Y3, Z3)


def host_msm(points, scalars):
    """sum_i scalars[i] * points[i] on host (affine int pairs, None =
    identity).  Routes through the native C++ library
    (halo2_aes_tpu_torch.native, the verifier's hot path) on the native
    host route; on the python route, a bucket Pippenger in Jacobian
    coordinates over python bigints, one inversion at the end.  The
    affine result is unique, so both equal the reference's
    double-and-add fold."""
    from halo2_aes_tpu_torch import native

    r = F.FR.modulus
    if native.route() == "native":
        return native.g1_msm(points, [int(s) % r for s in scalars])
    native.CALLS["python"] += 1
    pairs = [((p[0], p[1], 1), int(s) % r) for p, s in zip(points, scalars)
             if p is not None and int(s) % r]
    if not pairs:
        return None
    c = max(1, len(pairs).bit_length() - 2)
    mask = (1 << c) - 1
    acc = None
    for w in reversed(range(-(-r.bit_length() // c))):
        for _ in range(c):
            acc = _jdouble(acc)
        buckets = [None] * (mask + 1)
        for pt, s in pairs:
            d = (s >> (w * c)) & mask
            if d:
                buckets[d] = _jadd(buckets[d], pt)
        run = tot = None
        for b in range(mask, 0, -1):
            run = _jadd(run, buckets[b])
            tot = _jadd(tot, run)
        acc = _jadd(acc, tot)
    if acc is None:
        return None
    q = FQ.modulus
    zinv = pow(acc[2], -1, q)
    z2 = zinv * zinv % q
    return (acc[0] * z2 % q, acc[1] * z2 * zinv % q)
