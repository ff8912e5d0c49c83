"""Polynomial layer: coset extension, vanishing division, evals (port of
``backend/poly.py``).

Coset convention: the extended evaluation coset is {g * w_ext^i} with
g = 7, the Fr multiplicative generator.
"""

from __future__ import annotations

import functools

import torch

from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.ntt import Domain, domain, ntt_many

FR = F.FR
GEN = 7


@functools.lru_cache(maxsize=None)
def _shift_powers(k: int, inverse: bool, device):
    base = pow(GEN, -1, FR.modulus) if inverse else GEN
    return F.powers_table(FR, base, 1 << k, device)


def to_coeffs(dom: Domain, evals):
    return ntt_many(dom, evals, 1, inverse=True)


def to_evals(dom: Domain, coeffs):
    return ntt_many(dom, coeffs, 1)


def pad_coeffs(coeffs, n: int):
    m = coeffs.shape[0]
    if m == n:
        return coeffs
    return torch.nn.functional.pad(coeffs, (0, 0, 0, n - m))


def coset_evals(dom_ext: Domain, coeffs):
    """Evaluate coeffs (m <= ext_n) on the coset {g * w_ext^i}."""
    c = pad_coeffs(coeffs, dom_ext.n)
    return ntt_many(dom_ext, c, 1,
                    shift_pows=_shift_powers(dom_ext.k, False, c.device))


def coset_interp(dom_ext: Domain, evals):
    """Inverse of coset_evals: coset evaluations -> coefficients."""
    c = ntt_many(dom_ext, evals, 1, inverse=True)
    return F.mont_mul(FR, c, _shift_powers(dom_ext.k, True, c.device))


@functools.lru_cache(maxsize=None)
def _vanishing_inv_table(k: int, ext_k: int, device):
    """(ratio, 16) Montgomery inverses of Z_H on the coset: Z_H(g w_ext^i)
    = g^n w_ext^(n i) - 1 cycles with period ratio = 2^(ext_k - k)."""
    p = FR.modulus
    n = 1 << k
    wn = pow(domain(FR, ext_k).omega, n, p)
    acc = pow(GEN, n, p)
    vals = []
    for _ in range(1 << (ext_k - k)):
        vals.append(pow(acc - 1, -1, p))
        acc = acc * wn % p
    return F.encode(FR, vals, device)


def divide_by_vanishing(k: int, dom_ext: Domain, evals_ext):
    """Pointwise divide coset evaluations by Z_H(X) = X^n - 1."""
    table = _vanishing_inv_table(k, dom_ext.k, evals_ext.device)
    ratio = table.shape[0]
    return F.mont_mul(FR, evals_ext.reshape(-1, ratio, F.LIMBS),
                      table).reshape(dom_ext.n, F.LIMBS)


def rotate_ext(evals_ext, rot: int, ratio: int):
    """Rotation by w^rot on the base domain = roll by rot*ratio on the
    extended one."""
    return torch.roll(evals_ext, -rot * ratio, 0) if rot else evals_ext


def eval_at(coeffs, x: int):
    """Evaluate one or many coefficient polys ((..., m, 16) Montgomery)
    at the plain int x -> plain ints (read back to the host)."""
    pw = F.limbs(FR.host_powers(x, coeffs.shape[-2]), coeffs.device)
    return FR.decode(F.tree_sum(FR, F.mont_mul(FR, coeffs, pw), axis=-2))


# --------------------------------------------------------------------------
# host scalar helpers (verifier side)
# --------------------------------------------------------------------------

def lagrange_evals_host(k: int, x: int, rows) -> list:
    """l_j(x) for the given row indices: l_j(x) = w^j (x^n - 1) / (n (x - w^j))."""
    p = FR.modulus
    n = 1 << k
    w = domain(FR, k).omega
    zh = (pow(x, n, p) - 1) % p
    n_inv = pow(n, -1, p)
    out = []
    for j in rows:
        wj = pow(w, j % n, p)
        out.append(wj * zh % p * pow((x - wj) % p, -1, p) % p * n_inv % p)
    return out


def vanishing_poly_coeffs(points) -> list:
    """Z(X) = prod (X - t) as plain-int coefficient list, low to high."""
    coeffs = [1]
    for t in points:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i + 1] = (nxt[i + 1] + c) % FR.modulus
            nxt[i] = (nxt[i] - c * t) % FR.modulus
        coeffs = nxt
    return coeffs


def eval_host(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR.modulus
    return acc


def lagrange_interp_host(points, evals) -> list:
    """Coefficients (plain ints, low->high) of the unique poly through
    (points[i], evals[i])."""
    p = FR.modulus
    coeffs = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, evals)):
        basis = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            nxt = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nxt[d + 1] = (nxt[d + 1] + c) % p
                nxt[d] = (nxt[d] - c * xj) % p
            basis = nxt
            denom = denom * (xi - xj) % p
        scale = yi * pow(denom, -1, p) % p
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs
