"""Inner-product-argument (IPA) proving backend — a second proving SYSTEM
(port of ``backend/ipa.py``).

Role of the reference's compile-time backend switch (reference
src/lib.rs:10-13, Cargo.toml:6-11: the facade swaps the ENTIRE proving
system, PSE halo2 vs a HyperPlonk fork).  This module is the analogous
capability behind ``get_backend("ipa")``: a transparent-setup polynomial
commitment scheme — no trusted tau, no pairings, no G2 — with a log-n
recursive opening argument (halo2's original `poly/ipa` scheme, the
bulletproofs-style PCS from the halo2 paper).

What is shared with the KZG pipeline (by design, not by accident):
  * commitments are Pedersen vector commitments C = MSM(G, coeffs) —
    the same window-table MSM (ops/msm.py, the K3 kernels) over a
    hash-derived basis instead of tau powers,
  * ALL PLONK phases (advice, lookup, permutation, quotient, evals) and
    the SHPLONK reduction are PCS-agnostic polynomial algebra: they
    reduce the full protocol to ONE claim "L(u) = 0" whose commitment
    the verifier forms as a public linear combination of transcript
    commitments,
  * only the final opening differs: KZG commits the quotient
    L/(X - u) and checks one pairing; IPA runs k halving rounds
    (2 MSMs + 2 inner products each) and the verifier recomputes the
    folded basis point with one size-n MSM — no pairing anywhere.

Soundness of the basis: points are hash-to-curve (try-and-increment on
blake2b counters; bn254 G1 has cofactor 1 so every curve point is in the
r-order group) — nobody knows discrete-log relations among G_i and U,
which is exactly the binding assumption the argument needs.  Unlike the
KZG dev SRS (srs.py: NOT a trusted setup), this setup is transparent and
production-grade as-is.

Zero-knowledge: beyond the protocol's blinding rows and the random
polynomial halo2 folds into every opening set, the recursion runs WITH
per-round Pedersen blinds, matching halo2's `poly/ipa` create_proof:
each L_j/R_j gains an r·W term over an independently hash-derived
blinding point W, and the prover's final message carries the
accumulated blind f = Σ_j (x_j^{-1}·r_Lj + x_j·r_Rj) which the
verifier subtracts as [f]W in the closing MSM check.  The 2k round
points are therefore uniformly distributed independently of L's
coefficients.

The basis, its cache file (``ipa_bn254_{k}_{tag}.npz``) and its identity
tag are the reference's, so a basis cached by either package loads in
the other.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from halo2_aes_tpu_torch.backend import pairing as PR
from halo2_aes_tpu_torch.backend.keygen import commit_many
from halo2_aes_tpu_torch.backend.srs import SRS, _tag_from_host
from halo2_aes_tpu_torch.backend.verifier import VerifyError
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F

FR, FQ = F.FR, F.FQ
R = FR.modulus


# --------------------------------------------------------------------------
# transparent basis setup
# --------------------------------------------------------------------------


def _candidate_xs(count: int, seed: bytes, offset: int = 0) -> list:
    """Deterministic Fq x-coordinate candidates (blake2b counter mode)."""
    out = []
    for i in range(offset, offset + count):
        h = hashlib.blake2b(seed + i.to_bytes(8, "little"),
                            digest_size=40).digest()
        out.append(int.from_bytes(h, "little") % FQ.modulus)
    return out


def _lift_x_batch(x_mont):
    """Try-and-increment lift: for each candidate x, y = sqrt(x^3 + 3)
    via the q = 3 (mod 4) exponent (q+1)/4 — batched over the whole basis
    on the candidates' device (K1 on a card) instead of ~2n host bigint
    exponentiations.

    Returns (y_mont, ok) where ok marks candidates with a square RHS."""
    x2 = F.mont_mul(FQ, x_mont, x_mont)
    three = F.encode(FQ, 3, x_mont.device)
    y2 = F.add(FQ, F.mont_mul(FQ, x2, x_mont), three.expand(x_mont.shape))
    y = F.pow_const(FQ, y2, (FQ.modulus + 1) // 4)
    ok = (F.mont_mul(FQ, y, y) == y2).all(-1)
    return y, ok


def _hash_to_curve(count: int, seed: bytes, device):
    """``count`` independent G1 points as Montgomery limb arrays (numpy
    uint32), lifted on ``device``."""
    xs_np, ys_np = [], []
    have, offset = 0, 0
    while have < count:
        batch = max(1024, int(2.2 * (count - have)))
        cand = _candidate_xs(batch, seed, offset)
        offset += batch
        x_m = F.limbs(F.ints_to_limbs_fast(
            [FQ.to_mont_host(x) for x in cand]), device)
        y_m, ok = _lift_x_batch(x_m)
        ok = ok.cpu().numpy()
        xs_np.append(F.to_numpy(x_m)[ok])
        ys_np.append(F.to_numpy(y_m)[ok])
        have += int(ok.sum())
    xs = np.concatenate(xs_np)[:count]
    ys = np.concatenate(ys_np)[:count]
    return xs, ys


def _mont_limbs_to_point(x_row, y_row) -> tuple:
    return (FQ.from_mont_host(F.limbs_to_int(F.to_numpy(x_row))),
            FQ.from_mont_host(F.limbs_to_int(F.to_numpy(y_row))))


@functools.lru_cache(maxsize=None)
def _blind_w(seed: bytes, device) -> tuple:
    """The blinding point W: hash-derived in its OWN domain (seed
    suffix), so no discrete-log relation to the basis G_i or U is
    known — the binding assumption the blinded argument needs.  Derived
    on demand (not stored in the basis npz) so pre-blind cached basis
    files stay valid."""
    wx, wy = _hash_to_curve(1, seed + b"/blind-W", device)
    return _mont_limbs_to_point(wx[0], wy[0])


def setup(k: int, device, seed: bytes = b"halo2_aes_tpu ipa basis",
          cache_dir: str | None = "ptau") -> SRS:
    """Transparent IPA basis on ``device``: n hash-derived G1 points + the
    folding point U + the blinding point W.  Returned as an SRS instance
    (same ``commit`` / ``warm_tables`` / ``identity_tag`` surface, so
    keygen and every PLONK prover phase work unchanged); ``g1_extra`` is
    None — the prover's tau^n stagger-blind is KZG algebra and is
    skipped, exactly as for ceremony .srs files."""
    device = torch.device(device)
    path = None
    if cache_dir is not None:
        tag = hashlib.blake2b(seed, digest_size=8).hexdigest()
        path = os.path.join(cache_dir, f"ipa_bn254_{k}_{tag}.npz")
    if path is not None and os.path.exists(path):
        z = np.load(path)
        gx, gy, ux, uy = z["g1_x"], z["g1_y"], z["u_x"], z["u_y"]
    else:
        gx, gy = _hash_to_curve((1 << k) + 1, seed, device)
        ux, uy = gx[-1], gy[-1]
        gx, gy = gx[:-1], gy[:-1]
        if path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(path, g1_x=gx, g1_y=gy, u_x=ux, u_y=uy)
    srs = SRS(k, F.limbs(gx, device), F.limbs(gy, device), PR.G2, PR.G2,
              cache_dir=cache_dir, g1_extra=None,
              u_pt=_mont_limbs_to_point(ux, uy),
              w_pt=_blind_w(seed, device))
    object.__setattr__(srs, "_tag",
                       _tag_from_host(gx, gy, ("ipa2", srs.u_pt, srs.w_pt)))
    return srs


def basis_point0(srs: SRS) -> tuple:
    """G_0 as plain affine ints — the verifier's commitment to the
    constant polynomial 1 (in KZG this is the curve generator; here it
    is the first hash-derived basis point)."""
    return _mont_limbs_to_point(srs.g1_x[0], srs.g1_y[0])


# --------------------------------------------------------------------------
# prover-side opening argument
# --------------------------------------------------------------------------


def _dot(a, b):
    """<a, b> as a (1, 16) tensor: the products folded by a halving tree
    of modular adds."""
    t = F.mont_mul(FR, a, b)
    while t.shape[0] > 1:
        hh = t.shape[0] // 2
        t = F.add(FR, t[:hh], t[hh:])
    return t


def _halves(t, m: int):
    """(n, 16) -> (n / m, 2, m / 2, 16) view: index i of the basis as
    (block, i mod m >= m / 2, i mod (m / 2))."""
    return t.view(t.shape[0] // m, 2, m // 2, F.LIMBS)


def _round_pre(a, b, W, m: int):
    """One round's MSM scalars and inner products.

    Invariant: at round start the folded basis is
    H_t = sum_{i == t (mod m)} W_i G_i, so both halving MSMs are
    expressible over the ORIGINAL basis — they reuse the commit path's
    resident window tables instead of folding n curve points per round:
        MSM(H_hi, a_lo) = MSM(G, scal_L),
            scal_L[i] = [i mod m >= m/2] * W_i * a[(i mod m) - m/2]
        MSM(H_lo, a_hi) = MSM(G, scal_R),
            scal_R[i] = [i mod m <  m/2] * W_i * a[(i mod m) + m/2]
    The index pattern is periodic in m, so each half of every m-block of
    W is multiplied by a broadcast half of ``a`` through a view: no mask
    and no gather index is built, and the zero halves cost no product."""
    half = m // 2
    l_ip = _dot(a[:half], b[half:m])
    r_ip = _dot(a[half:m], b[:half])
    scal_l = torch.zeros_like(W)
    scal_r = torch.zeros_like(W)
    Wv = _halves(W, m)
    _halves(scal_l, m)[:, 1] = F.mont_mul(FR, Wv[:, 1], a[:half])
    _halves(scal_r, m)[:, 0] = F.mont_mul(FR, Wv[:, 0], a[half:m])
    return scal_l, scal_r, l_ip, r_ip


def _round_fold(a, b, W, m: int, x_m, xinv_m):
    half = m // 2
    a2 = F.add(FR, a[:half], F.mont_mul(FR, a[half:m], x_m))
    b2 = F.add(FR, b[:half], F.mont_mul(FR, b[half:m], xinv_m))
    W2 = W.clone()
    _halves(W2, m)[:, 1] = F.mont_mul(FR, _halves(W, m)[:, 1], xinv_m)
    return a2, b2, W2


def _point_plus_u(pt: tuple, u_pt: tuple, scal: int) -> tuple:
    return pt if scal == 0 else CV.py_add(pt, CV.py_mul(u_pt, scal))


def _rand_scalar(rng) -> int:
    """Uniform field scalar: 254-bit rejection sampling from the OS
    CSPRNG (``rng=None``) or a np.random.Generator (reproducible
    tests)."""
    randbytes = os.urandom if rng is None else rng.bytes
    while True:
        v = int.from_bytes(randbytes(32), "little") & ((1 << 254) - 1)
        if v < R:
            return v


def open_claim(srs: SRS, tr, l_coeffs, u: int, rng=None) -> None:
    """IPA opening of <a, b> = 0 for a = coeffs(L), b = (1, u, .., u^{n-1}).

    Writes 2k points (L_j, R_j interleaved with per-round challenges),
    the final folded scalar a_fin, and the accumulated blind f_fin to
    the transcript.  Fold convention (matching the verifier's s-vector):
        a' = a_lo + x a_hi,  b' = b_lo + x^{-1} b_hi,
        G' = G_lo + x^{-1} G_hi,
        P' = P + x^{-1} L_j + x R_j,
        L_j = MSM(G_hi, a_lo) + <a_lo, b_hi> U + r_Lj W,
        R_j = MSM(G_lo, a_hi) + <a_hi, b_lo> U + r_Rj W,
    with fresh Pedersen blinds r_Lj, r_Rj per round (halo2 poly/ipa's
    blinded rounds); f_fin = Σ_j (x_j^{-1} r_Lj + x_j r_Rj) closes the
    W component in the verifier's final MSM.

    Both round MSMs go through one ``commit_many`` (one ``msm_many`` pass
    of two).  The transcript forces two host reads a round: the pair of
    points and the pair of inner products."""
    k, n = srs.k, srs.n
    dev = l_coeffs.device
    assert srs.w_pt is not None, (
        "ipa open_claim needs a basis with a blinding point W "
        "(rebuild via ipa.setup)")
    a = l_coeffs
    b = F.powers(FR, F.encode(FR, u, dev), n)
    W = F.const(FR, "one", dev).expand(n, F.LIMBS).contiguous()
    f_fin = 0
    for j in range(k):
        m = n >> j
        scal_l, scal_r, l_ip, r_ip = _round_pre(a, b, W, m)
        lm, rm = commit_many(srs, [scal_l, scal_r])
        l_int, r_int = FR.decode(torch.cat([l_ip, r_ip]))
        r_l, r_r = _rand_scalar(rng), _rand_scalar(rng)
        tr.write_point(_point_plus_u(
            _point_plus_u(lm, srs.u_pt, l_int), srs.w_pt, r_l))
        tr.write_point(_point_plus_u(
            _point_plus_u(rm, srs.u_pt, r_int), srs.w_pt, r_r))
        x = tr.squeeze_challenge()
        xinv = pow(x, -1, R)
        f_fin = (f_fin + xinv * r_l + x * r_r) % R
        a, b, W = _round_fold(a, b, W, m, F.encode(FR, x, dev),
                              F.encode(FR, xinv, dev))
    a_fin = FR.decode(a)[0]
    tr.write_scalar(a_fin)
    tr.write_scalar(f_fin)


# --------------------------------------------------------------------------
# verifier
# --------------------------------------------------------------------------


def verify(vk, proof: bytes, instances=None, srs: SRS | None = None,
           device="cuda") -> bool:
    """Full IPA verification: transcript replay + SHPLONK linear
    combination (shared with the KZG verifier), then the k-round check

        P_0 + sum_j (x_j^{-1} L_j + x_j R_j)
            == a_fin MSM(G, s) + a_fin b_fin U + f_fin W

    with s_i = prod_{j : bit_{k-1-j}(i)} x_j^{-1},
    b_fin = prod_j (1 + x_j^{-1} u^{n / 2^{j+1}}), and f_fin the
    prover's accumulated per-round Pedersen blind.  The size-n MSM runs
    on the basis' device through the same window-table MSM as
    commitments; no pairing is evaluated.  ``device`` is used only when
    no ``srs`` is given (the basis is then loaded or rebuilt there)."""
    from halo2_aes_tpu_torch.backend import verifier as VF

    if srs is None:
        srs = setup(vk.k, device)
    tr, plan, comms, evals, rot_point = VF._replay_common(
        vk, proof, instances)
    pts, scs, const_corr, u = VF._shplonk_lincomb(
        tr, plan, comms, evals, rot_point)
    pts, scs = list(pts), list(scs)
    pts.append(basis_point0(srs))
    scs.append(-const_corr % R)

    k, n = vk.k, 1 << vk.k
    xinvs = []
    b_fin = 1
    try:
        for j in range(k):
            l_pt = tr.read_point()
            r_pt = tr.read_point()
            x = tr.squeeze_challenge()
            xinv = pow(x, -1, R)
            xinvs.append(xinv)
            pts += [l_pt, r_pt]
            scs += [xinv, x]
            b_fin = b_fin * (1 + xinv * pow(u, n >> (j + 1), R)) % R
        a_fin = tr.read_scalar()
        f_fin = tr.read_scalar()
        tr.assert_consumed()
    except ValueError as e:
        raise VerifyError(str(e)) from e

    # s-vector: round j's challenge governs bit (k-1-j) of the original
    # basis index.  The doubling construction attaches each processed
    # challenge to the next-higher bit (LSB first), so iterate the
    # rounds in REVERSE: the last round's challenge lands on bit 0.
    s = [1]
    for xinv in reversed(xinvs):
        s = s + [v * xinv % R for v in s]
    g_fin = CV.to_affine_host(srs.commit(F.encode(FR, s, srs.device)))[0]

    assert srs.w_pt is not None, "ipa verify needs a basis with W"
    pts += [g_fin, srs.u_pt, srs.w_pt]
    scs += [-a_fin % R, -(a_fin * b_fin) % R, -f_fin % R]
    if CV.host_msm(pts, scs) is not None:
        raise VerifyError("ipa final check failed")
    return True
