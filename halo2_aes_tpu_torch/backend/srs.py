"""KZG structured reference string: setup, cache, commit (port of
``backend/srs.py``).

Generation is deterministic from a seed (a dev SRS, not a trusted
setup).  The tau-power G1 table is computed on the device: the host
builds 32 x 256 fixed-window tables of G1 multiples (python bigints),
the device gathers them by scalar digits and tree-adds.  The cache is
the reference's ``ptau/kzg_bn254_{k}_{tag}.npz`` format, so either
package can read what the other wrote.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from halo2_aes_tpu_torch.backend import pairing as PR
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as MSM

FR, FQ = F.FR, F.FQ

_WINDOW = 8
_NWIN = -(-MSM.SCALAR_BITS // _WINDOW)


@dataclass
class SRS:
    """g1 powers [tau^i]G1 (affine Montgomery limb tensors) + G2 side."""

    k: int
    g1_x: torch.Tensor       # (n, 16) int32
    g1_y: torch.Tensor
    g2: tuple                # G2 generator, affine Fq2 ints
    s_g2: tuple              # [tau] G2
    cache_dir: str | None = None
    g1_extra: tuple | None = None  # [tau^n] G1 (plain affine ints), for the
    #   staggered quotient-piece blinds (backend/prover.py); None for
    #   ceremony .srs files and for the IPA basis
    u_pt: tuple | None = None      # IPA folding point U (plain affine ints);
    #   set only by backend/ipa.py's transparent setup — None for KZG.
    w_pt: tuple | None = None      # IPA blinding point W (plain affine ints):
    #   carries the per-round Pedersen blinds of the opening argument
    #   (halo2 poly/ipa's W); hash-derived in backend/ipa.py, None for KZG.

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self):
        return self.g1_x.device

    def identity_tag(self) -> str:
        """Short identity of this SRS (hash of a few G1 powers + G2)."""
        tag = getattr(self, "_tag", None)
        if tag is None:
            tag = _tag_from_host(F.to_numpy(self.g1_x[:4]),
                                 F.to_numpy(self.g1_y[:4]), self.s_g2)
            object.__setattr__(self, "_tag", tag)
        return tag

    def warm_tables(self) -> None:
        """Load or build the MSM window tables now; from
        ``MSM.TABLELESS_MIN_N`` points on there are none (None)."""
        if getattr(self, "_msm_tables", None) is None:
            tables = None
            if self.n < MSM.TABLELESS_MIN_N:
                tables = self._load_or_build_tables(MSM.default_window(self.n))
            object.__setattr__(self, "_msm_tables", tables)

    def commit(self, coeffs_mont):
        """Commit a coefficient-form poly ((m, 16) Montgomery, m <= n) ->
        projective point (3 x (16,))."""
        m = coeffs_mont.shape[0]
        scalars = F.from_mont(FR, coeffs_mont)
        if m < self.n:
            scalars = torch.nn.functional.pad(scalars, (0, 0, 0, self.n - m))
        self.warm_tables()
        return MSM.msm((self.g1_x, self.g1_y), scalars,
                       c=MSM.default_window(self.n), tables=self._msm_tables)

    def _load_or_build_tables(self, c: int):
        path = None
        if self.cache_dir is not None:
            base = f"msm_tables_{self.k}_{self.identity_tag()}_c{c}"
            path = os.path.join(self.cache_dir, base + "_v2.npz")
            if os.path.exists(path):
                return F.limbs(np.load(path)["txy"], self.device)
        txy = MSM.build_tables((self.g1_x, self.g1_y), c)
        if path is not None:
            np.savez(path, txy=F.to_numpy(txy))
        return txy


def _tag_from_host(gx_head: np.ndarray, gy_head: np.ndarray, s_g2) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(gx_head[:4], dtype=np.uint32).tobytes())
    h.update(np.ascontiguousarray(gy_head[:4], dtype=np.uint32).tobytes())
    h.update(repr(s_g2).encode())
    return h.hexdigest()


def _host_window_tables(c: int = _WINDOW):
    """T[w][d] = d * 2^(c*w) * G1 as (nwin, 2^c, 2, 16) Montgomery limbs;
    d = 0 rows are placeholders (masked to the identity)."""
    tables = np.zeros((_NWIN, 1 << c, 2, F.LIMBS), dtype=np.uint32)
    base = (CV.G1_X, CV.G1_Y)
    for w in range(_NWIN):
        acc = None
        xs, ys = [0], [0]
        for d in range(1, 1 << c):
            acc = CV.py_add(acc, base)
            xs.append(FQ.to_mont_host(acc[0]))
            ys.append(FQ.to_mont_host(acc[1]))
        tables[w, :, 0] = F.ints_to_limbs_fast(xs)
        tables[w, :, 1] = F.ints_to_limbs_fast(ys)
        for _ in range(c):
            base = CV.py_add(base, base)
    return tables


_POINTS_CHUNK = 1 << 17


def _points_from_scalars(scalars_plain, device):
    """[s_i] G1 for plain int scalars (all nonzero mod r) -> affine limb
    tensors on ``device``.  Up to 512 scalars are computed on the host;
    more go through the device window-table sum in 2^17 chunks."""
    total = len(scalars_plain)
    if total <= 512:
        pts = [CV.py_mul((CV.G1_X, CV.G1_Y), int(s) % FR.modulus)
               for s in scalars_plain]
        return CV.affine_from_ints(pts, device)
    if total > _POINTS_CHUNK:
        parts = [_points_from_scalars(scalars_plain[lo:lo + _POINTS_CHUNK], device)
                 for lo in range(0, total, _POINTS_CHUNK)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    limbs = F.limbs(F.ints_to_limbs_fast([int(s) for s in scalars_plain]), device)
    tables = F.limbs(_host_window_tables(), device)
    digs = MSM.digit_matrix(limbs, _WINDOW)
    return _combine_windows(digs, tables)


def _combine_windows(digs, tables):
    """Window-table sum: gather per-window multiples (digit 0 -> the
    identity (0 : 1 : 0)), tree-add the windows, normalise to affine."""
    one = F.const(FQ, "one", digs.device)
    xs, ys, zs = [], [], []
    for w in range(_NWIN):
        pt = tables[w][digs[w]]                 # (n, 2, 16)
        nz = (digs[w] != 0)[:, None]
        xs.append(torch.where(nz, pt[:, 0], 0))
        ys.append(torch.where(nz, pt[:, 1], one))
        zs.append(torch.where(nz, one, 0))
    proj = MSM._tree_add((torch.stack(xs), torch.stack(ys), torch.stack(zs)))
    zinv = F.batch_inv(FQ, proj[2])
    return F.mont_mul(FQ, proj[0], zinv), F.mont_mul(FQ, proj[1], zinv)


def _gen_g1_powers(k: int, tau: int, device):
    """[tau^i] G1 for i < 2^k."""
    n = 1 << k
    scal = []
    acc = 1
    for _ in range(n):
        scal.append(acc)
        acc = acc * tau % FR.modulus
    return _points_from_scalars(scal, device)


def setup(k: int, device, seed: bytes = b"halo2_aes_tpu dev srs",
          cache_dir: str | None = "ptau") -> SRS:
    """Deterministic dev SRS on ``device`` (cached).  NOT a trusted setup."""
    device = torch.device(device)
    tau = int.from_bytes(
        hashlib.blake2b(seed, digest_size=64).digest(), "little") % FR.modulus
    g1_extra = CV.py_mul((CV.G1_X, CV.G1_Y), pow(tau, 1 << k, FR.modulus))
    s_g2 = PR.g2_mul(PR.G2, tau)
    path = None
    if cache_dir is not None:
        tag = hashlib.blake2b(seed, digest_size=8).hexdigest()
        path = os.path.join(cache_dir, f"kzg_bn254_{k}_{tag}.npz")
        if os.path.exists(path):
            z = np.load(path)
            srs = SRS(k, F.limbs(z["g1_x"], device), F.limbs(z["g1_y"], device),
                      PR.G2, s_g2, cache_dir=cache_dir, g1_extra=g1_extra)
            object.__setattr__(
                srs, "_tag", _tag_from_host(z["g1_x"], z["g1_y"], s_g2))
            return srs
    g1_x, g1_y = _gen_g1_powers(k, tau, device)
    srs = SRS(k, g1_x, g1_y, PR.G2, s_g2, cache_dir=cache_dir, g1_extra=g1_extra)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, g1_x=F.to_numpy(g1_x), g1_y=F.to_numpy(g1_y))
    return srs
