"""Key generation: verifying key + proving key (port of
``backend/keygen.py``).

Keygen lifts the referenced fixed columns to field form, builds the
permutation assembly from the layout's copy pairs, interpolates
everything with one batched INTT per group, and commits.  The vk and
its digest are byte-for-byte the reference's.  From
``rest.HOST_REST_MIN_K`` on, the pk's coefficient stacks wait in pinned
host memory (the prover copies back the polys it reads).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from halo2_aes_tpu_torch.backend import permutation as PERM
from halo2_aes_tpu_torch.backend import rest
from halo2_aes_tpu_torch.backend.srs import SRS
from halo2_aes_tpu_torch.backend.transcript import point_to_bytes
from halo2_aes_tpu_torch.circuit.ir import CompiledCircuit, cs_bytes
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as MSM
from halo2_aes_tpu_torch.ops.ntt import domain, ntt_many
from halo2_aes_tpu_torch.parallel import msm as PMSM
from halo2_aes_tpu_torch.utils import timers

FR = F.FR


@dataclass
class VerifyingKey:
    k: int
    ext_k: int
    usable: int
    cs: object                       # host ConstraintSystem
    fixed_ids: list                  # global ids, commitment order
    fixed_commitments: list          # affine (x, y) plain-int pairs
    sigma_commitments: list
    g2: tuple = None
    s_g2: tuple = None
    digest: int = 0

    def _compute_digest(self) -> int:
        """Byte-serialized vk digest (the reference's, unchanged)."""
        h = hashlib.blake2b(b"halo2_aes_tpu vk v2", digest_size=64)
        for v in (self.k, self.ext_k, self.usable):
            h.update(int(v).to_bytes(8, "little"))
        h.update(cs_bytes(self.cs))
        for pt in self.fixed_commitments + self.sigma_commitments:
            h.update(point_to_bytes(pt))
        return int.from_bytes(h.digest(), "little") % FR.modulus


@dataclass
class ProvingKey:
    vk: VerifyingKey
    srs: SRS
    layout: CompiledCircuit
    assembly: object                 # PermutationAssembly (host numpy)
    fixed_coeffs: dict               # col id -> (n, 16) coefficient tensor
    sigma_coeffs: torch.Tensor       # FLAT (m*n, 16)
    perm_maps: tuple                 # (map_col, map_row) int64 tensors
    l0_coeffs: torch.Tensor
    l_last_coeffs: torch.Tensor
    l_active_coeffs: torch.Tensor

    def __post_init__(self):
        """From ``rest.HOST_REST_MIN_K`` on, the coefficient stacks wait
        in pinned host memory, however the pk was made (keygen, a cache,
        ``convert.pk_from_numpy``); the fixed polys and the selectors
        poly by poly (2^k x 64 B is a power of two, the size the pinned
        allocator rounds every block up to)."""
        if rest.on_host(self.vk.k):
            self.fixed_coeffs = {c: rest.park(v)
                                 for c, v in self.fixed_coeffs.items()}
            self.sigma_coeffs = rest.park(self.sigma_coeffs)
            self.l0_coeffs = rest.park(self.l0_coeffs)
            self.l_last_coeffs = rest.park(self.l_last_coeffs)
            self.l_active_coeffs = rest.park(self.l_active_coeffs)

    @property
    def device(self):
        return self.srs.device


# Toy domains up to this many points commit on the host (python bigints,
# as the reference's keygen does); tests lower it to run the device MSM
HOST_MSM_MAX_N = 512


def commit_affine(srs: SRS, coeffs, mesh=None):
    """Commit one coefficient poly -> affine point (plain ints) or None.

    Toy domains (``HOST_MSM_MAX_N``) fold on the host with python
    bigints, as the reference's keygen does; the affine result is the
    same point the device MSM gives.  With a ``mesh`` (parallel/comm.py)
    the sharded MSM commits at every n, as the reference's mesh prover
    does.  Each call of this and of ``commit_many`` is one ``commit``
    span (utils/timers.py): its polys, the SRS points an MSM takes, and
    ``tables`` (whether window tables were used)."""
    with timers.span("commit", polys=1, points=srs.n,
                     tables=_tables_used(srs, mesh)):
        return _commit_one(srs, coeffs, mesh)


def _tables_used(srs: SRS, mesh=None) -> int:
    """1 where the SRS's commitments run on MSM window tables, 0 where
    they do not (the host MSM of toy domains; the tableless device MSM
    with its Horner fold): what ``SRS.warm_tables`` built."""
    if mesh is None and srs.n <= HOST_MSM_MAX_N:
        return 0
    srs.warm_tables()
    return int(srs._msm_tables is not None)


def _commit_one(srs: SRS, coeffs, mesh=None):
    if mesh is not None:
        return PMSM.commit(mesh, srs, coeffs)
    if srs.n <= HOST_MSM_MAX_N:
        g1 = _srs_host_points(srs)
        scalars = FR.decode(coeffs)
        return CV.host_msm(g1[:len(scalars)], scalars)
    return CV.to_affine_host(srs.commit(coeffs))[0]


COMMIT_BATCH = 8


def commit_many(srs: SRS, polys, mesh=None) -> list:
    """Commit a list of coefficient polys (each (m <= n, 16)) -> affine
    points in order.  Above the toy size they go through ``msm_many``
    up to COMMIT_BATCH at a time: one K7 pass, one bucket set a poly.
    With a ``mesh``, every group is one sharded ``msm_many`` and one
    all-gather, at every n."""
    with timers.span("commit", polys=len(polys), points=srs.n,
                     tables=_tables_used(srs, mesh)):
        return _commit_many(srs, polys, mesh)


def _commit_many(srs: SRS, polys, mesh):
    if mesh is not None:
        return PMSM.commit_many(mesh, srs, polys, COMMIT_BATCH)
    if srs.n <= HOST_MSM_MAX_N or len(polys) < 2:
        return [_commit_one(srs, p) for p in polys]
    srs.warm_tables()
    # without window tables (MSM.TABLELESS_MIN_N) a batch saves nothing:
    # one commitment at a time keeps one poly's scalars and digits live
    batch = COMMIT_BATCH if srs._msm_tables is not None else 1
    out = []
    for lo in range(0, len(polys), batch):
        chunk = polys[lo:lo + batch]
        scalars = F.from_mont(FR, torch.cat([
            torch.nn.functional.pad(p, (0, 0, 0, srs.n - p.shape[0]))
            for p in chunk]))
        out += CV.to_affine_host(MSM.msm_many(
            (srs.g1_x, srs.g1_y), scalars, len(chunk),
            MSM.default_window(srs.n), srs._msm_tables))
    return out


def _srs_host_points(srs: SRS) -> list:
    pts = getattr(srs, "_host_points", None)
    if pts is None:
        xs = F.FQ.decode(srs.g1_x)
        ys = F.FQ.decode(srs.g1_y)
        pts = list(zip(xs, ys))
        object.__setattr__(srs, "_host_points", pts)
    return pts


def srs_identity(srs: SRS) -> str:
    """Short identity tag of an SRS (``SRS.identity_tag``): a cached pk
    built for another tau is never taken for this one."""
    return srs.identity_tag()


def layout_fingerprint(layout: CompiledCircuit) -> str:
    """Stable hash of everything keygen consumes from the layout."""
    h = hashlib.blake2b(digest_size=16)
    h.update(layout.k.to_bytes(4, "little"))
    h.update(cs_bytes(layout.cs))
    h.update(np.ascontiguousarray(layout.fixed).tobytes())
    h.update(np.ascontiguousarray(layout.copy_pairs).tobytes())
    return h.hexdigest()


def keygen_cached(layout: CompiledCircuit, srs: SRS,
                  cache_dir: str = "ptau") -> ProvingKey:
    """keygen with the reference's on-disk cache of the commitments and
    the permutation maps (same file name and format)."""
    tag = layout_fingerprint(layout)
    srs.warm_tables()
    path = os.path.join(cache_dir,
                        f"pk_{tag}_s{srs.k}_{srs.identity_tag()}.npz")

    def _dump(pts):
        return np.array([["", ""] if pt is None else [str(pt[0]), str(pt[1])]
                         for pt in pts], dtype=object)

    def _load(arr):
        return [None if pt[0] == "" else tuple(int(v) for v in pt)
                for pt in arr]

    if os.path.exists(path):
        z = np.load(path, allow_pickle=True)
        return keygen(layout, srs, _precomputed={
            "fixed_comms": _load(z["fixed_comms"]),
            "sigma_comms": _load(z["sigma_comms"]),
            "assembly": PERM.PermutationAssembly(
                list(layout.cs.perm_columns), z["map_col"], z["map_row"]),
        })
    pk = keygen(layout, srs)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, fixed_comms=_dump(pk.vk.fixed_commitments),
             sigma_comms=_dump(pk.vk.sigma_commitments),
             map_col=pk.assembly.map_col, map_row=pk.assembly.map_row)
    return pk


def keygen(layout: CompiledCircuit, srs: SRS,
           _precomputed: dict | None = None) -> ProvingKey:
    """Proving key on the SRS's device."""
    cs = layout.cs
    k = layout.k
    assert srs.k >= k, "SRS too small"
    n = layout.n
    dev = srs.device
    ext_k = k + max(1, (cs.degree() - 2).bit_length())
    usable = layout.usable_rows
    dom = domain(FR, k)

    referenced = cs.referenced_columns()
    fixed_ids = [c for c in layout.fixed_ids() if c in referenced]
    fixed_stack = layout.fixed[fixed_ids]
    assert int(fixed_stack.max(initial=0)) < (1 << 16)

    if _precomputed is not None and "assembly" in _precomputed:
        assembly = _precomputed["assembly"]
    else:
        assembly = PERM.build_assembly(cs.perm_columns, n, layout.copy_pairs)
    m_perm = len(cs.perm_columns)
    omega_pows, delta_pows = PERM._label_tables(k, max(m_perm, 1), dev)
    map_col = torch.as_tensor(assembly.map_col, dtype=torch.int64, device=dev)
    map_row = torch.as_tensor(assembly.map_row, dtype=torch.int64, device=dev)

    fld = F.u16_to_field(FR, torch.as_tensor(
        fixed_stack.astype(np.int32), device=dev).reshape(-1))
    fixed_flat = ntt_many(dom, fld, len(fixed_ids), inverse=True)
    if m_perm:
        sigma_values = F.mont_mul(FR, delta_pows[map_col.reshape(-1)],
                                  omega_pows[map_row.reshape(-1)])
        sigma_coeffs = ntt_many(dom, sigma_values, m_perm, inverse=True)
    else:
        sigma_coeffs = torch.zeros((0, F.LIMBS), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    one = F.const(FR, "one", dev)
    ind = torch.cat([F.select(rows == 0, one, 0),
                     F.select(rows == usable, one, 0),
                     F.select(rows < usable, one, 0)])
    ind_coeffs = ntt_many(dom, ind, 3, inverse=True)

    fixed_coeffs = {c: fixed_flat[i * n:(i + 1) * n]
                    for i, c in enumerate(fixed_ids)}
    if _precomputed is None:
        fixed_comms = commit_many(srs, [fixed_coeffs[c] for c in fixed_ids])
        sigma_comms = commit_many(srs, [sigma_coeffs[i * n:(i + 1) * n]
                                        for i in range(m_perm)])
    else:
        fixed_comms = _precomputed["fixed_comms"]
        sigma_comms = _precomputed["sigma_comms"]

    vk = VerifyingKey(k, ext_k, usable, cs, fixed_ids, fixed_comms,
                      sigma_comms, g2=srs.g2, s_g2=srs.s_g2)
    vk.digest = vk._compute_digest()
    return ProvingKey(
        vk=vk, srs=srs, layout=layout, assembly=assembly,
        fixed_coeffs=fixed_coeffs, sigma_coeffs=sigma_coeffs,
        perm_maps=(map_col, map_row),
        l0_coeffs=ind_coeffs[:n], l_last_coeffs=ind_coeffs[n:2 * n],
        l_active_coeffs=ind_coeffs[2 * n:3 * n])
