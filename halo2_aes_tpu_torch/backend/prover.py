"""The KZG/SHPLONK prover (port of ``backend/prover.py``).

The single-device, ``multiopen="shplonk"``, ``lookup_sort="field"``
path of the reference for k <= 18, phase by phase and in the same
transcript order, so that the same pk, witness and seed give the same
proof bytes:

  vk digest, instance values | advice commits | theta | per lookup:
  A'/S' commits | beta, gamma | permutation z commits | lookup z
  commits | random-poly commit | y | d-1 h piece commits | x | evals in
  protocol.open_queries order (h skipped) | y2, v | SHPLONK h commit |
  u | SHPLONK witness commit.

Every device tensor lives on the proving key's device.  Blinding
randomness is a ``numpy.random.Generator`` drawn in the reference's
order (``seed=None`` means ``os.urandom``).

The quotient is evaluated per SUB-COSET: the extended coset of ratio R
splits into R interleaved size-n cosets {g w_ext^s w^j}; rotations stay
intra-coset rolls.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from halo2_aes_tpu_torch.backend import lookup as LK
from halo2_aes_tpu_torch.backend import permutation as PERM
from halo2_aes_tpu_torch.backend import poly as P
from halo2_aes_tpu_torch.backend import protocol as PROTO
from halo2_aes_tpu_torch.backend.keygen import ProvingKey, commit_affine, commit_many
from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.ntt import domain, ntt_many

FR = F.FR
LIMBS = F.LIMBS
_R_LIMBS = F.int_to_limbs(FR.modulus)
MAX_K = 18


def _device_algebra(device):
    """Field algebra over (m, 16) Montgomery tensors for protocol.py."""

    class DeviceAlgebra:
        @staticmethod
        def const(v: int):
            return F.encode(FR, v, device)

        add = staticmethod(lambda a, b: F.add(FR, a, b))
        mul = staticmethod(lambda a, b: F.mont_mul(FR, a, b))
        neg = staticmethod(lambda a: F.neg(FR, a))

    return DeviceAlgebra


def _rand_field(rng, *shape) -> np.ndarray:
    """Exactly-uniform random field elements as (..., 16) numpy limbs:
    254-bit candidates from ``rng`` (None -> os.urandom), rejection-
    sampled below r, read as Montgomery representations (the
    reference's draw, byte for byte)."""
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    randbytes = os.urandom if rng is None else rng.bytes
    out = np.zeros((count, LIMBS), np.uint32)
    need = np.ones(count, bool)
    while need.any():
        m = int(need.sum())
        cand = (np.frombuffer(randbytes(32 * m), dtype="<u2")
                .reshape(m, LIMBS).astype(np.uint32).copy())
        cand[:, -1] &= 0x3FFF
        lt = np.zeros(m, bool)
        gt = np.zeros(m, bool)
        for i in range(LIMBS - 1, -1, -1):
            li, ri = cand[:, i], _R_LIMBS[i]
            lt |= ~gt & (li < ri)
            gt |= ~lt & (li > ri)
        idx = np.flatnonzero(need)[lt]
        out[idx] = cand[lt]
        need[idx] = False
    return out.reshape(*shape, LIMBS)


@functools.lru_cache(maxsize=None)
def _subcoset_tables_np(k: int, ext_k: int, s: int):
    """(shift_powers (n,16): (g w_ext^s)^i, zh_inv (16,): 1/Z_H on the
    sub-coset) as numpy limbs."""
    p = FR.modulus
    n = 1 << k
    w_ext = domain(FR, ext_k).omega
    shift = P.GEN * pow(w_ext, s, p) % p
    shift_powers = FR.host_powers(shift, n)
    zh_inv = F.int_to_limbs(FR.to_mont_host(pow(pow(shift, n, p) - 1, -1, p)))
    return shift_powers, zh_inv


@functools.lru_cache(maxsize=None)
def _coset_points(k: int, device):
    """(n, 16) Montgomery coset points g * w^j of domain(k)."""
    dom = domain(FR, k)
    p = FR.modulus
    out = []
    acc = P.GEN % p
    for _ in range(dom.n):
        out.append(FR.to_mont_host(acc))
        acc = acc * dom.omega % p
    return F.limbs(F.ints_to_limbs_fast(out), device)


class _Phases:
    """Per-pk phase functions and static plumbing (single device)."""

    def __init__(self, pk: ProvingKey):
        self.pk = pk
        vk = pk.vk
        cs = vk.cs
        layout = pk.layout
        self.dev = pk.device
        self.cs = cs
        self.layout = layout
        self.k, self.usable = vk.k, vk.usable
        self.n = layout.n
        self.ext_k = vk.ext_k
        self.dom = domain(FR, self.k)
        self.dom_ext = domain(FR, self.ext_k)
        self.ratio = self.dom_ext.n // self.n
        self.bf = self.n - self.usable - 1
        self.d = cs.degree()
        self.adv_ids = layout.advice_ids()
        self.inst_ids = layout.instance_ids()
        self.chunk_len = cs.permutation_chunk_len()
        self.chunks = -(-len(cs.perm_columns) // self.chunk_len)
        self.n_lk = len(cs.lookups)
        self.alg = _device_algebra(self.dev)

        self.needed_cols = sorted(cs.referenced_columns())
        dyn_cols = set(self.adv_ids) | set(self.inst_ids)
        skeys = [("col", c) for c in self.needed_cols if c not in dyn_cols]
        skeys += [("sigma", i) for i in range(len(cs.perm_columns))]
        skeys += [("l0",), ("l_last",), ("l_active",)]
        dkeys = [("col", c) for c in self.needed_cols if c in dyn_cols]
        dkeys += [("perm_z", t) for t in range(self.chunks)]
        for i in range(self.n_lk):
            dkeys += [("lookup_z", i), ("lookup_a", i), ("lookup_s", i)]
        self.q_static_keys = skeys
        self.q_dyn_keys = dkeys
        self._static_evals = {}          # sub-coset s -> (S*n, 16)
        self._delta_pows = F.limbs(
            FR.host_powers(PERM.delta(), len(cs.perm_columns)), self.dev)
        self.shp_sets = PROTO.rotation_sets(PROTO.open_queries(cs))
        self.shp_sizes = tuple(len(keys) for _, keys in self.shp_sets)

    def tensor(self, arr):
        return F.limbs(arr, self.dev)

    def encode(self, v):
        return F.encode(FR, v, self.dev)

    def _ntt_many(self, flat, count: int, inverse: bool, shift_pows=None):
        return ntt_many(self.dom, flat, count, inverse=inverse,
                        shift_pows=shift_pows)

    def _column_ctx(self, all_fld, theta_m):
        n = self.n

        def col_fld(col, rot):
            v = all_fld[col * n:(col + 1) * n]
            return torch.roll(v, -rot, 0) if rot else v

        class Ctx(PROTO.Context):
            alg = self.alg
            theta = theta_m
            column = staticmethod(col_fld)

        return Ctx

    def eval_many(self, flat, x_m, count: int):
        """Evaluate ``count`` size-n coefficient polys (FLAT) at x_m ->
        (count, 16) Montgomery values."""
        n = self.n
        pw = F.powers(FR, x_m, n)
        cur = F.mont_mul(FR, flat.reshape(count, n, LIMBS), pw)
        m = n
        while m > 1:
            half = m // 2
            cur = F.add(FR, cur[:, :half], cur[:, half:2 * half])
            m = half
        return cur.reshape(count, LIMBS)

    # -- phase 1: lift all columns, blind advice, INTT ---------------------

    def advice_phase(self, values, adv_blinding, inst_vals):
        usable, n = self.usable, self.n
        if len(self.inst_ids):
            values = values.clone()
            values[torch.as_tensor(self.inst_ids, device=self.dev)] = inst_vals
        all_fld = F.u16_to_field(FR, values.reshape(-1))
        for i, c in enumerate(self.adv_ids):
            all_fld[c * n + usable:(c + 1) * n] = adv_blinding[i]
        adv_flat = torch.cat([all_fld[c * n:(c + 1) * n] for c in self.adv_ids])
        adv_coeffs = self._ntt_many(adv_flat, len(self.adv_ids), inverse=True)
        if len(self.inst_ids):
            inst_flat = torch.cat([all_fld[c * n:(c + 1) * n]
                                   for c in self.inst_ids])
            inst_coeffs = self._ntt_many(inst_flat, len(self.inst_ids),
                                         inverse=True)
        else:
            inst_coeffs = torch.zeros((0, LIMBS), dtype=torch.int32,
                                      device=self.dev)
        return all_fld, adv_coeffs, inst_coeffs

    # -- phase 2: lookup permuted pairs (field order) ----------------------

    def lookup_phase(self, all_fld, theta_m, bl_a, bl_s):
        u, L = self.usable, self.n_lk
        Ctx = self._column_ctx(all_fld, theta_m)
        a_us = torch.cat([PROTO.compressed_input(Ctx, lk)[:u]
                          for lk in self.cs.lookups])
        s_us = torch.cat([PROTO.compressed_table(Ctx, lk)[:u]
                          for lk in self.cs.lookups])
        a_ord, t_perm = LK.permuted_indices_field_many(
            F.from_mont(FR, a_us), F.from_mont(FR, s_us), L, u)
        rowu = torch.arange(L, device=self.dev)[:, None] * u
        a_pr = a_us[(a_ord + rowu).reshape(-1)]
        s_pr = s_us[(t_perm + rowu).reshape(-1)]
        a_prime = torch.cat([x for l in range(L)
                             for x in (a_pr[l * u:(l + 1) * u], bl_a[l])])
        s_prime = torch.cat([x for l in range(L)
                             for x in (s_pr[l * u:(l + 1) * u], bl_s[l])])
        a_coeffs = self._ntt_many(a_prime, L, inverse=True)
        s_coeffs = self._ntt_many(s_prime, L, inverse=True)
        return a_prime, s_prime, a_coeffs, s_coeffs

    # -- phase 3: grand products -------------------------------------------

    def perm_products(self, all_fld, map_col, map_row, beta_m, gamma_m,
                      z_blind):
        m = len(self.cs.perm_columns)
        omega_pows, delta_pows = PERM._label_tables(self.k, m, self.dev)
        z_perm = PERM.grand_products(
            self.k, self.usable, self.chunk_len, all_fld,
            list(self.cs.perm_columns), map_col, map_row,
            omega_pows, delta_pows, beta_m, gamma_m, z_blind)
        return self._ntt_many(z_perm, self.chunks, inverse=True)

    def lookup_products_all(self, all_fld, lk_ap, lk_sp, theta_m, beta_m,
                            gamma_m, blinds):
        Ctx = self._column_ctx(all_fld, theta_m)
        a_all = torch.cat([PROTO.compressed_input(Ctx, lk)
                           for lk in self.cs.lookups])
        s_all = torch.cat([PROTO.compressed_table(Ctx, lk)
                           for lk in self.cs.lookups])
        return LK.grand_product_many(a_all, s_all, lk_ap, lk_sp, self.n_lk,
                                     self.usable, beta_m, gamma_m, blinds)

    # -- phase 4: quotient on sub-cosets -----------------------------------

    def static_subcoset_evals(self, s: int):
        """Sub-coset evaluations of the proof-independent quotient polys,
        cached per pk per sub-coset."""
        out = self._static_evals.get(s)
        if out is None:
            shift_np, _ = _subcoset_tables_np(self.k, self.ext_k, s)
            stack = torch.cat([self._coeffs_static(key)
                               for key in self.q_static_keys])
            out = self._ntt_many(stack, len(self.q_static_keys), inverse=False,
                                 shift_pows=self.tensor(shift_np))
            self._static_evals[s] = out
        return out

    def _coeffs_static(self, key):
        pk = self.pk
        kind = key[0]
        if kind == "col":
            return pk.fixed_coeffs[key[1]]
        if kind == "sigma":
            return pk.sigma_coeffs[key[1] * self.n:(key[1] + 1) * self.n]
        if kind == "l0":
            return pk.l0_coeffs
        if kind == "l_last":
            return pk.l_last_coeffs
        if kind == "l_active":
            return pk.l_active_coeffs
        raise KeyError(key)

    def quotient_subcoset(self, static_evals, dyn_evals, theta_m, beta_m,
                          gamma_m, y_m, shift_pows, zh_inv):
        """One sub-coset's quotient values: Horner-fold every constraint
        term with y, divide by Z_H."""
        n = self.n
        by_key = {key: static_evals[i * n:(i + 1) * n]
                  for i, key in enumerate(self.q_static_keys)}
        by_key.update({key: dyn_evals[i * n:(i + 1) * n]
                       for i, key in enumerate(self.q_dyn_keys)})
        pts = F.mont_mul(FR, self.dom.omega_powers(self.dev), shift_pows[1])
        delta_pows = self._delta_pows
        usable = self.usable

        def rot_roll(arr, rot):
            r = usable if rot == "u" else rot
            return torch.roll(arr, -r, 0) if r else arr

        class Ctx(PROTO.Context):
            alg = self.alg
            one = F.const(FR, "one", self.dev)
            theta, beta, gamma = theta_m, beta_m, gamma_m
            l0 = by_key[("l0",)]
            l_last = by_key[("l_last",)]
            l_active = by_key[("l_active",)]
            column = staticmethod(
                lambda col, rot: rot_roll(by_key[("col", col)], rot))
            perm_z = staticmethod(
                lambda t, rot: rot_roll(by_key[("perm_z", t)], rot))
            sigma = staticmethod(lambda i: by_key[("sigma", i)])
            perm_id = staticmethod(
                lambda i: F.mont_mul(FR, delta_pows[i], pts))
            lookup_z = staticmethod(
                lambda i, rot: rot_roll(by_key[("lookup_z", i)], rot))
            lookup_a = staticmethod(
                lambda i, rot: rot_roll(by_key[("lookup_a", i)], rot))
            lookup_s = staticmethod(lambda i: by_key[("lookup_s", i)])

        acc = None
        for term in PROTO.constraint_terms(self.cs, Ctx):
            acc = term if acc is None else F.add(
                FR, F.mont_mul(FR, acc, y_m), term)
        return F.mont_mul(FR, acc, zh_inv)

    def quotient_finish(self, q_flat):
        """Interleave the sub-coset values back to extended-coset order,
        interpolate, keep the d-1 live pieces (FLAT ((d-1)*n, 16))."""
        n, R = self.n, self.ratio
        q_ext = q_flat.reshape(R, n, LIMBS).transpose(0, 1).reshape(R * n, LIMBS)
        h = P.coset_interp(self.dom_ext, q_ext)
        return h[:(self.d - 1) * n]

    def h_combine(self, pieces_flat, xn_pows):
        n = self.n
        acc = None
        for j in range(self.d - 1):
            term = F.mont_mul(FR, pieces_flat[j * n:(j + 1) * n], xn_pows[j])
            acc = term if acc is None else F.add(FR, acc, term)
        return acc

    # -- phase 6: SHPLONK --------------------------------------------------

    def shplonk_fold(self, members_flat, weights):
        """Per-cluster weighted member fold -> (K*n, 16)."""
        n = self.n
        outs = []
        idx = 0
        for sz in self.shp_sizes:
            acc = None
            for _ in range(sz):
                t = F.mont_mul(FR, members_flat[idx * n:(idx + 1) * n],
                               weights[idx])
                acc = t if acc is None else F.add(FR, acc, t)
                idx += 1
            outs.append(acc)
        return torch.cat(outs)

    def shplonk_f(self, poly_flat, corr, zcs):
        """f(X) = sum_k v_k Z_{T\\S_k}(X) (p_k(X) - r_k(X)) -> (n+D-1, 16)."""
        n = self.n
        G, Dr, D = corr.shape[0], corr.shape[1], zcs.shape[1]
        terms = [None] * D
        for g in range(G):
            pg = poly_flat[g * n:(g + 1) * n].clone()
            pg[:Dr] = F.sub(FR, pg[:Dr], corr[g])
            for dd in range(D):
                t = F.mont_mul(FR, pg, zcs[g, dd])
                terms[dd] = t if terms[dd] is None else F.add(FR, terms[dd], t)
        out = torch.zeros((n + D - 1, LIMBS), dtype=torch.int32,
                          device=self.dev)
        for dd in range(D):
            out[dd:dd + n] = F.add(FR, out[dd:dd + n], terms[dd])
        return out

    def hshp_blind_fix(self, h_shp, x_m, coef_m):
        """h_shp += coef * sum_i x^{n-1-i} X^i."""
        rev_pows = F.powers(FR, x_m, self.n).flip(0)
        return F.add(FR, h_shp, F.mont_mul(FR, rev_pows, coef_m))

    def shplonk_h(self, f_acc, zt_coeffs_m):
        """h_shp = [f / Z_T] via evaluation on the 2n coset."""
        dom1 = domain(FR, self.k + 1)
        f_ev = P.coset_evals(dom1, P.pad_coeffs(f_acc, dom1.n))
        pts = _coset_points(self.k + 1, self.dev)
        D = zt_coeffs_m.shape[0]
        acc = zt_coeffs_m[D - 1].expand(dom1.n, LIMBS)
        for d in range(D - 2, -1, -1):
            acc = F.add(FR, F.mont_mul(FR, acc, pts), zt_coeffs_m[d])
        return P.coset_interp(
            dom1, F.mont_mul(FR, f_ev, F.batch_inv(FR, acc)))[:self.n]

    def shplonk_l(self, poly_flat, svals, h_shp, neg_zt_u, const_corr, u_m):
        """L(X) and the final witness quotient W' = L / (X - u)."""
        n = self.n
        acc = F.mont_mul(FR, h_shp, neg_zt_u)
        for g in range(svals.shape[0]):
            acc = F.add(FR, acc, F.mont_mul(
                FR, poly_flat[g * n:(g + 1) * n], svals[g]))
        acc = acc.clone()
        acc[0] = F.sub(FR, acc[0], const_corr)
        l_ev = P.coset_evals(self.dom, acc)
        den = F.sub(FR, _coset_points(self.k, self.dev), u_m)
        return P.coset_interp(
            self.dom, F.mont_mul(FR, l_ev, F.batch_inv(FR, den)))


def _get_phases(pk: ProvingKey) -> _Phases:
    ph = getattr(pk, "_phases", None)
    if ph is None:
        ph = _Phases(pk)
        pk._phases = ph
    return ph


def _stagger_blind_pieces(piece_pts, blinds, g1_extra):
    """C'_j = C_j + b_j [tau^n]G1 - b_{j-1} G1 (host point math): piece j
    is blinded as p_j - b_{j-1} + b_j X^n, which telescopes."""
    G = (CV.G1_X, CV.G1_Y)
    r = FR.modulus
    out = []
    for j, pt in enumerate(piece_pts):
        if j < len(blinds):
            pt = CV.py_add(pt, CV.py_mul(g1_extra, blinds[j]))
        if 0 < j <= len(blinds):
            pt = CV.py_add(pt, CV.py_mul(G, (r - blinds[j - 1]) % r))
        out.append(pt)
    return out


def _commit_pts(ph, flat, count):
    """Commit ``count`` size-n polys from a FLAT tensor -> affine points."""
    n = ph.n
    return commit_many(ph.pk.srs, [flat[i * n:(i + 1) * n] for i in range(count)])


def prove(pk: ProvingKey, values, instances=None, seed=None,
          mesh=None, multiopen: str = "shplonk", lookup_sort: str = "field",
          checkpoint_dir: str | None = None) -> bytes:
    """values: (num_columns, n) int merged column matrix (tensor or numpy;
    moved to the pk's device).  instances: per instance column, a list
    of python ints.  ``seed`` selects a reproducible blinding stream
    (tests only; None draws from os.urandom).  Returns proof bytes.

    Only the single-device KZG/SHPLONK path with field-ordered lookups
    at k <= 18 is ported; the other options raise NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError("mesh proving is not ported")
    if multiopen != "shplonk":
        raise NotImplementedError(f"multiopen={multiopen!r} is not ported")
    if lookup_sort != "field":
        raise NotImplementedError(f"lookup_sort={lookup_sort!r} is not ported")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint/resume is not ported")
    if pk.vk.k > MAX_K:
        raise NotImplementedError(f"k={pk.vk.k} > {MAX_K} (sliced phases)")

    ph = _get_phases(pk)
    vk, cs, layout = pk.vk, pk.vk.cs, pk.layout
    dev = ph.dev
    n, usable, bf = ph.n, ph.usable, ph.bf
    rng = None if seed is None else np.random.default_rng(seed)
    tr = TranscriptWriter()
    T = ph.tensor
    enc = ph.encode

    tr.common_scalar(vk.digest)
    inst_ids = ph.inst_ids
    values = torch.as_tensor(np.asarray(values) if not isinstance(
        values, torch.Tensor) else values).to(device=dev, dtype=torch.int32)
    if instances is None:
        instances = []
        values_np = values[inst_ids].cpu().numpy() if inst_ids else None
        for i, c in enumerate(inst_ids):
            mapped = np.nonzero(layout.witness_map[c] >= 0)[0]
            ln = int(mapped.max()) + 1 if len(mapped) else 0
            instances.append([int(v) for v in values_np[i][:ln]])
    assert len(instances) == len(inst_ids)
    for vals in instances:
        for v in vals:
            tr.common_scalar(int(v))
    inst_arr = np.zeros((len(inst_ids), n), dtype=np.int32)
    for i, vals in enumerate(instances):
        assert all(0 <= int(v) < (1 << 16) for v in vals)
        inst_arr[i, :len(vals)] = [int(v) % (1 << 16) for v in vals]

    # ---- phase 1: advice lift + blind + INTT + commits ----------------------
    adv_blinding = T(_rand_field(rng, len(ph.adv_ids), n - usable))
    all_fld, adv_coeffs, inst_coeffs = ph.advice_phase(
        values, adv_blinding, torch.as_tensor(inst_arr, device=dev))
    for pt in _commit_pts(ph, adv_coeffs, len(ph.adv_ids)):
        tr.write_point(pt)

    theta = tr.squeeze_challenge()
    theta_m = enc(theta)

    # ---- phase 2: lookup permuted pairs ---------------------------------------
    if ph.n_lk:
        bl_a = T(_rand_field(rng, ph.n_lk, n - usable))
        bl_s = T(_rand_field(rng, ph.n_lk, n - usable))
        lk_ap, lk_sp, lk_a_coeffs, lk_s_coeffs = ph.lookup_phase(
            all_fld, theta_m, bl_a, bl_s)
        polys = []
        for i in range(ph.n_lk):       # transcript order: a'_i, s'_i
            polys += [lk_a_coeffs[i * n:(i + 1) * n], lk_s_coeffs[i * n:(i + 1) * n]]
        for pt in commit_many(pk.srs, polys):
            tr.write_point(pt)
    else:
        lk_a_coeffs = lk_s_coeffs = torch.zeros((0, LIMBS), dtype=torch.int32,
                                                device=dev)

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    beta_m, gamma_m = enc(beta), enc(gamma)

    # ---- phase 3: grand products + random poly --------------------------------
    z_blind = T(_rand_field(rng, ph.chunks, bf))
    lkz_blind = T(_rand_field(rng, max(ph.n_lk, 1), bf))
    if ph.chunks:
        z_perm_coeffs = ph.perm_products(all_fld, pk.perm_maps[0],
                                         pk.perm_maps[1], beta_m, gamma_m,
                                         z_blind)
    else:
        z_perm_coeffs = torch.zeros((0, LIMBS), dtype=torch.int32, device=dev)
    if ph.n_lk:
        z_all = ph.lookup_products_all(all_fld, lk_ap, lk_sp, theta_m, beta_m,
                                       gamma_m, lkz_blind)
        lkz_coeffs = ph._ntt_many(z_all, ph.n_lk, inverse=True)
    else:
        lkz_coeffs = torch.zeros((0, LIMBS), dtype=torch.int32, device=dev)
    random_coeffs = T(_rand_field(rng, n))
    for pt in commit_many(
            pk.srs,
            [z_perm_coeffs[t * n:(t + 1) * n] for t in range(ph.chunks)]
            + [lkz_coeffs[i * n:(i + 1) * n] for i in range(ph.n_lk)]
            + [random_coeffs]):
        tr.write_point(pt)
    del all_fld

    y = tr.squeeze_challenge()
    y_m = enc(y)

    # ---- phase 4: quotient ----------------------------------------------------
    def _sl(flat, i):
        return flat[i * n:(i + 1) * n]

    def coeffs_for(key):
        kind = key[0]
        if kind == "col":
            c = key[1]
            if c in ph.adv_ids:
                return _sl(adv_coeffs, ph.adv_ids.index(c))
            if c in inst_ids:
                return _sl(inst_coeffs, inst_ids.index(c))
            return pk.fixed_coeffs[c]
        if kind == "perm_z":
            return _sl(z_perm_coeffs, key[1])
        if kind == "lookup_z":
            return _sl(lkz_coeffs, key[1])
        if kind == "lookup_a":
            return _sl(lk_a_coeffs, key[1])
        if kind == "lookup_s":
            return _sl(lk_s_coeffs, key[1])
        return ph._coeffs_static(key)

    q_subs = []
    for s in range(ph.ratio):
        shift_np, zh_inv_np = _subcoset_tables_np(ph.k, ph.ext_k, s)
        shift_pows = T(shift_np)
        dyn_stack = torch.cat([coeffs_for(key) for key in ph.q_dyn_keys])
        dyn_evals = ph._ntt_many(dyn_stack, len(ph.q_dyn_keys), inverse=False,
                                 shift_pows=shift_pows)
        del dyn_stack
        q_subs.append(ph.quotient_subcoset(
            ph.static_subcoset_evals(s), dyn_evals, theta_m, beta_m, gamma_m,
            y_m, shift_pows, T(zh_inv_np)))
        del dyn_evals
    pieces = ph.quotient_finish(torch.cat(q_subs))
    del q_subs
    piece_pts = _commit_pts(ph, pieces, ph.d - 1)
    n_qb = ph.d - 2 if pk.srs.g1_extra is not None else 0
    if n_qb > 0:
        qb_limbs = _rand_field(rng, n_qb)
        q_blinds = [F.limbs_to_int(qb_limbs[j]) for j in range(n_qb)]
        piece_pts = _stagger_blind_pieces(piece_pts, q_blinds, pk.srs.g1_extra)
    else:
        q_blinds = []
    for pt in piece_pts:
        tr.write_point(pt)

    x = tr.squeeze_challenge()
    xn = pow(x, n, FR.modulus)
    xn_pows = T(FR.encode([pow(xn, j, FR.modulus) for j in range(ph.d - 1)]))
    h_combined = ph.h_combine(pieces, xn_pows)
    cn = 0
    for j, b in enumerate(q_blinds):
        cn = (cn + b * pow(xn, j, FR.modulus)) % FR.modulus

    # ---- evaluations ----------------------------------------------------------
    def poly_coeffs(key):
        if key[0] == "advice":
            return _sl(adv_coeffs, ph.adv_ids.index(key[1]))
        if key[0] == "fixed":
            return pk.fixed_coeffs[key[1]]
        if key[0] == "h":
            return h_combined
        if key[0] == "random":
            return random_coeffs
        return coeffs_for(key)

    omega = ph.dom.omega

    def rot_point(rot):
        r = usable if rot == "u" else rot
        return x * pow(omega, r % n, FR.modulus) % FR.modulus

    plan = PROTO.open_queries(cs)
    by_rot = {}
    for key, rot in plan:
        by_rot.setdefault(rot, []).append(key)
    evals = {}
    for rot, keys in by_rot.items():
        stack = torch.cat([poly_coeffs(kk) for kk in keys])
        vals = ph.eval_many(stack, enc(rot_point(rot)), len(keys))
        for kk, v in zip(keys, FR.decode(vals)):
            evals[(kk, rot)] = v
    for key, rot in plan:
        if key[0] != "h":
            tr.write_scalar(evals[(key, rot)])

    # ---- SHPLONK multiopen ----------------------------------------------------
    y2 = tr.squeeze_challenge()
    v = tr.squeeze_challenge()
    sets_ = ph.shp_sets
    K = len(sets_)
    t_rots = []
    for rots, _ in sets_:
        for r in rots:
            if r not in t_rots:
                t_rots.append(r)
    t_points = [rot_point(r) for r in t_rots]

    members = [key for _, keys in sets_ for key in keys]
    w_np = np.zeros((len(members), LIMBS), np.uint32)
    max_zc = max(len(t_points) - len(rots) + 1 for rots, _ in sets_)
    max_corr = max(len(rots) for rots, _ in sets_)
    corr_np = np.zeros((K, max_corr, LIMBS), np.uint32)
    zcs_np = np.zeros((K, max_zc, LIMBS), np.uint32)
    r_at = {}
    W_h = 0
    mi = 0
    for gi, (rots, keys) in enumerate(sets_):
        vpw = pow(v, K - 1 - gi, FR.modulus)
        pts = [rot_point(r) for r in rots]
        ev_fold = [0] * len(rots)
        for i, key in enumerate(keys):
            w = pow(y2, len(keys) - 1 - i, FR.modulus)
            w_np[mi] = F.int_to_limbs(FR.to_mont_host(w))
            mi += 1
            for j, r in enumerate(rots):
                ev_fold[j] = (ev_fold[j] + w * evals[(key, r)]) % FR.modulus
            if key == ("h",):
                assert rots == [0], rots
                W_h = vpw * w % FR.modulus
        r_coeffs = P.lagrange_interp_host(pts, ev_fold)
        corr_np[gi, :len(r_coeffs)] = F.ints_to_limbs_fast(
            [FR.to_mont_host(c) for c in r_coeffs])
        z_rest = P.vanishing_poly_coeffs([p_ for p_ in t_points if p_ not in pts])
        zcs_np[gi, :len(z_rest)] = F.ints_to_limbs_fast(
            [FR.to_mont_host(zc * vpw % FR.modulus) for zc in z_rest])
        r_at[gi] = (pts, ev_fold)

    members_flat = torch.cat([poly_coeffs(key) for key in members])
    poly_flat = ph.shplonk_fold(members_flat, T(w_np))
    del members_flat
    f_acc = ph.shplonk_f(poly_flat, T(corr_np), T(zcs_np))
    zt_coeffs_m = T(F.ints_to_limbs_fast(
        [FR.to_mont_host(c) for c in P.vanishing_poly_coeffs(t_points)]))
    h_shp = ph.shplonk_h(f_acc, zt_coeffs_m)
    if cn:
        h_shp = ph.hshp_blind_fix(h_shp, enc(x), enc(W_h * cn % FR.modulus))
    tr.write_point(commit_affine(pk.srs, h_shp))

    u = tr.squeeze_challenge()
    gn = pow(P.GEN, n, FR.modulus)
    zt_u = P.eval_host(P.vanishing_poly_coeffs(t_points), u)
    svals_np = np.zeros((K, LIMBS), np.uint32)
    const_corr = 0
    for gi, (rots, keys) in enumerate(sets_):
        vpw = pow(v, K - 1 - gi, FR.modulus)
        pts, ev_fold = r_at[gi]
        s = vpw * P.eval_host(
            P.vanishing_poly_coeffs([p_ for p_ in t_points if p_ not in pts]),
            u) % FR.modulus
        svals_np[gi] = F.int_to_limbs(FR.to_mont_host(s))
        r_u = P.eval_host(P.lagrange_interp_host(pts, ev_fold), u)
        const_corr = (const_corr + s * r_u) % FR.modulus
        if ("h",) in keys and cn:
            y2w = pow(y2, len(keys) - 1 - keys.index(("h",)), FR.modulus)
            const_corr = (const_corr
                          - s * y2w % FR.modulus * cn % FR.modulus
                          * (gn - xn)) % FR.modulus

    q_w = ph.shplonk_l(poly_flat, T(svals_np), h_shp,
                       enc(FR.modulus - zt_u), enc(const_corr), enc(u))
    tr.write_point(commit_affine(pk.srs, q_w))
    return tr.finalize()
