"""The reference that decides ``correct``: every point and scalar of a
KZG + SHPLONK proof of a compiled circuit, worked out from the inputs.

The dev SRS's secret tau is public (blake2b of its seed string), so a
commitment to a polynomial f is the point [f(tau)] G1, and f(tau) is a
sum over f's values on the domain weighted by the Lagrange basis at
tau.  No transform and no multi-scalar multiplication is needed: the
reference computes each column (the witness from its own AES, the
fixed columns and the permutation from its own layout, the permuted
lookup columns sorted by field value, the grand products, the blinding
values from the request's seed), replays the Fiat-Shamir transcript
itself, and writes the proof it expects, word by word:

  vk digest | advice | theta | A', S' per lookup | beta, gamma |
  permutation z | lookup z | random poly | y | quotient pieces | x |
  evaluations | y2, v | SHPLONK h | u | opening witness.

Two places take the proof's own points: the d - 1 quotient pieces are
judged by their one combination that the protocol fixes, sum_j
tau^(nj) C_j = [h(tau)] G1 with h(tau) the constraint identity at tau
over Z_H(tau); and the two SHPLONK points are expected as [a] G1 +
b sum_j x^(nj) C_j, the pieces entering as the verifier folds them.

Field work runs in plain PyTorch (``field.py``) on the device it is
given; curve work in Python integers (``curve.py``).  Nothing of the
program is imported.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from benchmark.reference import curve as CV
from benchmark.reference import field as F
from benchmark.reference.frozen import protocol as PROTO
from benchmark.reference.frozen.ir import ADVICE, cs_bytes

P = F.P
LIMBS = F.LIMBS
DEV_SRS_SEED = b"halo2_aes_tpu dev srs"
TWO_ADICITY = 28
DELTA = pow(7, 1 << TWO_ADICITY, P)
# the grand products' z columns are worked out GRAND_COLUMNS at a time,
# GRAND_ROWS rows a pass: the check holds a few (GRAND_COLUMNS,
# GRAND_ROWS, 16) int64 blocks at a time, whatever n and the number of
# lookups are
GRAND_COLUMNS = 4
GRAND_ROWS = 1 << 20


def tau_of(seed: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(), "little") % P


def rand_field(rng, *shape) -> np.ndarray:
    """The blinding stream: 254-bit candidates from ``rng.bytes``,
    rejection-sampled below p, read as Montgomery representations;
    (..., 16) int64 limbs."""
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    p_limbs = F.to_limbs([P])[0]
    out = np.zeros((count, LIMBS), np.int64)
    need = np.ones(count, bool)
    while need.any():
        m = int(need.sum())
        cand = np.frombuffer(rng.bytes(32 * m), dtype="<u2").reshape(m, LIMBS).astype(np.int64)
        cand[:, -1] &= 0x3FFF
        lt = np.zeros(m, bool)
        gt = np.zeros(m, bool)
        for i in range(LIMBS - 1, -1, -1):
            lt |= ~gt & (cand[:, i] < p_limbs[i])
            gt |= ~lt & (cand[:, i] > p_limbs[i])
        idx = np.flatnonzero(need)[lt]
        out[idx] = cand[lt]
        need[idx] = False
    return out.reshape(*shape, LIMBS)


def build_assembly(perm_columns, n: int, copy_pairs):
    """Copy constraints -> sigma as (map_col, map_row) (m, n): cells of a
    cycle point each to the next cell of the cycle in (column, row)
    order, the last to the first."""
    m = len(perm_columns)
    N = m * n
    pos = {c: i for i, c in enumerate(perm_columns)}
    pairs = np.asarray(copy_pairs, dtype=np.int64).reshape(-1, 4)
    a = np.array([pos[c] for c in pairs[:, 0]], np.int64) * n + pairs[:, 1]
    b = np.array([pos[c] for c in pairs[:, 2]], np.int64) * n + pairs[:, 3]
    parent = np.arange(N, dtype=np.int64)
    while True:                       # union by smallest index to a fixpoint
        lo = np.minimum(parent[a], parent[b])
        np.minimum.at(parent, parent[a], lo)
        np.minimum.at(parent, parent[b], lo)
        while True:
            nxt = parent[parent]
            if np.array_equal(nxt, parent):
                break
            parent = nxt
        if np.array_equal(parent[a], parent[b]):
            break
    order = np.argsort(parent, kind="stable")
    roots = parent[order]
    start = np.ones(N, bool)
    start[1:] = roots[1:] != roots[:-1]
    starts = np.flatnonzero(start)
    nxt_pos = np.arange(1, N + 1, dtype=np.int64)
    ends = np.append(starts[1:] - 1, N - 1)
    nxt_pos[ends] = starts
    nxt = np.empty(N, np.int64)
    nxt[order] = order[nxt_pos]
    return (nxt // n).reshape(m, n), (nxt % n).reshape(m, n)


class _Ints:
    """Integer algebra for expressions over numpy columns."""

    const = staticmethod(lambda v: v)
    add = staticmethod(lambda a, b: a + b)
    mul = staticmethod(lambda a, b: a * b)
    neg = staticmethod(lambda a: -a)


class _Mod:
    const = staticmethod(lambda v: v % P)
    add = staticmethod(lambda a, b: (a + b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    neg = staticmethod(lambda a: -a % P)


def _interp_at(points, values, z):
    """The polynomial through (points, values), evaluated at z."""
    total = 0
    for i, (xi, yi) in enumerate(zip(points, values)):
        num, den = 1, 1
        for j, xj in enumerate(points):
            if j != i:
                num = num * (z - xj) % P
                den = den * (xi - xj) % P
        total = (total + yi * num * pow(den, -1, P)) % P
    return total


def _vanish_at(points, z):
    out = 1
    for t in points:
        out = out * (z - t) % P
    return out


def _unique_rows(rows: np.ndarray):
    """(unique rows, inverse) of an int64 (N, K) array, through one int64
    key per row where the value ranges allow it."""
    lo = rows.min(axis=0)
    span = rows.max(axis=0) - lo + 1
    if float(np.prod(span.astype(np.float64))) < 2.0 ** 62:
        key = np.zeros(rows.shape[0], np.int64)
        for j in range(rows.shape[1]):
            key = key * int(span[j]) + (rows[:, j] - lo[j])
        _, first, inv = np.unique(key, return_index=True, return_inverse=True)
        return rows[first], inv
    return np.unique(rows, axis=0, return_inverse=True)


class Reference:
    """What the reference derives once for a compiled circuit (its own
    layout): the Lagrange basis at tau, the fixed and permutation
    columns, the verifying key's commitments and its digest.  ``check``
    then judges one proof."""

    def __init__(self, layout, device, srs_seed: bytes = DEV_SRS_SEED):
        cs = layout.cs
        self.layout, self.cs, self.dev = layout, cs, torch.device(device)
        if layout.instance_ids():
            raise NotImplementedError("circuits with instance columns")
        self.k = k = layout.k
        self.n = n = 1 << k
        self.usable = layout.usable_rows
        self.bf = n - self.usable - 1
        self.d = cs.degree()
        self.ext_k = k + max(1, (self.d - 2).bit_length())
        self.tau = tau_of(srs_seed)
        self.omega = pow(pow(7, (P - 1) >> TWO_ADICITY, P), 1 << (TWO_ADICITY - k), P)
        self.adv_ids = layout.advice_ids()
        self.perm_cols = list(cs.perm_columns)
        self.chunk_len = cs.permutation_chunk_len()
        self.chunks = -(-len(self.perm_cols) // self.chunk_len)
        self.n_lk = len(cs.lookups)
        referenced = cs.referenced_columns()
        self.fixed_ids = [c for c in layout.fixed_ids() if c in referenced]
        self.plan = PROTO.open_queries(cs)
        self.rots = self._rotations()
        self.W = F.powers(self.omega, n, self.dev)              # omega^i, mont
        self.tau_bases = self._lagrange_bases(self.tau)
        self.tau_pows = F.from_mont(F.powers(self.tau, n, self.dev))
        lag = F.from_limbs(self.tau_bases[0][self.usable:])
        self.l_last_tau = lag[0]
        self.l_active_tau = (1 - sum(lag)) % P
        self.l0_tau = F.from_limbs(self.tau_bases[0][0])[0]

        self.polys = {}                       # key -> std limbs (n, 16) int32
        self.tau_vals = {}                    # (key, rot) -> int
        fixed = np.asarray(layout.fixed, dtype=np.int64)
        for c in self.fixed_ids:
            self._add_poly(("fixed", c), self._small(fixed[c]))
        map_col, map_row = build_assembly(self.perm_cols, n, layout.copy_pairs)
        deltas = F.mont([pow(DELTA, i, P) for i in range(max(len(self.perm_cols), 1))],
                        self.dev)
        for i in range(len(self.perm_cols)):       # sigma_i = delta^col w^row of the next cell
            mc = torch.as_tensor(map_col[i], device=self.dev)
            mr = torch.as_tensor(map_row[i], device=self.dev)
            self._add_poly(("sigma", i), F.from_mont(F.mul(deltas[mc], self.W[mr])))
        self._dots([("fixed", c) for c in self.fixed_ids]
                   + [("sigma", i) for i in range(len(self.perm_cols))],
                   self.tau_bases, self.tau_vals)
        self.fixed_comms = [CV.mul(CV.G1, self.tau_vals[(("fixed", c), 0)])
                            for c in self.fixed_ids]
        self.sigma_comms = [CV.mul(CV.G1, self.tau_vals[(("sigma", i), 0)])
                            for i in range(len(self.perm_cols))]
        h = hashlib.blake2b(b"halo2_aes_tpu vk v2", digest_size=64)
        for v in (k, self.ext_k, self.usable):
            h.update(int(v).to_bytes(8, "little"))
        h.update(cs_bytes(cs))
        for pt in self.fixed_comms + self.sigma_comms:
            h.update(CV.point_bytes(pt))
        self.digest = int.from_bytes(h.digest(), "little") % P

    # -- helpers ---------------------------------------------------------

    def _rotations(self):
        rots = {0, 1, -1, "u"}
        for _, g in self.cs.gates:
            rots |= {r for _, r in g.columns()}
        for lk in self.cs.lookups:
            for e, _ in lk.pairs:
                rots |= {r for _, r in e.columns()}
        return sorted(rots, key=str)

    def _shift(self, rot) -> int:
        return self.usable if rot == "u" else rot

    def _lagrange_bases(self, z: int) -> dict:
        """{rot: L_i(z w^rot) as std limbs (n, 16)}: L_i(z w^r) = L_{i-r}(z)."""
        n = self.n
        if pow(z, n, P) == 1:
            raise ValueError("evaluation point in the domain")
        zt = F.mont([z], self.dev)[0]
        inv = F.batch_inv(F.sub(zt.expand(n, LIMBS), self.W)[None])[0]
        c = (pow(z, n, P) - 1) * pow(n, -1, P) % P
        base = F.from_mont(F.mul(F.mul(self.W, inv), F.mont([c], self.dev)[0]))
        return {r: torch.roll(base, self._shift(r), 0) for r in self.rots}

    def _small(self, vals) -> torch.Tensor:
        t = torch.zeros((self.n, LIMBS), dtype=torch.int64, device=self.dev)
        t[:, 0] = torch.as_tensor(np.asarray(vals, dtype=np.int64), device=self.dev)
        return t

    def _add_poly(self, key, std):
        self.polys[key] = std.to(torch.int32)

    def _dots(self, keys, bases: dict, out: dict, group: int = 8):
        """out[(key, rot)] = sum_i poly_key[i] * base_rot[i] for every rot."""
        rots = list(bases)
        bstack = torch.stack([bases[r] for r in rots])
        for lo in range(0, len(keys), group):
            ks = keys[lo:lo + group]
            vals = F.dot_bases(torch.stack([self.polys[kk] for kk in ks]).to(torch.int64),
                               bstack)
            for kk, row in zip(ks, vals):
                for r, v in zip(rots, row):
                    out[(kk, r)] = v

    # -- the proof -------------------------------------------------------

    def check(self, values: np.ndarray, blind_seed: int, proof: bytes,
              multiopen: str = "shplonk", lookup_sort: str = "field") -> dict:
        """Judge ``proof`` of the witness ``values`` ((num_columns, n)
        merged advice and fixed values) made with blinding seed
        ``blind_seed``.  Returns counts of mismatched points and scalars,
        whether the quotient pieces' combination at tau is wrong, and the
        first word that differs."""
        if multiopen != "shplonk" or lookup_sort != "field":
            raise NotImplementedError("the reference writes SHPLONK proofs with "
                                      "field-ordered lookups")
        values = np.asarray(values, dtype=np.int64)
        static = self.polys
        self.polys = dict(static)
        try:
            return self._check(values, np.random.default_rng(blind_seed), proof,
                               dict(self.tau_vals))
        finally:
            self.polys = static

    def _blinded(self, vals_std_head, blind_mont, head: int):
        """A column: rows [0, head) from ``vals_std_head``, the rest the
        blinding values (Montgomery limbs) in canonical form."""
        out = torch.empty((self.n, LIMBS), dtype=torch.int64, device=self.dev)
        out[:head] = vals_std_head[:head]
        out[head:] = F.from_mont(torch.as_tensor(blind_mont, device=self.dev))
        return out

    def _check(self, values, rng, proof, tau_vals):
        n, u, bf, dev, cs = self.n, self.usable, self.bf, self.dev, self.cs
        tr = CV.Transcript()
        tr.common_scalar(self.digest)
        adv_bl = rand_field(rng, len(self.adv_ids), n - u)
        for i, c in enumerate(self.adv_ids):
            self._add_poly(("advice", c), self._blinded(self._small(values[c]), adv_bl[i], u))
        adv_keys = [("advice", c) for c in self.adv_ids]
        self._dots(adv_keys, self.tau_bases, tau_vals)
        for kk in adv_keys:
            tr.point(CV.mul(CV.G1, tau_vals[(kk, 0)]))
        theta = tr.challenge()

        # lookups: compressed columns, field-ordered permuted pairs
        L = self.n_lk
        bl_a = rand_field(rng, L, n - u)
        bl_s = rand_field(rng, L, n - u)

        def col(c, rot):
            return np.roll(values[c], -rot) if rot else values[c]

        lk_data = []
        for li, lk in enumerate(cs.lookups):
            ins = np.stack([e.eval(_Ints, col)[:u] for e, _ in lk.pairs], 1)
            tabs = np.stack([values[tc][:u] for _, tc in lk.pairs], 1)
            uniq, inv = _unique_rows(np.concatenate([ins, tabs]))
            acc = uniq[:, 0].astype(object) % P
            for j in range(1, uniq.shape[1]):
                acc = (acc * theta + uniq[:, j].astype(object)) % P
            comp = acc.tolist()
            order = sorted(range(len(comp)), key=comp.__getitem__)
            rank = np.empty(len(comp), np.int64)
            rank[order] = np.arange(len(comp))
            sorted_comp = [comp[j] for j in order]
            in_rank, tab_rank = rank[inv[:u]], rank[inv[u:]]
            a_rank = np.sort(in_rank)
            first = np.ones(u, bool)
            first[1:] = a_rank[1:] != a_rank[:-1]
            distinct = a_rank[first]
            t_sorted = np.sort(tab_rank)
            at = np.searchsorted(t_sorted, distinct)
            if (at >= u).any() or (t_sorted[np.minimum(at, u - 1)] != distinct).any():
                raise ValueError(f"lookup {lk.name!r}: an input is not in the table")
            used = np.zeros(u, bool)
            used[at] = True
            s_rank = np.empty(u, np.int64)
            s_rank[first] = distinct
            s_rank[~first] = t_sorted[~used]
            table = F.tensor(sorted_comp, dev)
            ar = torch.as_tensor(a_rank, device=dev)
            sr = torch.as_tensor(s_rank, device=dev)
            self._add_poly(("lookup_a", li), self._blinded(table[ar], bl_a[li], u))
            self._add_poly(("lookup_s", li), self._blinded(table[sr], bl_s[li], u))
            lk_data.append((sorted_comp, torch.as_tensor(in_rank, device=dev),
                            torch.as_tensor(tab_rank, device=dev), ar, sr))
        lk_keys = [(kind, i) for i in range(L) for kind in ("lookup_a", "lookup_s")]
        self._dots(lk_keys, self.tau_bases, tau_vals)
        for kk in lk_keys:
            tr.point(CV.mul(CV.G1, tau_vals[(kk, 0)]))
        beta = tr.challenge()
        gamma = tr.challenge()

        # grand products: GRAND_COLUMNS z columns at a time, GRAND_ROWS
        # rows a pass
        z_bl = rand_field(rng, self.chunks, bf)
        lkz_bl = rand_field(rng, max(L, 1), bf)
        rand_coeffs = rand_field(rng, n)
        one = F.one(dev)
        gamma_m = F.mont([gamma], dev)[0]
        beta_sigma = F.mont([beta * F.R % P], dev)[0]   # std sigma -> beta sigma, mont

        def perm_factors(cols):
            def factors(lo, hi):
                num = den = None
                for i in cols:
                    v = F.add(F.small_to_mont(torch.as_tensor(
                        values[self.perm_cols[i], lo:hi], device=dev)), gamma_m)
                    idv = F.mul(self.W[lo:hi], F.mont([beta * pow(DELTA, i, P)], dev)[0])
                    sig = self.polys[("sigma", i)][lo:hi].to(torch.int64)
                    a_ = F.add(v, idv)
                    b_ = F.add(v, F.mul(sig, beta_sigma))
                    num = a_ if num is None else F.mul(num, a_)
                    den = b_ if den is None else F.mul(den, b_)
                return num, den
            return factors

        def lookup_factors(comp, in_r, tab_r, ar, sr):
            ap = F.mont([(c + beta) % P for c in comp], dev)
            sp = F.mont([(c + gamma) % P for c in comp], dev)

            def factors(lo, hi):
                num = one.expand(hi - lo, LIMBS).clone()
                den = one.expand(hi - lo, LIMBS).clone()
                top = min(hi, u)
                if top > lo:
                    num[:top - lo] = F.mul(ap[in_r[lo:top]], sp[tab_r[lo:top]])
                    den[:top - lo] = F.mul(ap[ar[lo:top]], sp[sr[lo:top]])
                return num, den
            return factors

        columns = [(("perm_z", t), perm_factors(range(
            t * self.chunk_len, min((t + 1) * self.chunk_len, len(self.perm_cols)))),
                    z_bl[t]) for t in range(self.chunks)]
        columns += [(("lookup_z", li), lookup_factors(*data), lkz_bl[li])
                    for li, data in enumerate(lk_data)]
        totals = []
        for lo in range(0, len(columns), GRAND_COLUMNS):
            totals += self._z_columns(columns[lo:lo + GRAND_COLUMNS])
        init = one                   # chunk t's z starts where chunk t - 1's ended
        for t in range(1, self.chunks):
            init = F.mul(init, totals[t - 1])
            z = self.polys[("perm_z", t)]
            for lo in range(0, n - bf, GRAND_ROWS):
                hi = min(lo + GRAND_ROWS, n - bf)
                z[lo:hi] = F.mul(z[lo:hi].to(torch.int64), init)
        self._add_poly(("random",), F.from_mont(torch.as_tensor(rand_coeffs, device=dev)))
        z_keys = ([("perm_z", t) for t in range(self.chunks)]
                  + [("lookup_z", i) for i in range(L)])
        self._dots(z_keys, self.tau_bases, tau_vals)
        tau_vals[(("random",), 0)] = F.dot_bases(
            self.polys[("random",)][None].to(torch.int64), self.tau_pows[None])[0][0]
        for kk in z_keys + [("random",)]:
            tr.point(CV.mul(CV.G1, tau_vals[(kk, 0)]))
        y = tr.challenge()

        # quotient pieces: the proof's own, judged by their combination
        pos = len(tr.words)
        pieces = []
        for j in range(self.d - 1):
            wire = proof[32 * (pos + j):32 * (pos + j + 1)]
            pt = CV.point_from_bytes(wire) if len(wire) == 32 else None
            pieces.append(pt)
            tr.point(pt, wire=wire.ljust(32, b"\0"))
        tn = pow(self.tau, n, P)
        h_tau = self._quotient(tau_vals, lambda kk, r: tau_vals[(kk, r)], self.tau,
                               self.l0_tau, self.l_last_tau, self.l_active_tau,
                               theta, beta, gamma, y)
        quotient_ok = None not in pieces and CV.lincomb(
            pieces, [pow(tn, j, P) for j in range(len(pieces))]) == CV.mul(CV.G1, h_tau)
        x = tr.challenge()

        # evaluations at x and its rotations
        x_bases = self._lagrange_bases(x)
        x_vals = {}
        keys = [kk for kk in self.polys if kk != ("random",)]
        self._dots(keys, x_bases, x_vals)
        x_vals[(("random",), 0)] = F.dot_bases(
            self.polys[("random",)][None].to(torch.int64),
            F.from_mont(F.powers(x, n, dev))[None])[0][0]
        lag_x = F.from_limbs(x_bases[0][u:])
        l0x = F.from_limbs(x_bases[0][0])[0]
        evals = {}
        for key, rot in self.plan:
            if key[0] != "h":
                evals[(key, rot)] = x_vals[(key, rot)]
                tr.scalar(evals[(key, rot)])
        evals[(("h",), 0)] = self._quotient(
            x_vals, lambda kk, r: evals[(kk, r)], x, l0x, lag_x[0],
            (1 - sum(lag_x)) % P, theta, beta, gamma, y)

        # SHPLONK: h_shp and the opening witness, affine in the pieces'
        # x-combination H (their only use in the protocol)
        xn = pow(x, n, P)
        c_hx = None if None in pieces else CV.lincomb(
            pieces, [pow(xn, j, P) for j in range(len(pieces))])
        y2 = tr.challenge()
        v = tr.challenge()
        sets_ = PROTO.rotation_sets(self.plan)
        K = len(sets_)
        t_rots = []
        for rots, _ in sets_:
            t_rots += [r for r in rots if r not in t_rots]

        def rot_point(r):
            return x * pow(self.omega, self._shift(r) % n, P) % P

        t_points = [rot_point(r) for r in t_rots]
        folds = []                  # (pts, ev_fold, known fold at tau, h weight)
        for gi, (rots, keys_) in enumerate(sets_):
            pts = [rot_point(r) for r in rots]
            ev = [0] * len(rots)
            known, hw = 0, 0
            for i, key in enumerate(keys_):
                w = pow(y2, len(keys_) - 1 - i, P)
                for j, r in enumerate(rots):
                    ev[j] = (ev[j] + w * evals[(key, r)]) % P
                if key == ("h",):
                    hw = w
                else:
                    known = (known + w * tau_vals[(key, 0)]) % P
            folds.append((pts, ev, known, hw))
        a_s, b_s = 0, 0                  # h_shp(tau) = a_s + b_s H
        for gi, (pts, ev, known, hw) in enumerate(folds):
            c = pow(v, K - 1 - gi, P) * pow(_vanish_at(pts, self.tau), -1, P) % P
            a_s = (a_s + c * (known - _interp_at(pts, ev, self.tau))) % P
            b_s = (b_s + c * hw) % P
        tr.point(self._affine(a_s, b_s, c_hx))
        uu = tr.challenge()
        zt_u = _vanish_at(t_points, uu)
        a_q, b_q = 0, 0
        for gi, (pts, ev, known, hw) in enumerate(folds):
            s = pow(v, K - 1 - gi, P) * _vanish_at(
                [p_ for p_ in t_points if p_ not in pts], uu) % P
            a_q = (a_q + s * (known - _interp_at(pts, ev, uu))) % P
            b_q = (b_q + s * hw) % P
        inv = pow(self.tau - uu, -1, P)
        tr.point(self._affine((a_q - zt_u * a_s) * inv % P,
                              (b_q - zt_u * b_s) * inv % P, c_hx))

        # compare word by word
        got = [proof[i:i + 32] for i in range(0, len(proof), 32)]
        mism = {"point": 0, "scalar": 0}
        first = None
        for i, (kind, want) in enumerate(tr.words):
            if i >= len(got) or got[i] != want:
                mism[kind] += 1
                if first is None:
                    first = f"{kind} word {i}"
        return {"points_mismatched": mism["point"], "scalars_mismatched": mism["scalar"],
                "quotient_mismatched": 0 if quotient_ok else 1,
                "extra_bytes": abs(len(proof) - 32 * len(tr.words)),
                "first_mismatch": first}

    def _z_columns(self, columns):
        """Grand products z[j] = prod_{r < j} num_r / den_r (ratio 1 on
        the rows past the usable ones) for ``columns`` of (key, factors,
        blinding values), GRAND_ROWS rows a pass, ``factors(lo, hi)``
        giving a column's num and den on those rows (Montgomery); each
        z, its last rows the blinding values, is stored as a poly.
        Returns each column's product of every ratio (Montgomery)."""
        n, u, dev = self.n, self.usable, self.dev
        one = F.one(dev)
        zs = [torch.empty((n, LIMBS), dtype=torch.int32, device=dev) for _ in columns]
        totals = one.expand(len(columns), LIMBS)
        for lo in range(0, n, GRAND_ROWS):
            hi = min(lo + GRAND_ROWS, n)
            num = torch.empty((len(columns), hi - lo, LIMBS), dtype=torch.int64, device=dev)
            den = torch.empty_like(num)
            for c, (_, factors, _) in enumerate(columns):
                num[c], den[c] = factors(lo, hi)
            ratio = F.mul(num, F.batch_inv(den))
            del num, den
            ratio[:, max(u - lo, 0):] = one
            cum = F.scan(ratio)
            del ratio
            prev = F.mul(torch.cat([one.expand(len(columns), 1, LIMBS), cum[:, :-1]], 1),
                         totals[:, None])
            for z, p in zip(zs, F.from_mont(prev)):
                z[lo:hi] = p
            totals = F.mul(cum[:, -1], totals)
            del cum, prev
        for z, (key, _, blind_mont) in zip(zs, columns):
            z[n - self.bf:] = F.from_mont(torch.as_tensor(blind_mont, device=dev))
            self.polys[key] = z
        return list(totals)

    def _affine(self, a: int, b: int, c_hx):
        pt = CV.mul(CV.G1, a)
        return pt if b == 0 else (None if c_hx is None else CV.add(pt, CV.mul(c_hx, b)))

    def _quotient(self, vals, get, z, l0, l_last, l_active, theta, beta, gamma, y):
        """The constraint identity's y-fold at z over Z_H(z): h(z)."""
        cs = self.cs
        n = self.n

        class Ctx(PROTO.Context):
            alg = _Mod
            one = 1

            @staticmethod
            def column(c, rot):
                kind = cs.columns[c].kind
                return get(("advice" if kind == ADVICE else "fixed", c), rot)

            @staticmethod
            def perm_z(t, rot):
                return get(("perm_z", t), rot)

            @staticmethod
            def sigma(i):
                return get(("sigma", i), 0)

            @staticmethod
            def perm_id(i):
                return pow(DELTA, i, P) * z % P

            @staticmethod
            def lookup_z(i, rot):
                return get(("lookup_z", i), rot)

            @staticmethod
            def lookup_a(i, rot):
                return get(("lookup_a", i), rot)

            @staticmethod
            def lookup_s(i):
                return get(("lookup_s", i), 0)

        Ctx.l0, Ctx.l_last, Ctx.l_active = l0, l_last, l_active
        Ctx.theta, Ctx.beta, Ctx.gamma = theta, beta, gamma
        acc = None
        for term in PROTO.constraint_terms(cs, Ctx):
            acc = term if acc is None else (acc * y + term) % P
        return acc * pow((pow(z, n, P) - 1) % P, -1, P) % P
