"""The KZG prover with SHPLONK or GWC multiopen (port of
``backend/prover.py``).

The single-device path of the reference, at every k the field allows
(ext_k <= Fr's two-adicity, 28: k <= 26 for a degree-5 circuit), with either
multiopen (``"shplonk"``, ``"gwc"``) and either lookup order
(``"field"``, ``"packed"``), phase by phase and in the same transcript
order, so that the same pk, witness and seed give the same proof bytes:

  vk digest, instance values | advice commits | theta | per lookup:
  A'/S' commits | beta, gamma | permutation z commits | lookup z
  commits | random-poly commit | y | d-1 h piece commits | x | evals in
  protocol.open_queries order (h skipped) | then SHPLONK: y2, v | h
  commit | u | witness commit; or GWC: v | one witness commit per
  rotation point.

Every device tensor lives on the proving key's device.  Blinding
randomness is a ``numpy.random.Generator`` drawn in the reference's
order (``seed=None`` means ``os.urandom``).

The quotient is evaluated per SUB-COSET: the extended coset of ratio R
splits into R interleaved size-n cosets {g w_ext^s w^j}; rotations stay
intra-coset rolls.  The constraint terms of a sub-coset are one launch
of the term program (``quotient_subcoset``: the terms lowered once per
pk by backend/term_program.py) on every device: K4 on a card, its plain
version on the CPU.

From k = ``_LARGE_MIN_K`` (19) on, the reference's large path runs: the
quotient's coset NTTs go B polys at a time into one output
(``evals_sliced``), the static sub-coset evaluations are recomputed
every proof instead of cached, the lookup grand products stream one
lookup at a time, the quotient finish and the SHPLONK h quotient use
size-n sub-coset transforms in place of the 2^(k+2)- and 2^(k+1)-point
ones, the SHPLONK member fold streams B members at a time, and the
evaluations go a few polys per stack (``_EVAL_STACK``).  Each sliced
function equals its unsliced form bit for bit, so the proof bytes do not
depend on the switch.  The field-ordered permuted lookup pairs are built
one lookup at a time where the batched sort's keys would not fit
(``streamed_pairs``: from k = 22 for AES-128's 17 lookups).  From k =
``rest.HOST_REST_MIN_K`` (23) on, every coefficient stack rests in
pinned host memory from the phase that makes it (the pk's from its
making) and its readers copy back the polys they take
(backend/rest.py), and the forms of ``HOST_REST_FORMS`` keep the
transients of a phase within one card: the same bytes again.
``checkpoint_dir`` saves each of the phases advice, lookup, products
and quotient (backend/resume.py); ``HALO2_SANITIZE=1`` checks their
outputs for canonical limbs (utils/sanitize.py).

With a ``mesh`` (parallel/comm.py: one process per rank), every batched
transform goes through the distributed four-step NTT
(parallel/ntt.py) and every commitment, at every n, through the
point-sharded MSM (parallel/msm.py); everything else runs replicated on
each rank, which returns the one-device proof bytes.

A prove is one ``prove`` span (utils/timers.py: recorded only while a
profiler runs or inside ``timers.recording()``) split into the phase
spans of ``PHASE_SPANS``; the quotient's sub-coset evaluations, term
fold and finish, every transform (``ntt``) and every commitment
(``commit``) are spans inside them.
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
from halo2_aes_tpu_torch.backend import rest
from halo2_aes_tpu_torch.backend import resume as RES
from halo2_aes_tpu_torch.backend import term_program as TP
from halo2_aes_tpu_torch.backend.keygen import ProvingKey, commit_affine, commit_many
from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter
from halo2_aes_tpu_torch.ops import cuda_quotient as CQ
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.ntt import domain, ntt_many
from halo2_aes_tpu_torch.parallel import comm
from halo2_aes_tpu_torch.parallel import ntt as PNTT
from halo2_aes_tpu_torch.utils import sanitize as SAN
from halo2_aes_tpu_torch.utils import timers

FR = F.FR
LIMBS = F.LIMBS
_R_WORDS = np.array([(FR.modulus >> (64 * i)) & ((1 << 64) - 1) for i in range(4)],
                    dtype=np.uint64)
# the sliced phases run from this k on (tests and the chip smoke lower it
# to hold the sliced path against the unsliced one on small circuits)
_LARGE_MIN_K = 19
# Forms each (below rest.HOST_REST_MIN_K, from it): the second keeps a
# k >= 23 phase's transients within one card (without it k=23's prove
# peaked at 94.9% of an 80 GB card) and costs k=20's prove time
# (scripts/torch_rest_forms.py; PERF.md §6).  Polys per
# evaluation stack on the large path (an evaluation's halving adds take
# ~8x its stack).
_EVAL_STACK = (12, 4)
HOST_REST_FORMS = ("_EVAL_STACK",)
# The field-ordered permuted lookup pairs are sorted batched over the L
# lookups while the sort's int64 key words (8 a row of each lookup's 2u
# merged input and table rows) take at most this many bytes, and one
# lookup at a time beyond it (``streamed_pairs``).  Beside the keys the
# batched sort holds their gathered copy and its argsort temporaries: at
# k=22 with 17 lookups (8.5 GiB of keys) it ran out of an 80 GB card; one
# lookup at a time costs k=20 prove time (PERF.md §6).  Tests lower it.
PAIR_SORT_MAX_BYTES = 6 << 30
# From this k, below host rest, a prove on a card first builds the per-k
# tables its opening reads (``_Phases.warm_tables``: once per pk and
# opening), before its first transient, and hands the caching allocator's
# free segments back to the card as it starts and as it ends: so every
# prove starts from the segments of what outlives it (the pk, the SRS,
# the tables, the caller's witness) and allocates the same way.  Its
# stacks of tens of GB among transients of every size otherwise fragment
# the cache: at k=22 the second prove in one process could not place its
# 27.25 GiB quotient buffer, with the release alone (tables built among
# the first prove's transients held 16-25 GiB in pieces) and with the
# tables alone (the next witness split the cached segments; PERF.md §6).
# Below it nothing fragments; from host rest on, the processes that
# prove run the allocator with expandable segments (backend/rest.py).
RELEASE_CACHE_MIN_K = 22
# the spans that split a prove (the root span "prove") into its phases,
# each closed right after the Fiat-Shamir challenges that end it: advice
# at theta, the permuted lookup pairs at beta and gamma, the grand
# products at y, the quotient at x, the evaluations at v (SHPLONK
# squeezes y2 first); then SHPLONK's h at u and its L at the end, or
# GWC's witnesses (gwc_open) or IPA's opening (ipa_open) at the end
PHASE_SPANS = ("advice", "lookup_permuted", "grand_products", "quotient", "evals",
               "shplonk_h", "shplonk_l", "gwc_open", "ipa_open")


def _releases_cache(pk: ProvingKey) -> bool:
    """Whether a prove on ``pk`` warms its tables and releases the cache
    (``RELEASE_CACHE_MIN_K``)."""
    k = pk.vk.k
    return (k >= RELEASE_CACHE_MIN_K and not rest.on_host(k)
            and pk.device.type == "cuda")


def streamed_pairs(n: int, lookups: int) -> bool:
    """Whether the field-ordered permuted pairs of ``lookups`` lookups
    over n rows are built one lookup at a time (``_Phases.
    _permuted_pairs_streamed``) rather than in one batched sort."""
    return lookups * 2 * n * 8 * 8 > PAIR_SORT_MAX_BYTES


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


def _pack_u32(cols):
    """Pack <= 4 byte-ranged columns into one sortable uint32 key (held
    in int64).  The permuted-pair order is right only if each component
    fits 8 bits; ``_check_lookup_packable`` guards the table side."""
    assert len(cols) <= 4, "u32 packing supports at most 4 lookup pairs"
    key = torch.zeros_like(cols[0])
    for c in cols:
        key = ((key << 8) | (c & 0xFFFFFFFF)) & 0xFFFFFFFF
    return key


def _table_sort(layout, lk_index: int, usable: int):
    """Host-sorted (keys, argsort) of a lookup's packed table, cached on
    the layout: the table columns are fixed."""
    cache = layout.meta.setdefault("_prover_table_sort", {})
    if lk_index not in cache:
        lk = layout.cs.lookups[lk_index]
        key = np.zeros(usable, dtype=np.uint32)
        for _, tc in lk.pairs:
            key = (key << 8) | layout.fixed[tc][:usable].astype(np.uint32)
        order = np.argsort(key, kind="stable")
        cache[lk_index] = (key[order].astype(np.int64), order.astype(np.int64))
    return cache[lk_index]


def _check_lookup_packable(layout, lk):
    """Every table column of the lookup is byte-ranged and there are at
    most 4 pairs (honest inputs are table members, so the bound covers
    them too)."""
    if len(lk.pairs) > 4:
        raise ValueError(f"lookup {lk.name!r} has {len(lk.pairs)} pairs; "
                         "u32 packing supports at most 4")
    for _, tc in lk.pairs:
        hi = int(np.max(layout.fixed[tc]))
        if hi >= 256:
            raise ValueError(f"lookup {lk.name!r} table column {tc} holds "
                             f"values up to {hi}; packed keys need bytes")


def _context(**attrs) -> PROTO.Context:
    """A protocol Context instance.  (A class made per call, as the
    reference makes one inside its traced functions, sits in a reference
    cycle: eagerly, the tensors its accessors close over would stay
    allocated until Python's cyclic collector ran.)"""
    ctx = PROTO.Context()
    ctx.__dict__.update(attrs)
    return ctx


class _IntAlg:
    """Integer algebra for the packed keys (wraps like the reference's
    int32 arithmetic once masked to 32 bits)."""

    @staticmethod
    def const(v):
        return v

    add = staticmethod(lambda a, b: a + b)
    mul = staticmethod(lambda a, b: a * b)
    neg = staticmethod(lambda a: -a)


def _rand_field(rng, *shape) -> np.ndarray:
    """Exactly-uniform random field elements as (..., 16) numpy limbs:
    254-bit candidates from ``rng`` (None -> os.urandom), rejection-
    sampled below r, read as Montgomery representations (the
    reference's draw, byte for byte).  A candidate is compared as four
    little-endian 64-bit words: its top word decides unless it equals
    r's (odds 2^-62), and then the whole number does."""
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    randbytes = os.urandom if rng is None else rng.bytes
    out = np.zeros((count, LIMBS), np.uint32)
    need = np.ones(count, bool)
    while need.any():
        m = int(need.sum())
        cand = np.frombuffer(randbytes(32 * m), dtype="<u8").reshape(m, 4).copy()
        cand[:, 3] &= np.uint64((1 << 62) - 1)
        lt = cand[:, 3] < _R_WORDS[3]
        for j in np.flatnonzero(cand[:, 3] == _R_WORDS[3]):
            lt[j] = int.from_bytes(cand[j].tobytes(), "little") < FR.modulus
        idx = np.flatnonzero(need)[lt]
        out[idx] = cand[lt].view("<u2").astype(np.uint32)
        need[idx] = False
    return out.reshape(*shape, LIMBS)


@functools.lru_cache(maxsize=None)
def _subcoset_tables(k: int, ext_k: int, s: int, device):
    """(shift_powers (n, 16): (g w_ext^s)^i, zh_inv (16,): 1/Z_H on the
    sub-coset) on ``device``."""
    p = FR.modulus
    n = 1 << k
    shift = P.GEN * pow(domain(FR, ext_k).omega, s, p) % p
    return (F.powers_table(FR, shift, n, device),
            F.encode(FR, pow(pow(shift, n, p) - 1, -1, p), device))


@functools.lru_cache(maxsize=None)
def _finish_split_tables(k: int, ext_k: int, d: int, device):
    """Tables of the four-step quotient finish.  With sub-coset values
    v_s[t] = f(g W^s w^t) (W = w_ext, w = W^R), INTT_n over t and the
    unscale by (g W^s)^{-t'} leave an R-point DFT across the sub-cosets;
    its inverse is c_{t'+qn} = sum_s mix[q,s] d_s[t'] with
    mix[q,s] = R^-1 g^{-qn} (W^n)^{-sq}.  Returns (unscale (R*n, 16):
    rows [s*n, (s+1)*n) hold (g W^s)^{-t'}; mix (d-1, R, 16)) on
    ``device``."""
    p = FR.modulus
    n = 1 << k
    R = (1 << ext_k) // n
    w_ext = domain(FR, ext_k).omega
    unscale = torch.cat([
        F.powers_table(FR, pow(P.GEN * pow(w_ext, s, p) % p, -1, p), n, device)
        for s in range(R)])
    omega_r = pow(w_ext, n, p)
    r_inv = pow(R, -1, p)
    g_n = pow(P.GEN, n, p)
    mix = np.zeros((d - 1, R, LIMBS), np.uint32)
    for q in range(d - 1):
        gq_inv = pow(pow(g_n, q, p), -1, p)
        for s in range(R):
            mix[q, s] = FR.encode(r_inv * gq_inv % p * pow(omega_r, (-s * q) % R, p))
    return unscale, F.limbs(mix, device)


@functools.lru_cache(maxsize=None)
def _shplonk_h_tables(k: int, device):
    """(fold_sc (2, 16): shift_s^n; shift_pows2 (2, n, 16); unscale2;
    mix2) of the two sub-cosets of domain(k+1), for shplonk_h_large."""
    p = FR.modulus
    n = 1 << k
    w1 = domain(FR, k + 1).omega
    fold = FR.encode([pow(P.GEN * pow(w1, s, p) % p, n, p) for s in range(2)])
    shifts = torch.stack([_subcoset_tables(k, k + 1, s, device)[0]
                          for s in range(2)])
    return (F.limbs(fold, device), shifts,
            *_finish_split_tables(k, k + 1, 2, device))


@functools.lru_cache(maxsize=None)
def _coset_points(k: int, device):
    """(n, 16) Montgomery coset points g * w^j of domain(k)."""
    return F.mont_mul(FR, domain(FR, k).omega_powers(device),
                      F.encode(FR, P.GEN, device))


class _Phases:
    """Per-pk phase functions and static plumbing; with a ``mesh`` the
    batched transforms are distributed (``_ntt_many``)."""

    def __init__(self, pk: ProvingKey, mesh=None):
        self.pk = pk
        self.mesh = mesh
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
        # the constraint terms as one program over a row of the sub-coset's
        # stacks (static, then dynamic), run by quotient_subcoset
        self.terms = TP.lower(cs, skeys + dkeys, self.usable, self.n)
        self._terms_code = torch.as_tensor(self.terms.code, device=self.dev)
        self._terms_consts = self.encode(list(self.terms.consts)).reshape(-1, LIMBS)
        self._static_evals = {}          # sub-coset s -> (S*n, 16)
        self._packed_tables = {}         # lookup -> packed table sort
        self._warmed = set()             # openings whose tables are built
        self._delta_pows = F.limbs(
            FR.host_powers(PERM.delta(), len(cs.perm_columns)), self.dev)
        self.shp_sets = PROTO.rotation_sets(PROTO.open_queries(cs))
        self.shp_sizes = tuple(len(keys) for _, keys in self.shp_sets)

    def tensor(self, arr):
        return F.limbs(arr, self.dev)

    def _packed_table(self, li: int):
        """(sorted keys, argsort) of lookup li's packed table on the device."""
        out = self._packed_tables.get(li)
        if out is None:
            out = tuple(torch.as_tensor(a, device=self.dev)
                        for a in _table_sort(self.layout, li, self.usable))
            self._packed_tables[li] = out
        return out

    def encode(self, v):
        return F.encode(FR, v, self.dev)

    def host_rest(self) -> bool:
        """Whether this pk's idle stacks rest in pinned host memory."""
        return rest.on_host(self.k)

    def park(self, t):
        """``t`` where it waits until a reader copies back what it takes."""
        return rest.park(t) if self.host_rest() else t

    def stack(self, polys):
        """One FLAT device stack of size-n polys: below the host-rest
        threshold one ``torch.cat`` of device polys, from it each poly,
        on the device or parked in host memory, copied into place."""
        if not self.host_rest():
            return torch.cat(polys)
        n = self.n
        out = torch.empty((len(polys) * n, LIMBS), dtype=torch.int32,
                          device=self.dev)
        for i, poly in enumerate(polys):
            out[i * n:(i + 1) * n].copy_(poly, non_blocking=True)
        return out

    def _ntt_many(self, flat, count: int, inverse: bool, shift_pows=None):
        if self.mesh is None:
            return ntt_many(self.dom, flat, count, inverse=inverse,
                            shift_pows=shift_pows)
        return PNTT.ntt_sharded_many(self.mesh, self.dom, flat, count,
                                     inverse=inverse, shift_pows=shift_pows)

    def _column_ctx(self, all_fld, theta_m):
        n = self.n

        def col_fld(col, rot):
            v = all_fld[col * n:(col + 1) * n]
            return torch.roll(v, -rot, 0) if rot else v

        return _context(alg=self.alg, theta=theta_m, column=col_fld)

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

    # -- phase 2: lookup permuted pairs ------------------------------------

    def lookup_phase(self, values, all_fld, theta_m, bl_a, bl_s,
                     lookup_sort: str):
        u, L = self.usable, self.n_lk
        Ctx = self._column_ctx(all_fld, theta_m)
        if lookup_sort == "field" and streamed_pairs(self.n, L):
            a_prime, s_prime = self._permuted_pairs_streamed(Ctx, bl_a, bl_s)
        elif lookup_sort == "field":
            with timers.span("lookup.pairs", streamed=0, lookups=L, rows=u):
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
        else:
            def col_int(col, rot):
                v = values[col].to(torch.int64)
                return torch.roll(v, -rot, 0) if rot else v

            a_primes, s_primes = [], []
            for li, lk in enumerate(self.cs.lookups):
                packed_a = _pack_u32([e.eval(_IntAlg, col_int)
                                      for e, _ in lk.pairs])
                t_sorted, t_order = self._packed_table(li)
                a_ord, s_ord = LK.permuted_indices(packed_a, t_sorted,
                                                   t_order, u)
                a_primes.append(LK.apply_permutation(
                    PROTO.compressed_input(Ctx, lk)[:u], a_ord, bl_a[li]))
                s_primes.append(LK.apply_permutation(
                    PROTO.compressed_table(Ctx, lk)[:u], s_ord, bl_s[li]))
            a_prime = torch.cat(a_primes)
            s_prime = torch.cat(s_primes)
        a_coeffs = self._ntt_many(a_prime, L, inverse=True)
        s_coeffs = self._ntt_many(s_prime, L, inverse=True)
        return a_prime, s_prime, a_coeffs, s_coeffs

    def _permuted_pairs_streamed(self, Ctx, bl_a, bl_s):
        """The field-ordered permuted pairs one lookup at a time (its
        compressed columns and its sort's int64 keys are the only ones
        live), into preallocated (L*n, 16) stacks: equal to the batched
        ``permuted_indices_field_many`` rows.  The form of the proofs
        whose batched sort would not fit (``streamed_pairs``); one
        ``lookup.pairs`` span a lookup."""
        n, u = self.n, self.usable
        a_prime = torch.empty((self.n_lk * n, LIMBS), dtype=torch.int32,
                              device=self.dev)
        s_prime = torch.empty_like(a_prime)
        for li, lk in enumerate(self.cs.lookups):
            with timers.span("lookup.pairs", streamed=1, lookups=1, rows=u):
                a_u = PROTO.compressed_input(Ctx, lk)[:u]
                s_u = PROTO.compressed_table(Ctx, lk)[:u]
                a_ord, t_perm = LK.permuted_indices_field(
                    F.from_mont(FR, a_u), F.from_mont(FR, s_u), u)
                a_prime[li * n:li * n + u] = a_u[a_ord]
                a_prime[li * n + u:(li + 1) * n] = bl_a[li]
                s_prime[li * n:li * n + u] = s_u[t_perm]
                s_prime[li * n + u:(li + 1) * n] = bl_s[li]
                del a_u, s_u, a_ord, t_perm
        return a_prime, s_prime

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

    def lookup_products_streamed(self, all_fld, lk_ap, lk_sp, theta_m, beta_m,
                                 gamma_m, blinds):
        """The large path's lookup z columns, one lookup at a time through
        ``lookup.grand_product`` (equal to ``lookup_products_all``): only
        one lookup's compressed columns and scan are live at once."""
        n = self.n
        Ctx = self._column_ctx(all_fld, theta_m)
        return torch.cat([
            LK.grand_product(PROTO.compressed_input(Ctx, lk),
                             PROTO.compressed_table(Ctx, lk),
                             lk_ap[i * n:(i + 1) * n], lk_sp[i * n:(i + 1) * n],
                             self.usable, beta_m, gamma_m, blinds[i])
            for i, lk in enumerate(self.cs.lookups)])

    # -- phase 4: quotient on sub-cosets -----------------------------------

    def large(self) -> bool:
        """Whether this pk's proves take the sliced k >= 19 path."""
        return self.k >= _LARGE_MIN_K

    def warm_tables(self, multiopen: str = "shplonk"):
        """Build the per-k device tables that a prove opened by
        ``multiopen`` reads and would otherwise build on first use among
        its transients: the sub-coset shifts and the quotient finish's
        split tables, the permutation's labels, SHPLONK's split tables
        (SHPLONK and IPA), the coset points (SHPLONK and GWC), and the
        transforms' shifts and twiddles (one zero poly forward and back).
        Once per opening."""
        if multiopen in self._warmed:
            return
        k, dev = self.k, self.dev
        if self.chunks:
            PERM._label_tables(k, len(self.cs.perm_columns), dev)
        for s in range(self.ratio):
            _subcoset_tables(k, self.ext_k, s, dev)
        _finish_split_tables(k, self.ext_k, self.d, dev)
        if multiopen != "gwc":
            _shplonk_h_tables(k, dev)
        if multiopen != "ipa":
            _coset_points(k, dev)
        self.dom.omega_powers(dev)
        zero = torch.zeros((self.n, LIMBS), dtype=torch.int32, device=dev)
        for inverse in (False, True):
            P._shift_powers(k, inverse, dev)
            ntt_many(self.dom, zero, 1, inverse=inverse)
        self._warmed.add(multiopen)

    def evals_sliced(self, keys, coeffs_fn, shift_pows, B: int = 8, out=None):
        """Sub-coset NTT of the polys ``keys`` (coefficients from
        ``coeffs_fn``), B at a time into one preallocated (len*n, 16)
        output (``out`` where given): the stack, the transform's
        transposes and its temporaries stay B polys wide.  Equal to one
        ``ntt_many`` over the whole stack."""
        n = self.n
        if out is None:
            out = torch.empty((len(keys) * n, LIMBS), dtype=torch.int32,
                              device=self.dev)
        for lo in range(0, len(keys), B):
            sl = keys[lo:lo + B]
            stack = self.stack([coeffs_fn(kk) for kk in sl])
            out[lo * n:(lo + len(sl)) * n] = self._ntt_many(
                stack, len(sl), inverse=False, shift_pows=shift_pows)
        return out

    def static_subcoset_evals(self, s: int, out=None):
        """Sub-coset evaluations of the proof-independent quotient polys,
        cached per pk per sub-coset.  On the large path they are
        recomputed by ``evals_sliced`` at every call (into ``out`` where
        given): at k=20 a cache of all R sub-cosets (9.66 GB) saved no
        measurable time on one H100 and raised the prove's peak by 9.7 GB."""
        shift_pows, _ = _subcoset_tables(self.k, self.ext_k, s, self.dev)
        if self.large():
            return self.evals_sliced(self.q_static_keys, self._coeffs_static,
                                     shift_pows, out=out)
        out = self._static_evals.get(s)
        if out is None:
            stack = self.stack([self._coeffs_static(key)
                                for key in self.q_static_keys])
            out = self._ntt_many(stack, len(self.q_static_keys),
                                 inverse=False, shift_pows=shift_pows)
            self._static_evals[s] = out
        return out

    def _coeffs_static(self, key):
        """The pk's coefficient poly of a static quotient key (on the
        device, or parked in host memory from the threshold on)."""
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
        """One sub-coset's quotient values: the term program
        (``self.terms``) in one launch, the term fold and the Z_H division
        with no temporaries (K4 on CUDA tensors, its plain version on the
        CPU)."""
        table = self.terms_table(theta_m, beta_m, gamma_m, y_m, shift_pows,
                                 zh_inv)
        out = torch.empty((self.n, LIMBS), dtype=torch.int32, device=self.dev)
        return CQ.quotient_terms(self._terms_code, self.terms.slots, table,
                                 static_evals, dyn_evals,
                                 self.dom.omega_powers(self.dev), 0, out)

    def terms_table(self, theta_m, beta_m, gamma_m, y_m, shift_pows, zh_inv):
        """The term program's constant table for one sub-coset."""
        return CQ.constant_table(
            self._terms_consts, y_m, zh_inv, theta_m, beta_m, gamma_m,
            F.mont_mul(FR, self._delta_pows, shift_pows[1]))

    def quotient_subcoset_eager(self, static_evals, dyn_evals, theta_m, beta_m,
                                gamma_m, y_m, shift_pows, zh_inv):
        """The same values by the eager field ops: Horner-fold every
        constraint term with y, divide by Z_H.  The prover never calls
        it; the tests and ``chip_smoke.py`` hold the term program against
        it."""
        Ctx = self._subcoset_ctx(static_evals, dyn_evals, theta_m, beta_m,
                                 gamma_m, shift_pows)
        acc = None
        for term in PROTO.constraint_terms(self.cs, Ctx):
            acc = term if acc is None else F.add(
                FR, F.mont_mul(FR, acc, y_m), term)
        return F.mont_mul(FR, acc, zh_inv)

    def _subcoset_ctx(self, static_evals, dyn_evals, theta_m, beta_m, gamma_m,
                      shift_pows):
        """The protocol Context over one sub-coset's pre-evaluated stacks."""
        n = self.n
        by_key = {key: static_evals[i * n:(i + 1) * n]
                  for i, key in enumerate(self.q_static_keys)}
        by_key.update({key: dyn_evals[i * n:(i + 1) * n]
                       for i, key in enumerate(self.q_dyn_keys)})
        pts = F.mont_mul(FR, self.dom.omega_powers(self.dev), shift_pows[1])
        delta_pows = self._delta_pows
        usable = self.usable

        def rot_roll(arr, rot=0):
            r = (usable if rot == "u" else rot) % n
            return torch.roll(arr, -r, 0) if r else arr

        return _context(
            alg=self.alg, one=F.const(FR, "one", self.dev),
            theta=theta_m, beta=beta_m, gamma=gamma_m,
            l0=rot_roll(by_key[("l0",)]), l_last=rot_roll(by_key[("l_last",)]),
            l_active=rot_roll(by_key[("l_active",)]),
            column=lambda col, rot: rot_roll(by_key[("col", col)], rot),
            perm_z=lambda t, rot: rot_roll(by_key[("perm_z", t)], rot),
            sigma=lambda i: rot_roll(by_key[("sigma", i)]),
            perm_id=lambda i: F.mont_mul(FR, delta_pows[i], pts),
            lookup_z=lambda i, rot: rot_roll(by_key[("lookup_z", i)], rot),
            lookup_a=lambda i, rot: rot_roll(by_key[("lookup_a", i)], rot),
            lookup_s=lambda i: rot_roll(by_key[("lookup_s", i)]))

    def quotient_finish(self, q_flat):
        """Interleave the sub-coset values back to extended-coset order,
        interpolate, keep the d-1 live pieces (FLAT ((d-1)*n, 16))."""
        n, R = self.n, self.ratio
        q_ext = q_flat.reshape(R, n, LIMBS).transpose(0, 1).reshape(R * n, LIMBS)
        h = P.coset_interp(self.dom_ext, q_ext)
        return h[:(self.d - 1) * n]

    def _quotient_finish_split(self, q_flat, unscale, mix):
        """R size-n INTTs, the unscale, and the R-point mix across the
        sub-cosets (see _finish_split_tables) in place of the
        2^ext_k-point interpolation: equal to ``quotient_finish``."""
        n, R = self.n, self.ratio
        dvals = F.mont_mul(FR, self._ntt_many(q_flat, R, inverse=True), unscale)
        outs = []
        for q in range(self.d - 1):
            acc = None
            for s in range(R):
                t = F.mont_mul(FR, dvals[s * n:(s + 1) * n], mix[q, s])
                acc = t if acc is None else F.add(FR, acc, t)
            outs.append(acc)
        return torch.cat(outs)

    def quotient_finish_large(self, q_flat):
        return self._quotient_finish_split(
            q_flat, *_finish_split_tables(self.k, self.ext_k, self.d, self.dev))

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

    def shplonk_fold_large(self, coeffs_fn, members, w_np, B: int = 8):
        """``shplonk_fold`` without the (M*n, 16) member concat: each
        rotation-set cluster streams its members (coefficients from
        ``coeffs_fn``) B at a time.  Equal to ``shplonk_fold``."""
        n = self.n
        w = self.tensor(w_np)
        outs, idx = [], 0
        for sz in self.shp_sizes:
            acc = None
            for lo in range(idx, idx + sz, B):
                cnt = min(B, idx + sz - lo)
                # a copy, never a view of the resident poly
                stack = self.stack([coeffs_fn(kk) for kk in members[lo:lo + cnt]])
                part = F.mont_mul(FR, stack.reshape(cnt, n, LIMBS),
                                  w[lo:lo + cnt, None])
                for i in range(cnt):
                    acc = part[i] if acc is None else F.add(FR, acc, part[i])
            outs.append(acc)
            idx += sz
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

    def gwc_witness(self, poly_flat, vpows, eval_m, z_m):
        """One GWC opening witness W = [(F - F(z)) / (X - z)] where
        F = sum_j v^j p_j over the polys opened at the point z; divided
        on the base coset, which never meets z."""
        n = self.n
        acc = None
        for q in range(vpows.shape[0]):
            t = F.mont_mul(FR, poly_flat[q * n:(q + 1) * n], vpows[q])
            acc = t if acc is None else F.add(FR, acc, t)
        acc = acc.clone()
        acc[0] = F.sub(FR, acc[0], eval_m)
        return self._shpl_div_interp(self._shpl_div_eval(acc, z_m))

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

    def _shplonk_h_split(self, f_acc, zt_coeffs_m, fold_sc, shift_pows2,
                         unscale2, mix2):
        """h = f / Z_T by two size-n sub-coset passes over domain(k+1),
        the R = 2 case of ``_quotient_finish_split``: per sub-coset s,
        fold f's rows past n in with x^n = shift_s^n (constant on the
        sub-coset), shifted NTT_n, Horner Z_T over the sub-coset points,
        times the batch inverse, INTT_n, unscale; deg h < n, so only the
        q = 0 block of the mix survives.  Equal to ``shplonk_h``."""
        n = self.n
        tail = f_acc[n:]
        nt = tail.shape[0]
        omega_pows = self.dom.omega_powers(self.dev)
        D = zt_coeffs_m.shape[0]
        dsum = None
        for s in range(2):
            folded = f_acc[:n].clone()
            folded[:nt] = F.add(FR, f_acc[:nt], F.mont_mul(FR, tail, fold_sc[s]))
            f_ev = self._ntt_many(folded, 1, inverse=False,
                                  shift_pows=shift_pows2[s])
            pts = F.mont_mul(FR, omega_pows, shift_pows2[s][1])
            acc = zt_coeffs_m[D - 1].expand(n, LIMBS)
            for dd in range(D - 2, -1, -1):
                acc = F.add(FR, F.mont_mul(FR, acc, pts), zt_coeffs_m[dd])
            h_ev = F.mont_mul(FR, f_ev, F.batch_inv(FR, acc))
            d_s = F.mont_mul(FR, self._ntt_many(h_ev, 1, inverse=True),
                             unscale2[s * n:(s + 1) * n])
            t = F.mont_mul(FR, d_s, mix2[0, s])
            dsum = t if dsum is None else F.add(FR, dsum, t)
        return dsum

    def shplonk_h_large(self, f_acc, zt_coeffs_m):
        return self._shplonk_h_split(
            f_acc, zt_coeffs_m,
            *_shplonk_h_tables(self.k, self.dev))

    def ipa_l(self, poly_flat, svals, h_shp, neg_zt_u, const_corr):
        """The SHPLONK residual L(X) = -Z_T(u) h + sum_g s_g p_g - const
        before its division by (X - u) (the IPA backend, backend/ipa.py,
        opens L at u directly)."""
        n = self.n
        acc = F.mont_mul(FR, h_shp, neg_zt_u)
        for g in range(svals.shape[0]):
            acc = F.add(FR, acc, F.mont_mul(
                FR, poly_flat[g * n:(g + 1) * n], svals[g]))
        acc = acc.clone()
        acc[0] = F.sub(FR, acc[0], const_corr)
        return acc

    def _shpl_div_eval(self, acc, z_m):
        """acc / (X - z) as values on the base coset, which never meets z."""
        l_ev = P.coset_evals(self.dom, acc)
        den = F.sub(FR, _coset_points(self.k, self.dev), z_m)
        return F.mont_mul(FR, l_ev, F.batch_inv(FR, den))

    def _shpl_div_interp(self, vals):
        return P.coset_interp(self.dom, vals)

    def shplonk_l(self, poly_flat, svals, h_shp, neg_zt_u, const_corr, u_m):
        """L(X) and the final witness quotient W' = L / (X - u)."""
        return self._shpl_div_interp(self._shpl_div_eval(
            self.ipa_l(poly_flat, svals, h_shp, neg_zt_u, const_corr), u_m))

    # the reference runs shplonk_l's three stages as three executables
    # from k=19 on; run eagerly, that split is this same sequence of ops,
    # so the prover calls shplonk_l on both paths (the name stays for the
    # tests that hold it against the reference's)
    shplonk_l_large = shplonk_l


def _get_phases(pk: ProvingKey, mesh=None) -> _Phases:
    """The pk's phases for ``mesh`` (None: one device), built once.  The
    lookup order is an argument of each prove, so it does not key the
    cache (a second key would hold a second copy of the static sub-coset
    evaluations)."""
    cache = getattr(pk, "_phases", None)
    if cache is None:
        cache = pk._phases = {}
    if mesh not in cache:
        cache[mesh] = _Phases(pk, mesh)
    return cache[mesh]


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
    return commit_many(ph.pk.srs, [flat[i * n:(i + 1) * n] for i in range(count)],
                       mesh=ph.mesh)


def prove(pk: ProvingKey, values, instances=None, seed=None,
          mesh=None, mesh_axis: str = comm.AXIS, multiopen: str = "shplonk",
          lookup_sort: str = "field",
          checkpoint_dir: str | None = None) -> bytes:
    """values: (num_columns, n) int merged column matrix (tensor or numpy;
    moved to the pk's device).  instances: per instance column, a list
    of python ints.  ``seed`` selects a reproducible blinding stream
    (tests only; None draws from os.urandom).  Returns proof bytes.

    ``multiopen``: "shplonk" (default), "gwc" (one witness per
    rotation point) or "ipa" (the pairing-free opening argument of
    backend/ipa.py; needs a pk built against ``ipa.setup``'s basis).  ``lookup_sort``: "field" (default; halo2's order
    by canonical field value) or "packed" (uint32 keys of byte-ranged
    columns; other proof bytes, the same argument).  ``checkpoint_dir``:
    save each heavy phase there and resume a crashed prove at the first
    incomplete phase (backend/resume.py).  A vk whose extended domain
    exceeds the field's two-adicity (the reference's ``Domain`` refuses
    it) raises ValueError before any work.

    ``mesh``: a ``parallel.comm.Mesh``; every rank calls ``prove`` with
    the same arguments and gets the same bytes, those of the one-device
    prove with the same seed.  ``mesh_axis`` names the mesh's axis (a
    mesh here has one).  With ``seed=None`` rank 0 draws every blinding
    value from os.urandom and broadcasts the bytes.  On a mesh of more
    than one rank ``checkpoint_dir`` must be an existing directory that
    every rank sees; rank 0 writes the checkpoints (backend/resume.py).
    IPA on a mesh shards the commitments before
    the opening and runs the opening's rounds on each rank's device, as
    the reference does."""
    try:
        with timers.span("prove", k=pk.vk.k, multiopen=multiopen), \
                timers.Steps() as phase:
            return _prove(phase, pk, values, instances, seed, mesh, mesh_axis,
                          multiopen, lookup_sort, checkpoint_dir)
    finally:
        if _releases_cache(pk):
            torch.cuda.empty_cache()


def _prove(phase, pk, values, instances, seed, mesh, mesh_axis, multiopen,
           lookup_sort, checkpoint_dir) -> bytes:
    """``prove``'s body; ``phase(name)`` closes the open phase span and
    opens the next (PHASE_SPANS)."""
    phase("advice")
    if mesh is not None and mesh_axis != mesh.axis:
        raise ValueError(f"mesh axis {mesh_axis!r}; the mesh has {mesh.axis!r}")
    if multiopen not in ("shplonk", "gwc", "ipa"):
        raise ValueError(f"unknown multiopen {multiopen!r}")
    if lookup_sort not in ("field", "packed"):
        raise ValueError(f"unknown lookup_sort {lookup_sort!r}")
    if pk.vk.ext_k > FR.two_adicity:
        raise ValueError(
            f"k={pk.vk.k}: the extended domain of 2^{pk.vk.ext_k} points exceeds "
            f"Fr's two-adicity {FR.two_adicity} (the largest NTT the field has)")
    if lookup_sort == "packed":
        for lk in pk.vk.cs.lookups:
            _check_lookup_packable(pk.layout, lk)

    ph = _get_phases(pk, mesh)
    if _releases_cache(pk):
        ph.warm_tables(multiopen)
        torch.cuda.empty_cache()
    vk, cs, layout = pk.vk, pk.vk.cs, pk.layout
    dev = ph.dev
    n, usable, bf = ph.n, ph.usable, ph.bf
    rng = None if seed is None else np.random.default_rng(seed)
    ck_rng = rng                  # what a checkpoint saves and restores
    if mesh is not None and seed is None:
        rng = comm.RankZeroRandom(mesh)
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

    large = ph.large()
    empty = torch.zeros((0, LIMBS), dtype=torch.int32, device=dev)
    ck = None
    if checkpoint_dir is not None:
        ck = RES.ProveCheckpoint(checkpoint_dir, RES.prove_key_material(
            vk.digest, values, instances, seed, multiopen, lookup_sort), mesh)

    def restored(st, names, parked=()):
        """A loaded phase's tensors (on the device; those named in
        ``parked`` where they wait) and points; the RNG continues from the
        saved state."""
        arrays, pts, rng_state = st
        RES.restore_rng(ck_rng, rng_state)
        return [ph.park(T(arrays[name])) if name in parked else T(arrays[name])
                for name in names], pts

    # ---- phase 1: advice lift + blind + INTT + commits ----------------------
    st = ck.load("advice") if ck else None
    if st is None:
        adv_blinding = T(_rand_field(rng, len(ph.adv_ids), n - usable))
        all_fld, adv_coeffs, inst_coeffs = ph.advice_phase(
            values, adv_blinding, torch.as_tensor(inst_arr, device=dev))
        adv_pts = _commit_pts(ph, adv_coeffs, len(ph.adv_ids))
        adv_coeffs, inst_coeffs = ph.park(adv_coeffs), ph.park(inst_coeffs)
        if ck:
            ck.save("advice", {"all_fld": all_fld, "adv_coeffs": adv_coeffs,
                               "inst_coeffs": inst_coeffs}, adv_pts, ck_rng)
    else:
        (all_fld, adv_coeffs, inst_coeffs), adv_pts = restored(
            st, ("all_fld", "adv_coeffs", "inst_coeffs"),
            ("adv_coeffs", "inst_coeffs"))
    for pt in adv_pts:
        tr.write_point(pt)
    SAN.check_phase(FR, "advice", adv_coeffs=adv_coeffs, inst_coeffs=inst_coeffs)

    theta = tr.squeeze_challenge()
    phase("lookup_permuted")
    theta_m = enc(theta)

    # ---- phase 2: lookup permuted pairs ---------------------------------------
    st = ck.load("lookup") if ck else None
    if st is None:
        if ph.n_lk:
            bl_a = T(_rand_field(rng, ph.n_lk, n - usable))
            bl_s = T(_rand_field(rng, ph.n_lk, n - usable))
            lk_ap, lk_sp, lk_a_coeffs, lk_s_coeffs = ph.lookup_phase(
                values, all_fld, theta_m, bl_a, bl_s, lookup_sort)
            polys = []
            for i in range(ph.n_lk):       # transcript order: a'_i, s'_i
                polys += [lk_a_coeffs[i * n:(i + 1) * n],
                          lk_s_coeffs[i * n:(i + 1) * n]]
            lk_pts = commit_many(pk.srs, polys, mesh=mesh)
            del polys
            lk_a_coeffs, lk_s_coeffs = ph.park(lk_a_coeffs), ph.park(lk_s_coeffs)
        else:
            lk_ap = lk_sp = lk_a_coeffs = lk_s_coeffs = empty
            lk_pts = []
        if ck:
            ck.save("lookup", {"lk_ap": lk_ap, "lk_sp": lk_sp,
                               "lk_a_coeffs": lk_a_coeffs,
                               "lk_s_coeffs": lk_s_coeffs}, lk_pts, ck_rng)
    else:
        (lk_ap, lk_sp, lk_a_coeffs, lk_s_coeffs), lk_pts = restored(
            st, ("lk_ap", "lk_sp", "lk_a_coeffs", "lk_s_coeffs"),
            ("lk_a_coeffs", "lk_s_coeffs"))
    for pt in lk_pts:
        tr.write_point(pt)
    SAN.check_phase(FR, "lookup", a_coeffs=lk_a_coeffs, s_coeffs=lk_s_coeffs)

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    phase("grand_products")
    beta_m, gamma_m = enc(beta), enc(gamma)

    # ---- phase 3: grand products + random poly --------------------------------
    st = ck.load("products") if ck else None
    if st is None:
        z_blind = T(_rand_field(rng, ph.chunks, bf))
        lkz_blind = T(_rand_field(rng, max(ph.n_lk, 1), bf))
        if ph.chunks:
            z_perm_coeffs = ph.perm_products(all_fld, pk.perm_maps[0],
                                             pk.perm_maps[1], beta_m, gamma_m,
                                             z_blind)
        else:
            z_perm_coeffs = empty
        if ph.n_lk:
            lk_products = (ph.lookup_products_streamed if large
                           else ph.lookup_products_all)
            z_all = lk_products(all_fld, lk_ap, lk_sp, theta_m, beta_m,
                                gamma_m, lkz_blind)
            lkz_coeffs = ph._ntt_many(z_all, ph.n_lk, inverse=True)
            del z_all
        else:
            lkz_coeffs = empty
        random_coeffs = T(_rand_field(rng, n))
        prod_pts = commit_many(
            pk.srs,
            [z_perm_coeffs[t * n:(t + 1) * n] for t in range(ph.chunks)]
            + [lkz_coeffs[i * n:(i + 1) * n] for i in range(ph.n_lk)]
            + [random_coeffs], mesh=mesh)
        z_perm_coeffs, lkz_coeffs, random_coeffs = map(
            ph.park, (z_perm_coeffs, lkz_coeffs, random_coeffs))
        if ck:
            ck.save("products", {"z_perm_coeffs": z_perm_coeffs,
                                 "lkz_coeffs": lkz_coeffs,
                                 "random_coeffs": random_coeffs}, prod_pts, ck_rng)
    else:
        (z_perm_coeffs, lkz_coeffs, random_coeffs), prod_pts = restored(
            st, ("z_perm_coeffs", "lkz_coeffs", "random_coeffs"),
            ("z_perm_coeffs", "lkz_coeffs", "random_coeffs"))
    for pt in prod_pts:
        tr.write_point(pt)
    SAN.check_phase(FR, "products", z_perm=z_perm_coeffs, lkz=lkz_coeffs,
                    random=random_coeffs)
    # the evaluation-form tensors are dead from here on
    del all_fld, lk_ap, lk_sp

    y = tr.squeeze_challenge()
    phase("quotient")
    y_m = enc(y)

    # ---- phase 4: quotient ----------------------------------------------------
    # (a coefficient poly below is on the device, or parked in host memory
    # from rest.HOST_REST_MIN_K on: readers copy it into ph.stack)
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

    st = ck.load("quotient") if ck else None
    if st is None:
        q_subs = []
        if large:
            # one buffer for every sub-coset's evaluations, static then
            # dynamic, allocated before any transient of the phase: tens of
            # GB in one piece at k >= 23, where a second allocation of it
            # after the transients failed on a fragmented cache
            n_static = len(ph.q_static_keys) * n
            subcoset_evals = torch.empty(
                (n_static + len(ph.q_dyn_keys) * n, LIMBS), dtype=torch.int32,
                device=dev)
        n_polys = len(ph.q_dyn_keys) + len(ph.q_static_keys)
        for s in range(ph.ratio):
            shift_pows, zh_inv = _subcoset_tables(ph.k, ph.ext_k, s, dev)
            with timers.span("quotient.subcoset_evals", polys=n_polys):
                if large:
                    dyn_evals = ph.evals_sliced(ph.q_dyn_keys, coeffs_for,
                                                shift_pows,
                                                out=subcoset_evals[n_static:])
                    static_evals = ph.static_subcoset_evals(
                        s, out=subcoset_evals[:n_static])
                else:
                    dyn_stack = ph.stack([coeffs_for(key) for key in ph.q_dyn_keys])
                    dyn_evals = ph._ntt_many(dyn_stack, len(ph.q_dyn_keys),
                                             inverse=False, shift_pows=shift_pows)
                    del dyn_stack
                    static_evals = ph.static_subcoset_evals(s)
            # the Horner fold of the constraint terms and the Z_H division;
            # muls, polys and rows give the work the constraint system asks
            with timers.span("quotient.terms", terms=ph.terms.terms,
                             fused=int(dev.type == "cuda"), muls=ph.terms.muls,
                             polys=ph.terms.polys, rows=n):
                q_subs.append(ph.quotient_subcoset(
                    static_evals, dyn_evals, theta_m, beta_m, gamma_m, y_m,
                    shift_pows, zh_inv))
            del dyn_evals, static_evals
        if large:
            del subcoset_evals
        finish = ph.quotient_finish_large if large else ph.quotient_finish
        with timers.span("quotient.finish"):
            pieces = finish(torch.cat(q_subs))
        del q_subs
        piece_pts = _commit_pts(ph, pieces, ph.d - 1)
        n_qb = ph.d - 2 if pk.srs.g1_extra is not None else 0
        qb_limbs = _rand_field(rng, n_qb) if n_qb > 0 else np.zeros((0, LIMBS),
                                                                    np.uint32)
        q_blinds = [F.limbs_to_int(qb_limbs[j]) for j in range(n_qb)]
        if q_blinds:
            piece_pts = _stagger_blind_pieces(piece_pts, q_blinds,
                                              pk.srs.g1_extra)
        if ck:
            ck.save("quotient", {"pieces": pieces, "qblinds": qb_limbs},
                    piece_pts, ck_rng)
    else:
        (pieces,), piece_pts = restored(st, ("pieces",))
        qb = st[0]["qblinds"]
        q_blinds = [F.limbs_to_int(qb[j]) for j in range(qb.shape[0])]
    for pt in piece_pts:
        tr.write_point(pt)
    SAN.check_phase(FR, "quotient", pieces=pieces)

    x = tr.squeeze_challenge()
    phase("evals")
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
        x_m = enc(rot_point(rot))
        step = _EVAL_STACK[ph.host_rest()] if large else len(keys)
        for lo in range(0, len(keys), step):
            sl = keys[lo:lo + step]
            stack = ph.stack([poly_coeffs(kk) for kk in sl])
            vals = ph.eval_many(stack, x_m, len(sl))
            for kk, v in zip(sl, FR.decode(vals)):
                evals[(kk, rot)] = v
    for key, rot in plan:
        if key[0] != "h":
            tr.write_scalar(evals[(key, rot)])

    if multiopen == "gwc":
        # GWC: queries grouped BY ROTATION POINT, one opening witness
        # W_i = [(F_i - F_i(z_i)) / (X - z_i)] per point, v-power order =
        # plan order at that point
        v = tr.squeeze_challenge()
        phase("gwc_open")
        gn = pow(P.GEN, n, FR.modulus)    # X^n is constant on the base coset
        for rot, keys in by_rot.items():
            vp = np.zeros((len(keys), LIMBS), np.uint32)
            acc = 1
            ev = 0
            for j, kk in enumerate(keys):
                vp[j] = F.int_to_limbs(FR.to_mont_host(acc))
                ev = (ev + acc * evals[(kk, rot)]) % FR.modulus
                if kk == ("h",) and cn:
                    # h'(X) - h'(z) carries the on-coset constant
                    # v^j cn (g^n - x^n): fold it into the coefficient-0 term
                    ev = (ev - acc * cn % FR.modulus * (gn - xn)) % FR.modulus
                acc = acc * v % FR.modulus
            stack = ph.stack([poly_coeffs(kk) for kk in keys])
            w = ph.gwc_witness(stack, T(vp), enc(ev), enc(rot_point(rot)))
            del stack
            tr.write_point(commit_affine(pk.srs, w, mesh=mesh))
        if ck:
            ck.clear()
        return tr.finalize()

    # ---- SHPLONK multiopen ----------------------------------------------------
    y2 = tr.squeeze_challenge()
    v = tr.squeeze_challenge()
    phase("shplonk_h")
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

    if large:
        poly_flat = ph.shplonk_fold_large(poly_coeffs, members, w_np)
    else:
        members_flat = ph.stack([poly_coeffs(key) for key in members])
        poly_flat = ph.shplonk_fold(members_flat, T(w_np))
        del members_flat
    f_acc = ph.shplonk_f(poly_flat, T(corr_np), T(zcs_np))
    zt_coeffs_m = T(F.ints_to_limbs_fast(
        [FR.to_mont_host(c) for c in P.vanishing_poly_coeffs(t_points)]))
    h_shp = (ph.shplonk_h_large if large else ph.shplonk_h)(f_acc, zt_coeffs_m)
    if cn:
        h_shp = ph.hshp_blind_fix(h_shp, enc(x), enc(W_h * cn % FR.modulus))
    tr.write_point(commit_affine(pk.srs, h_shp, mesh=mesh))

    u = tr.squeeze_challenge()
    phase("ipa_open" if multiopen == "ipa" else "shplonk_l")
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

    if multiopen == "ipa":
        from halo2_aes_tpu_torch.backend import ipa as IPA

        # a transparent basis has no g1_extra, so the stagger-blind
        # corrections (cn) are structurally zero on this path
        if cn != 0:
            raise AssertionError("ipa prove with KZG-blinded quotient pieces")
        # a ceremony KZG SRS also has g1_extra=None (cn==0) but carries
        # no u-point; without this guard the failure surfaces deep in
        # _point_plus_u as CV.py_mul(None, ...)
        if getattr(pk.srs, "u_pt", None) is None:
            raise AssertionError(
                "ipa prove requires an IPA transparent basis from ipa.setup "
                "(this SRS has no u-point; pass multiopen='shplonk' or "
                "build the pk against ipa.setup(k))")
        l_poly = ph.ipa_l(poly_flat, T(svals_np), h_shp,
                          enc(FR.modulus - zt_u), enc(const_corr))
        IPA.open_claim(pk.srs, tr, l_poly, u, rng=rng)
        if ck:
            ck.clear()
        return tr.finalize()

    q_w = ph.shplonk_l(
        poly_flat, T(svals_np), h_shp, enc(FR.modulus - zt_u),
        enc(const_corr), enc(u))
    tr.write_point(commit_affine(pk.srs, q_w, mesh=mesh))
    if ck:
        ck.clear()
    return tr.finalize()
