"""The port's k >= 19 (sliced) prove path against the reference at K=6.

Each sliced function of ``backend/prover.py`` is held, on the same
seeded inputs, against the JAX package's function of the same name and
against the port's own unsliced form, bit for bit (the quotient's term
program, the prover's route, against the reference's sliced fold and
the port's eager fold); ``lookup.grand_product``
against the reference's and against the rows of ``grand_product_many``;
the tensors a quotient or lookup-product call reads are freed when it
returns, without the cyclic collector; and with the switch lowered to K
every golden proof (toys, GWC, packed) comes out byte-identical through
the sliced path and verifies.  So it does with the k >= 23 switch
lowered (idle stacks resting in host memory, however the pk was made,
and the k >= 23 forms of ``prover.HOST_REST_FORMS``) and with the NTT's
row cap lowered (three and more passes a transform), and with the pair
sort's limit lowered (the permuted pairs one lookup at a time, the form
``prover.streamed_pairs`` picks by the proof's size: from k=22 for
AES-128) and host rest left as it is; the term program launched over
row chunks and the permuted pairs built one lookup at a time equal
their whole forms; and prove takes every k the reference takes and
refuses, before any work, the k whose extended domain the field cannot
transform."""

import dataclasses
import gc
import json
import pathlib
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import lookup as ref_lookup
from halo2_aes_tpu.backend import poly as ref_poly
from halo2_aes_tpu.backend import prover as ref_prover
from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.ops import field as ref_field
from halo2_aes_tpu.ops import pallas_ntt as ref_pallas_ntt
from halo2_aes_tpu_torch.backend import convert, keygen, lookup, prover, rest, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import GOLDEN_PROOFS, K, TOYS
from halo2_aes_tpu_torch.ops import cuda_quotient as CQ
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as MSM
from halo2_aes_tpu_torch.ops import ntt as N
from halo2_aes_tpu_torch.parallel import comm

torch.set_num_threads(1)
FR = F.FR
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())


@pytest.fixture(scope="module")
def srs_pair():
    return srs.setup(K, "cpu", cache_dir=None), ref_srs.setup(K, cache_dir=None)


@pytest.fixture(scope="module")
def phases(srs_pair):
    """(port _Phases, reference _Phases) of the tagged toy (gates, a
    permutation and lookups)."""
    layout, _ = TOYS["tagged"][0]()
    ref_layout, _ = TOYS["tagged"][0](ref_ir)
    pk = keygen.keygen(layout, srs_pair[0])
    ref_pk = ref_keygen.keygen(ref_layout, srs_pair[1])
    return prover._get_phases(pk), ref_prover._get_phases(ref_pk)


def _rand(rng, rows):
    """Seeded canonical Montgomery limbs, as numpy uint32."""
    return FR.encode(rng.integers(1, 2**62, rows, dtype=np.int64).tolist())


def _t(a):
    return F.limbs(a, "cpu")


def _np(a):
    return F.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _sub(ph, s):
    """Sub-coset s's (shift powers, 1/Z_H) as numpy limbs."""
    return tuple(map(F.to_numpy, prover._subcoset_tables(ph.k, ph.ext_k, s, "cpu")))


def _same(*arrays):
    first = _np(arrays[0])
    return all(np.array_equal(first, _np(a)) for a in arrays[1:])


def test_evals_sliced(phases):
    ph, ref = phases
    shift, _ = _sub(ph, 1)
    sliced = ph.evals_sliced(ph.q_static_keys, ph._coeffs_static, _t(shift),
                             B=2)          # full slices and a remainder
    ref_sliced = ref.evals_sliced(ref.q_static_keys, ref._coeffs_static,
                                  jnp.asarray(shift), B=2)
    whole = ph._ntt_many(torch.cat([ph._coeffs_static(key)
                                    for key in ph.q_static_keys]),
                         len(ph.q_static_keys), inverse=False,
                         shift_pows=_t(shift))
    assert len(ph.q_static_keys) % 2 == 1
    assert _same(sliced, ref_sliced, whole)


@pytest.mark.parametrize("s", [0, 3])
def test_static_subcoset_evals_large_recomputes(phases, s, monkeypatch):
    """On the large path the static sub-coset evaluations are recomputed
    at every call, never cached, and equal the unsliced (cached) ones
    and the reference's."""
    ph, ref = phases
    whole = ph.static_subcoset_evals(s)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    ph._static_evals.clear()
    assert _same(ph.static_subcoset_evals(s), whole, ref.static_subcoset_evals(s))
    assert not ph._static_evals


@pytest.mark.parametrize("n_parts", [3, 4])
def test_quotient_subcoset_sliced(phases, n_parts):
    """The term program (the prover's route on every device) equals the
    reference's fold in ``n_parts`` Horner partials and the port's eager
    fold."""
    ph, ref = phases
    rng = np.random.default_rng(3)
    static = _rand(rng, len(ph.q_static_keys) * ph.n)
    dyn = _rand(rng, len(ph.q_dyn_keys) * ph.n)
    scal = [FR.encode(v) for v in (11, 13, 17, 19)]
    shift, zh_inv = _sub(ph, 1)
    args = (static, dyn, *scal, shift, zh_inv)
    ref_sliced = ref.quotient_subcoset_sliced(*map(jnp.asarray, args),
                                              n_parts=n_parts)
    assert _same(ph.quotient_subcoset(*map(_t, args)), ref_sliced,
                 ph.quotient_subcoset_eager(*map(_t, args)))


def test_quotient_finish_large(phases):
    ph, ref = phases
    q_flat = _rand(np.random.default_rng(5), ph.ratio * ph.n)
    assert _same(ph.quotient_finish_large(_t(q_flat)),
                 ref.quotient_finish_large(jnp.asarray(q_flat)),
                 ph.quotient_finish(_t(q_flat)))


def test_shplonk_h_large(phases):
    ph, ref = phases
    rng = np.random.default_rng(7)
    zt = ref_poly.vanishing_poly_coeffs([3, 5, 7])
    zt_m = F.ints_to_limbs_fast([FR.to_mont_host(c) for c in zt])
    f_acc = _rand(rng, ph.n + len(zt) - 1)
    assert _same(ph.shplonk_h_large(_t(f_acc), _t(zt_m)),
                 ref.shplonk_h_large(jnp.asarray(f_acc), jnp.asarray(zt_m)),
                 ph.shplonk_h(_t(f_acc), _t(zt_m)))


def test_shplonk_fold_large(phases):
    ph, ref = phases
    rng = np.random.default_rng(11)
    M = sum(ph.shp_sizes)
    assert any(sz > 2 and sz % 2 for sz in ph.shp_sizes)   # a remainder slice
    polys = [_rand(rng, ph.n) for _ in range(M)]
    w_np = F.ints_to_limbs_fast(
        [FR.to_mont_host(int(rng.integers(1, 2**61))) for _ in range(M)])
    sliced = ph.shplonk_fold_large(lambda i: _t(polys[i]), list(range(M)),
                                   w_np, B=2)
    ref_sliced = ref.shplonk_fold_large(lambda i: jnp.asarray(polys[i]),
                                        list(range(M)), w_np, B=2)
    whole = ph.shplonk_fold(_t(np.concatenate(polys)), _t(w_np))
    assert _same(sliced, ref_sliced, whole)


def test_shplonk_fold_large_single_member_is_a_copy(phases):
    """A one-member slice must not hand out a view of the resident poly."""
    ph, _ = phases
    poly = _t(_rand(np.random.default_rng(13), ph.n))
    keep = poly.clone()
    members = list(range(sum(ph.shp_sizes)))
    w_np = F.ints_to_limbs_fast([FR.to_mont_host(3)] * len(members))
    ph.shplonk_fold_large(lambda i: poly, members, w_np, B=1)
    assert torch.equal(poly, keep)


def test_shplonk_l_large_and_ipa_l(phases):
    ph, ref = phases
    rng = np.random.default_rng(9)
    G = len(ph.shp_sets)
    poly_flat, h_shp, svals = (_rand(rng, G * ph.n), _rand(rng, ph.n),
                               _rand(rng, G))
    neg_zt_u, const_corr, u_m = (FR.encode(v) for v in (23, 29, 31))
    args = (poly_flat, svals, h_shp, neg_zt_u, const_corr)
    assert _same(ph.ipa_l(*map(_t, args)), ref.ipa_l(*map(jnp.asarray, args)))
    assert _same(ph.shplonk_l_large(*map(_t, args), _t(u_m)),
                 ref.shplonk_l_large(*map(jnp.asarray, args), jnp.asarray(u_m)),
                 ph.shplonk_l(*map(_t, args), _t(u_m)))


def test_n_constraint_terms(phases):
    """The term program's term count equals the reference's and a walk of
    the terms."""
    ph, ref = phases
    assert ph.terms.terms == ref.n_constraint_terms()
    ctx = ph._subcoset_ctx(*(_t(a) for a in (
        _rand(np.random.default_rng(1), len(ph.q_static_keys) * ph.n),
        _rand(np.random.default_rng(2), len(ph.q_dyn_keys) * ph.n))),
        *(_t(FR.encode(v)) for v in (2, 3, 5)),
        _t(_sub(ph, 0)[0]))
    assert sum(1 for _ in prover.PROTO.constraint_terms(ph.cs, ctx)) == \
        ph.terms.terms


def test_grand_product():
    """One lookup's z column equals the reference's and the matching rows
    of grand_product_many."""
    rng = np.random.default_rng(17)
    n, usable, bf, L = 64, 57, 6, 3
    a, s, ap, sp = (_rand(rng, L * n) for _ in range(4))
    blinds = _rand(rng, L * bf).reshape(L, bf, F.LIMBS)
    beta, gamma = FR.encode(101), FR.encode(103)
    many = lookup.grand_product_many(*map(_t, (a, s, ap, sp)), L, usable,
                                     _t(beta), _t(gamma), _t(blinds))
    for i in range(L):
        rows = slice(i * n, (i + 1) * n)
        args = (a[rows], s[rows], ap[rows], sp[rows])
        one = lookup.grand_product(*map(_t, args), usable, _t(beta),
                                   _t(gamma), _t(blinds[i]))
        ref = ref_lookup.grand_product(*map(jnp.asarray, args), usable,
                                       jnp.asarray(beta), jnp.asarray(gamma),
                                       jnp.asarray(blinds[i]))
        assert _same(one, ref, many[rows])


@pytest.mark.parametrize("fn", ["quotient_subcoset", "quotient_subcoset_eager"])
def test_subcoset_stacks_freed_on_return(phases, fn):
    """A sub-coset's evaluation stacks are freed as soon as the quotient
    call returns, with Python's cyclic collector off: the protocol
    Context must not hold them in a reference cycle (a class made per
    call did, ~12 GB at k=20)."""
    ph, _ = phases
    rng = np.random.default_rng(19)
    static = _t(_rand(rng, len(ph.q_static_keys) * ph.n))
    dyn = _t(_rand(rng, len(ph.q_dyn_keys) * ph.n))
    shift, zh_inv = _sub(ph, 1)
    alive = [weakref.ref(static), weakref.ref(dyn)]
    gc.disable()
    try:
        getattr(ph, fn)(static, dyn, *(_t(FR.encode(v)) for v in (2, 3, 5, 7)),
                        _t(shift), _t(zh_inv))
        del static, dyn
        assert [r() for r in alive] == [None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("fn", ["lookup_products_all", "lookup_products_streamed"])
def test_column_stack_freed_on_return(phases, fn):
    """The lifted columns handed to the lookup products are freed when
    the call returns, with the cyclic collector off."""
    ph, _ = phases
    rng = np.random.default_rng(23)
    n, L = ph.n, ph.n_lk
    all_fld = _t(_rand(rng, ph.layout.witness_map.shape[0] * n))
    alive = weakref.ref(all_fld)
    gc.disable()
    try:
        getattr(ph, fn)(all_fld, _t(_rand(rng, L * n)), _t(_rand(rng, L * n)),
                        *(_t(FR.encode(v)) for v in (2, 3, 5)),
                        _t(_rand(rng, L * ph.bf).reshape(L, ph.bf, F.LIMBS)))
        del all_fld
        assert alive() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("count", [1, 2, 5, 64, 1000])
def test_powers_table_equals_host(count):
    """powers_table (log-depth doubling through K1; the plain mont_mul
    here on CPU tensors) equals the host bigint loop."""
    base = 0x2B7E151628AED2A6ABF7158809CF4F3C
    assert np.array_equal(F.to_numpy(F.powers_table(FR, base, count, "cpu")),
                          FR.host_powers(base, count))


@pytest.mark.parametrize("k,inverse", [(12, False), (12, True), (13, False)])
def test_ntt_mid_table_equals_reference(k, inverse):
    """The NTT's mid twiddles, gathered from one powers table, equal the
    reference's host-built table (limbs last)."""
    k1 = (k + 1) // 2
    assert np.array_equal(F.to_numpy(N._mid_table(FR, k, k1, inverse, "cpu")),
                          ref_pallas_ntt._mid_table(ref_field.FR, k, k1, inverse).T)


_REF_PKS = {}


@pytest.mark.parametrize("name", sorted(GOLDEN_PROOFS))
def test_forced_large_prove_equals_golden(name, srs_pair, monkeypatch):
    """With the switch lowered to K, every golden proof comes out of the
    sliced path byte for byte, with the static sub-coset evaluations
    recomputed (never cached), and both verifiers accept it."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, instances = TOYS[toy]
    layout, values = build()
    pk = keygen.keygen(layout, srs_pair[0])
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    ph = prover._get_phases(pk)
    assert ph.large()
    proof = prover.prove(pk, values, seed=seed, **opts)
    assert proof.hex() == GOLDEN[name]["proof"]
    assert len(ph._static_evals) == 0
    if toy not in _REF_PKS:
        _REF_PKS[toy] = ref_keygen.keygen(build(ref_ir)[0], srs_pair[1])
    multiopen = opts.get("multiopen", "shplonk")
    assert verifier.verify(pk.vk, proof, instances=instances, multiopen=multiopen)
    assert ref_verifier.verify(_REF_PKS[toy].vk, proof, instances=instances,
                               multiopen=multiopen)


class _PastTheGate(Exception):
    pass


def test_max_k_is_the_ntt_reach(srs_pair, monkeypatch):
    """The NTT reaches every k the field allows, so prove takes what the
    reference's Domain takes: a vk of k = 23..26 (the AES circuits'
    ext_k = k + 2 <= Fr's two-adicity 28) gets past the gate to its
    phases, with and without a mesh; k = 27 raises ValueError, naming
    the two-adicity, before any work (no phases built, no collective)."""
    assert F.FR.two_adicity == 28
    layout, values = TOYS["toy"][0]()
    pk = keygen.keygen(layout, srs_pair[0])

    def phases(*a, **kw):
        raise _PastTheGate

    monkeypatch.setattr(prover, "_get_phases", phases)
    comm.reset_counts()
    meshes = (None, comm.Mesh(None, "gloo", 0, 2, torch.device("cpu")))
    for k in (23, 24, 25, 26):
        big = dataclasses.replace(pk, vk=dataclasses.replace(pk.vk, k=k, ext_k=k + 2))
        for mesh in meshes:
            with pytest.raises(_PastTheGate):
                prover.prove(big, values, seed=1, mesh=mesh)
    big = dataclasses.replace(pk, vk=dataclasses.replace(pk.vk, k=27, ext_k=29))
    for mesh in meshes:
        with pytest.raises(ValueError, match="two-adicity 28"):
            prover.prove(big, values, seed=1, mesh=mesh)
    assert not hasattr(big, "_phases")
    assert sum(comm.CALLS.values()) == 0


@pytest.mark.parametrize("name", ["toy", "tagged", "instance", "toy_gwc",
                                  "tagged_packed"])
@pytest.mark.parametrize("cap", [2, 3])
def test_low_row_cap_prove_equals_golden(name, cap, srs_pair, monkeypatch):
    """With the NTT's row cap lowered, every K=6 transform (and the
    extended ones) is three or more composed passes: the golden bytes."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(N, "ROW_CAP", cap)
    assert len(N.pass_lengths(K)) >= 2
    pk = keygen.keygen(layout, srs_pair[0])
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]


@pytest.mark.parametrize("name", ["toy", "tagged", "toy_gwc"])
def test_low_row_cap_forced_sliced_equals_golden(name, srs_pair, monkeypatch):
    """The sliced path with three-pass transforms: the golden bytes."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(N, "ROW_CAP", 2)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    pk = keygen.keygen(layout, srs_pair[0])
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]


@pytest.mark.parametrize("name", sorted(GOLDEN_PROOFS))
def test_host_rest_prove_equals_golden(name, srs_pair, monkeypatch):
    """With the k >= 23 switch lowered to K (the pk's stacks parked, the
    prove parking each coefficient stack once made, readers copying back
    the polys they take, and the k >= 23 forms of HOST_REST_FORMS) on
    the sliced path, every golden proof comes out byte for byte."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(rest, "HOST_REST_MIN_K", K)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    pk = keygen.keygen(layout, srs_pair[0])
    ph = prover._get_phases(pk)
    assert ph.host_rest() and ph.large()
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]


@pytest.mark.parametrize("chunks", [1, 2, 3, 5])
def test_quotient_row_chunks(phases, chunks):
    """The term program launched once a row chunk (rotations reading
    across a chunk's edge and wrapping past the last row; 5 chunks are
    ragged, 12 and 13 rows) equals the whole-coset launch and the
    reference's fold."""
    ph, ref = phases
    rng = np.random.default_rng(31)
    static = _rand(rng, len(ph.q_static_keys) * ph.n)
    dyn = _rand(rng, len(ph.q_dyn_keys) * ph.n)
    scal = [FR.encode(v) for v in (11, 13, 17, 19)]
    shift, zh_inv = _sub(ph, 2)
    args = (static, dyn, *scal, shift, zh_inv)
    static_t, dyn_t, theta, beta, gamma, y, shift_t, zh_inv_t = map(_t, args)
    table = ph.terms_table(theta, beta, gamma, y, shift_t, zh_inv_t)
    omega = ph.dom.omega_powers("cpu")
    chunked = torch.empty((ph.n, F.LIMBS), dtype=torch.int32)
    for c in range(chunks):
        lo, hi = c * ph.n // chunks, (c + 1) * ph.n // chunks
        CQ.quotient_terms(ph._terms_code, ph.terms.slots, table, static_t, dyn_t,
                          omega, lo, chunked[lo:hi])
    assert _same(chunked, ph.quotient_subcoset(*map(_t, args)),
                 ref.quotient_subcoset_sliced(*map(jnp.asarray, args)))


def test_permuted_pairs_streamed(phases, monkeypatch):
    """The permuted pairs built one lookup at a time (the form of the
    proofs whose batched sort would not fit: k >= 22 for AES-128) equal
    the batched build, and the reference's lookup phase."""
    ph, ref = phases
    rng = np.random.default_rng(37)
    values = TOYS["tagged"][0]()[1]
    n, L = ph.n, ph.n_lk
    theta = FR.encode(7)
    bl = [_rand(rng, L * (n - ph.usable)).reshape(L, n - ph.usable, F.LIMBS)
          for _ in range(2)]
    all_fld = F.u16_to_field(FR, torch.as_tensor(values.astype(np.int32)).reshape(-1))
    args = (torch.as_tensor(values.astype(np.int32)), all_fld, _t(theta),
            _t(bl[0]), _t(bl[1]), "field")
    batched = ph.lookup_phase(*args)
    monkeypatch.setattr(prover, "PAIR_SORT_MAX_BYTES", 0)
    streamed = ph.lookup_phase(*args)
    for a, b in zip(batched, streamed):
        assert torch.equal(a, b)
    ref_out = ref.lookup_phase(jnp.asarray(values.astype(np.uint32)),
                               jnp.asarray(F.to_numpy(all_fld)), jnp.asarray(theta),
                               jnp.asarray(bl[0]), jnp.asarray(bl[1]))
    assert _same(streamed[0], ref_out[0]) and _same(streamed[2], ref_out[2])


@pytest.mark.parametrize("k, streamed", [(17, False), (18, False), (20, False),
                                         (21, False), (22, True), (23, True)])
def test_pair_form_follows_the_proofs_size(k, streamed):
    """AES-128's 17 lookups (upstream's layout, 4 sets): the batched pair
    sort up to k=21, one lookup at a time from k=22, whatever the
    host-rest threshold; a circuit of few lookups keeps the batched sort
    at k=22.  A prove on a card warms its tables and releases the cache
    at k=22 alone (from k=23 its process runs expandable segments); on
    the CPU never."""
    assert prover.streamed_pairs(1 << k, 17) is streamed
    assert not prover.streamed_pairs(1 << 22, 4)
    assert rest.on_host(k) is (k >= 23)
    for dev, releases in (("cuda", k == 22), ("cpu", False)):
        pk = types.SimpleNamespace(vk=types.SimpleNamespace(k=k),
                                   device=torch.device(dev))
        assert prover._releases_cache(pk) is releases


@pytest.mark.parametrize("name", ["toy", "tagged", "toy_gwc"])
def test_streamed_pairs_prove_equals_golden(name, srs_pair, monkeypatch):
    """The pair sort's limit lowered below the toy's (every lookup's pairs
    built one at a time) on the sliced path, host rest left at its
    threshold, as a k=22 prove runs: the golden bytes."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(prover, "PAIR_SORT_MAX_BYTES", 0)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    pk = keygen.keygen(layout, srs_pair[0])
    ph = prover._get_phases(pk)
    assert prover.streamed_pairs(ph.n, ph.n_lk) and ph.large()
    assert not ph.host_rest()
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]


@pytest.mark.parametrize("name", ["tagged", "toy_gwc"])
def test_warm_tables_cover_a_large_prove(name, srs_pair, monkeypatch):
    """``_Phases.warm_tables`` for the prove's opening (which a k >= 22
    prove on a card runs once, before its first transient) builds every
    cached device table a sliced prove with that opening reads: from
    cleared caches, the prove after it builds none; a second call builds
    nothing."""
    from halo2_aes_tpu_torch.backend import permutation, poly

    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    pk = keygen.keygen(layout, srs_pair[0])
    caches = [prover._subcoset_tables, prover._finish_split_tables,
              prover._shplonk_h_tables, prover._coset_points, poly._shift_powers,
              poly._vanishing_inv_table, permutation._label_tables, N._mid_table,
              N._powers_table, N._dev_limbs, N._dev_index]
    for fn in caches:
        fn.cache_clear()
    ph = prover._get_phases(pk)
    ph.warm_tables(opts.get("multiopen", "shplonk"))
    warmed = [fn.cache_info().currsize for fn in caches]
    misses = [fn.cache_info().misses for fn in caches]
    ph.warm_tables(opts.get("multiopen", "shplonk"))
    assert [fn.cache_info().misses for fn in caches] == misses
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]
    assert [fn.cache_info().currsize for fn in caches] == warmed


@pytest.mark.parametrize("made_by", ["keygen", "pk_from_numpy"])
def test_pk_stacks_rest_however_made(made_by, srs_pair, monkeypatch):
    """From the host-rest threshold on, a pk parks every coefficient
    stack (each fixed poly, the sigma stack, the three selectors) however
    it was made; below it, none."""
    layout, _ = TOYS["tagged"][0]()
    pk = keygen.keygen(layout, srs_pair[0])
    parked = []

    def park(t):
        parked.append(t.shape)
        return t

    monkeypatch.setattr(rest, "park", park)

    def make():
        if made_by == "keygen":
            return keygen.keygen(layout, srs_pair[0])
        return convert.pk_from_numpy(layout, srs_pair[0], **convert.pk_to_numpy(pk))

    make()
    assert parked == []
    monkeypatch.setattr(rest, "HOST_REST_MIN_K", K)
    again = make()
    n = 1 << K
    assert parked == ([(n, F.LIMBS)] * len(pk.fixed_coeffs)
                      + [pk.sigma_coeffs.shape] + [(n, F.LIMBS)] * 3)
    assert again.vk.digest == pk.vk.digest


def test_tableless_commitments_equal_host(monkeypatch):
    """With TABLELESS_MIN_N lowered to the SRS's size, the SRS builds no
    window tables and a commitment (``SRS.commit``, ``msm_many`` with
    tables None) equals the host MSM, as the tabled one does."""
    s = srs.setup(K, "cpu", cache_dir=None)
    s.warm_tables()
    assert s._msm_tables is not None
    monkeypatch.setattr(MSM, "TABLELESS_MIN_N", s.n)
    bare = srs.setup(K, "cpu", cache_dir=None)
    bare.warm_tables()
    assert bare._msm_tables is None
    rng = np.random.default_rng(29)
    polys = [_t(_rand(rng, s.n)) for _ in range(3)]
    points = keygen._srs_host_points(bare)
    want = [CV.host_msm(points, FR.decode(p)) for p in polys]
    assert [CV.to_affine_host(bare.commit(p))[0] for p in polys] == want
    assert [CV.to_affine_host(s.commit(p))[0] for p in polys] == want
    flat = F.from_mont(FR, torch.cat(polys))
    c = MSM.default_window(s.n)
    assert CV.to_affine_host(MSM.msm_many((bare.g1_x, bare.g1_y), flat, 3, c,
                                          None)) == want


@pytest.mark.parametrize("name", ["toy", "tagged", "toy_gwc"])
def test_tableless_forced_prove_equals_golden(name, monkeypatch):
    """Golden proofs with the tableless commitments forced (and the
    sliced path): the same bytes."""
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    monkeypatch.setattr(MSM, "TABLELESS_MIN_N", 1 << K)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    pk = keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None))
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]
