"""K4's term program (``backend/term_program.py``) against the eager fold.

The constraint terms lowered to one program a proving key, run by K4's
plain version (``ops/cuda_quotient.quotient_terms_plain``, what the
kernel runs on the card), equal ``quotient_subcoset_eager`` bit for bit
on every golden K=6 circuit, the k=11 mini-AES circuit and a toy with
four permutation chunks, over a whole sub-coset and over row ranges
that do not start at row 0; rotations -1, +1 and ``usable`` wrap at
rows 0 and n - 1; the program's product count is a counting walk of
``constraint_terms``; and the CPU prove runs the program.
"""

import types

import numpy as np
import pytest
import torch

from halo2_aes_tpu_torch.backend import keygen, prover, rest, srs
from halo2_aes_tpu_torch.backend import protocol as PROTO
from halo2_aes_tpu_torch.circuit import ir
from halo2_aes_tpu_torch.circuit.toys import K, MINI_CONFIG, TOYS
from halo2_aes_tpu_torch.models import aes_mini
from halo2_aes_tpu_torch.ops import cuda_quotient as CQ
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import timers

torch.set_num_threads(1)
FR = F.FR


def chunked_toy():
    """Four advice columns under copy constraints and a degree-3 gate:
    permutation chunks of one column, so four chunks and three links."""
    n = 1 << K
    cs = ir.ConstraintSystem()
    q = cs.fixed_column("q")
    adv = [cs.advice_column(f"a{i}") for i in range(4)]
    cs.create_gate("cube", ir.Prod(ir.Ref(q), ir.Prod(
        ir.Sum(ir.Ref(adv[0], 1), ir.Neg(ir.Ref(adv[1], -1))),
        ir.Sum(ir.Ref(adv[2]), ir.Sum(ir.Ref(adv[3]), ir.Const(5))))))
    for c in adv:
        cs.enable_equality(c)
    layout = ir.CompiledCircuit(
        k=K, cs=cs, fixed=np.zeros((5, n), np.uint32),
        witness_map=np.full((5, n), -1, np.int32),
        copy_pairs=np.array([[adv[0], 1, adv[3], 2]], np.int32), pool_len=0)
    return layout


def _phases_without_keys(layout):
    """_Phases over ``layout`` with the vk fields the quotient reads and no
    commitments (keygen of the k=11 circuit takes minutes on the CPU)."""
    cs = layout.cs
    vk = types.SimpleNamespace(
        cs=cs, k=layout.k, usable=layout.usable_rows,
        ext_k=layout.k + max(1, (cs.degree() - 2).bit_length()))
    return prover._Phases(types.SimpleNamespace(vk=vk, layout=layout,
                                                device=torch.device("cpu")))


@pytest.fixture(scope="module")
def kzg_srs():
    return srs.setup(K, "cpu", cache_dir=None)


CIRCUITS = [*TOYS, "chunked", "mini"]


@pytest.fixture(scope="module", params=CIRCUITS)
def phases(request, kzg_srs):
    name = request.param
    if name == "chunked":
        return _phases_without_keys(chunked_toy())
    if name == "mini":
        return _phases_without_keys(aes_mini.compile_mini_circuit(
            aes_mini.MiniAesConfig(**MINI_CONFIG)))
    return prover._get_phases(keygen.keygen(TOYS[name][0]()[0], kzg_srs))


def _inputs(ph, s: int, seed: int):
    """Random canonical stacks and challenges of sub-coset s."""
    rng = np.random.default_rng(seed)

    def rand(rows):
        return F.limbs(FR.encode(rng.integers(1, 2**62, rows, dtype=np.int64)
                                 .tolist()), "cpu")

    shift, zh_inv = prover._subcoset_tables(ph.k, ph.ext_k, s, "cpu")
    return (rand(len(ph.q_static_keys) * ph.n), rand(len(ph.q_dyn_keys) * ph.n),
            *(F.encode(FR, v, "cpu") for v in rng.integers(2, 2**62, 4).tolist()),
            shift, zh_inv)


def _equal(*tensors):
    return all(torch.equal(tensors[0], t) for t in tensors[1:])


def test_program_equals_eager_fold(phases):
    ph = phases
    args = _inputs(ph, 1, seed=ph.n + len(ph.q_dyn_keys))
    assert _equal(ph.quotient_subcoset(*args), ph.quotient_subcoset_eager(*args))


@pytest.mark.parametrize("chunks", [2, 3])
def test_program_row_chunks_equal_eager_fold(phases, chunks):
    """K4's plain version launched once a row chunk (rows from a first
    row that is not 0) equals the eager fold over the whole sub-coset."""
    ph = phases
    static, dyn, theta, beta, gamma, y, shift, zh_inv = args = _inputs(
        ph, ph.ratio - 1, seed=7)
    table = ph.terms_table(theta, beta, gamma, y, shift, zh_inv)
    omega = ph.dom.omega_powers("cpu")
    out = torch.empty((ph.n, F.LIMBS), dtype=torch.int32)
    for c in range(chunks):
        lo, hi = c * ph.n // chunks, (c + 1) * ph.n // chunks
        CQ.quotient_terms(ph._terms_code, ph.terms.slots, table, static, dyn,
                          omega, lo, out[lo:hi])
    assert _equal(out, ph.quotient_subcoset_eager(*args))


def test_rotations_wrap_at_the_ends(phases):
    """Rows 0 and n - 1 alone (a launch of one row) read their rotated
    neighbours across the ends: equal to the eager fold's rows."""
    ph = phases
    static, dyn, theta, beta, gamma, y, shift, zh_inv = _inputs(ph, 0, seed=11)
    whole = ph.quotient_subcoset_eager(static, dyn, theta, beta, gamma, y, shift,
                                       zh_inv)
    table = ph.terms_table(theta, beta, gamma, y, shift, zh_inv)
    omega = ph.dom.omega_powers("cpu")
    for row in (0, ph.n - 1):
        got = CQ.quotient_terms_plain(ph._terms_code, table, static, dyn, omega,
                                      row, 1)
        assert torch.equal(got[0], whole[row])
    loads = ph.terms.code[ph.terms.code[:, 0] == CQ.LOAD]
    want = {0}
    if ph.cs.lookups:
        want |= {1, ph.n - 1}              # z at +1, A' at -1
    if ph.chunks > 1:
        want.add(ph.usable)                # the perm chunks' links
    assert want <= set(loads[:, 3].tolist())


class _Count:
    """Counting algebra: each op a count, values carry nothing."""

    def __init__(self):
        self.muls = 0

    def const(self, v):
        return 0

    def add(self, a, b):
        return 0

    def neg(self, a):
        return 0

    def mul(self, a, b):
        self.muls += 1
        return 0


def test_muls_count_the_terms_as_stated(phases):
    ph = phases
    alg = _Count()
    ctx = PROTO.Context()
    ctx.__dict__.update(
        alg=alg, one=0, theta=0, beta=0, gamma=0, l0=0, l_last=0, l_active=0,
        column=lambda c, r: 0, perm_z=lambda t, r: 0, sigma=lambda i: 0,
        perm_id=lambda i: 0, lookup_z=lambda i, r: 0, lookup_a=lambda i, r: 0,
        lookup_s=lambda i: 0)
    terms = sum(1 for _ in PROTO.constraint_terms(ph.cs, ctx))
    assert ph.terms.terms == terms
    # each term past the first: one Horner product; then the Z_H division
    assert ph.terms.muls == alg.muls + terms - 1 + 1
    loads = ph.terms.code[ph.terms.code[:, 0] == CQ.LOAD]
    assert ph.terms.polys == len(set(loads[:, 2].tolist()))
    assert ph.terms.polys <= len(ph.q_static_keys) + len(ph.q_dyn_keys)


def test_slots_and_table_fit_a_block(phases):
    ph = phases
    code = ph.terms.code
    written = code[np.isin(code[:, 0], [CQ.FIRST, CQ.FOLD], invert=True), 1]
    assert written.max() < ph.terms.slots
    table_rows = CQ.TABLE_FIXED + len(ph.cs.perm_columns) + len(ph.terms.consts)
    operands = code[:, 2:][np.isin(code[:, 0], [CQ.LOAD, CQ.OMEGA], invert=True)]
    assert (~operands[operands < 0]).max(initial=0) < table_rows
    assert CQ.threads_for(table_rows, ph.terms.slots) == CQ.THREADS


def test_aes_cell_program():
    """The benchmark cell's circuit (AES-128, 4 sets, upstream's layout;
    the same constraint system at k=17 as at k=20): 97 terms, 481
    products as stated, and a program that needs few slots."""
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    layout = compile_circuit(AesConfig(k=17, n_sets=4, n_blocks=384))
    cs = layout.cs
    chunks = -(-len(cs.perm_columns) // cs.permutation_chunk_len())
    assert (len(cs.gates), len(cs.lookups), len(cs.perm_columns), chunks) == (1, 17, 14, 5)
    ph = _phases_without_keys(layout)
    assert (ph.terms.terms, ph.terms.muls) == (97, 481)
    assert ph.terms.slots <= 8


@pytest.mark.parametrize("host_rest", [False, True])
def test_cpu_prove_runs_the_term_program(kzg_srs, monkeypatch, host_rest):
    """On the CPU the prover runs the term program through K4's plain
    version, once a whole sub-coset, and never the eager fold; its
    quotient.terms spans say fused 0, with the work the constraint
    system asks.  So it does with the k >= 19 and k >= 23 switches
    lowered to K (the sliced path with host rest), where the term
    program runs in no row chunks."""
    if host_rest:
        monkeypatch.setattr(rest, "HOST_REST_MIN_K", K)
        monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    build, seed, _ = TOYS["toy"]
    layout, values = build()
    pk = keygen.keygen(layout, kzg_srs)
    ph = prover._get_phases(pk)
    assert (ph.host_rest(), ph.large()) == (host_rest, host_rest)
    plain = CQ.quotient_terms_plain
    launches = []

    def counted(code, table, static, dyn, omega, row0, rows):
        launches.append((row0, rows))
        return plain(code, table, static, dyn, omega, row0, rows)

    def refuse(*args, **kwargs):
        raise AssertionError("the eager fold ran on the CPU prove path")

    monkeypatch.setattr(CQ, "quotient_terms_plain", counted)
    monkeypatch.setattr(prover._Phases, "quotient_subcoset_eager", refuse)
    timers.clear()
    try:
        with timers.recording():
            prover.prove(pk, values, seed=seed)
        spans = [r for r in timers.spans() if r.name == "quotient.terms"]
    finally:
        timers.clear()
    assert launches == [(0, ph.n)] * ph.ratio
    assert len(spans) == ph.ratio
    for r in spans:
        assert r.attrs == {"terms": ph.terms.terms, "fused": 0,
                           "muls": ph.terms.muls, "polys": ph.terms.polys,
                           "rows": ph.n}
