"""The reference against the port on the CPU: its pieces (AES, layout,
blinding stream, permutation, field) equal the port's, and its judgement
of whole proofs of the K=6 toy circuits is exact and fails on one
flipped byte anywhere."""

import numpy as np
import pytest
import torch

from benchmark.reference import aes as RAES
from benchmark.reference import check as RC
from benchmark.reference import field as RF
from benchmark.reference.frozen import aes128 as RA
from benchmark.reference.frozen import ir as RIR

TOYS = ["toy_circuit", "tagged_toy_circuit", "onecol_circuit", "onecol_lookup_circuit"]


@pytest.fixture(scope="module")
def proofs():
    """{toy: (reference layout and values, port pk, proof)}, seed 1234."""
    from halo2_aes_tpu_torch.backend import keygen, prover, srs
    from halo2_aes_tpu_torch.circuit import toys

    out = {}
    for name in TOYS:
        layout, values = getattr(toys, name)()
        pk = keygen.keygen(layout, srs.setup(layout.k, "cpu", cache_dir=None))
        out[name] = (getattr(toys, name)(ir=RIR), pk,
                     prover.prove(pk, values, seed=1234))
    return out


@pytest.mark.parametrize("name", TOYS)
def test_reference_writes_the_port_proof(proofs, name):
    (rlayout, rvalues), pk, proof = proofs[name]
    ref = RC.Reference(rlayout, "cpu")
    assert ref.digest == pk.vk.digest
    r = ref.check(rvalues, 1234, proof)
    assert r == {"points_mismatched": 0, "scalars_mismatched": 0,
                 "quotient_mismatched": 0, "extra_bytes": 0, "first_mismatch": None}


@pytest.mark.parametrize("name", TOYS)
def test_flipped_words_are_caught(proofs, name):
    """One bit flipped in a 32-byte word of the proof: every word in turn
    for the first toy, the first, a middle and the last for the others
    (the quotient pieces are caught through their combination)."""
    (rlayout, rvalues), _, proof = proofs[name]
    ref = RC.Reference(rlayout, "cpu")
    words = len(proof) // 32
    for w in range(words) if name == TOYS[0] else (0, words // 2, words - 1):
        bad = bytearray(proof)
        bad[32 * w + 3] ^= 0x10
        r = ref.check(rvalues, 1234, bytes(bad))
        assert r["points_mismatched"] + r["scalars_mismatched"] + r["quotient_mismatched"] > 0, w


@pytest.mark.parametrize("rows,columns", [(16, 1), (24, 3)], ids=["rows16-cols1", "rows24-cols3"])
@pytest.mark.parametrize("name", TOYS)
def test_grand_products_in_passes(proofs, name, rows, columns, monkeypatch):
    """GRAND_ROWS and GRAND_COLUMNS lowered, so that the z columns take
    several groups and each group several passes (with 24 of 64 rows, a
    short last one and one across the end of the usable rows): the
    judgement is the one pass's, exact on the port's proof, and a flipped
    bit in the first, a middle, the last and every grand-product word is
    caught."""
    (rlayout, rvalues), _, proof = proofs[name]
    monkeypatch.setattr(RC, "GRAND_ROWS", rows)
    monkeypatch.setattr(RC, "GRAND_COLUMNS", columns)
    inverted = []
    real_inv = RF.batch_inv

    def batch_inv(x):
        inverted.append(tuple(x.shape[:2]))
        return real_inv(x)

    monkeypatch.setattr(RF, "batch_inv", batch_inv)
    ref = RC.Reference(rlayout, "cpu")
    inverted.clear()
    r = ref.check(rvalues, 1234, proof)
    assert r == {"points_mismatched": 0, "scalars_mismatched": 0,
                 "quotient_mismatched": 0, "extra_bytes": 0, "first_mismatch": None}
    zs = ref.chunks + ref.n_lk
    groups = [min(columns, zs - g) for g in range(0, zs, columns)]
    heights = [rows] * (ref.n // rows) + [ref.n % rows] * (ref.n % rows > 0)
    assert zs > 0 and len(heights) > 1
    assert sorted(x for x in inverted if x[1] <= rows) == sorted(
        (g, h) for g in groups for h in heights)
    first_z = len(ref.adv_ids) + 2 * ref.n_lk
    words = len(proof) // 32
    for w in sorted({0, words // 2, words - 1, *range(first_z, first_z + zs)}):
        bad = bytearray(proof)
        bad[32 * w + 3] ^= 0x10
        r = ref.check(rvalues, 1234, bytes(bad))
        assert r["points_mismatched"] + r["scalars_mismatched"] + r["quotient_mismatched"] > 0, w


@pytest.mark.parametrize("rows,columns", [(None, None), (24, 2)], ids=["one-pass", "rows24-cols2"])
def test_chained_permutation_chunks(rows, columns, monkeypatch):
    """The toy circuit with one permutation column a chunk on both sides
    (three chunks, each z starting where the last one ended, and a
    lookup): the port's proof verifies and the reference writes it, in
    one pass and with the chunks split across groups of passes; a
    flipped bit in any grand-product word is caught."""
    from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
    from halo2_aes_tpu_torch.circuit import ir as PIR
    from halo2_aes_tpu_torch.circuit import toys

    for ir in (PIR, RIR):
        monkeypatch.setattr(ir.ConstraintSystem, "permutation_chunk_len", lambda self: 1)
    if rows is not None:
        monkeypatch.setattr(RC, "GRAND_ROWS", rows)
        monkeypatch.setattr(RC, "GRAND_COLUMNS", columns)
    layout, values = toys.toy_circuit()
    pk = keygen.keygen(layout, srs.setup(layout.k, "cpu", cache_dir=None))
    proof = prover.prove(pk, values, seed=4321)
    verifier.verify(pk.vk, proof)
    rlayout, rvalues = toys.toy_circuit(ir=RIR)
    ref = RC.Reference(rlayout, "cpu")
    assert ref.chunks == 3 and ref.digest == pk.vk.digest
    assert ref.check(rvalues, 4321, proof) == {
        "points_mismatched": 0, "scalars_mismatched": 0, "quotient_mismatched": 0,
        "extra_bytes": 0, "first_mismatch": None}
    first_z = len(ref.adv_ids) + 2 * ref.n_lk
    for w in range(first_z, first_z + ref.chunks + ref.n_lk):
        bad = bytearray(proof)
        bad[32 * w + 3] ^= 0x10
        assert ref.check(rvalues, 4321, bytes(bad))["points_mismatched"] > 0, w


def test_wrong_blinding_seed_or_witness_fails(proofs):
    (rlayout, rvalues), _, proof = proofs["toy_circuit"]
    ref = RC.Reference(rlayout, "cpu")
    assert ref.check(rvalues, 1235, proof)["points_mismatched"] > 0
    other = np.array(rvalues, dtype=np.int64)
    other[4, 0] = (other[4, 0] + 1) % 32          # a lookup input, a0 row 0
    other[5, 0] = 7 * other[4, 0] % 256
    assert ref.check(other, 1234, proof)["points_mismatched"] > 0


def test_blinding_stream_equals_the_port():
    from halo2_aes_tpu_torch.backend import prover

    for shape in [(3, 6), (5,), (1, 0)]:
        a = RC.rand_field(np.random.default_rng(99), *shape)
        b = prover._rand_field(np.random.default_rng(99), *shape)
        assert (a == b.astype(np.int64)).all()


def test_aes_equals_fips_and_the_port():
    from halo2_aes_tpu_torch.circuit import witness

    key = np.arange(16, dtype=np.uint8)
    pt = np.array([0x00, 0x11, 0x22, 0x33, 0x44, 0x55, 0x66, 0x77, 0x88, 0x99, 0xAA,
                   0xBB, 0xCC, 0xDD, 0xEE, 0xFF], np.uint8)
    ct = RAES.encrypt(pt[None], key)[0].astype(np.uint8)
    assert bytes(ct).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    rng = np.random.default_rng(5)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (7, 16), dtype=np.uint8)
    port = witness.build_pool(torch.as_tensor(key), torch.as_tensor(pts)).numpy()
    assert (RAES.pool(key, pts) == port).all()


@pytest.mark.parametrize("tagged_ops", [False, True], ids=["upstream", "tagged"])
def test_layout_and_permutation_equal_the_port(tagged_ops):
    """The frozen layout at k=17 / 4 sets / 384 blocks, in upstream's
    layout and the port's tagged one, and the reference's own
    permutation cycles, against the port's."""
    from halo2_aes_tpu_torch.backend import permutation
    from halo2_aes_tpu_torch.circuit.ir import cs_bytes
    from halo2_aes_tpu_torch.models import aes128

    cfg = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=tagged_ops)
    mine = RA.compile_circuit(RA.AesConfig(**cfg))
    port = aes128.compile_circuit(aes128.AesConfig(**cfg))
    assert (mine.fixed == port.fixed).all()
    assert (mine.witness_map == port.witness_map).all()
    assert (mine.copy_pairs == port.copy_pairs).all()
    assert RIR.cs_bytes(mine.cs) == cs_bytes(port.cs)
    mc, mr = RC.build_assembly(mine.cs.perm_columns, mine.n, mine.copy_pairs)
    asm = permutation.build_assembly(port.cs.perm_columns, port.n, port.copy_pairs)
    assert (mc == asm.map_col).all() and (mr == asm.map_row).all()


def test_field_ops_against_python_ints():
    rng = np.random.default_rng(3)
    xs = [int(v) for v in rng.integers(0, 1 << 62, 64)] + [0, 1, RF.P - 1]
    xs = [x * x * x % RF.P for x in xs]
    ys = xs[::-1]
    a, b = RF.mont(xs, "cpu"), RF.mont(ys, "cpu")
    assert RF.decode(RF.mul(a, b)) == [x * y % RF.P for x, y in zip(xs, ys)]
    assert RF.decode(RF.add(a, b)) == [(x + y) % RF.P for x, y in zip(xs, ys)]
    assert RF.decode(RF.sub(a, b)) == [(x - y) % RF.P for x, y in zip(xs, ys)]
    nz = [x or 5 for x in xs] * 4
    inv = RF.decode(RF.batch_inv(RF.mont(nz, "cpu").reshape(2, -1, 16)))
    assert inv == [pow(x, -1, RF.P) for x in nz]
    scan = RF.decode(RF.scan(RF.mont(nz, "cpu")[None]))
    acc, want = 1, []
    for x in nz:
        acc = acc * x % RF.P
        want.append(acc)
    assert scan == want


@pytest.mark.chip
def test_reference_writes_the_flagship_proof_on_the_card(card):
    """The port's k=17 / 4 sets / 384 blocks proof in upstream's layout
    on the card, judged exact; with one plaintext bit flipped under it,
    judged wrong."""
    from halo2_aes_tpu_torch.backend import keygen, prover, srs
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models import aes128

    cfg = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=False)
    layout = aes128.compile_circuit(aes128.AesConfig(**cfg))
    pk = keygen.keygen(layout, srs.setup(17, card, cache_dir=None))
    rng = np.random.default_rng(8)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (384, 16), dtype=np.uint8)
    values = witness.assemble_values(layout, witness.build_pool(
        torch.as_tensor(key, device=card), torch.as_tensor(pts, device=card)))
    proof = prover.prove(pk, values, seed=77)
    rl = RA.compile_circuit(RA.AesConfig(**cfg))
    ref = RC.Reference(rl, card)
    wm = rl.witness_map
    pool = RAES.pool(key, pts)
    rv = np.where(wm >= 0, pool[np.maximum(wm, 0)], 0) + rl.fixed.astype(np.int64)
    assert ref.check(rv, 77, proof)["points_mismatched"] == 0
    pts[-1, 0] ^= 1
    pool = RAES.pool(key, pts)
    rv = np.where(wm >= 0, pool[np.maximum(wm, 0)], 0) + rl.fixed.astype(np.int64)
    assert ref.check(rv, 77, proof)["points_mismatched"] > 0
