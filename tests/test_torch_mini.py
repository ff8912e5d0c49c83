"""Mini-AES (models/aes_mini.py) of the port against the reference, bit
for bit: the GF(2^4) tables, ``build_mini_table``, ``compile_mini_circuit``
(fixed columns, witness map, copy pairs, constraint system bytes) and the
witness engine (``expand_key_mini``, ``block_pool_mini``,
``build_pool_mini``) on seeded keys and plaintexts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.models import aes_mini as REF
from halo2_aes_tpu_torch.circuit import ir
from halo2_aes_tpu_torch.models import aes128
from halo2_aes_tpu_torch.models import aes_mini as MINI

torch.set_num_threads(1)


def test_gf16_tables_equal_reference():
    for name in ("S_BOX4", "MUL2_4", "MUL3_4", "RCON4"):
        assert np.array_equal(getattr(MINI, name), getattr(REF, name)), name
    assert MINI.MINI_TABLE_ROWS == REF.MINI_TABLE_ROWS == 321
    assert sorted(MINI.S_BOX4.tolist()) == list(range(16))
    for tab in (MINI.MUL2_4, MINI.MUL3_4):
        for a in range(16):
            for b in range(16):
                assert tab[a ^ b] == tab[a] ^ tab[b]


@pytest.mark.parametrize("n", [321, 1 << 9, 1 << 11])
def test_mini_table_equals_reference(n):
    t = MINI.build_mini_table(n)
    assert t.dtype == np.uint32 and np.array_equal(t, REF.build_mini_table(n))
    assert all(int(t[c, 320]) == 0 for c in range(4))
    a, b = 5, 12
    row = 32 + a * 16 + b
    assert (int(t[1, row]), int(t[2, row]), int(t[3, row])) == (a, b, a ^ b)


@pytest.mark.parametrize("cfg", [dict(k=11, n_sets=2, n_blocks=2),
                                 dict(k=11, n_sets=2, n_blocks=1),
                                 dict(k=12, n_sets=3, n_blocks=5)],
                         ids=["k11_2x2", "k11_2x1", "k12_3x5"])
def test_compile_mini_circuit_equals_reference(cfg):
    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**cfg))
    ref = REF.compile_mini_circuit(REF.MiniAesConfig(**cfg))
    assert layout.k == ref.k and layout.pool_len == ref.pool_len
    assert np.array_equal(layout.fixed, ref.fixed)
    assert np.array_equal(layout.witness_map, ref.witness_map)
    assert np.array_equal(layout.copy_pairs, ref.copy_pairs)
    assert ir.cs_bytes(layout.cs) == ref_ir.cs_bytes(ref.cs)
    assert layout.meta["pruned_lookups"] == ref.meta["pruned_lookups"]
    assert layout.meta["placements"] == ref.meta["placements"]


def test_mini_capacity_errors():
    with pytest.raises(aes128.CapacityError):
        MINI.compile_mini_circuit(MINI.MiniAesConfig(k=8, n_sets=1, n_blocks=1))
    with pytest.raises(aes128.CapacityError):
        MINI.compile_mini_circuit(MINI.MiniAesConfig(k=11, n_sets=1, n_blocks=9))


@pytest.mark.parametrize("seed,blocks", [(4, 2), (9, 1), (11, 7)])
def test_witness_engine_equals_reference(seed, blocks):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 16, 16, dtype=np.uint8)
    pts = rng.integers(0, 16, (blocks, 16), dtype=np.uint8)
    ks_pool, rks = MINI.expand_key_mini(torch.as_tensor(key))
    ref_ks, ref_rks = REF.expand_key_mini(jnp.asarray(key))
    assert np.array_equal(ks_pool.numpy(), np.asarray(ref_ks))
    assert np.array_equal(rks.numpy(), np.asarray(ref_rks))
    one = MINI.block_pool_mini(torch.as_tensor(pts[0]), rks)
    assert np.array_equal(one.numpy(), np.asarray(
        REF.block_pool_mini(jnp.asarray(pts[0]), ref_rks)))
    batch = MINI.block_pool_mini_batch(torch.as_tensor(pts), rks)
    assert np.array_equal(batch.numpy(), np.asarray(
        REF.block_pool_mini_batch(jnp.asarray(pts), ref_rks)))
    pool = MINI.build_pool_mini(torch.as_tensor(key), torch.as_tensor(pts))
    assert np.array_equal(pool.numpy(), np.asarray(
        REF.build_pool_mini(jnp.asarray(key), jnp.asarray(pts))))
    assert int(pool.max()) < 16


def _golden_mini():
    import json
    import pathlib

    return json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "halo2_aes_tpu_torch" / "testdata"
                       / "golden_mini_k11.json").read_text())


def test_golden_mini_entry_matches_the_layout():
    """The committed mini-AES golden proof (made by the reference) has the
    configuration the port builds and the cost model's length."""
    from halo2_aes_tpu_torch.circuit.toys import MINI_CONFIG, MINI_PROVE_SEED
    from halo2_aes_tpu_torch.utils import cost_model

    golden = _golden_mini()
    assert {k: golden[k] for k in MINI_CONFIG} == MINI_CONFIG
    assert golden["mini"]["seed"] == MINI_PROVE_SEED
    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**MINI_CONFIG))
    assert len(golden["mini"]["proof"]) // 2 == cost_model.estimate(layout).proof_bytes


@pytest.mark.slow
def test_mini_prove_equals_golden():
    """The port's k=11 mini-AES proof equals the reference's bytes and
    both verifiers accept it (minutes on the CPU; the chip smoke runs the
    same check on the card)."""
    from halo2_aes_tpu.backend import keygen as ref_keygen
    from halo2_aes_tpu.backend import srs as ref_srs
    from halo2_aes_tpu.backend import verifier as ref_verifier
    from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.circuit.toys import (MINI_CONFIG, MINI_PROVE_SEED,
                                                  mini_inputs)

    golden = _golden_mini()["mini"]
    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**MINI_CONFIG))
    key, pts = (torch.as_tensor(a) for a in mini_inputs())
    values = witness.assemble_values(layout, MINI.build_pool_mini(key, pts))
    pk = keygen.keygen(layout, srs.setup(MINI_CONFIG["k"], "cpu", cache_dir=None))
    assert hex(pk.vk.digest) == golden["vk_digest"]
    proof = prover.prove(pk, values, seed=MINI_PROVE_SEED)
    assert proof.hex() == golden["proof"]
    assert verifier.verify(pk.vk, proof)
    ref_layout = REF.compile_mini_circuit(REF.MiniAesConfig(**MINI_CONFIG))
    ref_pk = ref_keygen.keygen(ref_layout, ref_srs.setup(MINI_CONFIG["k"],
                                                         cache_dir=None))
    assert ref_verifier.verify(ref_pk.vk, proof)
