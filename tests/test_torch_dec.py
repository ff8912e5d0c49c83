"""The port's AES-128 decryption path against the reference: the host
circuit compiler at full capacity (k=17, 4 sets, 384 blocks) with and
without the exposed plaintext, the batched inverse-cipher witness, and
the FIPS-197 decryption vector."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.circuit import witness as ref_witness
from halo2_aes_tpu.models import aes128_dec as ref_dec
from halo2_aes_tpu.ops import aes as ref_aes
from halo2_aes_tpu_torch.circuit import ir, witness
from halo2_aes_tpu_torch.models import aes128_dec as dec
from halo2_aes_tpu_torch.ops import aes

torch.set_num_threads(1)

FULL = dict(k=17, n_sets=4, n_blocks=384)
KEY = np.frombuffer(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), np.uint8)
PT = np.frombuffer(bytes.fromhex("3243f6a8885a308d313198a2e0370734"), np.uint8)
CT = np.frombuffer(bytes.fromhex("3925841d02dc09fbdc118597196a0b32"), np.uint8)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.uint8))


def _inputs(seed=3, blocks=FULL["n_blocks"]):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    cts = aes.encrypt(_t(pts), _t(key)).numpy().astype(np.uint8)
    return key, pts, cts


def test_full_capacity_is_384_blocks():
    cfg = dec.AesDecConfig(**FULL)
    assert sum(dec.capacities(cfg, dec.configure(cfg)[0])) == FULL["n_blocks"]


@pytest.fixture(scope="module", params=[False, True], ids=["hidden", "exposed"])
def layouts(request):
    cfg = dict(FULL, expose_plaintext=request.param)
    return (dec.compile_circuit(dec.AesDecConfig(**cfg)),
            ref_dec.compile_circuit(ref_dec.AesDecConfig(**cfg)))


@pytest.mark.parametrize("field", ["fixed", "witness_map", "copy_pairs"])
def test_dec_layout_arrays_equal(layouts, field):
    port, ref = layouts
    assert np.array_equal(getattr(port, field), getattr(ref, field))


def test_dec_constraint_system_bytes_equal(layouts):
    port, ref = layouts
    assert ir.cs_bytes(port.cs) == ref_ir.cs_bytes(ref.cs)
    assert port.usable_rows == ref.usable_rows
    assert port.pool_len == ref.pool_len
    assert port.meta["pruned_lookups"] == ref.meta["pruned_lookups"]


def test_dec_pool_and_values_equal_reference(layouts):
    port, ref = layouts
    key, pts, cts = _inputs()
    pool = witness.build_dec_pool(_t(key), _t(cts))
    ref_pool = ref_witness.build_dec_pool(jnp.asarray(key), jnp.asarray(cts))
    assert np.array_equal(pool.numpy(), np.asarray(ref_pool).astype(np.int64))
    values = witness.assemble_values(port, pool)
    ref_values = ref_witness.assemble_values(ref, ref_pool)
    assert np.array_equal(values.numpy().astype(np.uint32), np.asarray(ref_values))
    # the recovered plaintext sits in each block's last 16 rows of a2,
    # and in the instance column when it is exposed
    cols = port.meta["columns"]
    base = int(port.meta["block_starts"][0])
    a2 = cols.chip_sets[0].advice[2]
    assert bytes(values[a2, base + 1344:base + 1360].numpy().astype(np.uint8)) \
        == bytes(pts[0])
    if cols.instance is not None:
        assert np.array_equal(values[cols.instance, :16 * len(pts)].numpy(),
                              pts.reshape(-1))


def test_decrypt_fips197_vector():
    assert bytes(aes.decrypt(_t(CT[None]), _t(KEY))[0].tolist()) == bytes(PT)


def test_decrypt_inverts_encrypt_and_matches_reference():
    key, pts, cts = _inputs(seed=7, blocks=64)
    assert np.array_equal(aes.decrypt(_t(cts), _t(key)).numpy(), pts)
    assert np.array_equal(cts, np.asarray(ref_aes.encrypt(pts, key)))
    edge = np.full((1, 16), 255, np.uint8)        # every byte 0xFF
    _, rks = aes.expand_key(_t(KEY))
    ref_rks = ref_aes.expand_key(jnp.asarray(KEY))[1]
    assert np.array_equal(
        aes.dec_block_pool_batch(_t(edge), rks).numpy(),
        np.asarray(ref_aes.dec_block_pool_batch(jnp.asarray(edge), ref_rks)))


def test_ctr_blocks_equal_reference():
    for nonce, count in ((0, 3), (0x0123456789ABCDEF, 5)):
        assert np.array_equal(aes.ctr_blocks(nonce, count),
                              ref_aes.ctr_blocks(nonce, count))


@pytest.mark.slow
def test_dec_prove_verify_k17_reference_pk():
    """The reference's decryption pk, carried over by backend/convert.py,
    proves a full-capacity decryption in the port; the reference's
    verifier accepts it with the plaintext instances (hours on a CPU)."""
    from halo2_aes_tpu.backend import keygen as ref_keygen
    from halo2_aes_tpu.backend import srs as ref_srs
    from halo2_aes_tpu.backend import verifier as ref_verifier
    from halo2_aes_tpu_torch.backend import convert, prover

    cfg = dict(FULL, expose_plaintext=True)
    layout = dec.compile_circuit(dec.AesDecConfig(**cfg))
    ref_layout = ref_dec.compile_circuit(ref_dec.AesDecConfig(**cfg))
    rs = ref_srs.setup(17, cache_dir=None)
    ref_pk = ref_keygen.keygen(ref_layout, rs)
    vk = ref_pk.vk
    srs = convert.srs_from_numpy(17, np.asarray(rs.g1_x), np.asarray(rs.g1_y),
                                 rs.g2, rs.s_g2, "cpu", g1_extra=rs.g1_extra)
    pk = convert.pk_from_numpy(
        layout, srs, ext_k=vk.ext_k, usable=vk.usable, fixed_ids=vk.fixed_ids,
        fixed_commitments=vk.fixed_commitments,
        sigma_commitments=vk.sigma_commitments,
        fixed_coeffs={c: np.asarray(v) for c, v in ref_pk.fixed_coeffs.items()},
        sigma_coeffs=np.asarray(ref_pk.sigma_coeffs),
        perm_maps=tuple(np.asarray(m) for m in ref_pk.perm_maps),
        l0=np.asarray(ref_pk.l0_coeffs), l_last=np.asarray(ref_pk.l_last_coeffs),
        l_active=np.asarray(ref_pk.l_active_coeffs))
    key, pts, cts = _inputs()
    values = witness.assemble_values(layout, witness.build_dec_pool(_t(key), _t(cts)))
    proof = prover.prove(pk, values)
    assert ref_verifier.verify(vk, proof, instances=[[int(v) for v in pts.reshape(-1)]])
