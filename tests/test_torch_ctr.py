"""The port's AES-128-CTR layer against the reference: counter blocks,
the NIST SP 800-38A F.5.1 keystream out of the port's AES, and the
bundle's per-proof instance split."""

import numpy as np
import pytest
import torch

from halo2_aes_tpu import ctr as ref_ctr
from halo2_aes_tpu_torch import ctr
from halo2_aes_tpu_torch.ops import aes

torch.set_num_threads(1)

KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")


def _encrypt(blocks, key):
    return aes.encrypt(torch.as_tensor(blocks),
                       torch.as_tensor(np.frombuffer(key, np.uint8).copy())
                       ).numpy().astype(np.uint8)


@pytest.mark.parametrize("start,count", [(0, 5), (0xFFFFFFFE, 2),
                                         (0xFCFDFEFF, 4), (123456, 384)])
def test_counter_blocks_equal_reference(start, count):
    nonce = bytes(range(12))
    blocks = ctr.counter_blocks(nonce, start, count)
    assert blocks.dtype == np.uint8 and blocks.shape == (count, 16)
    assert np.array_equal(blocks, ref_ctr.counter_blocks(nonce, start, count))


def test_counter_blocks_reject_bad_arguments():
    with pytest.raises(ValueError):
        ctr.counter_blocks(bytes(12), 0xFFFFFFFF, 2)       # counter overflow
    with pytest.raises(ValueError):
        ctr.counter_blocks(b"short", 0, 1)


def test_nist_sp800_38a_ctr_vectors():
    """F.5.1 CTR-AES128.Encrypt: nonce f0..fb, 32-bit counter from
    0xfcfdfeff, the keystream from the port's AES."""
    nonce = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafb")
    pt = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a"
        "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef"
        "f69f2445df4f9b17ad2b417be66c3710")
    expect = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce"
        "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab"
        "1e031dda2fbe03d1792170a0f3009cee")
    ks = _encrypt(ctr.counter_blocks(nonce, 0xFCFDFEFF, 4), KEY)
    bundle = ctr.CtrBundle(nonce=nonce, start=0xFCFDFEFF, n_blocks=4,
                           blocks_per_proof=4, keystream=ks)
    assert ctr.xor_keystream(bundle, pt) == expect
    assert ctr.xor_keystream(bundle, expect) == pt
    with pytest.raises(ValueError):
        ctr.xor_keystream(bundle, pt + b"x")


def test_bundle_instances_split():
    ks = np.arange(4 * 16, dtype=np.uint8).reshape(4, 16)
    kw = dict(nonce=bytes(12), start=0, n_blocks=3, blocks_per_proof=2,
              keystream=ks)
    inst = ctr.CtrBundle(**kw).instances()
    assert len(inst) == 2 and len(inst[0]) == 32
    assert inst[1][0] == 32                 # the second proof starts at byte 32
    assert inst == ref_ctr.CtrBundle(**kw).instances()


def test_prove_keystream_needs_exposed_layout():
    from halo2_aes_tpu_torch.backend import keygen, srs
    from halo2_aes_tpu_torch.circuit.toys import K, toy_circuit

    layout, _ = toy_circuit()
    pk = keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None))
    with pytest.raises(ValueError):
        ctr.prove_keystream(pk, np.frombuffer(KEY, np.uint8), bytes(12), 1)


@pytest.mark.slow
def test_ctr_bundle_prove_verify_k17():
    """3 keystream blocks at blocks_per_proof=2 -> 2 proofs, ONE pairing
    check for the bundle, and a changed keystream byte fails (hours on a
    CPU; the chip smoke runs this at full width on the card)."""
    from halo2_aes_tpu_torch.backend import keygen, srs
    from halo2_aes_tpu_torch.backend.verifier import VerifyError
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    layout = compile_circuit(AesConfig(k=17, n_sets=1, n_blocks=2,
                                       expose_ciphertext=True))
    pk = keygen.keygen(layout, srs.setup(17, "cpu", cache_dir=None))
    nonce = bytes(range(12))
    bundle = ctr.prove_keystream(pk, np.frombuffer(KEY, np.uint8), nonce, 3)
    assert len(bundle.proofs) == 2 and bundle.keystream.shape == (4, 16)
    assert np.array_equal(bundle.keystream,
                          _encrypt(ctr.counter_blocks(nonce, 0, 4), KEY))
    assert ctr.verify_bundle(pk.vk, bundle)
    bundle.keystream[0, 0] ^= 1
    with pytest.raises(VerifyError):
        ctr.verify_bundle(pk.vk, bundle)
