"""The port's AES witness (trace pool + assembled column matrix) equals
the reference's at the flagship configuration, and the trace matches
the FIPS-197 AES-128 vector."""

import jax.numpy as jnp
import numpy as np
import torch

from halo2_aes_tpu.circuit import witness as ref_witness
from halo2_aes_tpu.models import aes128 as ref_aes
from halo2_aes_tpu_torch.circuit import witness
from halo2_aes_tpu_torch.models import aes128
from halo2_aes_tpu_torch.ops import aes

torch.set_num_threads(1)
CFG = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=True)


def _inputs():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (CFG["n_blocks"], 16), dtype=np.uint8)
    return key, pts


def test_pool_and_values_equal_reference():
    key, pts = _inputs()
    pool = witness.build_pool(torch.as_tensor(key), torch.as_tensor(pts))
    ref_pool = ref_witness.build_pool(jnp.asarray(key), jnp.asarray(pts))
    assert np.array_equal(pool.numpy(), np.asarray(ref_pool).astype(np.int64))
    layout = aes128.compile_circuit(aes128.AesConfig(**CFG))
    ref_layout = ref_aes.compile_circuit(ref_aes.AesConfig(**CFG))
    values = witness.assemble_values(layout, pool)
    ref_values = ref_witness.assemble_values(ref_layout, ref_pool)
    assert values.dtype == torch.int32
    assert np.array_equal(values.numpy().astype(np.uint32), np.asarray(ref_values))


def test_fips197_vector():
    key = torch.as_tensor(list(bytes.fromhex("000102030405060708090a0b0c0d0e0f")),
                          dtype=torch.uint8)
    pt = torch.as_tensor([list(bytes.fromhex("00112233445566778899aabbccddeeff"))],
                         dtype=torch.uint8)
    ct = bytes(aes.encrypt(pt, key)[0].tolist())
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_sbox_index_255():
    """Byte 0xFF through the S-box (the reference fixed an upstream bug
    there): every state byte 0xFF after the first AddRoundKey."""
    key = torch.zeros(16, dtype=torch.uint8)
    pt = torch.full((1, 16), 255, dtype=torch.uint8)
    _, rks = aes.expand_key(key)
    pool = aes.block_pool_batch(pt, rks)
    ref = ref_witness.aes.block_pool(jnp.asarray(pt[0].numpy()),
                                     ref_witness.aes.expand_key(
                                         jnp.zeros(16, jnp.uint8))[1])
    assert np.array_equal(pool[0].numpy(), np.asarray(ref).astype(np.int64))
    assert int(pool[0, 32]) == 0x16          # S_BOX[0xFF]
