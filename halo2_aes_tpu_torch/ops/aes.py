"""Batched AES-128 witness engine: the port of ``ops/aes.py``.

The whole trace of every AES block, encryption or decryption, is
computed as a flat value pool with batched tensor ops on the input's
device; ``circuit/witness.py`` scatters it into columns.  Pool layouts
are the reference's (see its module docstring and ``dec_block_pool``):
a 336-byte key-schedule pool, then 1360 bytes per block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from halo2_aes_tpu_torch.models import constants as C

KS_POOL_LEN = 16 + 10 * 32
BLOCK_POOL_LEN = C.AES_BLOCK_ROWS


@functools.lru_cache(maxsize=None)
def _table(name: str, device) -> torch.Tensor:
    return torch.as_tensor(getattr(C, name).astype("int64"), device=device)


def expand_key(key):
    """AES-128 key expansion trace.

    key: uint8[16] tensor -> (ks_pool int64[336], round_keys int64[11, 16])"""
    dev = key.device
    return expand_key_with(key, _table("S_BOX", dev), _table("ROUND_CONSTANTS", dev))


def expand_key_with(key, sbox, rcon):
    """``expand_key`` over the given S-box and round-constant tables (int64
    tensors on the key's device); ``models/aes_mini.py`` passes the
    GF(2^4) ones."""
    dev = key.device
    key = key.to(torch.int64)
    rot_idx = torch.tensor([13, 14, 15, 12], device=dev)
    pool = [key]
    rks = [key]
    prev = key
    for r in range(1, 11):
        shifted = prev[rot_idx]
        subbed = sbox[shifted]
        rc_word = torch.cat([rcon[r - 1:r], torch.zeros(3, dtype=torch.int64,
                                                        device=dev)])
        rconned = subbed ^ rc_word
        w0 = prev[0:4] ^ rconned
        w1 = prev[4:8] ^ w0
        w2 = prev[8:12] ^ w1
        w3 = prev[12:16] ^ w2
        w = torch.cat([w0, w1, w2, w3])
        pool += [shifted, subbed, rc_word, rconned, w]
        rks.append(w)
        prev = w
    return torch.cat(pool), torch.stack(rks)


def block_pool(plaintext, round_keys):
    """The circuit trace of one AES-128 encryption: (16,) -> int64 (1360,)."""
    return block_pool_batch(plaintext[None], round_keys)[0]


def dec_block_pool(ciphertext, round_keys):
    """The circuit trace of one AES-128 decryption: (16,) -> int64 (1360,)."""
    return dec_block_pool_batch(ciphertext[None], round_keys)[0]


def block_pool_batch(plaintexts, round_keys):
    """Full circuit traces of a batch of AES-128 encryptions.

    plaintexts: (B, 16) uint8/int tensor; round_keys: (11, 16) ->
    int64 (B, 1360)."""
    dev = plaintexts.device
    return block_pool_batch_with(plaintexts, round_keys, _table("S_BOX", dev),
                                 _table("MUL_BY_2", dev), _table("MUL_BY_3", dev))


def block_pool_batch_with(plaintexts, round_keys, sbox, mul2, mul3):
    """``block_pool_batch`` over the given S-box and GF multiply tables."""
    dev = plaintexts.device
    shift_idx = _table("SHIFT_ROWS_IDX", dev)
    coeff = _table("MIX_MATRIX", dev)[None, None]          # (1, 1, m, j)
    pt = plaintexts.to(torch.int64)
    B = pt.shape[0]
    parts = [pt]
    state = pt ^ round_keys[0]
    parts.append(state)
    for r in range(1, 11):
        sub = sbox[state]
        parts.append(sub)
        shifted = sub[:, shift_idx]
        if r < 10:
            s = shifted.reshape(B, 4, 1, 4)                 # (B, i, 1, j)
            tmp = torch.where(coeff == 1, s,
                              torch.where(coeff == 2, mul2[s], mul3[s]))
            inter1 = tmp[..., 0] ^ tmp[..., 1]
            inter2 = tmp[..., 2] ^ tmp[..., 3]
            out = inter1 ^ inter2                           # (B, i, m)
            group = torch.cat([tmp, inter1[..., None], inter2[..., None],
                               out[..., None]], dim=-1)     # (B, i, m, 7)
            parts.append(group.reshape(B, 112))
            mixed = out.reshape(B, 16)
        else:
            mixed = shifted
        state = mixed ^ round_keys[r]
        parts.append(state)
    return torch.cat(parts, dim=1)


def dec_block_pool_batch(ciphertexts, round_keys):
    """Full circuit traces of a batch of AES-128 decryptions (the
    straightforward inverse cipher, FIPS-197 section 5.3).

    ciphertexts: (B, 16) uint8/int tensor; round_keys: (11, 16) ->
    int64 (B, 1360):
      [0:16]     ciphertext
      [16:32]    initial AddRoundKey (rk10)
      rounds rr in 1..9 (round key 10-rr) at base=32+(rr-1)*144:
        [base   : base+16]   InvSubBytes outputs (InvShiftRows is free
                             index rewiring)
        [base+16: base+32]   AddRoundKey outputs
        [base+32: base+144]  InvMixColumns: for output (word i, row m),
                             7 values [tmp0..3, inter1, inter2, out] at
                             base+32+(4i+m)*7+t
      [1328:1344] final InvSubBytes, [1344:1360] AddRoundKey (rk0)
                  = recovered plaintext"""
    dev = ciphertexts.device
    inv_sbox = _table("INV_S_BOX", dev)
    muls = {c: _table(f"MUL_BY_{c}", dev) for c in (9, 11, 13, 14)}
    inv_shift = _table("INV_SHIFT_ROWS_IDX", dev)
    coeff = _table("INV_MIX_MATRIX", dev)[None, None]      # (1, 1, m, j)
    ct = ciphertexts.to(torch.int64)
    B = ct.shape[0]
    parts = [ct]
    state = ct ^ round_keys[10]
    parts.append(state)
    for rr in range(1, 11):
        sub = inv_sbox[state[:, inv_shift]]
        parts.append(sub)
        ark = sub ^ round_keys[10 - rr]
        parts.append(ark)
        if rr == 10:
            break
        s = ark.reshape(B, 4, 1, 4)                         # (B, i, 1, j)
        tmp = torch.where(coeff == 9, muls[9][s], torch.where(
            coeff == 11, muls[11][s], torch.where(
                coeff == 13, muls[13][s], muls[14][s])))    # (B, i, m, j)
        inter1 = tmp[..., 0] ^ tmp[..., 1]
        inter2 = tmp[..., 2] ^ tmp[..., 3]
        out = inter1 ^ inter2                               # (B, i, m)
        group = torch.cat([tmp, inter1[..., None], inter2[..., None],
                           out[..., None]], dim=-1)         # (B, i, m, 7)
        parts.append(group.reshape(B, 112))
        state = out.reshape(B, 16)
    return torch.cat(parts, dim=1)


def encrypt(plaintext, key):
    """Plain AES-128 ECB encrypt of (B, 16) blocks (oracle)."""
    _, rks = expand_key(key)
    return block_pool_batch(plaintext, rks)[:, -16:]


def decrypt(ciphertext, key):
    """Plain AES-128 ECB decrypt of (B, 16) blocks (oracle)."""
    _, rks = expand_key(key)
    return dec_block_pool_batch(ciphertext, rks)[:, -16:]


def ctr_blocks(nonce: int, count: int) -> np.ndarray:
    """uint8[count, 16] big-endian counter blocks (nonce << 64 | i)."""
    out = np.zeros((count, 16), dtype=np.uint8)
    for i in range(count):
        v = (nonce << 64) | i
        out[i] = np.frombuffer(v.to_bytes(16, "big"), dtype=np.uint8)
    return out
