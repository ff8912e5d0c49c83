"""Batched AES-128 witness engine: the port of ``ops/aes.py`` (encryption).

The whole trace of every AES block is computed as a flat value pool
with batched tensor ops; ``circuit/witness.py`` scatters it into
columns.  Pool layouts are the reference's (see its module docstring):
a 336-byte key-schedule pool, then 1360 bytes per block.
"""

from __future__ import annotations

import functools

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
    sbox = _table("S_BOX", dev)
    rcon = _table("ROUND_CONSTANTS", dev)
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


def block_pool_batch(plaintexts, round_keys):
    """Full circuit traces of a batch of AES-128 encryptions.

    plaintexts: (B, 16) uint8/int tensor; round_keys: (11, 16) ->
    int64 (B, 1360)."""
    dev = plaintexts.device
    sbox = _table("S_BOX", dev)
    mul2 = _table("MUL_BY_2", dev)
    mul3 = _table("MUL_BY_3", dev)
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


def encrypt(plaintext, key):
    """Plain AES-128 ECB encrypt of (B, 16) blocks (oracle)."""
    _, rks = expand_key(key)
    return block_pool_batch(plaintext, rks)[:, -16:]
