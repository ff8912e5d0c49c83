"""AES-128 (FIPS-197) in NumPy, laid out as the circuit's witness pool.

The pool is the order in which the circuit's layout reads the trace:
a 336-entry key-schedule part (the key; then per round the rotated
word, its S-box image, the round-constant word, their XOR, and the new
round key), then 1,360 entries per block (the plaintext, the state after
the first AddRoundKey; per round the SubBytes output, for rounds 1-9 the
MixColumns trace of seven entries per output byte (the four products,
the two partial XORs, the output), and the state after AddRoundKey).
The S-box is built here from exponent and logarithm tables of GF(2^8).
"""

from __future__ import annotations

import numpy as np


def _tables():
    exp = np.zeros(256, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF     # x * 3
    inv = np.zeros(256, np.int64)
    inv[1:] = exp[(255 - log[1:]) % 255]
    sbox = np.zeros(256, np.int64)
    for v in range(256):
        b = int(inv[v])
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        sbox[v] = s ^ 0x63
    xt = np.array([((v << 1) ^ (0x1B if v & 0x80 else 0)) & 0xFF
                   for v in range(256)], np.int64)
    return sbox, xt, xt ^ np.arange(256)


SBOX, MUL2, MUL3 = _tables()
# state byte 4c + r (column c, row r); ShiftRows moves row r left by r
SHIFT = np.array([4 * ((c + r) % 4) + r for c in range(4) for r in range(4)])
MIX = np.array([[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]])
RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def key_pool(key: np.ndarray):
    """(336-entry key-schedule pool, round keys (11, 16))."""
    prev = key.astype(np.int64)
    pool, rks = [prev], [prev]
    for r in range(10):
        rot = prev[[13, 14, 15, 12]]
        sub = SBOX[rot]
        rc = np.array([RCON[r], 0, 0, 0], np.int64)
        t = sub ^ rc
        words = [prev[0:4] ^ t]
        for j in range(1, 4):
            words.append(prev[4 * j:4 * j + 4] ^ words[-1])
        w = np.concatenate(words)
        pool += [rot, sub, rc, t, w]
        rks.append(w)
        prev = w
    return np.concatenate(pool), np.stack(rks)


def _mult(coef, v):
    return v if coef == 1 else (MUL2[v] if coef == 2 else MUL3[v])


def block_pools(pts: np.ndarray, rks: np.ndarray) -> np.ndarray:
    """(B, 16) plaintexts -> (B, 1360) traces."""
    pts = pts.astype(np.int64)
    B = pts.shape[0]
    parts = [pts]
    state = pts ^ rks[0]
    parts.append(state)
    for r in range(1, 11):
        sub = SBOX[state]
        parts.append(sub)
        sh = sub[:, SHIFT]
        if r < 10:
            group = np.zeros((B, 4, 4, 7), np.int64)
            for c in range(4):
                col = sh[:, 4 * c:4 * c + 4]
                for m in range(4):
                    prods = [_mult(MIX[m][j], col[:, j]) for j in range(4)]
                    i1, i2 = prods[0] ^ prods[1], prods[2] ^ prods[3]
                    group[:, c, m] = np.stack(prods + [i1, i2, i1 ^ i2], axis=1)
            parts.append(group.reshape(B, 112))
            mixed = group[:, :, :, 6].reshape(B, 16)
        else:
            mixed = sh
        state = mixed ^ rks[r]
        parts.append(state)
    return np.concatenate(parts, axis=1)


def encrypt(pts: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Ciphertexts of (B, 16) plaintext blocks."""
    _, rks = key_pool(key)
    return block_pools(pts, rks)[:, -16:]


def pool(key: np.ndarray, pts: np.ndarray) -> np.ndarray:
    kp, rks = key_pool(key)
    return np.concatenate([kp, block_pools(pts, rks).reshape(-1)])
