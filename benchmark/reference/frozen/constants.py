"""AES-128 tables and circuit row constants.

All tables are *generated* from GF(2^8) math rather than transcribed, so
they are correct by construction.  The reference hard-codes them
(reference src/constant.rs:1-111) and has a verified bug: its
S_BOX[255] = 0x17 where FIPS-197 requires 0x16 (reference
src/constant.rs:14).  Our generated table is FIPS-correct; tests
exercise index 255 explicitly.

Row-budget constants mirror reference src/constant.rs:113-114 in role;
the key-schedule figure differs because our static layout packs the
gadget into exactly the rows it uses (the reference budgets 1760 rows,
an overestimate noted in its own docs).
"""

from __future__ import annotations

import numpy as np

# --- GF(2^8) with the AES polynomial x^8 + x^4 + x^3 + x + 1 (0x11B) ----


def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _gf_inv(a: int) -> int:
    if a == 0:
        return 0
    # a^(254) in GF(2^8)
    r = 1
    e = 254
    base = a
    while e:
        if e & 1:
            r = _gf_mul(r, base)
        base = _gf_mul(base, base)
        e >>= 1
    return r


def _sbox_entry(x: int) -> int:
    b = _gf_inv(x)
    y = 0
    for i in range(8):
        bit = (
            (b >> i)
            ^ (b >> ((i + 4) % 8))
            ^ (b >> ((i + 5) % 8))
            ^ (b >> ((i + 6) % 8))
            ^ (b >> ((i + 7) % 8))
            ^ (0x63 >> i)
        ) & 1
        y |= bit << i
    return y


S_BOX = np.array([_sbox_entry(x) for x in range(256)], dtype=np.uint8)

# Fixed-constant GF(2^8) multiplication tables.  MUL_BY_9/11/13/14 are the
# InvMixColumns constants, staged for decryption exactly as the reference
# stages them unused (reference src/constant.rs:49-111).
MUL_BY_2 = np.array([_gf_mul(x, 2) for x in range(256)], dtype=np.uint8)
MUL_BY_3 = np.array([_gf_mul(x, 3) for x in range(256)], dtype=np.uint8)
MUL_BY_9 = np.array([_gf_mul(x, 9) for x in range(256)], dtype=np.uint8)
MUL_BY_11 = np.array([_gf_mul(x, 11) for x in range(256)], dtype=np.uint8)
MUL_BY_13 = np.array([_gf_mul(x, 13) for x in range(256)], dtype=np.uint8)
MUL_BY_14 = np.array([_gf_mul(x, 14) for x in range(256)], dtype=np.uint8)

# Inverse S-box (NOT in the reference: its decryption support stops at
# staging the InvMixColumns mul tables, reference src/constant.rs:49-111).
INV_S_BOX = np.zeros(256, dtype=np.uint8)
INV_S_BOX[S_BOX] = np.arange(256, dtype=np.uint8)

# AES key-schedule round constants (reference src/utils.rs:28).
ROUND_CONSTANTS = np.array([1, 2, 4, 8, 16, 32, 64, 128, 27, 54], dtype=np.uint8)

# MixColumns matrix, row-major (reference src/aes128.rs:228-233).
MIX_MATRIX = np.array(
    [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]], dtype=np.uint8
)

# ShiftRows as a flat gather over column-major byte order:
# shifted[4*i + j] = sub[4*((i + j) % 4) + j]  (reference src/aes128.rs:211-223)
SHIFT_ROWS_IDX = np.array(
    [4 * ((i + j) % 4) + j for i in range(4) for j in range(4)], dtype=np.int32
)

# InvMixColumns matrix (FIPS-197 §5.3.3), row-major like MIX_MATRIX.
INV_MIX_MATRIX = np.array(
    [[14, 11, 13, 9], [9, 14, 11, 13], [13, 9, 14, 11], [11, 13, 9, 14]],
    dtype=np.uint8,
)

# InvShiftRows: inv_shifted[4*i + j] = state[4*((i - j) % 4) + j].
INV_SHIFT_ROWS_IDX = np.array(
    [4 * ((i - j) % 4) + j for i in range(4) for j in range(4)], dtype=np.int32
)

# --- circuit row accounting (static layout) -----------------------------

# Rows per AES block: 16 plaintext + 16 initial-ARK xor + per round 1..9
# (16 sbox + 16 outputs * 7 lcon rows) + round 10 (16 sbox) + 10*16 ARK
# xors = 1360, matching reference src/constant.rs:114 (derived identically
# from src/aes128.rs:154-301).
AES_BLOCK_ROWS = 1360
ROUND_ROWS = 144          # rounds 1..9: 16 sub + 112 lcon + 16 ark
LAST_ROUND_ROWS = 32      # round 10: 16 sub + 16 ark

# Key-schedule chip rows per round: 4 sbox + 4 rcon-xor + 16 chain-xor
# + 16 range checks = 40; 10 rounds = 400 rows on the chip columns.
# (The reference budgets KEY_SCHEDULE_ROWS=1760 on one column,
# reference src/constant.rs:113 — a conservative overestimate.)
KEY_SCHEDULE_CHIP_ROWS = 400
# words_column rows: 16 first-round + per round (4 shifted + 4 rcon) = 96.
KEY_SCHEDULE_WORDS_ROWS = 96

# Tagged mega-table size: 256 u8 + 256 sbox + 65536 xor + 256 mul2
# + 256 mul3 + 1 zero row (reference src/table.rs:18-192).
TABLE_ROWS = 66561
MIN_K = 17  # smallest domain holding the table

# Decryption circuit rows per block: 16 ciphertext + 16 initial-ARK xor
# + per round 9..1 (16 inv-sbox + 16 ARK xor + 16 outputs * 7 InvMix lcon
# rows) + final round (16 inv-sbox + 16 ARK) = 1360 — same budget as
# encryption (enc lcon spends its 288 coeff-1 copy rows; dec spends them
# as mul lookups since every InvMix coefficient is 9/11/13/14).
AES_DEC_BLOCK_ROWS = 1360

# Decryption mega-table adds inv-sbox + 4 InvMixColumns mul sub-tables
# (5 * 256 rows) after the encryption content.
DEC_TABLE_ROWS = TABLE_ROWS + 5 * 256
