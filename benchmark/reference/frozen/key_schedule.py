"""AES-128 key-schedule gadget as a static layout template.

The TPU equivalent of reference src/key_schedule.rs: the gadget occupies
a fixed window of rows — 400 chip rows on column-set 0 (per round: 4 sbox
+ 4 rcon-xor + 16 chain-xor + 16 range checks) plus 96 rows of the
dedicated ``words`` advice column (16 key bytes + per round 4 RotWord
copies + 4 round-constant cells).

The round constant is bound to the fixed column by the circuit's only
custom gate ``q_eq_rcon * (words - rcon_fixed)`` (reference
src/key_schedule.rs:59-64).  Unlike the reference, the three zero pads
next to each round constant are copy-constrained to the fixed column's
zero cells (the reference leaves them as unconstrained advice,
src/key_schedule.rs:177-186 — a soundness quirk we do not replicate).

Pool indices refer to the key-schedule pool of ops/aes.py (length 336).
Column-kind codes used in pairs/cells here:
  0,1,2 = set-0 advice a0,a1,a2;  3 = words column;  4 = rcon fixed column.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.frozen import constants as C

CHIP_ROWS = C.KEY_SCHEDULE_CHIP_ROWS     # 400
WORDS_ROWS = C.KEY_SCHEDULE_WORDS_ROWS   # 96

ROT_IDX = (13, 14, 15, 12)  # RotWord copy pattern (reference key_schedule.rs:141)


def rk_cell(r: int, j: int):
    """Where round-key byte j of round r lives: (colkind, row)."""
    if r == 0:
        return (3, j)                      # words column, first 16 rows
    return (2, (r - 1) * 40 + 8 + j)       # z-cell of the chain xor


def rk_pool_idx(r: int, j: int) -> int:
    """Key-schedule pool index of round-key byte j of round r."""
    if r == 0:
        return j
    return 16 + (r - 1) * 32 + 16 + j


@dataclass
class KeyScheduleTemplate:
    # pool index (into the 336-entry ks pool) per cell, -1 = unused
    a_pool: np.ndarray = field(default_factory=lambda: np.full((3, CHIP_ROWS), -1, np.int32))
    words_pool: np.ndarray = field(default_factory=lambda: np.full(WORDS_ROWS, -1, np.int32))
    sel: dict = field(default_factory=dict)          # name -> bool[CHIP_ROWS]
    q_eq_rcon: np.ndarray = field(default_factory=lambda: np.zeros(WORDS_ROWS, bool))
    rcon_fixed: np.ndarray = field(default_factory=lambda: np.zeros(WORDS_ROWS, np.uint32))
    pairs: list = field(default_factory=list)         # (ck_a, row_a, ck_b, row_b)


def build_template() -> KeyScheduleTemplate:
    t = KeyScheduleTemplate()
    for name in ("q_u8_range_check", "q_u8_xor", "q_sbox"):
        t.sel[name] = np.zeros(CHIP_ROWS, bool)

    # first round: 16 key bytes in the words column (fresh witness)
    t.words_pool[0:16] = np.arange(16)

    for r in range(1, 11):
        cr = (r - 1) * 40          # chip-row base
        wr = 16 + (r - 1) * 8      # words-row base
        pb = 16 + (r - 1) * 32     # ks-pool base

        # RotWord: copy prev round word bytes [13,14,15,12] into words col
        for tt in range(4):
            t.words_pool[wr + tt] = pb + tt
            t.pairs.append((3, wr + tt, *rk_cell(r - 1, ROT_IDX[tt])))

        # SubWord: 4 sbox rows
        for tt in range(4):
            row = cr + tt
            t.a_pool[0, row] = pb + tt        # x = shifted
            t.a_pool[1, row] = pb + 4 + tt    # y = subbed
            t.sel["q_sbox"][row] = True
            t.pairs.append((0, row, 3, wr + tt))

        # round constant region in the words column: [rc, 0, 0, 0]
        for tt in range(4):
            t.words_pool[wr + 4 + tt] = pb + 8 + tt
        t.q_eq_rcon[wr + 4] = True
        t.rcon_fixed[wr + 4] = int(C.ROUND_CONSTANTS[r - 1])
        for tt in range(1, 4):  # constrain pads to the fixed zeros
            t.pairs.append((3, wr + 4 + tt, 4, wr + 4 + tt))

        # rconned = subbed ^ rc word: 4 xor rows
        for tt in range(4):
            row = cr + 4 + tt
            t.a_pool[0, row] = pb + 4 + tt
            t.a_pool[1, row] = pb + 8 + tt
            t.a_pool[2, row] = pb + 12 + tt
            t.sel["q_u8_xor"][row] = True
            t.pairs.append((0, row, 1, cr + tt))
            t.pairs.append((1, row, 3, wr + 4 + tt))

        # w0 = prev word 0 ^ rconned, then w1..w3 chains: 16 xor rows
        for w in range(4):
            for tt in range(4):
                row = cr + 8 + 4 * w + tt
                j = 4 * w + tt
                t.a_pool[0, row] = rk_pool_idx(r - 1, j)
                t.a_pool[2, row] = pb + 16 + j
                t.sel["q_u8_xor"][row] = True
                t.pairs.append((0, row, *rk_cell(r - 1, j)))
                if w == 0:
                    t.a_pool[1, row] = pb + 12 + tt                 # rconned
                    t.pairs.append((1, row, 2, cr + 4 + tt))
                else:
                    t.a_pool[1, row] = pb + 16 + 4 * (w - 1) + tt   # prev new word
                    t.pairs.append((1, row, 2, cr + 8 + 4 * (w - 1) + tt))

        # range check all 16 new bytes (reference key_schedule.rs:218-221)
        for j in range(16):
            row = cr + 24 + j
            t.a_pool[0, row] = pb + 16 + j
            t.sel["q_u8_range_check"][row] = True
            t.pairs.append((0, row, 2, cr + 8 + j))

    return t
