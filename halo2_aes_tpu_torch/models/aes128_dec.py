"""Fixed-key multi-block AES-128 DECRYPTION circuit (beyond the reference).

The reference stages the InvMixColumns mul tables (reference
src/constant.rs:49-111) but builds no decryption chips or circuit; this
module completes that staged capability TPU-first.  Structure mirrors
models/aes128.py — static layout templates, batched witness pool, free
InvShiftRows as copy rewiring, 1360 rows/block — but the lookup design
is leaner: all 2-column table ops (forward S-box for the key schedule,
inverse S-box, GF mul by 9/11/13/14) share ONE lookup argument whose
tag comes from a per-set fixed column (models/chips.py DecChipSet),
so each column set carries 3 lookup arguments instead of 8.

Round structure (straightforward inverse cipher, FIPS-197 §5.3):
AddRoundKey(rk10), then for rounds 9..1: InvShiftRows (free) ->
InvSubBytes -> AddRoundKey -> InvMixColumns; final round: InvShiftRows
-> InvSubBytes -> AddRoundKey(rk0).  The key schedule gadget is the
same forward expansion as encryption (models/key_schedule.py), with its
S-box rows routed through the shared tagged-op lookup.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from halo2_aes_tpu_torch.circuit.ir import (
    CompiledCircuit,
    ConstraintSystem,
    Prod,
    Ref,
    Sum,
    Neg,
)
from halo2_aes_tpu_torch.models import constants as C
from halo2_aes_tpu_torch.models import key_schedule as KS
from halo2_aes_tpu_torch.models import table as T
from halo2_aes_tpu_torch.models.aes128 import CapacityError, _ksref, _KSREF_BASE
from halo2_aes_tpu_torch.models.chips import (
    DEC_SELECTOR_NAMES,
    DecChipSet,
    configure_dec_chip_set,
)

BLOCK_ROWS = C.AES_DEC_BLOCK_ROWS  # 1360

_MUL_TAG = {9: T.Tag.GFMUL9, 11: T.Tag.GFMUL11,
            13: T.Tag.GFMUL13, 14: T.Tag.GFMUL14}


@dataclass(frozen=True)
class AesDecConfig:
    k: int = 17
    n_sets: int = 1
    n_blocks: int = 1
    expose_plaintext: bool = False     # recovered plaintext as public input


@dataclass
class DecBlockTemplate:
    a_pool: np.ndarray = dfield(
        default_factory=lambda: np.full((3, BLOCK_ROWS), -1, np.int32))
    sel: dict = dfield(default_factory=dict)
    tag: np.ndarray = dfield(
        default_factory=lambda: np.zeros(BLOCK_ROWS, np.uint32))
    intra_pairs: list = dfield(default_factory=list)
    rk_pairs: list = dfield(default_factory=list)


def build_dec_block_template() -> DecBlockTemplate:
    """Row/pool map of one decryption block (pool layout of
    ops/aes.py dec_block_pool)."""
    t = DecBlockTemplate()
    for name in DEC_SELECTOR_NAMES:
        t.sel[name] = np.zeros(BLOCK_ROWS, bool)
    INV_SHIFT = C.INV_SHIFT_ROWS_IDX
    M = C.INV_MIX_MATRIX

    # ciphertext rows (fresh witness)
    t.a_pool[0, 0:16] = np.arange(16)

    # initial AddRoundKey with rk10
    for i in range(16):
        row = 16 + i
        t.a_pool[0, row] = i
        t.a_pool[1, row] = _ksref(KS.rk_pool_idx(10, i))
        t.a_pool[2, row] = row
        t.sel["q_u8_xor"][row] = True
        t.intra_pairs.append((0, row, 0, i))
        t.rk_pairs.append((1, row, 10, i))

    # prev-state access: (cell, pool idx) per byte q
    prev = [((2, 16 + q), 16 + q) for q in range(16)]

    for rr in range(1, 11):
        base = 32 + (rr - 1) * 144 if rr < 10 else 1328
        kround = 10 - rr

        # InvShiftRows (free) + InvSubBytes
        for q in range(16):
            row = base + q
            cell, pool = prev[int(INV_SHIFT[q])]
            t.a_pool[0, row] = pool
            t.a_pool[1, row] = row
            t.sel["q_op"][row] = True
            t.tag[row] = int(T.Tag.INV_SBOX)
            t.intra_pairs.append((0, row, *cell))

        # AddRoundKey
        for q in range(16):
            row = base + 16 + q
            t.a_pool[0, row] = base + q
            t.a_pool[1, row] = _ksref(KS.rk_pool_idx(kround, q))
            t.a_pool[2, row] = row
            t.sel["q_u8_xor"][row] = True
            t.intra_pairs.append((0, row, 1, base + q))
            t.rk_pairs.append((1, row, kround, q))
        if rr == 10:
            break

        # InvMixColumns via lcon: 7 rows per output byte, all four
        # coefficients are mul lookups (9/11/13/14)
        new_prev = [None] * 16
        for i in range(4):
            for m in range(4):
                lb = base + 32 + (4 * i + m) * 7
                tmp_cells = []
                for j in range(4):
                    row = lb + j
                    src = base + 16 + 4 * i + j       # ARK output byte
                    t.a_pool[0, row] = src
                    t.a_pool[1, row] = row
                    t.sel["q_op"][row] = True
                    t.tag[row] = int(_MUL_TAG[int(M[m][j])])
                    t.intra_pairs.append((0, row, 2, src))
                    tmp_cells.append((1, row))
                for g, (xa, xb) in enumerate([(0, 1), (2, 3)]):
                    row = lb + 4 + g
                    t.a_pool[0, row] = lb + xa
                    t.a_pool[1, row] = lb + xb
                    t.a_pool[2, row] = row
                    t.sel["q_u8_xor"][row] = True
                    t.intra_pairs.append((0, row, *tmp_cells[xa]))
                    t.intra_pairs.append((1, row, *tmp_cells[xb]))
                row = lb + 6
                t.a_pool[0, row] = lb + 4
                t.a_pool[1, row] = lb + 5
                t.a_pool[2, row] = row
                t.sel["q_u8_xor"][row] = True
                t.intra_pairs.append((0, row, 2, lb + 4))
                t.intra_pairs.append((1, row, 2, lb + 5))
                new_prev[4 * i + m] = ((2, row), row)
        prev = new_prev
    return t


@dataclass
class DecColumns:
    tables: tuple
    chip_sets: list
    q_eq_rcon: int
    rcon_fixed: int
    words: int
    instance: int | None


def configure(cfg: AesDecConfig):
    cs = ConstraintSystem()
    tables = tuple(cs.fixed_column(f"table_{n}")
                   for n in ("tag", "in1", "in2", "out"))
    sel_ids, tag_ids = [], []
    for s in range(cfg.n_sets):
        sel_ids.append(tuple(cs.fixed_column(f"{n}_{s}")
                             for n in DEC_SELECTOR_NAMES))
        tag_ids.append(cs.fixed_column(f"op_tag_{s}"))
    q_eq_rcon = cs.fixed_column("q_eq_rcon")
    rcon_fixed = cs.fixed_column("rcon")

    chip_sets = []
    for s in range(cfg.n_sets):
        advice = tuple(cs.advice_column(f"a{j}_set{s}") for j in range(3))
        chip_sets.append(DecChipSet(s, advice, sel_ids[s], tag_ids[s]))
    words = cs.advice_column("words")

    for chip in chip_sets:
        configure_dec_chip_set(cs, chip, tables)

    cs.create_gate(
        "Equality RC",
        Prod(Ref(q_eq_rcon), Sum(Ref(words), Neg(Ref(rcon_fixed)))))

    for chip in chip_sets:
        for a in chip.advice:
            cs.enable_equality(a)
    cs.enable_equality(words)
    cs.enable_equality(rcon_fixed)

    instance = None
    if cfg.expose_plaintext:
        instance = cs.instance_column("plaintext")
        cs.enable_equality(instance)

    return cs, DecColumns(tables, chip_sets, q_eq_rcon, rcon_fixed, words,
                          instance)


def capacities(cfg: AesDecConfig, cs: ConstraintSystem):
    usable = (1 << cfg.k) - (cs.blinding_factors() + 1)
    c0 = max(0, (usable - KS.CHIP_ROWS) // BLOCK_ROWS)
    return [c0] + [usable // BLOCK_ROWS] * (cfg.n_sets - 1)


def compile_circuit(cfg: AesDecConfig) -> CompiledCircuit:
    cs, cols = configure(cfg)
    n = 1 << cfg.k
    if n < C.DEC_TABLE_ROWS:
        raise CapacityError(
            f"k={cfg.k} too small for the {C.DEC_TABLE_ROWS}-row dec table")
    caps = capacities(cfg, cs)
    if cfg.n_blocks > sum(caps):
        raise CapacityError(
            f"{cfg.n_blocks} blocks > capacity {sum(caps)} at k={cfg.k}, "
            f"N={cfg.n_sets}")

    num_cols = len(cs.columns)
    fixed = np.zeros((num_cols, n), dtype=np.uint32)
    witness_map = np.full((num_cols, n), -1, dtype=np.int32)

    fixed[list(cols.tables), :] = T.build_dec_table(n)

    # --- key schedule on set 0 (S-box rows via the tagged-op lookup) ------
    kst = KS.build_template()
    set0 = cols.chip_sets[0]
    ks_sel_of = {"q_u8_range_check": "q_u8_range_check",
                 "q_u8_xor": "q_u8_xor", "q_sbox": "q_op"}
    for ks_name, mask in kst.sel.items():
        sel_col = set0.selectors[DEC_SELECTOR_NAMES.index(ks_sel_of[ks_name])]
        fixed[sel_col, : KS.CHIP_ROWS] |= mask.astype(np.uint32)
    fixed[set0.op_tag, : KS.CHIP_ROWS] = (
        kst.sel["q_sbox"].astype(np.uint32) * int(T.Tag.SBOX))
    fixed[cols.q_eq_rcon, : KS.WORDS_ROWS] = kst.q_eq_rcon.astype(np.uint32)
    fixed[cols.rcon_fixed, : KS.WORDS_ROWS] = kst.rcon_fixed
    witness_map[list(set0.advice), : KS.CHIP_ROWS] = kst.a_pool
    witness_map[cols.words, : KS.WORDS_ROWS] = kst.words_pool

    def ks_cell_to_global(ck, row):
        if ck <= 2:
            return (set0.advice[ck], row)
        if ck == 3:
            return (cols.words, row)
        return (cols.rcon_fixed, row)

    pairs = [
        np.array(
            [(*ks_cell_to_global(a, ra), *ks_cell_to_global(b, rb))
             for (a, ra, b, rb) in kst.pairs],
            dtype=np.int32,
        ).reshape(-1, 4)
    ]

    # --- blocks -----------------------------------------------------------
    bt = build_dec_block_template()
    tpool = bt.a_pool
    intra = np.array(bt.intra_pairs, dtype=np.int32)
    rk = bt.rk_pairs
    rk_local = np.array([(ck, row) for ck, row, _, _ in rk], dtype=np.int32)
    rk_target = np.array(
        [ks_cell_to_global(*KS.rk_cell(r, j)) for _, _, r, j in rk],
        dtype=np.int32)

    placements = []
    b = 0
    for s, cap in enumerate(caps):
        for j in range(cap):
            if b >= cfg.n_blocks:
                break
            placements.append((s, j))
            b += 1
    assert len(placements) == cfg.n_blocks

    ks_pool_len = 16 + 10 * 32
    block_starts = np.empty(cfg.n_blocks, dtype=np.int64)

    is_none = tpool == -1
    is_ksref = tpool <= _KSREF_BASE
    ks_idx = (_KSREF_BASE - tpool).astype(np.int32)

    for b, (s, j) in enumerate(placements):
        base = (KS.CHIP_ROWS if s == 0 else 0) + j * BLOCK_ROWS
        block_starts[b] = base
        chip = cols.chip_sets[s]
        gpool = ks_pool_len + b * BLOCK_ROWS
        wm = np.where(
            is_none, -1, np.where(is_ksref, ks_idx, tpool + gpool)
        ).astype(np.int32)
        witness_map[list(chip.advice), base : base + BLOCK_ROWS] = wm
        for name, sel_col in zip(DEC_SELECTOR_NAMES, chip.selectors):
            fixed[sel_col, base : base + BLOCK_ROWS] |= bt.sel[name].astype(
                np.uint32)
        fixed[chip.op_tag, base : base + BLOCK_ROWS] = bt.tag
        adv = np.array(chip.advice, dtype=np.int32)
        ip = np.empty_like(intra)
        ip[:, 0] = adv[intra[:, 0]]
        ip[:, 1] = intra[:, 1] + base
        ip[:, 2] = adv[intra[:, 2]]
        ip[:, 3] = intra[:, 3] + base
        rp = np.empty((len(rk), 4), dtype=np.int32)
        rp[:, 0] = adv[rk_local[:, 0]]
        rp[:, 1] = rk_local[:, 1] + base
        rp[:, 2:] = rk_target
        pairs += [ip, rp]

    # --- public-input exposure of the recovered plaintext -----------------
    if cfg.expose_plaintext:
        inst = cols.instance
        pt_pairs = np.empty((cfg.n_blocks * 16, 4), dtype=np.int32)
        for b, (s, j) in enumerate(placements):
            base = (KS.CHIP_ROWS if s == 0 else 0) + j * BLOCK_ROWS
            gpool = ks_pool_len + b * BLOCK_ROWS
            a2 = cols.chip_sets[s].advice[2]
            for q in range(16):
                row = 16 * b + q
                witness_map[inst, row] = gpool + 1344 + q
                pt_pairs[16 * b + q] = (inst, row, a2, base + 1344 + q)
        pairs.append(pt_pairs)

    copy_pairs = np.concatenate(pairs, axis=0)

    # see models/aes128.py: dead lookups (never-firing guard selectors)
    # are dropped at compile time
    from halo2_aes_tpu_torch.circuit.ir import prune_dead_lookups

    pruned = prune_dead_lookups(cs, fixed)

    meta = {
        "pruned_lookups": pruned,
        "config": cfg,
        "columns": cols,
        "capacities": caps,
        "block_starts": block_starts,
        "ks_pool_len": ks_pool_len,
        "placements": placements,
    }
    return CompiledCircuit(
        k=cfg.k,
        cs=cs,
        fixed=fixed,
        witness_map=witness_map,
        copy_pairs=copy_pairs,
        pool_len=ks_pool_len + cfg.n_blocks * BLOCK_ROWS,
        meta=meta,
    )
