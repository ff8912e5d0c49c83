"""Mini-AES (GF(2^4)) variant of the AES-128 circuit FAMILY — the
mesh-provable shape demonstrator.

The real circuit's shared table is 66,561 rows (models/table.py,
reference src/table.rs:18-192), forcing k >= 17 — far past what the
8-device CPU mesh can prove inside a test budget.  This module keeps the
ENTIRE circuit structure — the 4-column tagged mega-table with the same
five tags, 5 lookup arguments per column set (reference
src/aes128.rs:63-115), the rcon equality custom gate
(src/key_schedule.rs:59-64), the full 10-round key-schedule copy web,
ShiftRows as pure copy rewiring, 1360 rows per block — and shrinks only
the VALUE domain from bytes to nibbles (GF(2^4), x^4 + x + 1):

  * table rows: 16 u4-range + 16 sbox + 256 xor + 16 mul2 + 16 mul3
    + 1 zero row = 321 -> the full 2-set circuit fits at k = 11,
  * S-box: GF(2^4) inverse + an invertible affine map (same
    construction recipe as FIPS-197, section 5.1.1),
  * round constants: the doubling sequence in GF(2^4).

Because the row templates in models/aes128.py and models/key_schedule.py
are value-agnostic index maps, they are REUSED verbatim — the only
differences are the table contents, the rcon fixed values, and the
witness trace tables.  This is the circuit the multi-chip tests prove
end-to-end on the mesh (tests/test_parallel.py): >= 2 column sets,
>= 5 live lookup arguments into one shared table, the custom gate, and
the cross-set key-schedule copy web, byte-identical to the
single-device proof.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from halo2_aes_tpu_torch.circuit.ir import CompiledCircuit
from halo2_aes_tpu_torch.models import aes128 as A
from halo2_aes_tpu_torch.models import key_schedule as KS
from halo2_aes_tpu_torch.models import table as T
from halo2_aes_tpu_torch.ops import aes

# --- GF(2^4) with x^4 + x + 1 (0x13) ------------------------------------


def _gf16_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(4):
        if b & 1:
            r ^= a
        hi = a & 0x8
        a = (a << 1) & 0xF
        if hi:
            a ^= 0x3          # x^4 == x + 1
        b >>= 1
    return r


def _gf16_inv(a: int) -> int:
    if a == 0:
        return 0
    r, e, base = 1, 14, a      # a^(2^4 - 2)
    while e:
        if e & 1:
            r = _gf16_mul(r, base)
        base = _gf16_mul(base, base)
        e >>= 1
    return r


def _sbox4_entry(x: int) -> int:
    """Nibble S-box: inverse in GF(2^4) then the invertible affine
    y = b ^ rotl(b,1) ^ rotl(b,2) ^ 0x9 (the circulant I + R + R^2 is
    coprime to x^4 + 1 over GF(2), hence invertible)."""
    b = _gf16_inv(x)
    rot1 = ((b << 1) | (b >> 3)) & 0xF
    rot2 = ((b << 2) | (b >> 2)) & 0xF
    return b ^ rot1 ^ rot2 ^ 0x9


S_BOX4 = np.array([_sbox4_entry(x) for x in range(16)], dtype=np.uint8)
assert sorted(S_BOX4.tolist()) == list(range(16)), "S_BOX4 not a permutation"
MUL2_4 = np.array([_gf16_mul(2, x) for x in range(16)], dtype=np.uint8)
MUL3_4 = np.array([_gf16_mul(3, x) for x in range(16)], dtype=np.uint8)
# doubling sequence in GF(2^4): 1,2,4,8,3,6,12,11,5,10
RCON4 = np.array([1, 2, 4, 8, 3, 6, 12, 11, 5, 10], dtype=np.uint8)

MINI_TABLE_ROWS = 16 + 16 + 256 + 16 + 16 + 1   # = 321


def build_mini_table(n: int) -> np.ndarray:
    """(4, n) fixed table columns — same tag layout as models/table.py
    (reference src/table.rs:18-192) over the nibble domain."""
    assert n >= MINI_TABLE_ROWS
    cols = np.zeros((4, n), dtype=np.uint32)
    v = np.arange(16, dtype=np.uint32)
    cols[0, 0:16] = T.Tag.U8
    cols[1, 0:16] = v
    cols[0, 16:32] = T.Tag.SBOX
    cols[1, 16:32] = v
    cols[2, 16:32] = S_BOX4
    a, b = np.divmod(np.arange(256, dtype=np.uint32), 16)
    cols[0, 32:288] = T.Tag.XOR
    cols[1, 32:288] = a
    cols[2, 32:288] = b
    cols[3, 32:288] = a ^ b
    cols[0, 288:304] = T.Tag.GFMUL2
    cols[1, 288:304] = v
    cols[2, 288:304] = MUL2_4
    cols[0, 304:320] = T.Tag.GFMUL3
    cols[1, 304:320] = v
    cols[2, 304:320] = MUL3_4
    # row 320: all-zero padding row (disabled lookups resolve here)
    return cols


# --- witness trace engine (nibble-valued; pool layouts of ops/aes.py) ----


@functools.lru_cache(maxsize=None)
def _table(name: str, device) -> torch.Tensor:
    return torch.as_tensor(globals()[name].astype("int64"), device=device)


def expand_key_mini(key):
    """key uint8[16] tensor (nibble values) -> (ks_pool int64[336],
    round_keys int64[11, 16]) on the key's device.  Same pool layout as
    ops/aes.expand_key."""
    dev = key.device
    return aes.expand_key_with(key, _table("S_BOX4", dev), _table("RCON4", dev))


def block_pool_mini_batch(plaintexts, round_keys):
    """Mini-AES encryption traces of a (B, 16) batch -> int64 (B, 1360)
    (pool layout of ops/aes.block_pool_batch; ShiftRows free, MixColumns
    over GF(2^4))."""
    dev = plaintexts.device
    return aes.block_pool_batch_with(
        plaintexts, round_keys, _table("S_BOX4", dev), _table("MUL2_4", dev),
        _table("MUL3_4", dev))


def block_pool_mini(plaintext, round_keys):
    """One mini-AES encryption trace -> int64[1360]."""
    return block_pool_mini_batch(plaintext[None], round_keys)[0]


def build_pool_mini(key, plaintexts):
    ks_pool, rks = expand_key_mini(key)
    pools = block_pool_mini_batch(plaintexts, rks)
    return torch.cat([ks_pool, pools.reshape(-1)])


# --- circuit compilation -------------------------------------------------


@dataclass(frozen=True)
class MiniAesConfig:
    k: int = 11
    n_sets: int = 2
    n_blocks: int = 2


def compile_mini_circuit(cfg: MiniAesConfig) -> CompiledCircuit:
    """Same assembly as models/aes128.compile_circuit with the nibble
    table and GF(2^4) round constants; templates reused verbatim."""
    acfg = A.AesConfig(k=cfg.k, n_sets=cfg.n_sets, n_blocks=cfg.n_blocks)
    cs, cols = A.configure(acfg)
    n = 1 << cfg.k
    if n < MINI_TABLE_ROWS:
        raise A.CapacityError(
            f"k={cfg.k} too small for the {MINI_TABLE_ROWS}-row mini table")
    caps = A.capacities(acfg, cs)
    if cfg.n_blocks > sum(caps):
        raise A.CapacityError(
            f"{cfg.n_blocks} blocks > capacity {sum(caps)} at "
            f"k={cfg.k}, N={cfg.n_sets}")

    num_cols = len(cs.columns)
    fixed = np.zeros((num_cols, n), dtype=np.uint32)
    witness_map = np.full((num_cols, n), -1, dtype=np.int32)
    fixed[list(cols.tables), :] = build_mini_table(n)

    kst = KS.build_template()
    # the ONLY value-level difference in the key schedule: GF(2^4) rcon
    kst.rcon_fixed[np.flatnonzero(kst.q_eq_rcon)] = RCON4
    set0 = cols.chip_sets[0]
    A._fill_selectors(fixed, set0, kst.sel, 0, KS.CHIP_ROWS, False)
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

    pairs = [np.array(
        [(*ks_cell_to_global(a, ra), *ks_cell_to_global(b, rb))
         for (a, ra, b, rb) in kst.pairs], dtype=np.int32).reshape(-1, 4)]

    bt = A.build_block_template()
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
    is_none = tpool == -1
    is_ksref = tpool <= A._KSREF_BASE
    ks_idx = (A._KSREF_BASE - tpool).astype(np.int32)
    sel_masks = {name: bt.sel[name] for name in bt.sel}

    for b, (s, j) in enumerate(placements):
        base = (KS.CHIP_ROWS if s == 0 else 0) + j * A.BLOCK_ROWS
        chip = cols.chip_sets[s]
        gpool = ks_pool_len + b * A.BLOCK_ROWS
        wm = np.where(is_none, -1,
                      np.where(is_ksref, ks_idx, tpool + gpool)
                      ).astype(np.int32)
        witness_map[list(chip.advice), base : base + A.BLOCK_ROWS] = wm
        A._fill_selectors(fixed, chip, sel_masks, base, A.BLOCK_ROWS, False)
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

    copy_pairs = np.concatenate(pairs, axis=0)
    from halo2_aes_tpu_torch.circuit.ir import prune_dead_lookups

    pruned = prune_dead_lookups(cs, fixed)
    return CompiledCircuit(
        k=cfg.k, cs=cs, fixed=fixed, witness_map=witness_map,
        copy_pairs=copy_pairs,
        pool_len=ks_pool_len + cfg.n_blocks * A.BLOCK_ROWS,
        meta={"pruned_lookups": pruned, "config": cfg,
              "placements": placements})
