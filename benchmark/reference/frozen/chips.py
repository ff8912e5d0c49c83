"""Chip gadgets as static lookup-argument descriptors.

Each reference "chip" (reference src/chips/*.rs) contributes one lookup
argument per advice-column set; rows are emitted by the layout templates
(models/key_schedule.py, models/aes128.py) rather than by per-op regions.
The lookup shapes are byte-for-byte the reference's:

  range (u8_range_check_chip.rs:35-43): (q*U8,   tag) (q*x, in1)
  xor   (u8_xor_chip.rs:41-53):         (q*XOR,  tag) (q*x, in1) (q*y, in2) (q*z, out)
  sbox  (sbox_chip.rs:38-48):           (q*SBOX, tag) (q*x, in1) (q*y, in2)
  mul2  (gf_mul_chip.rs:40-50):         (q*GFMUL2, tag) (q*x, in1) (q*y, in2)
  mul3  (gf_mul_chip.rs:40-50):         (q*GFMUL3, tag) (q*x, in1) (q*y, in2)

With q = 0 every expression is 0, matching the table's all-zero row —
exactly the disabled-row convention of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.frozen.ir import Const, ConstraintSystem, Prod, Ref
from benchmark.reference.frozen.table import Tag

SELECTOR_NAMES = ("q_u8_range_check", "q_u8_xor", "q_sbox", "q_mul_by_2", "q_mul_by_3")


@dataclass(frozen=True)
class ChipSet:
    """Column/selector ids for one advice-column set."""

    index: int
    advice: tuple          # (a0, a1, a2) global column ids
    selectors: tuple       # 5 selector fixed-column ids, SELECTOR_NAMES order


def configure_chip_set(cs: ConstraintSystem, chip: ChipSet, table_cols):
    """Register the 5 lookup arguments of one column set.

    Mirrors reference src/aes128.rs:63-115 (configure order: range, xor,
    sbox, mul2, mul3).
    """
    tag, in1, in2, out = table_cols
    a0, a1, a2 = chip.advice
    q_range, q_xor, q_sbox, q_mul2, q_mul3 = chip.selectors

    def q(sel):
        return Ref(sel)

    cs.add_lookup(
        f"u8 range check (set {chip.index})",
        [(Prod(q(q_range), Const(int(Tag.U8))), tag),
         (Prod(q(q_range), Ref(a0)), in1)],
    )
    cs.add_lookup(
        f"u8 xor (set {chip.index})",
        [(Prod(q(q_xor), Const(int(Tag.XOR))), tag),
         (Prod(q(q_xor), Ref(a0)), in1),
         (Prod(q(q_xor), Ref(a1)), in2),
         (Prod(q(q_xor), Ref(a2)), out)],
    )
    cs.add_lookup(
        f"sbox (set {chip.index})",
        [(Prod(q(q_sbox), Const(int(Tag.SBOX))), tag),
         (Prod(q(q_sbox), Ref(a0)), in1),
         (Prod(q(q_sbox), Ref(a1)), in2)],
    )
    cs.add_lookup(
        f"gf mul by 2 (set {chip.index})",
        [(Prod(q(q_mul2), Const(int(Tag.GFMUL2))), tag),
         (Prod(q(q_mul2), Ref(a0)), in1),
         (Prod(q(q_mul2), Ref(a1)), in2)],
    )
    cs.add_lookup(
        f"gf mul by 3 (set {chip.index})",
        [(Prod(q(q_mul3), Const(int(Tag.GFMUL3))), tag),
         (Prod(q(q_mul3), Ref(a0)), in1),
         (Prod(q(q_mul3), Ref(a1)), in2)],
    )


# --------------------------------------------------------------------------
# decryption chip set (beyond the reference — see models/aes128_dec.py)
# --------------------------------------------------------------------------

DEC_SELECTOR_NAMES = ("q_u8_range_check", "q_u8_xor", "q_op")


@dataclass(frozen=True)
class DecChipSet:
    """Column/selector ids for one decryption advice-column set.

    Instead of one lookup argument per op type, all 2-column table ops
    (forward S-box for the key schedule, inverse S-box, GF mul by
    9/11/13/14) share ONE lookup whose tag is read from a per-set fixed
    column — 3 lookup arguments per set where the reference's design
    would need 8.  Fewer lookups = fewer permuted/grand-product columns
    per proof."""

    index: int
    advice: tuple          # (a0, a1, a2) global column ids
    selectors: tuple       # 3 selector fixed-column ids, DEC_SELECTOR_NAMES order
    op_tag: int            # fixed column holding the per-row table tag


def configure_dec_chip_set(cs: ConstraintSystem, chip: DecChipSet, table_cols,
                           label: str = "dec set"):
    """Register the 3 lookup arguments of one tagged-op column set.

    Used by the decryption circuit and by the encryption circuit's LEAN
    mode (AesConfig.tagged_ops): one fused lookup whose tag comes from a
    per-set fixed column replaces the reference's per-op lookups."""
    tag, in1, in2, out = table_cols
    a0, a1, a2 = chip.advice
    q_range, q_xor, q_op = (Ref(s) for s in chip.selectors)

    cs.add_lookup(
        f"u8 range check ({label} {chip.index})",
        [(Prod(q_range, Const(int(Tag.U8))), tag),
         (Prod(q_range, Ref(a0)), in1)],
    )
    cs.add_lookup(
        f"u8 xor ({label} {chip.index})",
        [(Prod(q_xor, Const(int(Tag.XOR))), tag),
         (Prod(q_xor, Ref(a0)), in1),
         (Prod(q_xor, Ref(a1)), in2),
         (Prod(q_xor, Ref(a2)), out)],
    )
    cs.add_lookup(
        f"tagged table op ({label} {chip.index})",
        [(Prod(q_op, Ref(chip.op_tag)), tag),
         (Prod(q_op, Ref(a0)), in1),
         (Prod(q_op, Ref(a1)), in2)],
    )
