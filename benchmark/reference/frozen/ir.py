"""Static circuit IR: columns, expressions, gates, lookup arguments.

Plays the role of halo2's ``ConstraintSystem`` (reference dependency layer,
SURVEY.md section 2.13) but as a *static* description: the circuit shape is
known up front, so there is no Layouter, no regions, no selector
compression — selectors are plain fixed columns, and every assignment is a
precomputed index map (built by the static layout compilers in
``models/aes128.py`` / ``models/aes128_dec.py``).

Expressions are evaluated through an *algebra* object so the same IR
drives three consumers:
  * the int32 mock checker (all AES circuit values < 2^16: exact),
  * the field-limb quotient evaluator in the prover,
  * degree accounting for the extended evaluation domain.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Callable, List, Sequence, Tuple

import numpy as np

FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"


@dataclass(frozen=True)
class Column:
    index: int          # global column id
    kind: str           # FIXED / ADVICE / INSTANCE
    name: str


# --- expressions -----------------------------------------------------------


class Expr:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __sub__(self, other):
        return Sum(self, Neg(_wrap(other)))

    def __mul__(self, other):
        return Prod(self, _wrap(other))

    def degree(self) -> int:
        raise NotImplementedError

    def eval(self, alg, get):
        """alg: algebra with const/add/sub/mul/neg; get(col_id, rot) -> values."""
        raise NotImplementedError

    def columns(self) -> set:
        raise NotImplementedError


def _wrap(v):
    return Const(v) if isinstance(v, int) else v


@dataclass(frozen=True)
class Const(Expr):
    value: int  # plain (non-Montgomery) field value

    def degree(self):
        return 0

    def eval(self, alg, get):
        return alg.const(self.value)

    def columns(self):
        return set()


@dataclass(frozen=True)
class Ref(Expr):
    """Column reference at a rotation (halo2 ``query_advice/fixed``)."""

    column: int
    rotation: int = 0

    def degree(self):
        return 1

    def eval(self, alg, get):
        return get(self.column, self.rotation)

    def columns(self):
        return {(self.column, self.rotation)}


@dataclass(frozen=True)
class Neg(Expr):
    inner: Expr

    def degree(self):
        return self.inner.degree()

    def eval(self, alg, get):
        return alg.neg(self.inner.eval(alg, get))

    def columns(self):
        return self.inner.columns()


@dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def eval(self, alg, get):
        return alg.add(self.a.eval(alg, get), self.b.eval(alg, get))

    def columns(self):
        return self.a.columns() | self.b.columns()


@dataclass(frozen=True)
class Prod(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()

    def eval(self, alg, get):
        return alg.mul(self.a.eval(alg, get), self.b.eval(alg, get))

    def columns(self):
        return self.a.columns() | self.b.columns()


# --- constraint system -----------------------------------------------------


def expr_bytes(e: Expr) -> bytes:
    """Canonical byte serialization of an expression tree.

    Prefix notation with fixed-width operands — stable across Python
    versions and dataclass repr changes (the vk digest hashes this, so
    ``repr`` instability must never change a verifying key)."""
    if isinstance(e, Const):
        return b"C" + (e.value % (1 << 256)).to_bytes(32, "little")
    if isinstance(e, Ref):
        return (b"R" + e.column.to_bytes(4, "little", signed=True)
                + e.rotation.to_bytes(4, "little", signed=True))
    if isinstance(e, Neg):
        return b"N" + expr_bytes(e.inner)
    if isinstance(e, Sum):
        return b"S" + expr_bytes(e.a) + expr_bytes(e.b)
    if isinstance(e, Prod):
        return b"P" + expr_bytes(e.a) + expr_bytes(e.b)
    raise TypeError(f"unknown expression node {type(e)!r}")


def cs_bytes(cs: "ConstraintSystem") -> bytes:
    """Canonical byte serialization of the whole constraint system."""
    out = bytearray()
    out += len(cs.columns).to_bytes(4, "little")
    for c in cs.columns:
        out += c.kind.encode() + b"\x00"
    out += len(cs.gates).to_bytes(4, "little")
    for name, g in cs.gates:
        b = expr_bytes(g)
        out += len(b).to_bytes(4, "little") + b
    out += len(cs.lookups).to_bytes(4, "little")
    for lk in cs.lookups:
        out += len(lk.pairs).to_bytes(4, "little")
        for e, tc in lk.pairs:
            b = expr_bytes(e)
            out += len(b).to_bytes(4, "little") + b
            out += tc.to_bytes(4, "little")
    out += len(cs.perm_columns).to_bytes(4, "little")
    for c in cs.perm_columns:
        out += c.to_bytes(4, "little")
    return bytes(out)


@dataclass
class Lookup:
    """One lookup argument: input expressions -> fixed table columns.

    Mirrors halo2 ``meta.lookup`` (e.g. reference src/chips/u8_xor_chip.rs:
    41-53): ``pairs[i] = (input_expr_i, table_column_id_i)``.
    """

    name: str
    pairs: List[Tuple[Expr, int]]

    def input_degree(self):
        return max(e.degree() for e, _ in self.pairs)


@dataclass
class ConstraintSystem:
    columns: List[Column] = dfield(default_factory=list)
    gates: List[Tuple[str, Expr]] = dfield(default_factory=list)
    lookups: List[Lookup] = dfield(default_factory=list)
    perm_columns: List[int] = dfield(default_factory=list)  # equality-enabled

    def add_column(self, kind: str, name: str) -> int:
        idx = len(self.columns)
        self.columns.append(Column(idx, kind, name))
        return idx

    def fixed_column(self, name: str) -> int:
        return self.add_column(FIXED, name)

    def advice_column(self, name: str) -> int:
        return self.add_column(ADVICE, name)

    def instance_column(self, name: str) -> int:
        return self.add_column(INSTANCE, name)

    def enable_equality(self, col: int):
        if col not in self.perm_columns:
            self.perm_columns.append(col)

    def create_gate(self, name: str, expr: Expr):
        self.gates.append((name, expr))

    def add_lookup(self, name: str, pairs):
        self.lookups.append(Lookup(name, list(pairs)))

    # -- degree accounting (drives extended-domain size, halo2 cs.degree())
    def degree(self) -> int:
        d = 3  # permutation argument floor (z * product terms * active factor)
        for _, g in self.gates:
            d = max(d, g.degree())
        for lk in self.lookups:
            # active * (z(wX) (A'+beta)(S'+gamma) - z(X)(A+beta)(S+gamma))
            d = max(d, 1 + 1 + max(2, lk.input_degree()) + 1)
        # permutation chunked at degree-2 columns per product: 2 + chunk + 1
        return d

    def permutation_chunk_len(self) -> int:
        return max(1, self.degree() - 2)

    def referenced_columns(self) -> set:
        """Column ids referenced by any gate, lookup (input or table), or
        the copy-constraint permutation — the set whose polynomials the
        protocol actually opens/commits.  Fixed columns OUTSIDE this set
        (e.g. selectors whose lookups were pruned) need no commitment:
        committing their all-zero polynomials would put identity points
        in the vk (halo2's transcript panics on identity — reference
        dependency behavior, src/main.rs:92)."""
        need = set()
        for _, g in self.gates:
            need |= {c for c, _ in g.columns()}
        for lk in self.lookups:
            for e, tc in lk.pairs:
                need |= {c for c, _ in e.columns()}
                need.add(tc)
        need |= set(self.perm_columns)
        return need

    def blinding_factors(self) -> int:
        """Unusable blinding rows at the tail of each advice column.

        Documented policy (role of halo2 cs.blinding_factors()): all our
        columns are queried at rotation 0/±1 only; we reserve
        max(3, max queries)+2 rows. With single-rotation queries: 5.
        """
        return 5


def _prod_factor_refs(e: Expr) -> set:
    """Rotation-0 column refs that appear as top-level multiplicative
    factors of ``e`` (so e == 0 wherever any of them is 0)."""
    if isinstance(e, Prod):
        return _prod_factor_refs(e.a) | _prod_factor_refs(e.b)
    if isinstance(e, Neg):
        return _prod_factor_refs(e.inner)
    if isinstance(e, Ref) and e.rotation == 0:
        return {e.column}
    return set()


def prune_dead_lookups(cs: ConstraintSystem, fixed: np.ndarray) -> list:
    """Drop lookup arguments that are provably inactive: every input pair
    is guarded by a common fixed-column factor whose values are all zero,
    so each row's input tuple is (0,...,0) — the disabled-row convention
    matched by the table's all-zero row.  Removing such a lookup changes
    neither satisfiability nor soundness, and saves the prover a permuted
    pair + grand product + 3 commitments per proof.

    The reference configures 5 lookups per column set unconditionally
    (src/aes128.rs:63-115) even when a chip is never used (e.g. the range
    chip outside the key-schedule set, src/aes128.rs:168); with a static
    layout the dead ones are visible at compile time.  Returns the names
    of the dropped lookups."""
    fixed_cols = {c.index for c in cs.columns if c.kind == FIXED}
    live, dropped = [], []
    for lk in cs.lookups:
        guards = None
        for e, _ in lk.pairs:
            f = {c for c in _prod_factor_refs(e) if c in fixed_cols}
            guards = f if guards is None else (guards & f)
        dead = bool(guards) and any(not fixed[c].any() for c in guards)
        (dropped if dead else live).append(lk)
    cs.lookups = live
    return [lk.name for lk in dropped]


@dataclass
class CompiledCircuit:
    """A fully laid-out circuit: the static artifact all backends consume.

    fixed:        uint32 (num_fixed_like_columns = total columns, n) but only
                  fixed columns populated; small values (< 2^16).
    witness_map:  int32 (num_columns, n): index into the global witness pool,
                  or -1 (unassigned -> value 0, blinding rows randomized by
                  the prover).  Only advice columns have entries != -1.
    copy_pairs:   int32 (P, 4): (col_a, row_a, col_b, row_b) equality links.
    """

    k: int
    cs: ConstraintSystem
    fixed: np.ndarray
    witness_map: np.ndarray
    copy_pairs: np.ndarray
    pool_len: int
    meta: dict = dfield(default_factory=dict)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def usable_rows(self) -> int:
        return self.n - (self.cs.blinding_factors() + 1)

    def advice_ids(self):
        return [c.index for c in self.cs.columns if c.kind == ADVICE]

    def fixed_ids(self):
        return [c.index for c in self.cs.columns if c.kind == FIXED]

    def instance_ids(self):
        return [c.index for c in self.cs.columns if c.kind == INSTANCE]
