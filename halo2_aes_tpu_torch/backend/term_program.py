"""The quotient's constraint terms lowered to a straight-line program.

``protocol.constraint_terms`` states every term of the quotient once,
over an abstract algebra.  ``lower`` walks it once per proving key with
a recording algebra and returns a ``TermProgram``: a list of
instructions over per-row value slots that computes, for one row of a
sub-coset, every term in canonical order, folds each into the
accumulator as soon as it is made (acc = acc * y + term) and ends with
the Z_H division.  The prover runs it for every sub-coset on every
device (``prover._Phases.quotient_subcoset``): K4
(``ops/cuda_quotient.py``) over every row in one launch on a card, its
plain version with the field's tensor ops on the CPU.  The field math
is exact, so the program gives the eager fold's bits
(``quotient_subcoset_eager``, the tests' reference) whatever order it
computes in.

The instruction set is K4's (``ops/cuda_quotient.py``).  The constant
table's rows after ``TABLE_FIXED`` hold delta^i * shift for each
permutation column i (perm_id(i) = delta^i * shift * omega^row), then
the program's own constants (``TermProgram.consts``, plain values).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from halo2_aes_tpu_torch.backend import protocol as PROTO
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.cuda_quotient import (
    ADD, FIRST, FOLD, LOAD, MUL, NEG, OMEGA, SUB, TABLE_BETA, TABLE_FIXED,
    TABLE_GAMMA, TABLE_THETA)


@dataclass(frozen=True)
class TermProgram:
    code: np.ndarray     # (N, 4) int32 instructions
    consts: tuple        # plain field values: table rows TABLE_FIXED + m on
    slots: int           # value slots a row needs at once
    terms: int
    muls: int            # products as constraint_terms states them, with
    #                      the Horner fold's and the Z_H division's
    polys: int           # distinct polys the terms read


class _Recorder:
    """Algebra whose values are interned nodes: leaves ("load", p, r),
    ("omega",), ("const", v), ("arg", row) and ops over node ids.
    ``calls`` counts the products ``constraint_terms`` asks for."""

    def __init__(self):
        self.nodes = []
        self._ids = {}
        self.calls = 0

    def node(self, *key) -> int:
        nid = self._ids.get(key)
        if nid is None:
            nid = self._ids[key] = len(self.nodes)
            self.nodes.append(key)
        return nid

    def const(self, v: int) -> int:
        return self.node("const", v % F.FR.modulus)

    def _value(self, nid):
        key = self.nodes[nid]
        return key[1] if key[0] == "const" else None

    def add(self, a: int, b: int) -> int:
        va, vb = self._value(a), self._value(b)
        if va is not None and vb is not None:
            return self.const(va + vb)
        if self.nodes[b][0] == "neg":
            return self.node("sub", a, self.nodes[b][1])
        if self.nodes[a][0] == "neg":
            return self.node("sub", b, self.nodes[a][1])
        return self.node("add", a, b)

    def mul(self, a: int, b: int) -> int:
        self.calls += 1
        return self.product(a, b)

    def product(self, a: int, b: int) -> int:
        va, vb = self._value(a), self._value(b)
        if va is not None and vb is not None:
            return self.const(va * vb)
        return self.node("mul", a, b)

    def neg(self, a: int) -> int:
        va = self._value(a)
        return self.const(-va) if va is not None else self.node("neg", a)


def lower(cs, poly_keys, usable: int, n: int) -> TermProgram:
    """The term program of ``cs`` over a sub-coset of n rows whose polys
    are ``poly_keys`` in stack order (the prover's static keys, then its
    dynamic keys)."""
    rec = _Recorder()
    index = {key: p for p, key in enumerate(poly_keys)}

    def load(key, rot=0):
        r = usable if rot == "u" else rot
        return rec.node("load", index[key], r % n)

    omega = rec.node("omega")
    m = len(cs.perm_columns)
    ctx = PROTO.Context()
    ctx.__dict__.update(
        alg=rec, one=rec.const(1),
        theta=rec.node("arg", TABLE_THETA), beta=rec.node("arg", TABLE_BETA),
        gamma=rec.node("arg", TABLE_GAMMA),
        l0=load(("l0",)), l_last=load(("l_last",)), l_active=load(("l_active",)),
        column=lambda col, rot: load(("col", col), rot),
        perm_z=lambda t, rot: load(("perm_z", t), rot),
        sigma=lambda i: load(("sigma", i)),
        perm_id=lambda i: rec.product(rec.node("arg", TABLE_FIXED + i), omega),
        lookup_z=lambda i, rot: load(("lookup_z", i), rot),
        lookup_a=lambda i, rot: load(("lookup_a", i), rot),
        lookup_s=lambda i: load(("lookup_s", i)))
    roots = list(PROTO.constraint_terms(cs, ctx))

    consts = {}
    code = []            # [op, dst vreg, a, b] with operands vregs or table codes

    def operand(nid):
        key = rec.nodes[nid]
        if key[0] == "arg":
            return ~key[1]
        if key[0] == "const":
            c = consts.setdefault(key[1], len(consts))
            return ~(TABLE_FIXED + m + c)
        return None

    need = {}

    def need_of(nid):
        """Sethi-Ullman count: slots a subtree needs at once."""
        if nid not in need:
            key = rec.nodes[nid]
            if operand(nid) is not None:
                need[nid] = 0
            elif key[0] in ("load", "omega"):
                need[nid] = 1
            elif key[0] == "neg":
                need[nid] = max(1, need_of(key[1]))
            else:
                na, nb = need_of(key[1]), need_of(key[2])
                need[nid] = max(na, nb) if na != nb else na + 1
        return need[nid]

    vregs = 0

    def emit(nid, memo):
        nonlocal vregs
        op = operand(nid)
        if op is not None:
            return op
        if nid in memo:
            return memo[nid]
        key = rec.nodes[nid]
        kind = key[0]
        if kind == "load":
            ins = [LOAD, None, key[1], key[2]]
        elif kind == "omega":
            ins = [OMEGA, None, 0, 0]
        elif kind == "neg":
            ins = [NEG, None, emit(key[1], memo), 0]
        else:
            a, b = key[1], key[2]
            # the child that needs more slots first, so fewer stay live
            if need_of(b) > need_of(a):
                vb = emit(b, memo)
                va = emit(a, memo)
            else:
                va = emit(a, memo)
                vb = emit(b, memo)
            ins = [{"add": ADD, "sub": SUB, "mul": MUL}[kind], None, va, vb]
        ins[1] = vregs
        vregs += 1
        code.append(ins)
        memo[nid] = ins[1]
        return ins[1]

    for t, root in enumerate(roots):
        # each term in its own scope: a value is made again rather than
        # held in a slot across terms
        code.append([FIRST if t == 0 else FOLD, -1, emit(root, {}), 0])

    slots = _allocate(code)
    const_vals = tuple(sorted(consts, key=consts.get))
    muls = rec.calls + max(len(roots) - 1, 0) + 1
    polys = len({ins[2] for ins in code if ins[0] == LOAD})
    return TermProgram(code=np.asarray(code, np.int32).reshape(-1, 4),
                       consts=const_vals, slots=slots,
                       terms=len(roots), muls=muls, polys=polys)


def _allocate(code) -> int:
    """Map the virtual registers of ``code`` to slots in place (a slot is
    free again after its value's last use); returns the slots needed."""
    operands = {LOAD: (), OMEGA: (), NEG: (2,), FIRST: (2,), FOLD: (2,)}
    last = {}
    for j, ins in enumerate(code):
        for pos in operands.get(ins[0], (2, 3)):
            if ins[pos] >= 0:
                last[ins[pos]] = j
    slot_of, free, used = {}, [], 0
    for j, ins in enumerate(code):
        read = {ins[pos] for pos in operands.get(ins[0], (2, 3)) if ins[pos] >= 0}
        for pos in operands.get(ins[0], (2, 3)):
            if ins[pos] >= 0:
                ins[pos] = slot_of[ins[pos]]
        free += [slot_of.pop(v) for v in read if last[v] == j]
        if ins[1] >= 0:
            if free:
                s = min(free)
                free.remove(s)
            else:
                s, used = used, used + 1
            slot_of[ins[1]] = s
            ins[1] = s
    return used
