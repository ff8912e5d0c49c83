"""Vectorized satisfiability checker — the MockProver equivalent (port of
``circuit/mock.py``).

Where halo2's MockProver walks every row of every constraint in Rust
loops (reference src/aes128.rs:417-418 usage; SURVEY.md section 3.2),
this evaluates:
  * every gate as one vectorized int32 polynomial over all rows,
  * every lookup as packed-key membership (sort + searchsorted),
  * every copy constraint as one gather-compare,
all on the device of the values matrix.

int32 is exact here by construction: all circuit values are < 2^16 and
expression degree <= 2 with 0/1 selectors, so no intermediate exceeds
int32 range (asserted).  Failure reports carry constraint names and the
first failing rows, matching MockProver's dev ergonomics.

The packed lookup keys are 32-bit words held in int64 (the CPU has no
shift or compare on ``torch.uint32``); they are masked to 32 bits after
every step, so a corrupted, out-of-range cell packs to the same key as
in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from halo2_aes_tpu_torch.circuit.ir import CompiledCircuit

_U32 = 0xFFFFFFFF


class Int32Algebra:
    @staticmethod
    def const(v: int):
        assert 0 <= v < (1 << 15), "mock algebra requires small constants"
        return v

    add = staticmethod(lambda a, b: a + b)
    mul = staticmethod(lambda a, b: a * b)
    neg = staticmethod(lambda a: -a)


def _as_values(values) -> torch.Tensor:
    """The (num_columns, n) values matrix as an int32 tensor, on its own
    device when it already is a tensor."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.int32)
    return torch.from_numpy(np.asarray(values).astype(np.int32))


def _getter(values):
    def get(col, rot):
        v = values[col]
        return torch.roll(v, -rot) if rot else v

    return get


def _pack(components):
    """Pack byte-ranged components into one 32-bit key (msb-first), held
    in int64."""
    key = torch.zeros_like(components[0], dtype=torch.int64)
    for c in components:
        key = ((key << 8) | (c.to(torch.int64) & _U32)) & _U32
    return key


def _sorted_table(layout: CompiledCircuit, lk_index: int, usable: int, device):
    """Pre-sorted packed table keys for lookup ``lk_index`` on ``device``.

    Computed once on the host in numpy and cached on the layout (the
    table columns are fixed at layout time), then moved to each device
    once."""
    cache = layout.meta.setdefault("_sorted_tables", {})
    if lk_index not in cache:
        lk = layout.cs.lookups[lk_index]
        key = np.zeros(usable, dtype=np.uint32)
        for _, c in lk.pairs:
            key = (key << 8) | layout.fixed[c][:usable].astype(np.uint32)
        cache[lk_index] = np.sort(key)
    on_device = layout.meta.setdefault("_sorted_tables_device", {})
    dkey = (lk_index, str(device))
    if dkey not in on_device:
        on_device[dkey] = torch.from_numpy(
            cache[lk_index].astype(np.int64)).to(device)
    return on_device[dkey]


def _copy_pairs(layout: CompiledCircuit, device):
    """The layout's copy pairs as an int64 index tensor on ``device``."""
    on_device = layout.meta.setdefault("_copy_pairs_device", {})
    if str(device) not in on_device:
        on_device[str(device)] = torch.from_numpy(
            np.asarray(layout.copy_pairs).astype(np.int64)).to(device)
    return on_device[str(device)]


@dataclass
class MockReport:
    gate_failures: list = dfield(default_factory=list)      # (name, rows)
    lookup_failures: list = dfield(default_factory=list)    # (name, rows)
    perm_failures: np.ndarray = None                        # failing pair idx

    @property
    def ok(self) -> bool:
        return (
            not self.gate_failures
            and not self.lookup_failures
            and (self.perm_failures is None or len(self.perm_failures) == 0)
        )

    def message(self) -> str:
        if self.ok:
            return "satisfied"
        lines = []
        for name, rows in self.gate_failures:
            lines.append(f"gate '{name}' violated at rows {rows[:8].tolist()}"
                         f" ({len(rows)} rows)")
        for name, rows in self.lookup_failures:
            lines.append(f"lookup '{name}' input not in table at rows "
                         f"{rows[:8].tolist()} ({len(rows)} rows)")
        if self.perm_failures is not None and len(self.perm_failures):
            lines.append(f"{len(self.perm_failures)} copy constraints violated "
                         f"(first pair indices {self.perm_failures[:8].tolist()})")
        return "; ".join(lines)


def _lookup_ok(layout, i, lk, get, usable, device):
    """Per usable row: is lookup ``i``'s packed input a table key."""
    inputs = _pack([e.eval(Int32Algebra, get) for e, _ in lk.pairs])[:usable]
    table_sorted = _sorted_table(layout, i, usable, device)
    pos = torch.searchsorted(table_sorted, inputs).clamp(0, usable - 1)
    return table_sorted[pos] == inputs


def _copy_sides(layout, values):
    cp = _copy_pairs(layout, values.device)
    return values[cp[:, 0], cp[:, 1]], values[cp[:, 2], cp[:, 3]]


def violation_counts(layout: CompiledCircuit, values):
    """Total violation count per constraint class.

    Returns dict of 0-dim int32 tensors {gates, lookups, copies} on the
    values' device; all zero iff the circuit is satisfied.  Unlike
    :func:`check` this extracts no row indices, so nothing is read back
    to the host."""
    values = _as_values(values)
    dev = values.device
    usable = layout.usable_rows
    get = _getter(values)
    row_ok = torch.arange(layout.n, device=dev) < usable

    gate_bad = torch.zeros((), dtype=torch.int32, device=dev)
    for _, gate in layout.cs.gates:
        out = gate.eval(Int32Algebra, get)
        gate_bad = gate_bad + ((out != 0) & row_ok).sum(dtype=torch.int32)

    lookup_bad = torch.zeros((), dtype=torch.int32, device=dev)
    for i, lk in enumerate(layout.cs.lookups):
        ok = _lookup_ok(layout, i, lk, get, usable, dev)
        lookup_bad = lookup_bad + (~ok).sum(dtype=torch.int32)

    va, vb = _copy_sides(layout, values)
    copy_bad = (va != vb).sum(dtype=torch.int32)
    return {"gates": gate_bad, "lookups": lookup_bad, "copies": copy_bad}


def check(layout: CompiledCircuit, values) -> MockReport:
    """values: int (num_columns, n) from witness.assemble_values (tensor
    or numpy)."""
    values = _as_values(values)
    dev = values.device
    usable = layout.usable_rows
    get = _getter(values)
    report = MockReport()
    row_ok = torch.arange(layout.n, device=dev) < usable

    for name, gate in layout.cs.gates:
        out = gate.eval(Int32Algebra, get)
        bad = torch.nonzero((out != 0) & row_ok)[:, 0].cpu().numpy()
        if len(bad):
            report.gate_failures.append((name, bad))

    for i, lk in enumerate(layout.cs.lookups):
        ok = _lookup_ok(layout, i, lk, get, usable, dev)
        bad = torch.nonzero(~ok)[:, 0].cpu().numpy()
        if len(bad):
            report.lookup_failures.append((lk.name, bad))

    va, vb = _copy_sides(layout, values)
    report.perm_failures = torch.nonzero(va != vb)[:, 0].cpu().numpy()
    return report


def assert_satisfied(layout: CompiledCircuit, values):
    report = check(layout, values)
    if not report.ok:
        raise AssertionError(f"circuit not satisfied: {report.message()}")
