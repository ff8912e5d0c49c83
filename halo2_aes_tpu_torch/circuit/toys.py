"""The two K=6 toy circuits whose proofs are the golden fixtures.

Each circuit function takes the ``circuit.ir`` module to build with, so the same
definition yields the reference package's circuit (for the fixture
script) and this package's circuit (for the tests and the chip smoke).
They match the toy circuits of ``tests/test_prove_verify.py``.
"""

from __future__ import annotations

import numpy as np

K = 6


def toy_circuit(ir=None):
    """q_add * (a0 + a1 - a2) gate; (a0, a1) lookup into (i, 7i mod 256);
    one copy constraint a2[2] == a0[5].  Returns (layout, values)."""
    if ir is None:
        from halo2_aes_tpu_torch.circuit import ir
    n = 1 << K
    cs = ir.ConstraintSystem()
    q_add = cs.fixed_column("q_add")
    q_lk = cs.fixed_column("q_lk")
    t_in = cs.fixed_column("t_in")
    t_out = cs.fixed_column("t_out")
    a0 = cs.advice_column("a0")
    a1 = cs.advice_column("a1")
    a2 = cs.advice_column("a2")
    cs.create_gate("add", ir.Prod(ir.Ref(q_add), ir.Sum(
        ir.Sum(ir.Ref(a0), ir.Ref(a1)), ir.Neg(ir.Ref(a2)))))
    cs.add_lookup("mul7", [(ir.Prod(ir.Ref(q_lk), ir.Ref(a0)), t_in),
                           (ir.Prod(ir.Ref(q_lk), ir.Ref(a1)), t_out)])
    for c in (a0, a1, a2):
        cs.enable_equality(c)

    fixed = np.zeros((7, n), dtype=np.uint32)
    fixed[t_in, :32] = np.arange(32)
    fixed[t_out, :32] = (np.arange(32) * 7) % 256
    values = np.zeros((7, n), dtype=np.uint32)
    for row, x in [(0, 3), (1, 5), (10, 31)]:
        fixed[q_lk, row] = 1
        values[a0, row] = x
        values[a1, row] = (x * 7) % 256
    fixed[q_add, 2] = 1
    values[a0, 2], values[a1, 2], values[a2, 2] = 2, 3, 5
    values[a0, 5] = 5
    layout = ir.CompiledCircuit(
        k=K, cs=cs, fixed=fixed,
        witness_map=np.full((7, n), -1, np.int32),
        copy_pairs=np.array([[a2, 2, a0, 5]], dtype=np.int32), pool_len=0)
    return layout, values + fixed


def tagged_toy_circuit(ir=None):
    """A lookup whose tag comes from a fixed column: tag 1 -> y = 2x,
    tag 2 -> y = 3x (x < 16).  Returns (layout, values)."""
    if ir is None:
        from halo2_aes_tpu_torch.circuit import ir
    n = 1 << K
    cs = ir.ConstraintSystem()
    q = cs.fixed_column("q_op")
    tag_col = cs.fixed_column("op_tag")
    t_tag = cs.fixed_column("t_tag")
    t_in = cs.fixed_column("t_in")
    t_out = cs.fixed_column("t_out")
    a0 = cs.advice_column("a0")
    a1 = cs.advice_column("a1")
    cs.add_lookup("tagged op", [(ir.Prod(ir.Ref(q), ir.Ref(tag_col)), t_tag),
                                (ir.Prod(ir.Ref(q), ir.Ref(a0)), t_in),
                                (ir.Prod(ir.Ref(q), ir.Ref(a1)), t_out)])
    cs.enable_equality(a0)

    fixed = np.zeros((7, n), dtype=np.uint32)
    fixed[t_tag, 0:16], fixed[t_in, 0:16] = 1, np.arange(16)
    fixed[t_out, 0:16] = np.arange(16) * 2
    fixed[t_tag, 16:32], fixed[t_in, 16:32] = 2, np.arange(16)
    fixed[t_out, 16:32] = (np.arange(16) * 3) % 256
    values = np.zeros((7, n), dtype=np.uint32)
    for row, tag, x in [(0, 1, 5), (1, 2, 5), (2, 1, 15)]:
        fixed[q, row] = 1
        fixed[tag_col, row] = tag
        values[a0, row] = x
        values[a1, row] = (x * 2 if tag == 1 else x * 3) % 256
    layout = ir.CompiledCircuit(
        k=K, cs=cs, fixed=fixed,
        witness_map=np.full((7, n), -1, np.int32),
        copy_pairs=np.zeros((0, 4), np.int32), pool_len=0)
    return layout, values + fixed


# name -> (circuit function, prove seed); the seeds are those of the reference's
# own round-trip tests
TOYS = {"toy": (toy_circuit, 42), "tagged": (tagged_toy_circuit, 11)}
