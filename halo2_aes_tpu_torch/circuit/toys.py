"""The K=6 toy circuits whose proofs are the golden fixtures.

Each circuit function takes the ``circuit.ir`` module to build with, so the same
definition yields the reference package's circuit (for the fixture
script) and this package's circuit (for the tests and the chip smoke).
The first two match the toy circuits of ``tests/test_prove_verify.py``;
the third adds an instance column; the last two have one advice column
(every advice stack of their proves holds one poly), with and without a
lookup.
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


PUBLIC = [6, 5, 9]      # the instance toy's public values, rows 0..2


def instance_toy_circuit(ir=None):
    """An instance column ``pub`` in a gate and in a copy constraint:
    q_mul * (a0 * a1 - pub) on rows 0 and 2, pub[1] == a0[4], and the
    (a0, a1) lookup into (i, 7i mod 256) on rows 6 and 7.  The public
    values pub[0:3] are ``PUBLIC``.  Returns (layout, values)."""
    if ir is None:
        from halo2_aes_tpu_torch.circuit import ir
    n = 1 << K
    cs = ir.ConstraintSystem()
    q_mul = cs.fixed_column("q_mul")
    q_lk = cs.fixed_column("q_lk")
    t_in = cs.fixed_column("t_in")
    t_out = cs.fixed_column("t_out")
    a0 = cs.advice_column("a0")
    a1 = cs.advice_column("a1")
    pub = cs.instance_column("pub")
    cs.create_gate("mul", ir.Prod(ir.Ref(q_mul), ir.Sum(
        ir.Prod(ir.Ref(a0), ir.Ref(a1)), ir.Neg(ir.Ref(pub)))))
    cs.add_lookup("mul7", [(ir.Prod(ir.Ref(q_lk), ir.Ref(a0)), t_in),
                           (ir.Prod(ir.Ref(q_lk), ir.Ref(a1)), t_out)])
    cs.enable_equality(a0)
    cs.enable_equality(pub)

    fixed = np.zeros((7, n), dtype=np.uint32)
    fixed[t_in, :32] = np.arange(32)
    fixed[t_out, :32] = (np.arange(32) * 7) % 256
    values = np.zeros((7, n), dtype=np.uint32)
    witness_map = np.full((7, n), -1, np.int32)
    values[pub, :3] = PUBLIC
    witness_map[pub, :3] = np.arange(3)           # the rows the proof exposes
    fixed[q_mul, [0, 2]] = 1
    values[a0, 0], values[a1, 0] = 2, 3           # 2 * 3 == pub[0]
    values[a0, 2], values[a1, 2] = 3, 3           # 3 * 3 == pub[2]
    values[a0, 4] = 5                             # == pub[1]
    for row, x in [(6, 4), (7, 10)]:
        fixed[q_lk, row] = 1
        values[a0, row] = x
        values[a1, row] = (x * 7) % 256
    layout = ir.CompiledCircuit(
        k=K, cs=cs, fixed=fixed, witness_map=witness_map,
        copy_pairs=np.array([[pub, 1, a0, 4]], dtype=np.int32), pool_len=0)
    return layout, values + fixed


def onecol_circuit(ir=None, lookup: bool = False):
    """ONE advice column ``a``: the gate q * (a * a - a[+1]) on rows 0
    and 2, the copy a[2] == a[5] and, with ``lookup``, q_lk * a into the
    range table 0..31 on rows 0..3.  Every advice stack of its prove
    holds one poly.  Returns (layout, values)."""
    if ir is None:
        from halo2_aes_tpu_torch.circuit import ir
    n = 1 << K
    cs = ir.ConstraintSystem()
    q = cs.fixed_column("q_sq")
    if lookup:
        q_lk = cs.fixed_column("q_lk")
        t_in = cs.fixed_column("t_in")
    a = cs.advice_column("a")
    cs.create_gate("square", ir.Prod(ir.Ref(q), ir.Sum(
        ir.Prod(ir.Ref(a), ir.Ref(a)), ir.Neg(ir.Ref(a, 1)))))
    cs.enable_equality(a)
    cols = 4 if lookup else 2
    fixed = np.zeros((cols, n), dtype=np.uint32)
    values = np.zeros((cols, n), dtype=np.uint32)
    fixed[q, [0, 2]] = 1
    values[a, :6] = [3, 9, 4, 16, 0, 4]
    if lookup:
        cs.add_lookup("range", [(ir.Prod(ir.Ref(q_lk), ir.Ref(a)), t_in)])
        fixed[t_in, :32] = np.arange(32)
        fixed[q_lk, :4] = 1
    layout = ir.CompiledCircuit(
        k=K, cs=cs, fixed=fixed, witness_map=np.full((cols, n), -1, np.int32),
        copy_pairs=np.array([[a, 2, a, 5]], dtype=np.int32), pool_len=0)
    return layout, values + fixed


def onecol_lookup_circuit(ir=None):
    """``onecol_circuit`` with its range lookup."""
    return onecol_circuit(ir, lookup=True)


# name -> (circuit function, prove seed, public instances); the first two
# seeds are those of the reference's own round-trip tests
TOYS = {"toy": (toy_circuit, 42, []), "tagged": (tagged_toy_circuit, 11, []),
        "instance": (instance_toy_circuit, 7, [PUBLIC]),
        "onecol": (onecol_circuit, 17, []),
        "onecol_lookup": (onecol_lookup_circuit, 19, [])}

# golden proof name -> (toy, prove options); the toys' own names prove
# with the defaults (SHPLONK, field-ordered lookups)
GOLDEN_PROOFS = {
    **{name: (name, {}) for name in TOYS},
    "toy_gwc": ("toy", {"multiopen": "gwc"}),
    "tagged_gwc": ("tagged", {"multiopen": "gwc"}),
    "toy_packed": ("toy", {"lookup_sort": "packed"}),
    "tagged_packed": ("tagged", {"lookup_sort": "packed"}),
    "onecol_gwc": ("onecol", {"multiopen": "gwc"}),
    "onecol_lookup_gwc": ("onecol_lookup", {"multiopen": "gwc"}),
}

# golden IPA proof name -> toy: proved with ``multiopen="ipa"`` and the
# toy's seed against the transparent basis ``ipa.setup(K)`` (the entries
# above are proved against the dev KZG SRS)
GOLDEN_IPA_PROOFS = {"toy_ipa": "toy", "tagged_ipa": "tagged"}

# the mini-AES golden proof (``testdata/golden_mini_k11.json``): the
# k=11, 2-set, 2-block GF(2^4) circuit of ``models/aes_mini.py``, key and
# plaintext nibbles from numpy's default_rng(MINI_DATA_SEED), SHPLONK
# against the dev KZG SRS, blinding seed MINI_PROVE_SEED
MINI_CONFIG = dict(k=11, n_sets=2, n_blocks=2)
MINI_DATA_SEED = 4
MINI_PROVE_SEED = 13


def mini_inputs():
    """(key uint8[16], plaintexts uint8[2, 16]) nibble values of the
    mini-AES golden proof."""
    rng = np.random.default_rng(MINI_DATA_SEED)
    return (rng.integers(0, 16, 16, dtype=np.uint8),
            rng.integers(0, 16, (MINI_CONFIG["n_blocks"], 16), dtype=np.uint8))
