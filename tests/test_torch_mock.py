"""The port's vectorized MockProver (circuit/mock.py) and mini-AES mock
checks against the reference's, bit for bit: the cases of
tests/test_circuit_mock.py and tests/test_aes_mini.py on the port, and
for the same values matrix (seeded with numpy) the port's
``violation_counts`` and ``check`` reports equal the reference's
(satisfied, corrupted lookup, corrupted gate, corrupted copy; the K=6 toy
layouts, mini-AES and one k=17 AES layout).  Everything is integer: the
tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.circuit import mock as ref_mock
from halo2_aes_tpu.models import aes128 as ref_aes128
from halo2_aes_tpu.models import aes_mini as ref_mini
from halo2_aes_tpu_torch.circuit import mock, witness
from halo2_aes_tpu_torch.circuit.toys import TOYS
from halo2_aes_tpu_torch.models import aes128, aes_mini
from halo2_aes_tpu_torch.models import constants as C
from halo2_aes_tpu_torch.ops import aes

torch.set_num_threads(1)


def _values(layout, key, pts):
    pool = witness.build_pool(torch.as_tensor(key), torch.as_tensor(pts))
    return witness.assemble_values(layout, pool)


@pytest.fixture(scope="module")
def aes_k17():
    """One k=17 AES layout (1 set, 1 block) in both packages, with its
    satisfying values matrix (seeded key and plaintext)."""
    cfg = dict(k=17, n_sets=1, n_blocks=1)
    layout = aes128.compile_circuit(aes128.AesConfig(**cfg))
    ref_layout = ref_aes128.compile_circuit(ref_aes128.AesConfig(**cfg))
    rng = np.random.default_rng(0)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (1, 16), dtype=np.uint8)
    return layout, ref_layout, _values(layout, key, pts).numpy(), key, pts


def _same_report(layout, ref_layout, values_np):
    """The port's counts and report on ``values_np`` equal the
    reference's; returns the port's report."""
    vt = torch.from_numpy(values_np.astype(np.int32))
    vj = jnp.asarray(values_np.astype(np.uint32))
    counts = mock.violation_counts(layout, vt)
    ref_counts = ref_mock.violation_counts(ref_layout, vj)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in counts.values())
    assert {k: int(v) for k, v in counts.items()} == {
        k: int(v) for k, v in ref_counts.items()}
    report = mock.check(layout, vt)
    ref_report = ref_mock.check(ref_layout, vj)
    assert report.ok == ref_report.ok
    assert report.message() == ref_report.message()
    assert [n for n, _ in report.gate_failures] == [n for n, _ in ref_report.gate_failures]
    for (_, a), (_, b) in zip(report.gate_failures + report.lookup_failures,
                              ref_report.gate_failures + ref_report.lookup_failures):
        assert np.array_equal(a, b)
    assert np.array_equal(report.perm_failures, ref_report.perm_failures)
    return report


# (name, (column selector, row offset from block 0, xor mask))
def _cell(layout, which):
    cols = layout.meta["columns"]
    base = int(layout.meta["block_starts"][0])
    adv = cols.chip_sets[0].advice
    return {"lookup": (adv[2], base + 16, 1), "gate": (cols.words, 20, 0xFF),
            "copy": (adv[0], base, 1)}[which]


def test_aes_k17_satisfied_equals_reference(aes_k17):
    layout, ref_layout, vals, _, _ = aes_k17
    assert _same_report(layout, ref_layout, vals).ok
    mock.assert_satisfied(layout, torch.from_numpy(vals))
    assert mock.check(layout, vals).message() == "satisfied"      # numpy input


@pytest.mark.parametrize("which", ["lookup", "gate", "copy"])
def test_aes_k17_corrupted_equals_reference(aes_k17, which):
    layout, ref_layout, vals, _, _ = aes_k17
    col, row, flip = _cell(layout, which)
    bad = vals.copy()
    bad[col, row] ^= flip
    report = _same_report(layout, ref_layout, bad)
    assert not report.ok
    if which == "lookup":
        assert any("xor" in name for name, _ in report.lookup_failures)
        assert len(report.perm_failures) > 0
    elif which == "gate":
        assert any(name == "Equality RC" for name, _ in report.gate_failures)
    else:
        assert len(report.perm_failures) > 0
    with pytest.raises(AssertionError, match="circuit not satisfied"):
        mock.assert_satisfied(layout, torch.from_numpy(bad))


def test_out_of_range_cell_packs_like_reference(aes_k17):
    """A cell far outside the byte range (and a negative one) wraps in the
    32-bit packed lookup key exactly as the reference's uint32 does."""
    layout, ref_layout, vals, _, _ = aes_k17
    col, row, _ = _cell(layout, "lookup")
    for v in (0x12345, -7):
        bad = vals.astype(np.int32).copy()
        bad[col, row] = v
        assert not _same_report(layout, ref_layout, bad).ok


def test_ciphertext_in_witness(aes_k17):
    layout, _, vals, key, pts = aes_k17
    cols = layout.meta["columns"]
    base = layout.meta["block_starts"][0]
    a2 = cols.chip_sets[0].advice[2]
    expect = aes.encrypt(torch.as_tensor(pts), torch.as_tensor(key))[0]
    assert list(vals[a2, base + 1344:base + 1360]) == expect.tolist()


def test_sbox_255_path_satisfied():
    pts = np.zeros((1, 16), np.uint8)
    pts[0, 0] = 0xFF
    layout = aes128.compile_circuit(aes128.AesConfig(k=17, n_sets=1, n_blocks=1))
    vals = _values(layout, np.zeros(16, np.uint8), pts)
    mock.assert_satisfied(layout, vals)
    assert C.S_BOX[0xFF] == 0x16


def test_multi_set_and_tagged_circuits_satisfied():
    """More blocks than one set holds at k=17 (set 1 in use), plain and
    with tagged ops; a corrupted S-box output fails the tagged lookup."""
    key = np.zeros(16, np.uint8)
    pts = np.arange(1600, dtype=np.uint8).reshape(100, 16)
    for tagged in (False, True):
        layout = aes128.compile_circuit(aes128.AesConfig(
            k=17, n_sets=2, n_blocks=100, tagged_ops=tagged))
        vals = _values(layout, key, pts)
        counts = mock.violation_counts(layout, vals)
        assert all(int(v) == 0 for v in counts.values()), counts
    cols = layout.meta["columns"]
    base = int(layout.meta["block_starts"][0])
    bad = vals.clone()
    bad[cols.chip_sets[0].advice[1], base + 32] ^= 1
    with pytest.raises(AssertionError):
        mock.assert_satisfied(layout, bad)


def test_key_schedule_only_circuit():
    layout = aes128.compile_circuit(aes128.AesConfig(k=17, n_sets=1, n_blocks=0))
    vals = _values(layout, np.arange(16, dtype=np.uint8), np.zeros((0, 16), np.uint8))
    mock.assert_satisfied(layout, vals)


def test_expose_ciphertext_instance():
    layout = aes128.compile_circuit(aes128.AesConfig(
        k=17, n_sets=1, n_blocks=2, expose_ciphertext=True))
    key = np.zeros(16, np.uint8)
    pts = np.arange(32, dtype=np.uint8).reshape(2, 16)
    vals = _values(layout, key, pts)
    mock.assert_satisfied(layout, vals)
    inst = layout.meta["columns"].instance
    expect = aes.encrypt(torch.as_tensor(pts), torch.as_tensor(key)).reshape(-1)
    assert vals[inst, :32].tolist() == expect.tolist()
    bad = vals.clone()
    bad[inst, 3] ^= 1
    assert len(mock.check(layout, bad).perm_failures) > 0


@pytest.mark.parametrize("name", sorted(TOYS))
def test_toy_layouts_equal_reference(name):
    """The K=6 toys: satisfied, and one changed cell, in both packages."""
    build = TOYS[name][0]
    layout, values = build()
    ref_layout, _ = build(ref_ir)
    assert _same_report(layout, ref_layout, values).ok
    rng = np.random.default_rng(5)
    for _ in range(4):
        bad = values.copy()
        # an advice/instance column; the one-column toys' last column is
        # their advice column
        col = min(int(rng.integers(4, 7)), values.shape[0] - 1)
        row = int(rng.integers(0, 12))
        bad[col, row] = (int(bad[col, row]) + 1 + int(rng.integers(0, 200))) % 256
        _same_report(layout, ref_layout, bad)


def test_mini_mock_satisfied_and_negative():
    """tests/test_aes_mini.py on the port, counts equal to the reference's."""
    cfg = dict(k=11, n_sets=2, n_blocks=2)
    layout = aes_mini.compile_mini_circuit(aes_mini.MiniAesConfig(**cfg))
    ref_layout = ref_mini.compile_mini_circuit(ref_mini.MiniAesConfig(**cfg))
    rng = np.random.default_rng(4)
    key = torch.as_tensor(rng.integers(0, 16, 16, dtype=np.uint8))
    pts = torch.as_tensor(rng.integers(0, 16, (2, 16), dtype=np.uint8))
    pool = aes_mini.build_pool_mini(key, pts)
    values = witness.assemble_values(layout, pool)
    assert _same_report(layout, ref_layout, values.numpy()).ok
    bad = pool.clone()
    bad[400] ^= 1
    values_bad = witness.assemble_values(layout, bad)
    counts = mock.violation_counts(layout, values_bad)
    assert sum(int(v) for v in counts.values()) > 0
    assert not _same_report(layout, ref_layout, values_bad.numpy()).ok


def test_const_asserts_small():
    assert mock.Int32Algebra.const(5) == 5
    with pytest.raises(AssertionError, match="small constants"):
        mock.Int32Algebra.const(1 << 15)


def test_sorted_table_cached_per_device(aes_k17):
    layout = aes_k17[0]
    a = mock._sorted_table(layout, 0, layout.usable_rows, torch.device("cpu"))
    b = mock._sorted_table(layout, 0, layout.usable_rows, torch.device("cpu"))
    assert a is b and a.dtype == torch.int64
    assert bool((a[1:] >= a[:-1]).all())


def test_layout_tables_moved_once_per_device(aes_k17):
    """``assemble_values`` keeps the layout's gather index, mask and fixed
    values on the device (they were re-uploaded on every call before)."""
    layout, _, vals, key, pts = aes_k17
    again = _values(layout, key, pts)
    assert np.array_equal(again.numpy(), vals)
    tables = layout.meta["_witness_tables_device"]["cpu"]
    assert witness._layout_tables(layout, torch.device("cpu")) is tables
    assert tables[0].dtype == torch.int32 and tables[2].dtype == torch.int32
