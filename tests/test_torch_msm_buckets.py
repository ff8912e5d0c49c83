"""K7's plain version (``ops/cuda_msm.py``): the MSM as Pippenger bucket
sums, one bucket set a commitment over its pre-scaled windows (one a
window without tables), against the reference's host MSMs
(``halo2_aes_tpu.ops.curve.host_msm`` in every case;
``halo2_aes_tpu.ops.msm.msm_host``, a double-and-add a point, at 64
points) and the port's own sorted-prefix tree
(``msm.msm_many_tree``): with and without tables, one
to eight commitments a pass, all-zero scalars, every digit equal (one
full bucket), a poly shorter than the SRS, 2^9 to 2^12 points, the
tableless switch lowered; the counting sort's bucket order; and the prove paths
(``commit_many``, ``SRS.commit``) on the CPU take the bucket route and
never the tree, with the golden bytes."""

import json
import pathlib
import random

import numpy as np
import pytest
import torch

from halo2_aes_tpu.ops import curve as JC
from halo2_aes_tpu.ops import msm as JM
from halo2_aes_tpu_torch.backend import keygen, prover, srs
from halo2_aes_tpu_torch.circuit.toys import GOLDEN_PROOFS, K, TOYS
from halo2_aes_tpu_torch.ops import cuda_curve as CC
from halo2_aes_tpu_torch.ops import cuda_msm as CM
from halo2_aes_tpu_torch.ops import curve as C
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as M
from halo2_aes_tpu_torch.utils import timers

torch.set_num_threads(2)
FR = F.FR
G = (C.G1_X, C.G1_Y)
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())


@pytest.fixture(scope="module")
def inputs():
    """2^12 points P_i = (i + 1) Q, 8 x 2^12 random scalars, and the
    window tables T[w][i] = 2^(cw) P_i of c = 6 (the default window of
    every size used here) made on the host: row i of window w is
    (i + 1) 2^(cw) Q."""
    rnd = random.Random(20)
    c = M.default_window(1 << 12)
    assert {M.default_window(1 << lg) for lg in (6, 9, 10, 11, 12)} == {c}
    q = C.py_mul(G, rnd.randrange(1, FR.modulus))
    rows = []
    for w in range(CM.windows(c)):
        acc = base = C.py_mul(q, 1 << (c * w))
        rows.append(acc)
        for _ in range((1 << 12) - 1):
            acc = C.py_add(acc, base)
            rows.append(acc)
    pts = rows[:1 << 12]
    tables = torch.cat(C.affine_from_ints(rows), 1).reshape(-1, 1 << 12, 2 * F.LIMBS)
    sc = [rnd.randrange(FR.modulus) for _ in range(8 << 12)]
    return pts, sc, c, tables


def _tables(inputs, lg):
    """(points, window, tables) of the first 2^lg points."""
    pts, _, c, tables = inputs
    n = 1 << lg
    return (C.affine_from_ints(pts[:n]), c,
            tables[:, :n].reshape(-1, 2 * F.LIMBS).contiguous())


def _limbs(xs):
    return F.limbs(F.ints_to_limbs_fast(xs), "cpu")


def _ref(points, scalars):
    """sum_i scalars[i] points[i] by the reference's host MSM."""
    return JC.host_msm(points, scalars)


@pytest.mark.parametrize("lg", [9, 10, 11, 12])
def test_tables_equal_host(inputs, lg):
    pts, sc = inputs[:2]
    n = 1 << lg
    xy, c, tables = _tables(inputs, lg)
    got = C.to_affine_host(M.msm(xy, _limbs(sc[:n]), c=c, tables=tables))[0]
    assert got == _ref(pts[:n], sc[:n])


@pytest.mark.parametrize("tabled", [True, False])
def test_equals_reference_host_msm(inputs, tabled):
    """64 points (the default window is the same c = 6)."""
    pts, sc = inputs[:2]
    xy, c, tables = _tables(inputs, 6)
    got = M.msm(xy, _limbs(sc[:64]), c=c, tables=tables if tabled else None)
    assert C.to_affine_host(got)[0] == JM.msm_host(pts[:64], sc[:64])


@pytest.mark.parametrize("lg", [9, 11])
def test_without_tables_equal_host(inputs, lg):
    pts, sc = inputs[:2]
    n = 1 << lg
    got = C.to_affine_host(M.msm(C.affine_from_ints(pts[:n]), _limbs(sc[:n])))[0]
    assert got == _ref(pts[:n], sc[:n])


def test_ragged_n_without_tables(inputs):
    """No padding: 300 points, a window of 7."""
    pts, sc = inputs[:2]
    got = C.to_affine_host(M.msm(C.affine_from_ints(pts[:300]), _limbs(sc[:300]),
                                 c=7))[0]
    assert got == _ref(pts[:300], sc[:300])


@pytest.mark.parametrize("count", [1, 2, 8])
def test_msm_many_equals_host_and_tree(inputs, count):
    pts, sc = inputs[:2]
    n = 1 << 9
    xy, c, tables = _tables(inputs, 9)
    flat = _limbs(sc[:count * n])
    got = C.to_affine_host(M.msm_many(xy, flat, count, c, tables))
    assert got == [_ref(pts[:n], sc[i * n:(i + 1) * n]) for i in range(count)]
    if count == 2:
        assert got == C.to_affine_host(M.msm_many_tree(xy, flat, count, c, tables))


@pytest.mark.parametrize("tabled", [True, False])
def test_all_zero_scalars_give_identity(inputs, tabled):
    xy, c, tables = _tables(inputs, 9)
    zero = torch.zeros((1 << 9, F.LIMBS), dtype=torch.int32)
    got = M.msm(xy, zero, c=c, tables=tables if tabled else None)
    assert C.to_affine_host(got) == [None]


@pytest.mark.parametrize("tabled", [True, False])
def test_every_digit_equal(inputs, tabled):
    """Every window digit of every scalar 5 below the top window: one
    full bucket a set, cut by every slice."""
    pts = inputs[0]
    n = 1 << 8
    xy, c, tables = _tables(inputs, 8)
    s = sum(5 << (c * w) for w in range(CM.windows(c) - 1))
    assert s < FR.modulus
    scal = _limbs([s] * n)
    digs = CM.digits_plain(scal, 1, c)[0]
    assert set(digs[:-1].reshape(-1).tolist()) == {5} and not digs[-1].any()
    got = CM.bucket_sums(xy, scal, 1, c, tables if tabled else None, slice=100)
    if not tabled:
        assert C.to_affine_host(got)[1:-1] == C.to_affine_host(got)[:-2]
        got = M.msm(xy, scal, c=c)
    assert C.to_affine_host(got)[0] == _ref(pts[:n], [s] * n)


def test_short_poly(inputs):
    """Scalars past a poly's length are zero (``SRS.commit`` pads them)
    and go into no bucket."""
    pts, sc = inputs[:2]
    xy, c, tables = _tables(inputs, 10)
    scal = torch.cat([_limbs(sc[:700]), torch.zeros((324, F.LIMBS), dtype=torch.int32)])
    got = C.to_affine_host(M.msm(xy, scal, c=c, tables=tables))[0]
    assert got == _ref(pts[:700], sc[:700])


def test_lowered_tableless_switch(monkeypatch):
    """With ``TABLELESS_MIN_N`` at the SRS's size there are no tables and
    ``commit_many`` runs one set a window, one poly a pass."""
    monkeypatch.setattr(M, "TABLELESS_MIN_N", 1 << K)
    monkeypatch.setattr(keygen, "HOST_MSM_MAX_N", 0)
    bare = srs.setup(K, "cpu", cache_dir=None)
    bare.warm_tables()
    assert bare._msm_tables is None
    rng = np.random.default_rng(6)
    polys = [F.encode(FR, [int(v) for v in rng.integers(0, 1 << 62, 1 << K)], "cpu")
             for _ in range(2)]
    points = keygen._srs_host_points(bare)
    with timers.recording():
        got = keygen.commit_many(bare, polys)
    spans = [r for r in timers.spans() if r.name == "msm.buckets"]
    timers.clear()
    assert got == [_ref(points, FR.decode(p)) for p in polys]
    c, n = M.default_window(1 << K), 1 << K
    assert [r.attrs for r in spans] == [dict(
        fused=0, sets=CM.windows(c), buckets=1 << c, rows=CM.windows(c) * n,
        windows=CM.windows(c), points=n)] * 2


def test_sort_lists_each_bucket_ascending():
    """The counting sort's lists: bucket g = s*2^c + d holds the rows of
    set s with digit d != 0 in ascending order, the buckets in order."""
    rng = np.random.default_rng(7)
    c, sets, R = 4, 3, 500
    digs = torch.from_numpy(rng.integers(0, 1 << c, (sets, R)))
    digs[1, 100:300] = 9                       # one long bucket
    rows, starts = CM.sort_plain(digs, c)
    want, bounds = [], [0]
    for s in range(sets):
        for d in range(1 << c):
            want += [r for r in range(R) if d and int(digs[s, r]) == d]
            bounds.append(len(want))
    assert starts.dtype == rows.dtype == torch.int32
    assert starts.tolist() == bounds
    assert rows[:len(want)].tolist() == want


@pytest.mark.parametrize("slice", [2, 37, 300])
def test_slices_change_no_affine_sum(inputs, slice):
    """Any slice length gives the same sum; a bucket cut by many slices
    is merged in slice order."""
    pts, sc = inputs[:2]
    n = 1 << 9
    xy, c, tables = _tables(inputs, 9)
    got = CM.bucket_sums(xy, _limbs(sc[:n]), 1, c, tables, slice=slice)
    assert C.to_affine_host(got)[0] == _ref(pts[:n], sc[:n])


def test_mixed_addition_equals_complete_addition(inputs):
    pts = inputs[0]
    p = CC.double_n_plain(C.affine_to_proj(C.affine_from_ints(pts[:16])), 3)
    q = C.affine_from_ints(pts[16:32])
    got = C.to_affine_host(CM.madd_plain(p, *q))
    assert got == C.to_affine_host(CC.add_plain(p, C.affine_to_proj(q)))
    assert C.to_affine_host(CM.madd_plain(C.identity((16,)), *q)) == pts[16:32]


@pytest.mark.parametrize("c", [2, 3, 6, 7])
def test_reduce_is_the_weighted_bucket_sum(inputs, c):
    pts = inputs[0]
    sets, B = 2, 1 << c
    rnd = random.Random(c)
    ks = [rnd.randrange(4) for _ in range(sets * B)]
    bucket = [C.py_mul(pts[i], k) if k else None for i, k in enumerate(ks)]
    tensors = C.affine_to_proj(C.affine_from_ints(
        [p if p is not None else G for p in bucket]))
    empty = torch.tensor([p is None for p in bucket])[:, None]
    ident = C.identity((sets * B,))
    tensors = [torch.where(empty, i, t) for i, t in zip(ident, tensors)]
    got = C.to_affine_host(CM.reduce_plain(tensors, sets, c))
    for s in range(sets):
        want = None
        for b in range(B):
            if bucket[s * B + b] is not None:
                want = C.py_add(want, C.py_mul(bucket[s * B + b], b))
        assert got[s] == want


@pytest.mark.parametrize("name", ["toy", "tagged_gwc"])
def test_cpu_prove_commits_through_buckets(name, monkeypatch):
    """A golden K=6 prove with the host MSM's toy threshold lowered:
    keygen's and the prover's commitments (``commit_many``,
    ``SRS.commit``) take the bucket route, never the tree; the bytes
    are the golden ones."""
    def refuse(*a, **k):
        raise AssertionError("the sorted-prefix tree ran")

    monkeypatch.setattr(M, "_window_sums", refuse)
    monkeypatch.setattr(keygen, "HOST_MSM_MAX_N", 0)
    passes = []
    real = CM.bucket_sums
    monkeypatch.setattr(CM, "bucket_sums",
                        lambda *a, **k: passes.append(a[2]) or real(*a, **k))
    toy, opts = GOLDEN_PROOFS[name]
    build, seed, _ = TOYS[toy]
    layout, values = build()
    pk = keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None))
    at_keygen = len(passes)
    assert prover.prove(pk, values, seed=seed, **opts).hex() == GOLDEN[name]["proof"]
    assert at_keygen >= 2 and len(passes) > at_keygen
    assert max(passes) > 1 and min(passes) == 1     # batches and SRS.commit
