"""The port's G1 arithmetic (plain PyTorch on CPU) equals the
reference's: complete add and double on the identity, doubling and
negation cases (projective outputs bit for bit), window tables, and MSMs
at n = 2^8 .. 2^10 (affine results)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.ops import curve as JC
from halo2_aes_tpu.ops import msm as JM
from halo2_aes_tpu_torch.ops import cuda_curve
from halo2_aes_tpu_torch.ops import curve as C
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as M

torch.set_num_threads(1)
G = (C.G1_X, C.G1_Y)


@pytest.fixture(scope="module")
def points():
    rnd = random.Random(5)
    return [C.py_mul(G, rnd.randrange(1, 1 << 64)) for _ in range(16)]


def _proj(pts, cls):
    xs = F.FQ.encode([p[0] for p in pts])
    ys = F.FQ.encode([p[1] for p in pts])
    one = np.broadcast_to(F.FQ.one_mont, xs.shape)
    if cls == "port":
        return tuple(F.limbs(v, "cpu") for v in (xs, ys, one))
    return tuple(jnp.asarray(v) for v in (xs, ys, one))


def _cases(points):
    """(p, q) rows: generic, P + P, P + (-P), identity + P, P + identity."""
    p = list(points)
    q = list(points[1:]) + [points[0]]
    q[1] = p[1]                                              # doubling
    q[2] = (p[2][0], (-p[2][1]) % F.FQ.modulus)              # negation
    return p, q


def _set_identity(coords, row):
    x, y, z = (c.clone() if isinstance(c, torch.Tensor) else np.array(c)
               for c in coords)
    x[row] = 0
    z[row] = 0
    y[row] = F.limbs(F.FQ.one_mont, "cpu") if isinstance(y, torch.Tensor) \
        else F.FQ.one_mont
    return x, y, z


def _eq(t, j):
    return all(np.array_equal(a.numpy().astype(np.uint32), np.asarray(b))
               for a, b in zip(t, j))


def test_complete_add_cases(points):
    p_pts, q_pts = _cases(points)
    tp, tq = _proj(p_pts, "port"), _proj(q_pts, "port")
    jp, jq = _proj(p_pts, "ref"), _proj(q_pts, "ref")
    tp, jp = _set_identity(tp, 3), _set_identity(jp, 3)
    tq, jq = _set_identity(tq, 4), _set_identity(jq, 4)
    got = C.add(tp, tq)
    assert _eq(got, JC.add(tuple(map(jnp.asarray, jp)),
                           tuple(map(jnp.asarray, jq))))
    aff = C.to_affine_host(got)
    assert aff[1] == C.py_add(p_pts[1], p_pts[1])
    assert aff[2] is None
    assert aff[3] == q_pts[3] and aff[4] == p_pts[4]


def test_double_and_identity(points):
    tp, jp = _proj(points, "port"), _proj(points, "ref")
    tp, jp = _set_identity(tp, 0), _set_identity(jp, 0)
    got = C.double(tp)
    assert _eq(got, JC.double(tuple(map(jnp.asarray, jp))))
    aff = C.to_affine_host(got)
    assert aff[0] is None and aff[5] == C.py_add(points[5], points[5])


def test_plain_add_is_the_cpu_route(points):
    tp = _proj(points, "port")
    assert _eq(cuda_curve.add(tp, tp), cuda_curve.add_plain(tp, tp))


def test_double_n_against_repeated_reference_double(points):
    tp, jp = _proj(points, "port"), _proj(points, "ref")
    tp, jp = _set_identity(tp, 0), _set_identity(jp, 0)
    exp = tuple(map(jnp.asarray, jp))
    for times in (1, 2, 5):
        exp_t = exp
        for _ in range(times):
            exp_t = JC.double(exp_t)
        assert _eq(cuda_curve.double_n_plain(tp, times), exp_t)
        assert _eq(C.double_n(tp, times), exp_t)
    assert _eq(C.double_n(tp, 0), exp)
    assert C.to_affine_host(C.double_n(tp, 3))[0] is None


def _level(points, groups, m):
    """A (groups*m)-row level from the 16 points, rows 1 and m+2 the
    identity, row 3 = -row 3+m/2... (every identity case meets a fold)."""
    reps = -(-groups * m // len(points))
    lvl = tuple(t.repeat(reps, 1)[:groups * m].clone()
                for t in _proj(points, "port"))
    lvl = _set_identity(lvl, 1)
    lvl = _set_identity(lvl, m + 2 if groups > 1 else m - 1)
    half = m // 2
    lvl[0][half], lvl[2][half] = lvl[0][0], lvl[2][0]         # P + (-P)
    lvl[1][half] = F.neg(F.FQ, lvl[1][0])
    for t in lvl:
        t[half + 2] = t[2]                                    # P + P
    lvl = _set_identity(_set_identity(lvl, 3), half + 3)       # O + O
    return lvl


@pytest.mark.parametrize("groups,m,depth", [(1, 8, 3), (3, 8, 2), (2, 12, 2),
                                            (2, 6, 1)])
def test_fold_equals_per_level_fold(points, groups, m, depth):
    """The multi-level fold equals one complete add per level (node i
    with node i + m/2 of each group) at every level it returns."""
    cur = _level(points, groups, m)
    got = C.fold(cur, groups, m, depth)
    assert len(got) == depth
    for lvl in got:
        half = m // 2
        v = [t.reshape(groups, m, F.LIMBS) for t in cur]
        exp = C.add([t[:, :half] for t in v], [t[:, half:] for t in v])
        assert all(torch.equal(a, b.reshape(-1, F.LIMBS)) for a, b in zip(lvl, exp))
        cur, m = lvl, half
    with pytest.raises(ValueError):
        C.fold(cur, groups, m, 5)


@pytest.mark.parametrize("m", [2, 3, 5, 6, 11, 12, 22])
def test_tree_add_odd_widths(points, m):
    """_tree_add at odd and even widths equals the pairwise reference
    order (i with i + m//2, the odd node carried)."""
    width = 2
    pts = tuple(t.repeat(3, 1)[:m * width].reshape(m, width, F.LIMBS)
                for t in _proj(points, "port"))
    pts = _set_identity(pts, (m // 2, 0))
    cur, n = pts, m
    while n > 1:
        half = n // 2
        s = C.add(tuple(t[:half] for t in cur), tuple(t[half:2 * half] for t in cur))
        cur = tuple(torch.cat([a, t[2 * half:]]) for a, t in zip(s, cur))
        n = cur[0].shape[0]
    got = M._tree_add(pts)
    assert all(torch.equal(a, b[0]) for a, b in zip(got, cur))


def test_masked_add_equals_select_then_add(points):
    rng = np.random.default_rng(3)
    nodes = _set_identity(_proj(points, "port"), 4)
    n = 40
    index = torch.as_tensor(rng.integers(0, 16, n), dtype=torch.int64)
    mask = torch.as_tensor(rng.integers(0, 2, n).astype(bool))
    mask[:2] = torch.tensor([True, False])
    index[0] = 4                                  # a gathered identity
    acc = tuple(t.repeat(3, 1)[:n].clone() for t in _proj(points[::-1], "port"))
    acc = _set_identity(acc, 1)                   # O + O at a clear bit
    ident = C.identity()
    for p in (acc, ident):
        node = tuple(F.select(mask, t[index], i) for t, i in zip(nodes, ident))
        exp = C.add(p, node)
        got = C.masked_add(p, nodes, index, mask)
        assert all(torch.equal(a, b) for a, b in zip(got, exp))
    with pytest.raises(ValueError):
        C.masked_add(acc, nodes, index.to(torch.int32), mask)


def test_add_reads_strided_views_in_place():
    """The stride description the card's adder is launched with names
    the rows the view holds (and refuses what it cannot describe)."""
    base = torch.arange(6 * 10 * 16, dtype=torch.int32).reshape(6, 10, 16)

    def rows(view):
        n_rows, inner, outer = cuda_curve._strides(view)
        r = torch.arange(view.numel() // 16) % n_rows
        at = r if inner >= n_rows else (r // inner) * outer + r % inner
        first = int(view.reshape(-1)[0]) // 16
        return base.reshape(-1, 16)[first + at]

    for view in (base, base[:, :5], base[:, 5:], base[2:4], base[1, 3:7],
                 base[:, 2:3], base[:, ::2], base[0, 0].expand(4, 7, 16),
                 base[0].expand(3, 10, 16)):
        assert torch.equal(rows(view), view.reshape(-1, 16)), view.shape
    assert cuda_curve._strides(base[:, 1:8:2][1:]) is None
    assert cuda_curve._strides(base[..., ::2]) is None
    assert cuda_curve._strides(base.transpose(0, 1)) is None


@pytest.fixture(scope="module")
def msm_inputs():
    rnd = random.Random(9)
    pts = [C.py_mul(G, rnd.randrange(1, 1 << 64)) for _ in range(1 << 10)]
    sc = [rnd.randrange(F.FR.modulus) for _ in range(1 << 10)]
    return pts, sc


_TABLES = {}


def _tables(pts, lg):
    """(points, window, tables) for the first 2^lg points, built once."""
    if lg not in _TABLES:
        tx, ty = C.affine_from_ints(pts[:1 << lg])
        c = M.default_window(1 << lg)
        _TABLES[lg] = ((tx, ty), c, M.build_tables((tx, ty), c))
    return _TABLES[lg]


@pytest.mark.parametrize("lg", [8, 10])
def test_msm_with_tables(msm_inputs, lg):
    pts, sc = msm_inputs
    pts, sc = pts[:1 << lg], sc[:1 << lg]
    points, c, tables = _tables(pts, lg)
    scal = F.limbs(F.ints_to_limbs_fast(sc), "cpu")
    got = C.to_affine_host(M.msm(points, scal, c=c, tables=tables))[0]
    assert got == C.host_msm(pts, sc)
    if lg == 8:
        ref_tables = JM.build_tables(JC.affine_from_ints(pts), c)
        assert np.array_equal(tables.numpy().astype(np.uint32), ref_tables)


def test_msm_without_tables_and_padding(msm_inputs):
    pts, sc = msm_inputs
    pts, sc = pts[:300], sc[:300]
    tx, ty = C.affine_from_ints(pts)
    scal = F.limbs(F.ints_to_limbs_fast(sc), "cpu")
    got = C.to_affine_host(M.msm((tx, ty), scal, c=7))[0]
    assert got == C.host_msm(pts, sc)


def test_digit_matrix(msm_inputs):
    _, sc = msm_inputs
    limbs = F.ints_to_limbs_fast(sc[:64])
    for c in (7, 10, 13):
        got = M.digit_matrix(F.limbs(limbs, "cpu"), c).numpy()
        assert np.array_equal(got, np.asarray(JM.digit_matrix(jnp.asarray(limbs), c)))


def test_msm_many_equals_msm(msm_inputs):
    pts, sc = msm_inputs
    n, count = 1 << 8, 3
    points, c, tables = _tables(pts, 8)
    flat = F.limbs(F.ints_to_limbs_fast(sc[:count * n]), "cpu")
    got = C.to_affine_host(M.msm_many(points, flat, count, c, tables))
    assert got == [C.host_msm(pts[:n], sc[i * n:(i + 1) * n])
                   for i in range(count)]
