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
