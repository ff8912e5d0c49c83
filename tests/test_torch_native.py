"""The port's native host library (csrc/bn254_host.cpp through
ops/_build.build_host and native/__init__.py): the cases of
tests/test_native.py against the port's build (MSM differential and edge
cases, ``host_msm`` on both routes against the Python fold, bilinearity,
pairing against the Python oracle), the route switch, and that a broken
source or a failed self-test raises instead of falling back.  Skipped
only where no host compiler exists."""

import random

import pytest

from halo2_aes_tpu_torch import native
from halo2_aes_tpu_torch.backend import pairing as PR
from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import curve as CV

G1 = (CV.G1_X, CV.G1_Y)
RNG = random.Random(99)


@pytest.fixture(autouse=True)
def _needs_compiler():
    if _build.host_compiler() is None:
        pytest.skip("no host C++ compiler: the native library cannot be built")
    native.set_route(None)
    yield
    native.set_route(None)


def _fold(pts, ks):
    acc = None
    for p, k in zip(pts, ks):
        if p is not None and k:
            acc = CV.py_add(acc, CV.py_mul(p, k))
    return acc


def test_default_route_is_native(monkeypatch):
    assert native.route() == "native"
    native.set_route("python")
    assert native.route() == "python"
    native.set_route(None)
    assert native.route() == "native"
    with pytest.raises(ValueError):
        native.set_route("gpu")
    # without a compiler the default is the python route
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    native._compiler_exists.cache_clear()
    try:
        assert native.route() == "python"
    finally:
        monkeypatch.undo()
        native._compiler_exists.cache_clear()


@pytest.mark.parametrize("trial", range(4))
def test_msm_differential(trial):
    rng = random.Random(trial)
    ks = [rng.randrange(PR.R) for _ in range(3)]
    pts = [CV.py_mul(G1, k + 1) for k in ks]
    assert native.g1_msm(pts, ks) == _fold(pts, ks)


def test_msm_edge_cases():
    assert native.g1_msm([], []) is None
    assert native.g1_msm([G1, None], [0, 5]) is None
    assert native.g1_msm([G1], [1]) == G1
    assert native.g1_msm([G1], [PR.R - 1]) == CV.py_mul(G1, PR.R - 1)
    # r * P = identity; P + (r-1) P = identity
    assert native.g1_msm([G1, G1], [1, PR.R - 1]) is None


@pytest.mark.parametrize("route", native.ROUTES)
def test_host_msm_matches_python_fold(route):
    ks = [0, 1, RNG.randrange(PR.R), PR.R - 2, PR.R + 5]
    pts = [CV.py_mul(G1, k + 2) for k in ks]
    native.set_route(route)
    before = dict(native.CALLS)
    assert CV.host_msm(pts, ks) == _fold(pts, [k % PR.R for k in ks])
    assert native.CALLS[route] == before[route] + 1
    other = [r for r in native.ROUTES if r != route][0]
    assert native.CALLS[other] == before[other]


def test_pairing_bilinearity():
    a = RNG.randrange(1, PR.R)
    aP = CV.py_mul(G1, a)
    aQ = PR.g2_mul(PR.G2, a)
    negP = (G1[0], -G1[1] % PR.Q)
    assert native.pairing_product_is_one([(aP, PR.G2), (negP, aQ)])
    assert not native.pairing_product_is_one([(aP, PR.G2), (G1, aQ)])
    # infinity pairs contribute 1
    assert native.pairing_product_is_one(
        [(aP, PR.G2), (None, PR.G2), (negP, aQ), (aP, None)])


def test_pairing_matches_python_oracle():
    """Same verdicts as the pure-python Miller loop on random inputs, and
    through ``pairing.pairing_product_is_one`` on both routes."""
    a, b = RNG.randrange(1, 1000), RNG.randrange(1, 1000)
    aP, bQ = CV.py_mul(G1, a), PR.g2_mul(PR.G2, b)
    negabP = CV.py_mul(G1, (-a * b) % PR.R)
    pairs_good = [(aP, bQ), (negabP, PR.G2)]
    pairs_bad = [(aP, bQ), (CV.py_mul(G1, 7), PR.G2)]
    for pairs, want in ((pairs_good, True), (pairs_bad, False)):
        f = PR.FQ12_ONE
        for p, q in pairs:
            f = PR.fq12_mul(f, PR.miller_loop(q, p))
        assert (PR.final_exponentiation(f) == PR.FQ12_ONE) is want
        assert native.pairing_product_is_one(pairs) is want
        for route in native.ROUTES:
            native.set_route(route)
            assert PR.pairing_product_is_one(pairs) is want


def test_broken_source_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's output, and the routed functions raise with it."""
    bad = tmp_path / "bn254_host.cpp"
    bad.write_text('extern "C" int g1_msm( { this is not C++\n')
    monkeypatch.setattr(_build, "HOST_SOURCE", str(bad))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "out"))
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on .*bn254_host.cpp") as exc:
            native.library()
        assert "error" in str(exc.value)
        native.set_route("native")
        with pytest.raises(RuntimeError):
            CV.host_msm([G1], [2])
        with pytest.raises(RuntimeError):
            PR.pairing_product_is_one([(G1, PR.G2)])
    finally:
        native.library.cache_clear()


def test_failed_self_test_raises(monkeypatch):
    monkeypatch.setattr(native, "_g1_msm", lambda lib, pts, ks: None)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="self-test failed"):
            native.library()
    finally:
        native.library.cache_clear()
