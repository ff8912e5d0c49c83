"""Native (C++) host backend loader: BN254 G1 ops + optimal-ate pairing
(port of ``native/__init__.py``).

Role of halo2curves' CPU curve/pairing layer for the VERIFIER
(``csrc/bn254_host.cpp``).  The shared object is compiled on first use
by ``ops/_build.build_host`` into ``build/torch_kernels/host_<hash>/``;
every numeric constant (modulus, Montgomery parameters, exponent bit
strings) is computed here with Python bigints and injected via
``bn254_init``, so the C++ holds no transcribed magic numbers.

An explicit switch chooses the route of ``curve.host_msm`` and
``pairing.pairing_product_is_one``: ``"native"`` (this library) or
``"python"`` (the bigint oracle of ``ops/curve.py`` and
``backend/pairing.py``).  ``set_route`` sets it, and the default is
native wherever a host compiler exists.  There is no silent fallback: on
the native route a failed build or a failed self-test raises, with the
compiler's output.  ``CALLS`` counts the calls each route served.
"""

from __future__ import annotations

import ctypes
import functools

ROUTES = ("native", "python")
CALLS = {"native": 0, "python": 0}
_route: str | None = None


def set_route(route: str | None) -> None:
    """Choose the host route; None returns to the default."""
    global _route
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown host route {route!r}; one of {ROUTES}")
    _route = route


def route() -> str:
    """The route in force: ``set_route``'s, else native where a host
    compiler exists and python where none does."""
    if _route is not None:
        return _route
    return "native" if _compiler_exists() else "python"


def available() -> bool:
    """Whether the native route can be taken: a host compiler exists (a
    build or self-test that then fails raises; nothing falls back)."""
    return _compiler_exists()


@functools.lru_cache(maxsize=1)
def _compiler_exists() -> bool:
    from halo2_aes_tpu_torch.ops import _build

    return _build.host_compiler() is not None


def _limbs(x: int):
    return (ctypes.c_uint64 * 4)(*[(x >> (64 * i)) & ((1 << 64) - 1)
                                   for i in range(4)])


def _bits_msb(x: int):
    s = bin(x)[2:]
    return (ctypes.c_uint8 * len(s))(*[int(c) for c in s]), len(s)


@functools.lru_cache(maxsize=1)
def library():
    """Compile (cached) + load + init + self-test; returns the ctypes
    lib.  Raises if the build or the self-test fails."""
    from halo2_aes_tpu_torch.backend import pairing as PR
    from halo2_aes_tpu_torch.ops import _build
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops.field import FQ, FR

    lib = ctypes.CDLL(_build.build_host())
    q, r = FQ.modulus, FR.modulus
    u = 4965661367192848881
    q_bits, q_len = _bits_msb(q)
    hard_bits, hard_len = _bits_msb((q**4 - q**2 + 1) // r)
    ate_bits, ate_len = _bits_msb(6 * u + 2)
    r2 = pow(2, 512, q)
    n0inv = (-pow(q, -1, 1 << 64)) % (1 << 64)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bn254_init.argtypes = [ptr, ctypes.c_uint64, ptr, ptr, i32, ptr, i32,
                               ptr, i32]
    lib.bn254_init.restype = None
    lib.g1_msm.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    lib.g1_msm.restype = i32
    lib.pairing_product_is_one.argtypes = [ptr, ptr, ptr, ptr, i32]
    lib.pairing_product_is_one.restype = i32
    lib.bn254_init(_limbs(q), ctypes.c_uint64(n0inv), _limbs(r2),
                   q_bits, q_len, hard_bits, hard_len, ate_bits, ate_len)

    # self-test: 2P via msm matches Python; e(P, Q) * e(-P, Q) == 1 and
    # e(P, Q)^2 != 1
    g1 = (CV.G1_X, CV.G1_Y)
    neg = (g1[0], (-g1[1]) % q)
    if _g1_msm(lib, [g1, g1], [1, 1]) != CV.py_add(g1, g1):
        raise RuntimeError("native host library: the G1 MSM self-test failed")
    if (not _pairing_product(lib, [(g1, PR.G2), (neg, PR.G2)])
            or _pairing_product(lib, [(g1, PR.G2), (g1, PR.G2)])):
        raise RuntimeError("native host library: the pairing self-test failed")
    return lib


def g1_msm(points, scalars):
    """sum_i scalars[i] * points[i]; points: affine int pairs or None;
    returns an affine int pair or None (infinity)."""
    CALLS["native"] += 1
    return _g1_msm(library(), points, scalars)


def _g1_msm(lib, points, scalars):
    n = len(points)
    xs = (ctypes.c_uint64 * (4 * n))()
    ys = (ctypes.c_uint64 * (4 * n))()
    inf = (ctypes.c_uint8 * n)()
    sc = (ctypes.c_uint64 * (4 * n))()
    for i, (pt, s) in enumerate(zip(points, scalars)):
        if pt is None or s == 0:
            inf[i] = 1
            continue
        for j in range(4):
            xs[4 * i + j] = (pt[0] >> (64 * j)) & ((1 << 64) - 1)
            ys[4 * i + j] = (pt[1] >> (64 * j)) & ((1 << 64) - 1)
            sc[4 * i + j] = (int(s) >> (64 * j)) & ((1 << 64) - 1)
    out = (ctypes.c_uint64 * 8)()
    if lib.g1_msm(xs, ys, inf, sc, n, out):
        return None
    x = sum(int(out[j]) << (64 * j) for j in range(4))
    y = sum(int(out[j + 4]) << (64 * j) for j in range(4))
    return (x, y)


def _pairing_product(lib, pairs) -> bool:
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g1_inf = (ctypes.c_uint8 * n)()
    g2 = (ctypes.c_uint64 * (16 * n))()
    g2_inf = (ctypes.c_uint8 * n)()
    for i, (p, q2) in enumerate(pairs):
        if p is None:
            g1_inf[i] = 1
        else:
            for j in range(4):
                g1[8 * i + j] = (p[0] >> (64 * j)) & ((1 << 64) - 1)
                g1[8 * i + 4 + j] = (p[1] >> (64 * j)) & ((1 << 64) - 1)
        if q2 is None:
            g2_inf[i] = 1
        else:
            (x0, x1), (y0, y1) = q2
            for j, v in enumerate((x0, x1, y0, y1)):
                for l in range(4):
                    g2[16 * i + 4 * j + l] = (v >> (64 * l)) & ((1 << 64) - 1)
    return bool(lib.pairing_product_is_one(g1, g1_inf, g2, g2_inf, n))


def pairing_product_is_one(pairs) -> bool:
    CALLS["native"] += 1
    return _pairing_product(library(), pairs)
