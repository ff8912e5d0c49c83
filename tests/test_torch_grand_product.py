"""K6's plain version (``ops/cuda_grand.py``) against the eager grand
products it replaced, bit for bit.

``grand_product_plain`` is what the kernel computes on the card and what
the CPU prover runs: the tiles' products, one inversion a segment, the
rows of each tile.  It must equal ``lookup.grand_product_eager``,
``lookup.grand_product_many_eager`` and
``permutation.grand_products_eager`` (batch_inv and cumprod) with several
tiles and a ragged last tile forced, ``usable`` below the blinding
boundary, blinding tails, zero denominators planted inside and past
``usable``, one or several lookup segments, and permutation chunks of
one or more columns with the chunk link.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from halo2_aes_tpu_torch.backend import lookup as LK
from halo2_aes_tpu_torch.backend import permutation as PERM
from halo2_aes_tpu_torch.ops import _build
from halo2_aes_tpu_torch.ops import cuda_grand as CG
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import timers

torch.set_num_threads(1)
FR = F.FR
K = 6
N = 1 << K
BETA, GAMMA = 0x1234567, 0x89ABCDEF


def _rand(rng, rows):
    """Seeded canonical Montgomery limbs on the CPU: (rows, 16) int32."""
    return F.limbs(FR.encode([int(v) for v in rng.integers(1, 2**62, rows)]), "cpu")


def _neg(x):
    return F.neg(FR, x)


def _lookup_inputs(seed, L, usable, bf, zeros=()):
    """L lookups' A, S, A', S' and blinding; at each row of ``zeros``
    (rows of segment 0 and of the last segment) A' = -beta, so the row's
    denominator (A'+beta)(S'+gamma) is 0."""
    rng = np.random.default_rng(seed)
    a, s, ap, sp = (_rand(rng, L * N) for _ in range(4))
    beta, gamma = F.encode(FR, BETA, "cpu"), F.encode(FR, GAMMA, "cpu")
    for r in zeros:
        ap[r] = _neg(beta)
        ap[(L - 1) * N + r] = _neg(beta)
    blind = _rand(rng, L * bf).reshape(L, bf, F.LIMBS)
    return a, s, ap, sp, beta, gamma, blind


@pytest.mark.parametrize("tile", [8, 12, 64, CG.TILE])
@pytest.mark.parametrize("usable,bf,zeros", [
    (57, 6, ()),                # the prover's shape: usable = n - bf - 1
    (40, 6, ()),                # usable below the blinding boundary
    (57, 6, (0, 13, 56)),       # zero denominators at the ends of the rows
    (50, 3, (7, 52)),           # ... and one past usable (ratio 1 there)
])
def test_lookup_column_matches_eager(tile, usable, bf, zeros):
    a, s, ap, sp, beta, gamma, blind = _lookup_inputs(1, 1, usable, bf, zeros)
    want = LK.grand_product_eager(a, s, ap, sp, usable, beta, gamma, blind[0])
    got = CG.lookup_z(a, s, ap, sp, usable, beta, gamma, blind, tile=tile)
    assert torch.equal(got, want)
    assert torch.equal(LK.grand_product(a, s, ap, sp, usable, beta, gamma,
                                        blind[0]), want)


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("tile", [12, CG.TILE])
def test_lookup_segments_match_eager(L, tile):
    a, s, ap, sp, beta, gamma, blind = _lookup_inputs(2, L, 57, 6, (5, 30))
    want = LK.grand_product_many_eager(a, s, ap, sp, L, 57, beta, gamma, blind)
    assert torch.equal(CG.lookup_z(a, s, ap, sp, 57, beta, gamma, blind,
                                   tile=tile), want)
    assert torch.equal(LK.grand_product_many(a, s, ap, sp, L, 57, beta, gamma,
                                             blind), want)
    for i in range(L):     # each segment is the one-column product
        rows = slice(i * N, (i + 1) * N)
        assert torch.equal(LK.grand_product(a[rows], s[rows], ap[rows], sp[rows],
                                            57, beta, gamma, blind[i]), want[rows])


def _perm_inputs(seed, m, cols_total, zero_rows=()):
    """m permutation columns over ``cols_total`` columns of evaluations,
    sigma a random permutation of the m*n cells; at each (column, row) of
    ``zero_rows`` the value makes the row's sigma factor 0."""
    rng = np.random.default_rng(seed)
    fld = _rand(rng, cols_total * N)
    perm_columns = sorted(rng.choice(cols_total, m, replace=False).tolist())
    cells = rng.permutation(m * N)
    map_col = torch.as_tensor(cells // N, dtype=torch.int64).reshape(m, N)
    map_row = torch.as_tensor(cells % N, dtype=torch.int64).reshape(m, N)
    omega, delta = PERM._label_tables(K, m, torch.device("cpu"))
    beta, gamma = F.encode(FR, BETA, "cpu"), F.encode(FR, GAMMA, "cpu")
    for i, r in zero_rows:
        sig = F.mont_mul(FR, delta[map_col[i, r]], omega[map_row[i, r]])
        term = F.add(FR, F.mont_mul(FR, beta, sig), gamma)
        fld[perm_columns[i] * N + r] = _neg(term)
    return fld, perm_columns, map_col, map_row, omega, delta, beta, gamma


@pytest.mark.parametrize("chunk_len", [1, 2, 3, 7])
@pytest.mark.parametrize("zero_rows", [(), ((0, 0), (4, 31), (6, 58))])
def test_perm_chunks_match_eager(chunk_len, zero_rows):
    """Seven columns in chunks of 1, 2, 3 and 7: the last chunk of one
    column, each link read from the previous chunk's z at ``usable``."""
    m, usable, bf = 7, 57, 6
    fld, cols, mc, mr, omega, delta, beta, gamma = _perm_inputs(
        3, m, 9, zero_rows)
    chunks = -(-m // chunk_len)
    blind = _rand(np.random.default_rng(4), chunks * bf).reshape(chunks, bf, F.LIMBS)
    args = (K, usable, chunk_len, fld, cols, mc, mr, omega, delta, beta, gamma,
            blind)
    want = PERM.grand_products_eager(*args)
    assert torch.equal(PERM.grand_products(*args), want)


@pytest.mark.parametrize("tile", [8, 12, 64])
def test_perm_chunk_tiles_match_eager(tile):
    """``perm_z`` chunk by chunk with the tile forced (several tiles, a
    ragged last one), the chunk link taken from the previous column."""
    m, usable, bf, chunk_len = 5, 57, 6, 2
    fld, cols, mc, mr, omega, delta, beta, gamma = _perm_inputs(5, m, 6, ((2, 9),))
    blind = _rand(np.random.default_rng(6), 3 * bf).reshape(3, bf, F.LIMBS)
    want = PERM.grand_products_eager(K, usable, chunk_len, fld, cols, mc, mr,
                                     omega, delta, beta, gamma, blind)
    table = CG.perm_table(beta, gamma, delta)
    out = torch.empty_like(want)
    init = F.const(FR, "one", "cpu")
    for t in range(3):
        chunk = [(cols[i], i) for i in range(2 * t, min(2 * t + 2, m))]
        CG.perm_z(fld, chunk, mc, mr, omega, table, usable, init, blind[t],
                  out[t * N:(t + 1) * N], tile=tile)
        init = out[t * N + usable]
    assert torch.equal(out, want)


def test_plain_uses_one_inversion_a_segment(monkeypatch):
    """The decomposition inverts once a segment (D, the product of the
    segment's denominators), whatever the number of tiles."""
    calls = []
    inv = F.inv

    def counting(spec, a):
        calls.append(a.shape)
        return inv(spec, a)

    monkeypatch.setattr(F, "inv", counting)
    a, s, ap, sp, beta, gamma, blind = _lookup_inputs(7, 3, 57, 6)
    CG.lookup_z(a, s, ap, sp, 57, beta, gamma, blind, tile=8)
    assert calls == [torch.Size([3, F.LIMBS])]


@pytest.mark.parametrize("usable,bf", [(58, 6), (0, 6), (57, N)])
def test_rows_that_do_not_fit_raise(usable, bf):
    a, s, ap, sp, beta, gamma, _ = _lookup_inputs(8, 1, 57, 6)
    blind = torch.zeros((1, bf, F.LIMBS), dtype=torch.int32)
    with pytest.raises(ValueError):
        CG.lookup_z(a, s, ap, sp, usable, beta, gamma, blind)


def test_spans_state_each_columns_work():
    """One ``grand_products.lookup`` span a lookup column (L*n rows for
    the batched form) and one ``grand_products.perm`` span a chunk, with
    the argument's work: 4 polys and 7 products a lookup row, c polys
    and 4c + 4 products a chunk row; ``fused`` 0 on the CPU."""
    a, s, ap, sp, beta, gamma, blind = _lookup_inputs(9, 2, 57, 6)
    fld, cols, mc, mr, omega, delta, _, _ = _perm_inputs(10, 5, 6)
    pblind = blind[:, :, :].repeat(2, 1, 1)[:3]
    timers.clear()
    with timers.recording():
        LK.grand_product(a[:N], s[:N], ap[:N], sp[:N], 57, beta, gamma, blind[0])
        LK.grand_product_many(a, s, ap, sp, 2, 57, beta, gamma, blind)
        PERM.grand_products(K, 57, 2, fld, cols, mc, mr, omega, delta, beta,
                            gamma, pblind)
    got = [(r.name, r.attrs) for r in timers.spans()]
    lk = {"fused": 0, "polys": 4, "muls": 7}
    assert got == [("grand_products.lookup", {**lk, "rows": N}),
                   ("grand_products.lookup", {**lk, "rows": 2 * N}),
                   *[("grand_products.perm", {"fused": 0, "rows": N, "polys": c,
                                              "muls": 4 * c + 4})
                     for c in (2, 2, 1)]]


INVERSE_MAIN = r"""
#define __device__
#define __forceinline__ inline
#include "fe_inv.cuh"
#include <cstdio>
int main() {
  uint32_t p[8], a[8], r[8];
  for (int i = 0; i < 8; ++i) if (scanf("%x", &p[i]) != 1) return 1;
  while (true) {
    for (int i = 0; i < 8; ++i) if (scanf("%x", &a[i]) != 1) return 0;
    fe_inv_binary(r, a, p);
    for (int i = 0; i < 8; ++i) printf("%08x ", r[i]);
    printf("\n");
  }
}
"""


def test_binary_inverse_matches_python(tmp_path):
    """K6's one inversion a column (``csrc/fe_inv.cuh``, plain C++ built
    here by the host compiler) against ``pow(a, -1, p)`` for edge and
    random elements of Fr."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "inv.cpp"
    src.write_text(INVERSE_MAIN)
    exe = tmp_path / "inv"
    subprocess.run([cxx, "-O2", "-I", _build.CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    p = FR.modulus
    rng = np.random.default_rng(11)
    vals = [1, 2, 3, p - 1, p - 2, 1 << 200, (1 << 254) % p, FR.r_mod_p]
    vals += [int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1 for _ in range(500)]

    def words(x):
        return " ".join(f"{(x >> (32 * i)) & 0xFFFFFFFF:x}" for i in range(8))

    run = subprocess.run([str(exe)], input="\n".join(map(words, [p, *vals])) + "\n",
                         capture_output=True, text=True, check=True)
    got = [sum(int(h, 16) << (32 * i) for i, h in enumerate(line.split()))
           for line in run.stdout.splitlines()]
    assert got == [pow(v, -1, p) for v in vals]


@pytest.mark.parametrize("case", ["lookup", "chunk", "lookup_rows", "chunk_columns",
                                  "map_shape", "table_rows", "column_index"])
def test_kernel_wrapper_refuses_bad_shapes(case, monkeypatch):
    """The launch wrapper refuses operands that do not fit the column before
    it reaches the kernel library (which this machine cannot build), and
    passes the prover's shapes on to it."""
    def no_library():
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    a, s, ap, sp, beta, gamma, blind = _lookup_inputs(12, 2, 57, 6)
    fld, cols, mc, mr, omega, delta, _, _ = _perm_inputs(13, 5, 6)
    table = CG.perm_table(beta, gamma, delta)
    one = F.const(FR, "one", "cpu")
    out = torch.empty((N, F.LIMBS), dtype=torch.int32)
    chunk = [(cols[0], 0), (cols[1], 1)]
    args = {"lookup": (CG.LOOKUP, torch.empty_like(a), (a, s, ap, sp),
                       torch.stack([beta, gamma]), one, blind, N, 57, 2),
            "chunk": (CG.PERM, out, (fld, mc, mr, omega), table, one, blind[0],
                      N, 57, 1, chunk),
            "lookup_rows": (CG.LOOKUP, torch.empty_like(a), (a, s, ap[:-1], sp),
                            torch.stack([beta, gamma]), one, blind, N, 57, 2),
            "chunk_columns": (CG.PERM, out, (fld, mc, mr, omega), table, one,
                              blind[0], N, 57, 1, chunk * 9),
            "map_shape": (CG.PERM, out, (fld, mc[:, :-1].contiguous(), mr, omega),
                          table, one, blind[0], N, 57, 1, chunk),
            "table_rows": (CG.PERM, out, (fld, mc, mr, omega), table[:-1], one,
                           blind[0], N, 57, 1, chunk),
            "column_index": (CG.PERM, out, (fld, mc, mr, omega), table, one,
                             blind[0], N, 57, 1, [(6, 0)])}[case]
    with pytest.raises(AssertionError if case in ("lookup", "chunk") else ValueError):
        CG._launch(*args)
