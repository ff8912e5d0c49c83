"""K5's packed operand and normalize entry (``ops/cuda_nibble.py``) on
the CPU, exactly: ``pack`` / ``unpack`` round-trip every B the
``mxu_field`` paths use plus random, all-15 and all-zero ones; a product
that reads the packed layout equals ``nibble_product_plain``; the skip
table drops no chunk with a non-zero entry; the normalize entry's
plain version equals the reference's ``carry_norm_ks`` of fold + addend
at each carry site of the paths; and the paths, which now carry through
that entry, equal ``halo2_aes_tpu.ops.mxu_field`` bit for bit without
calling ``carry_norm_ks``.  Inputs are made by numpy from a seed."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.ops import field as JF
from halo2_aes_tpu.ops import mxu_field as JM
from halo2_aes_tpu_torch.ops import cuda_nibble as C
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import mxu_field as M

torch.set_num_threads(1)

SPEC = F.FR
P = SPEC.modulus


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _dft(n, seed):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in _rand(rng, n)] for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _matrix(name):
    """(B as an int8 torch tensor (G, K, M), block) by name."""
    rng = np.random.default_rng(len(name))
    NP, Pm = M._reducer_mats(P)
    omega = pow(SPEC.generator, (P - 1) // 16, P)
    mats = {
        "fixed_random": lambda: (M.FixedMul(SPEC, _rand(rng, 1)[0])._B, None),
        "fixed_p-1": lambda: (M.FixedMul(SPEC, P - 1)._B, None),
        "fixed_0": lambda: (M.FixedMul(SPEC, 0)._B, None),
        "reducer_np": lambda: (NP[None], None),
        "reducer_p": lambda: (Pm[None], None),
        "reducer_np_fq": lambda: (M._reducer_mats(F.FQ_MODULUS)[0][None], None),
        "dft4": lambda: (M.DftMatmul(SPEC, _dft(4, 4))._W, 127),
        "dft16": lambda: (M.DftMatmul(SPEC, [[pow(omega, j * k, P) for k in range(16)]
                                             for j in range(16)])._W, 127),
        "dft32_p-1": lambda: (M.DftMatmul(SPEC, [[P - 1] * 32] * 32)._W, 127),
        "batched_3x4": lambda: (M.BatchedDftMatmul(
            SPEC, [_dft(4, 10 + g) for g in range(3)])._W, 127),
        "ntt256_stage2": lambda: (M._ntt256_stages(SPEC)[1]._W, 127),
        "random_blocks68": lambda: (rng.integers(0, 16, (2, 64, 3 * 68)), 68),
        "random_wide": lambda: (rng.integers(0, 16, (1, 68, 300)), None),
        "random_sparse": lambda: (rng.integers(0, 16, (2, 100, 131))
                                  * (rng.random((2, 100, 131)) < 0.02), 131),
        "all15": lambda: (np.full((1, 2048, 32 * 127), 15), 127),
        "zero": lambda: (np.zeros((1, 64, 127)), None),
    }
    B, block = mats[name]()
    return torch.from_numpy(np.ascontiguousarray(B).astype(np.int8)), block


NAMES = ["fixed_random", "fixed_p-1", "fixed_0", "reducer_np", "reducer_p",
         "reducer_np_fq", "dft4", "dft16", "dft32_p-1", "batched_3x4",
         "ntt256_stage2", "random_blocks68", "random_wide", "random_sparse",
         "all15", "zero"]


@functools.lru_cache(maxsize=None)
def _packed(name):
    B, block = _matrix(name)
    return C.pack(B, block)


@pytest.mark.parametrize("name", NAMES)
def test_pack_roundtrip(name):
    B, block = _matrix(name)
    pk = _packed(name)
    assert pk.shape == tuple(B.shape) and pk.block == (block or B.shape[-1])
    assert pk.data.dtype == torch.uint8 and pk.data.shape[1] == C.FRAG
    assert pk.offsets.dtype == torch.int32 and pk.masks.dtype == torch.int32
    assert int(pk.offsets[-1]) == int(C._kept(pk).sum())
    assert torch.equal(C.unpack(pk), B)


@pytest.mark.parametrize("name", NAMES)
def test_packed_product_plain(name):
    B, block = _matrix(name)
    g, k, _ = B.shape
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << 16, (g, 7, k // 4))
    x[:, 0] = 0xFFFF
    xt = torch.from_numpy(x.astype(np.int32))
    want = C.nibble_product_plain(xt, B, block)
    assert torch.equal(C.packed_product_plain(xt, _packed(name)), want)


@pytest.mark.parametrize("name", NAMES)
def test_skip_table_keeps_every_nonzero(name):
    """Each (tile, k-step, chunk of 4 n-tiles), read from B through the
    padded-column map with plain loops, is kept exactly when it holds a
    non-zero entry."""
    B, block = _matrix(name)
    pk = _packed(name)
    g, k, m = B.shape
    *_, src = C._padded_columns(m, pk.block)
    src = src.reshape(pk.tiles, pk.ntc * C.NTILE).numpy()
    b = B.numpy()
    kept = C._kept(pk).numpy()
    width = C.CHUNK * C.NTILE
    for gi in range(g):
        for t in range(pk.tiles):
            for nt in range(pk.ntc):
                chunk = src[t, nt // C.CHUNK * width:(nt // C.CHUNK + 1) * width]
                nz = b[gi][:, chunk[chunk >= 0]].reshape(k, -1).any(-1)
                for ks in range(pk.ksteps):
                    want = bool(nz[ks * C.KSTEP:(ks + 1) * C.KSTEP].any())
                    assert kept[gi, t, ks, nt] == want, (gi, t, ks, nt)
    if name == "all15":
        assert kept.all()
    if name in ("dft16", "ntt256_stage2"):
        # a 64-nibble band at 32 x 32 granularity: 3 of 4 chunks a k-step
        assert kept.mean() == 0.75


@pytest.mark.parametrize("m,block,tl", [(127, 127, 32), (68, 68, 17),
                                        (131, 131, 33), (16 * 127, 127, 32),
                                        (3 * 68, 68, 34), (300, 300, 34)])
def test_tile_layout(m, block, tl):
    got = C._padded_columns(m, block)
    assert got[0] == tl and got[1] == -(-tl // 2)
    src = got[-1]
    # every B column appears exactly once; padded columns read zero
    assert sorted(src[src >= 0].tolist()) == list(range(m))


def _carry_reference(limbs, olb, width, addend):
    """The reference's carry_norm_ks of each block's limbs plus the addend,
    padded to width as ``reduce_wide`` pads them."""
    g, rows, n = limbs.shape
    v = limbs.astype(np.int64).reshape(g, rows, n // olb, olb)
    v = np.pad(v, [(0, 0)] * 3 + [(0, max(width - olb, 0))])[..., :width]
    if addend is not None:
        v = v + np.pad(addend.astype(np.int64)[:, :, None, :],
                       [(0, 0)] * 3 + [(0, width - addend.shape[-1])])
    assert v.max() < 1 << 31
    out = JM.carry_norm_ks(jnp.asarray(v.astype(np.uint32)), width)
    return np.asarray(out).astype(np.int64).reshape(g, rows, -1)


SITES = {
    # name: (matrix, width, addend limbs)
    "fixed_mul_w32": ("fixed_random", 32, 0),
    "reduce_first_w17": ("reducer_np", 17, 0),
    "reduce_second_w34_t32": ("reducer_p", 34, 32),
    "reduce_second_w34_t33": ("reducer_p", 34, 33),
    "dft_outputs_w33": ("dft4", 33, 0),
    "batched_outputs_w33": ("batched_3x4", 33, 0),
}


@pytest.mark.parametrize("site", list(SITES))
def test_normalize_plain_equals_carry_norm_ks(site):
    name, width, alimbs = SITES[site]
    B, block = _matrix(name)
    g, k, m = B.shape
    rng = np.random.default_rng(width + alimbs)
    x = rng.integers(0, 1 << 16, (g, 9, k // 4))
    x[:, :2] = 0xFFFF                       # the largest limbs
    xt = torch.from_numpy(x.astype(np.int32))
    addend = None
    if alimbs:
        addend = rng.integers(0, 1 << 16, (g, 9, alimbs))
        addend[:, 0] = 0xFFFF
        addend = torch.from_numpy(addend.astype(np.int32))
    got = C.nibble_normalize_plain(xt, B, block, width, addend)
    folded = C.nibble_product_plain(xt, B, block)
    olb = -(-(block or m) // 4)
    want = _carry_reference(folded.numpy(), olb, width,
                            None if addend is None else addend.numpy())
    assert got.dtype == torch.int32 and got.shape == (g, 9, (m // (block or m)) * width)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same through the port's carry_norm_ks, block by block
    v = torch.nn.functional.pad(folded.reshape(g, 9, -1, olb).to(torch.int64),
                                (0, width - olb))
    if addend is not None:
        v = v + torch.nn.functional.pad(addend.to(torch.int64), (0, width - alimbs))[:, :, None]
    assert torch.equal(M.carry_norm_ks(v, width).reshape(g, 9, -1), got)
    # the entry itself takes the plain version on the CPU, with or without
    # the packed operand
    before = C.LAUNCHES
    assert torch.equal(C.nibble_normalize(xt, B, block, width, addend), got)
    assert torch.equal(C.nibble_normalize(xt, B, block, width, addend,
                                          packed=_packed(name)), got)
    assert torch.equal(C.nibble_product(xt, B, block, packed=_packed(name)), folded)
    assert C.LAUNCHES == before


def test_normalize_rejects():
    B, _ = _matrix("fixed_random")
    x = torch.zeros((1, 4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        C.nibble_normalize(x, B, None, 0)
    with pytest.raises(ValueError, match="width"):
        C.nibble_normalize(x, B, None, C.MAX_WIDTH + 1)
    wide, _ = _matrix("random_wide")
    with pytest.raises(ValueError, match="exceeds a tile"):
        C.nibble_normalize(torch.zeros((1, 4, 17), dtype=torch.int32), wide, None, 32)
    for bad in (torch.zeros((1, 4, 33), dtype=torch.int32),      # wider than width
                torch.zeros((1, 3, 8), dtype=torch.int32),       # other rows
                torch.zeros((1, 4, 8), dtype=torch.int64),       # not int32
                torch.zeros((1, 8, 4), dtype=torch.int32).transpose(1, 2)):
        with pytest.raises(ValueError, match="addend"):
            C.nibble_normalize(x, B, None, 32, bad)
    with pytest.raises(ValueError, match="packed operand"):
        C.nibble_product(x, B, None, packed=_packed("reducer_np"))
    dft, _ = _matrix("dft16")
    with pytest.raises(ValueError, match="packed operand"):     # another block
        C.nibble_product(torch.zeros((1, 4, 256), dtype=torch.int32), dft, 127,
                         packed=C.pack(dft, 16 * 127))
    with pytest.raises(ValueError):
        C.pack(B, 100)


@pytest.mark.parametrize("other", ["another_matrix", "a_copy"])
def test_packed_operand_of_another_b_refused(other):
    """A packed operand is taken only with the B it was packed from: the
    card reads the packed data and the CPU reads B, so a B of the same
    shape but other (or merely copied) storage must not pass."""
    B, _ = _matrix("fixed_random")
    pk = _packed("fixed_random")
    B2 = _matrix("fixed_p-1")[0] if other == "another_matrix" else B.clone()
    assert B2.shape == B.shape and B2 is not B
    x = torch.zeros((1, 4, B.shape[1] // 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="not packed from this B"):
        C.nibble_product(x, B2, None, packed=pk)
    with pytest.raises(ValueError, match="not packed from this B"):
        C.nibble_normalize(x, B2, None, 32, packed=pk)
    assert torch.equal(C.nibble_product(x, B, None, packed=pk),
                       C.nibble_product_plain(x, B))


@pytest.mark.parametrize("alimbs", [32, 33])
def test_normalize_addend_taken_mod_2_16(alimbs):
    """An addend entry outside 16 bits counts as its value mod 2^16 (the
    kernel masks it the same way)."""
    B, block = _matrix("reducer_p")
    rng = np.random.default_rng(alimbs)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (1, 9, B.shape[1] // 4))
                         .astype(np.int32))
    wild = rng.integers(-(1 << 31), 1 << 31, (1, 9, alimbs)).astype(np.int32)
    wild[0, 0] = -1
    wild[0, 1] = np.iinfo(np.int32).min
    wild[0, 2] = np.iinfo(np.int32).max
    canonical = torch.from_numpy(wild & 0xFFFF)
    want = C.nibble_normalize(x, B, block, 34, canonical)
    assert torch.equal(C.nibble_normalize(x, B, block, 34, torch.from_numpy(wild)), want)
    assert torch.equal(C.nibble_normalize_plain(x, B, block, 34, torch.from_numpy(wild)),
                       want)


# --------------------------------------------------------------------------
# the paths, carried through the normalize entry
# --------------------------------------------------------------------------

@pytest.fixture
def no_torch_carry(monkeypatch):
    """The paths must not reach the plain carry pass any more."""
    def refuse(*args, **kwargs):
        raise AssertionError("carry_norm_ks was called")
    monkeypatch.setattr(M, "carry_norm_ks", refuse)


def _eq(t, ref):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("t_limbs", [32, 33])
def test_reduce_wide_widths(t_limbs, no_torch_carry):
    """Both T of the paths: 32 (FixedMul) and 33 (the DFT outputs)."""
    rng = np.random.default_rng(t_limbs)
    top = P << M.RP_BITS if t_limbs == 33 else 1 << (16 * 32)
    ts = [int.from_bytes(rng.bytes(70), "little") % top for _ in range(12)]
    ts += [0, top - 1]
    limbs = np.array([[(t >> (16 * j)) & 0xFFFF for j in range(t_limbs)] for t in ts],
                     dtype=np.uint32)
    got = M.reduce_wide(SPEC, F.limbs(limbs, "cpu"))
    assert _eq(got, np.asarray(JM.reduce_wide(JF.FR, jnp.asarray(limbs))))


@pytest.mark.parametrize("b", ["random", "p-1"])
def test_fixed_mul_without_torch_carry(b, no_torch_carry):
    rng = np.random.default_rng(12)
    b_val = _rand(rng, 1)[0] if b == "random" else P - 1
    a = F.ints_to_limbs_fast(_rand(rng, 16) + [0, 1, P - 1])
    got = M.FixedMul(SPEC, b_val)(F.limbs(a, "cpu"))
    assert _eq(got, np.asarray(JM.FixedMul(JF.FR, b_val)(jnp.asarray(a))))


@pytest.mark.parametrize("n", [8, 32])
def test_dft_matmul_without_torch_carry(n, no_torch_carry):
    rng = np.random.default_rng(n + 40)
    w = _dft(n, n) if n == 8 else [[P - 1] * n for _ in range(n)]
    x = SPEC.encode(_rand(rng, 2 * n) if n == 8 else [P - 1] * (2 * n)).reshape(
        2, n, F.LIMBS)
    got = M.DftMatmul(SPEC, w)(F.limbs(x, "cpu"))
    assert _eq(got, np.asarray(JM.DftMatmul(JF.FR, w)(jnp.asarray(x))))


def test_batched_dft_and_ntt256_without_torch_carry(no_torch_carry):
    rng = np.random.default_rng(44)
    ws = [_dft(8, 20 + g) for g in range(2)]
    x = SPEC.encode(_rand(rng, 3 * 2 * 8)).reshape(3, 2, 8, F.LIMBS)
    got = M.BatchedDftMatmul(SPEC, ws)(F.limbs(x, "cpu"))
    assert _eq(got, np.asarray(JM.BatchedDftMatmul(JF.FR, ws)(jnp.asarray(x))))
    v = SPEC.encode(_rand(rng, 256)).reshape(1, 256, F.LIMBS)
    got = M.ntt256(SPEC, F.limbs(v, "cpu"))
    assert _eq(got, np.asarray(JM.ntt256(JF.FR, jnp.asarray(v))))
