"""The port's ``ops/mxu_field.py`` (K5's plain version on the CPU) against
the reference's, bit for bit: the host matrices, the nibble split, the
carry pass, the R' = 2^272 reduction, FixedMul (also against the port's
``mont_mul``), DftMatmul at N = 4, 16, 32 (all p-1 at 32),
BatchedDftMatmul and ntt256 (also against the port's ``ntt`` at k = 8);
and ``nibble_product_plain`` against a numpy int64 product and fold.
Inputs are made by numpy from a seed; the reference's results that more
than one test reads are module-scoped fixtures."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.ops import field as JF
from halo2_aes_tpu.ops import mxu_field as JM
from halo2_aes_tpu_torch.ops import cuda_nibble
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import mxu_field as M
from halo2_aes_tpu_torch.ops import ntt

torch.set_num_threads(1)

SPEC = F.FR
P = SPEC.modulus


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _port(limbs):
    return F.limbs(limbs, "cpu")


def _eq(t, ref):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(ref))


def test_constants_match():
    for name in ("NIB_BITS", "NIB_MASK", "NIBS", "RP_LIMBS", "RP_NIBS",
                 "RP_BITS", "DFT_MAX_N"):
        assert getattr(M, name) == getattr(JM, name), name


@pytest.mark.parametrize("kind,in_nibs,out_nibs", [
    ("random", 64, 127), ("zero", 64, 127), ("p-1", 68, 131), ("random", 68, 68),
    ("2^255", 64, 127)])
def test_banded_equal(kind, in_nibs, out_nibs):
    rng = np.random.default_rng(in_nibs + out_nibs)
    value = {"random": _rand(rng, 1)[0], "zero": 0, "p-1": P - 1,
             "2^255": (1 << 255) % P}[kind]
    got = M.banded(value, in_nibs, out_nibs)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, JM.banded(value, in_nibs, out_nibs))


@pytest.mark.parametrize("modulus", [F.FR_MODULUS, F.FQ_MODULUS], ids=["fr", "fq"])
def test_reducer_mats_equal(modulus):
    for got, want in zip(M._reducer_mats(modulus), JM._reducer_mats(modulus)):
        np.testing.assert_array_equal(got, want)


def test_nibble_roundtrip():
    rng = np.random.default_rng(1)
    xs = _rand(rng, 32) + [0, 1, P - 1]
    limbs = F.ints_to_limbs_fast(xs)
    nib = M.nibbles_from_limbs(_port(limbs))
    assert nib.dtype == torch.int8 and nib.shape == (len(xs), M.NIBS)
    assert int(nib.min()) >= 0 and int(nib.max()) <= 15
    back = [sum(int(v) << (4 * i) for i, v in enumerate(row)) for row in nib.tolist()]
    assert back == xs
    assert _eq(nib.to(torch.int32),
               np.asarray(JM.nibbles_from_limbs(jnp.asarray(limbs))).astype(np.uint32))


@pytest.mark.parametrize("m,out_limbs", [(17, 17), (32, 32), (33, 33), (34, 34),
                                         (34, 16)])
def test_carry_norm_ks(m, out_limbs):
    """Random redundant limbs below 2^31, with 0xFFFF ripple chains (a
    generated carry running through propagating limbs) and all-0xFFFF rows."""
    rng = np.random.default_rng(m * 100 + out_limbs)
    acc = rng.integers(0, 1 << 31, (24, m), dtype=np.int64)
    acc[4:12] = rng.integers(0, 1 << 16, (8, m))
    acc[8:12, 1:m - 1] = 0xFFFF            # a carry from limb 0 ripples up
    acc[8:12, 0] = 0x1FFFF
    acc[12:14] = 0xFFFF
    acc[14, :] = 0x10000
    got = M.carry_norm_ks(torch.from_numpy(acc.astype(np.int32)), out_limbs)
    want = np.asarray(JM.carry_norm_ks(jnp.asarray(acc.astype(np.uint32)), out_limbs))
    assert got.dtype == torch.int32 and got.shape == (24, out_limbs)
    assert _eq(got, want)
    # and the value itself: the limbs sum mod 2^(16 out_limbs)
    for row, out in zip(acc.tolist(), got.tolist()):
        total = sum(v << (16 * i) for i, v in enumerate(row))
        assert sum(v << (16 * i) for i, v in enumerate(out)) == \
            total % (1 << (16 * out_limbs))


def test_reduce_wide():
    rng = np.random.default_rng(2)
    ts = [int.from_bytes(rng.bytes(70), "little") % (P << M.RP_BITS) for _ in range(16)]
    ts += [0, (P << M.RP_BITS) - 1]
    limbs = np.array([[(t >> (16 * j)) & 0xFFFF for j in range(33)] for t in ts],
                     dtype=np.uint32)
    got = M.reduce_wide(SPEC, _port(limbs))
    want = np.asarray(JM.reduce_wide(JF.FR, jnp.asarray(limbs)))
    assert got.dtype == torch.int32 and got.shape == (len(ts), F.LIMBS)
    assert _eq(got, want)
    rp_inv = pow(1 << M.RP_BITS, -1, P)
    assert F.limbs_to_ints(got) == [(t * rp_inv) % P for t in ts]


@pytest.fixture(scope="module")
def fixed_inputs():
    rng = np.random.default_rng(3)
    return F.ints_to_limbs_fast(_rand(rng, 24) + [0, 1, P - 1])


@pytest.mark.parametrize("b", ["random", "0", "1", "p-1", "2^255 mod p"])
def test_fixed_mul(fixed_inputs, b):
    rng = np.random.default_rng(4)
    b_val = {"random": _rand(rng, 1)[0], "0": 0, "1": 1, "p-1": P - 1,
             "2^255 mod p": (1 << 255) % P}[b]
    a = _port(fixed_inputs)
    got = M.FixedMul(SPEC, b_val)(a)
    assert got.dtype == torch.int32 and got.shape == a.shape
    assert torch.equal(got, F.mont_mul(SPEC, a, _port(F.int_to_limbs(b_val))))
    want = np.asarray(JM.FixedMul(JF.FR, b_val)(jnp.asarray(fixed_inputs)))
    assert _eq(got, want)


def _dft_case(n, extreme):
    rng = np.random.default_rng(n)
    if extreme:
        w = [[P - 1] * n for _ in range(n)]
        x = SPEC.encode([P - 1] * (3 * n)).reshape(3, n, F.LIMBS)
    else:
        w = [[int(v) for v in _rand(rng, n)] for _ in range(n)]
        x = SPEC.encode(_rand(rng, 3 * n)).reshape(3, n, F.LIMBS)
    return w, x


@pytest.fixture(scope="module")
def dft_results():
    """n -> (w, x, the reference's DftMatmul matrix and output)."""
    out = {}
    for n, extreme in ((4, False), (16, False), (32, True)):
        w, x = _dft_case(n, extreme)
        ref = JM.DftMatmul(JF.FR, w)
        out[n] = (w, x, np.asarray(ref._W), np.asarray(ref(jnp.asarray(x))))
    return out


@pytest.mark.parametrize("n", [4, 16, 32])
def test_dft_matmul(dft_results, n):
    w, x, ref_w, ref_out = dft_results[n]
    dft = M.DftMatmul(SPEC, w)
    np.testing.assert_array_equal(dft._W[0], ref_w)
    got = dft(_port(x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert _eq(got, ref_out)
    # the values themselves: Montgomery in, Montgomery out
    xs = SPEC.decode(x.reshape(-1, F.LIMBS))
    vals = SPEC.decode(got.reshape(-1, F.LIMBS))
    for v in range(x.shape[0]):
        row = xs[v * n:(v + 1) * n]
        assert vals[v * n:(v + 1) * n] == [
            sum(w[j][k] * row[k] for k in range(n)) % P for j in range(n)]


def test_batched_dft_matmul():
    rng = np.random.default_rng(5)
    g, n = 3, 4
    ws = [[[int(v) for v in _rand(rng, n)] for _ in range(n)] for _ in range(g)]
    x = SPEC.encode(_rand(rng, 2 * g * n)).reshape(2, g, n, F.LIMBS)
    mat = M.BatchedDftMatmul(SPEC, ws)
    ref = JM.BatchedDftMatmul(JF.FR, ws)
    np.testing.assert_array_equal(mat._W, np.asarray(ref._W))
    got = mat(_port(x))
    assert got.shape == x.shape
    assert _eq(got, np.asarray(ref(jnp.asarray(x))))


@pytest.mark.parametrize("cls", ["DftMatmul", "BatchedDftMatmul"])
def test_dft_max_n(cls):
    w = [[0] * 33 for _ in range(33)]
    with pytest.raises(AssertionError, match="int32 accumulator bound: N <= 32"):
        if cls == "DftMatmul":
            M.DftMatmul(SPEC, w)
        else:
            M.BatchedDftMatmul(SPEC, [w])


@pytest.fixture(scope="module")
def ntt256_case():
    rng = np.random.default_rng(6)
    x = SPEC.encode(_rand(rng, 2 * 256)).reshape(2, 256, F.LIMBS)
    return x, M.ntt256(SPEC, _port(x))


def test_ntt256_matches_reference(ntt256_case):
    x, got = ntt256_case
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert _eq(got, np.asarray(JM.ntt256(JF.FR, jnp.asarray(x))))


def test_ntt256_matches_port_ntt(ntt256_case):
    x, got = ntt256_case
    dom = ntt.domain(SPEC, 8)
    assert torch.equal(got, ntt.ntt_many(dom, _port(x).reshape(-1, F.LIMBS), 2)
                       .reshape(x.shape))
    assert torch.equal(got[1], ntt.ntt(dom, _port(x[1])))


def _numpy_product(x, B, block):
    """int64 nibble product plus per-block fold, in numpy."""
    nib = ((x[..., None] >> np.array([0, 4, 8, 12])) & 0xF).reshape(
        *x.shape[:-1], -1).astype(np.int64)
    conv = np.einsum("grk,gkm->grm", nib, B.astype(np.int64))
    g, rows, m = conv.shape
    olb = -(-block // 4)
    c = np.zeros((g, rows, m // block, 4 * olb), np.int64)
    c[..., :block] = conv.reshape(g, rows, m // block, block)
    return (c.reshape(g, rows, m // block, olb, 4)
            * np.array([1, 16, 256, 4096])).sum(-1).reshape(g, rows, -1)


@pytest.mark.parametrize("g,limbs,m,block", [
    (1, 16, 127, 127), (1, 17, 68, 68), (1, 17, 131, 131), (2, 32, 254, 127),
    (3, 16, 127, 127), (1, 512, 32 * 127, 127)])
def test_nibble_product_plain(g, limbs, m, block):
    rng = np.random.default_rng(limbs + m)
    rows = 5
    x = rng.integers(0, 1 << 16, (g, rows, limbs), dtype=np.int64)
    B = rng.integers(0, 16, (g, 4 * limbs, m), dtype=np.int64)
    if limbs == 512:            # the accumulator edge the kernel admits
        x[:] = 0xFFFF
        B[:] = 15
    want = _numpy_product(x, B, block)
    assert want.max() < 1 << 31
    xt = torch.from_numpy(x.astype(np.int32))
    Bt = torch.from_numpy(B.astype(np.int8))
    got = cuda_nibble.nibble_product_plain(xt, Bt, block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    before = cuda_nibble.LAUNCHES
    assert torch.equal(cuda_nibble.nibble_product(xt, Bt, block), got)
    assert cuda_nibble.LAUNCHES == before          # the CPU takes the plain version
    if limbs == 512:
        assert int(got.max()) == 225 * 2048 * 4369


def test_nibble_product_rejects():
    x = torch.zeros((1, 4, 16), dtype=torch.int32)
    B = torch.zeros((1, 64, 127), dtype=torch.int8)
    with pytest.raises(TypeError):
        cuda_nibble.nibble_product(x.to(torch.int64), B)
    with pytest.raises(TypeError):
        cuda_nibble.nibble_product(x, B.to(torch.int32))
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(x[0], B)                          # not 3-d
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(x, B[:, :60])                     # K != 4L
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(x, B, 100)                        # block
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(torch.zeros((1, 4, 600), dtype=torch.int32),
                                   torch.zeros((1, 2400, 8), dtype=torch.int8))
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(x[:, ::2], B)                     # strided
    with pytest.raises(ValueError):
        cuda_nibble.nibble_product(x.to("meta"), B.to("meta"))      # no kernel


def test_probe_helpers():
    """The probe script's K5 cases, bound and spot check on the CPU at
    a 2^8 batch (its timings need the card)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "torch_mxu_probe.py"
    spec = importlib.util.spec_from_file_location("_probe_torch_mxu", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    rng = np.random.default_rng(8)
    cases = probe.k5_cases(8, rng, "cpu")
    assert {k: (tuple(x.shape), tuple(B.shape), blk) for k, (x, B, blk) in cases.items()} == {
        "fixed_64x127": ((1, 256, 16), (1, 64, 127), None),
        "reduce_68x68": ((1, 256, 17), (1, 68, 68), None),
        "reduce_68x131": ((1, 256, 17), (1, 68, 131), None),
        "dft16_1024x2032": ((1, 16, 256), (1, 1024, 2032), 127),
        "ntt256_stage2_16x1024x2032": ((16, 1, 256), (16, 1024, 2032), 127)}
    x, B, blk = cases["dft16_1024x2032"]
    bound = probe.k5_bound(x, B, blk)
    assert bound["macs"] == 16 * int(np.count_nonzero(B.numpy()))
    assert bound["bytes"] == 4 * x.numel() + B.numel() + 4 * 16 * 16 * 32
    a = probe.random_fr(256, rng, "cpu")
    probe.spot_check(a[:8], P - 2, a.reshape(1, 256, F.LIMBS))
