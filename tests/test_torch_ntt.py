"""The port's NTTs (the composed four-step transform, through K2's plain
version on CPU) equal the reference's, bit for bit: ntt_many and the
coset transforms at k = 6..12, at k = 15 the reference's Pallas
four-step NTT run in interpret mode, and with the row cap lowered (three
to eight passes) the reference and the older two-pass plain route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import poly as ref_poly
from halo2_aes_tpu.ops import field as JF
from halo2_aes_tpu.ops import ntt as JN
from halo2_aes_tpu.ops import pallas_ntt as PN
from halo2_aes_tpu_torch.backend import poly
from halo2_aes_tpu_torch.ops import cuda_ntt
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import ntt

torch.set_num_threads(1)


def _rand(count, seed):
    rng = np.random.default_rng(seed)
    return F.FR.encode([int.from_bytes(rng.bytes(32), "little") % F.FR.modulus
                        for _ in range(count)])


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.mark.parametrize("k,count", [(6, 1), (7, 3), (11, 2), (12, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_many(k, count, inverse):
    a = _rand(count << k, k)
    got = ntt.ntt_many(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                       inverse=inverse)
    exp = JN.ntt_many(JN.domain(JF.FR, k), jnp.asarray(a), count,
                      inverse=inverse)
    assert _eq(got, exp)


@pytest.mark.parametrize("k", [6, 9])
def test_coset_evals_and_interp(k):
    c = _rand(1 << (k - 1), 100 + k)
    got = poly.coset_evals(ntt.domain(F.FR, k), F.limbs(c, "cpu"))
    exp = ref_poly.coset_evals(JN.domain(JF.FR, k), jnp.asarray(c))
    assert _eq(got, exp)
    back = poly.coset_interp(ntt.domain(F.FR, k), got)
    assert _eq(back, ref_poly.coset_interp(JN.domain(JF.FR, k), exp))


@pytest.mark.parametrize("k", [6, 10])
def test_coset_ntt_and_intt(k):
    c = _rand(1 << k, 200 + k)
    sp = F.FR.host_powers(5, 1 << k)
    sp_inv = F.FR.host_powers(pow(5, -1, F.FR.modulus), 1 << k)
    dom, jdom = ntt.domain(F.FR, k), JN.domain(JF.FR, k)
    got = ntt.coset_ntt(dom, F.limbs(c, "cpu"), F.limbs(sp, "cpu"))
    assert _eq(got, JN.coset_ntt(jdom, jnp.asarray(c), jnp.asarray(sp)))
    back = ntt.coset_intt(dom, got, F.limbs(sp_inv, "cpu"))
    assert _eq(back, c)


def test_ntt_many_shifted():
    k, count = 8, 3
    a = _rand(count << k, 7)
    sp = F.FR.host_powers(5, 1 << k)
    got = ntt.ntt_many(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                       shift_pows=F.limbs(sp, "cpu"))
    exp = JN.ntt_many(JN.domain(JF.FR, k), jnp.asarray(a), count,
                      shift_pows=jnp.asarray(sp))
    assert _eq(got, exp)


def test_k15_against_pallas_interpret():
    """Both four-step passes and the mid twiddle at k=15, count=2,
    against the reference's Pallas NTT lattice in interpret mode."""
    k, count = 15, 2
    a = _rand(count << k, 15)
    dom = JN.domain(JF.FR, k)
    PN.set_interpret(True)
    try:
        assert PN.enabled_for(dom)
        exp = PN.ntt_flat(dom, jnp.asarray(a), count)
    finally:
        PN.set_interpret(False)
    got = ntt.ntt_many(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count)
    assert _eq(got, exp)


@pytest.mark.parametrize("k", [12, 13])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_fused_passes_against_pallas_interpret(k, inverse, shift):
    """The card's composition (two fused K2 passes: strided rows, shift on
    load, mid twiddle in the epilogue, natural-order store), run through
    the kernel's plain version, against the reference's ntt_many and its
    Pallas lattice in interpret mode; count 3, odd k included."""
    count = 3
    a = _rand(count << k, 40 + k)
    sp = F.FR.host_powers(5, 1 << k) if shift else None
    dom = JN.domain(JF.FR, k)
    exp = JN.ntt_many(dom, jnp.asarray(a), count, inverse=inverse,
                      shift_pows=None if sp is None else jnp.asarray(sp))
    shifted = jnp.asarray(a) if sp is None else JF.mont_mul(
        JF.FR, jnp.asarray(a), jnp.tile(jnp.asarray(sp), (count, 1)))
    PN.set_interpret(True)
    try:
        assert _eq(F.limbs(np.asarray(exp), "cpu"),
                   PN.ntt_flat(dom, shifted, count, inverse=inverse))
    finally:
        PN.set_interpret(False)
    got = ntt._ntt_flat_composed(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                                 inverse, None if sp is None else F.limbs(sp, "cpu"))
    assert _eq(got, exp)


@pytest.mark.parametrize("k,count", [(1, 2), (4, 1), (7, 5), (11, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_single_pass(k, count, inverse):
    """k <= 11: one fused pass with the bit reversal, the shift and n^-1
    inside it equals the reference's ntt_many."""
    a = _rand(count << k, 60 + k)
    sp = F.FR.host_powers(7, 1 << k)
    got = ntt._ntt_flat_composed(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                                 inverse, F.limbs(sp, "cpu"))
    exp = JN.ntt_many(JN.domain(JF.FR, k), jnp.asarray(a), count,
                      inverse=inverse, shift_pows=jnp.asarray(sp))
    assert _eq(got, exp)


def test_fused_plain_is_the_cpu_route():
    """On CPU tensors the wrapper is the plain version, at every output
    stride (first, middle and natural-order passes) and with tables."""
    k, lt, count = 6, 3, 2
    x = F.limbs(_rand(count << k, 3), "cpu")
    tw = ntt._twiddles(F.FR, lt, False, "cpu")
    for stride in (1, 2, 4, 8):
        mul_out = F.limbs(_rand((1 << k) // stride, 5), "cpu")
        for table in (None, mul_out):
            assert torch.equal(
                cuda_ntt.ntt_fused(F.FR, x, count, k, lt, tw, stride, mul_out=table),
                cuda_ntt.ntt_fused_plain(F.FR, x, count, k, lt, tw, stride,
                                         mul_out=table))


def test_pass_wrapper_checks_shape():
    x = torch.zeros((2 * 64, 16), dtype=torch.int32, device="meta")
    tw = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):          # 48 twiddles asked of a T=8 pass
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw[:3], 8)
    with pytest.raises(ValueError):          # a meta tensor is no CUDA tensor
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw, 8)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 12, tw, 8)
    with pytest.raises(ValueError):          # rows longer than 2^MAX_LT
        cuda_ntt.ntt_fused(F.FR, x, 2, cuda_ntt.MAX_LT + 1, cuda_ntt.MAX_LT + 1,
                           tw, 1)
    for stride in (0, 3, 16):                # no power of two dividing 8 columns
        with pytest.raises(ValueError, match="stride"):
            cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw, stride)
    with pytest.raises(ValueError, match="in place"):
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw, 4, in_place=True)


@pytest.mark.parametrize("k,cap,want", [
    (6, 11, [6]), (12, 11, [6, 6]), (17, 11, [9, 8]), (22, 11, [11, 11]),
    (23, 11, [8, 8, 7]), (23, 12, [12, 11]), (26, 11, [9, 9, 8]),
    (28, 11, [10, 9, 9]), (8, 3, [3, 3, 2]), (8, 2, [2, 2, 2, 2])])
def test_pass_lengths(k, cap, want):
    """ceil(k / cap) passes, balanced, the longer first; at most two up to
    k = 22 with the card's cap, as before the composition grew."""
    assert ntt.pass_lengths(k, cap) == want
    assert ntt.pass_lengths(k, cap) == sorted(want, reverse=True)


@pytest.mark.parametrize("cap", [2, 3])
@pytest.mark.parametrize("k,count", [(4, 2), (6, 1), (7, 3), (8, 2)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_composed_low_row_cap(monkeypatch, cap, k, count, inverse, shift):
    """With the row cap lowered (three to four passes: first, middle and
    last strides, the mid twiddles of every level, n^-1 on the first),
    ntt_many equals the reference's and the older two-pass plain route."""
    a = _rand(count << k, 80 + 7 * k + count)
    sp = F.FR.host_powers(3, 1 << k) if shift else None
    monkeypatch.setattr(ntt, "ROW_CAP", cap)
    assert len(ntt.pass_lengths(k)) >= 2
    dom = ntt.domain(F.FR, k)
    got = ntt.ntt_many(dom, F.limbs(a, "cpu"), count, inverse=inverse,
                       shift_pows=None if sp is None else F.limbs(sp, "cpu"))
    exp = JN.ntt_many(JN.domain(JF.FR, k), jnp.asarray(a), count,
                      inverse=inverse,
                      shift_pows=None if sp is None else jnp.asarray(sp))
    assert _eq(got, exp)
    assert torch.equal(got, ntt.ntt_flat_plain(
        dom, F.limbs(a, "cpu"), count, inverse,
        None if sp is None else F.limbs(sp, "cpu")))
