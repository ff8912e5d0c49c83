"""The port's NTTs (four-step transform + plain pass on CPU) equal the
reference's, bit for bit: ntt_many and the coset transforms at
k = 6..12, and at k = 15 the reference's Pallas four-step NTT run in
interpret mode."""

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
    got = ntt._ntt_flat_cuda(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                             inverse, None if sp is None else F.limbs(sp, "cpu"))
    assert _eq(got, exp)


@pytest.mark.parametrize("k,count", [(1, 2), (4, 1), (7, 5), (11, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_single_pass(k, count, inverse):
    """k <= 11: one fused pass with the bit reversal, the shift and n^-1
    inside it equals the reference's ntt_many."""
    a = _rand(count << k, 60 + k)
    sp = F.FR.host_powers(7, 1 << k)
    got = ntt._ntt_flat_cuda(ntt.domain(F.FR, k), F.limbs(a, "cpu"), count,
                             inverse, F.limbs(sp, "cpu"))
    exp = JN.ntt_many(JN.domain(JF.FR, k), jnp.asarray(a), count,
                      inverse=inverse, shift_pows=jnp.asarray(sp))
    assert _eq(got, exp)


def test_fused_plain_is_the_cpu_route():
    k, lt, count = 6, 3, 2
    x = F.limbs(_rand(count << k, 3), "cpu")
    tw = ntt._twiddles(F.FR, lt, False, "cpu")
    for transposed in (False, True):
        assert torch.equal(
            cuda_ntt.ntt_fused(F.FR, x, count, k, lt, tw, transposed),
            cuda_ntt.ntt_fused_plain(F.FR, x, count, k, lt, tw, transposed))


def test_pass_wrapper_checks_shape():
    x = torch.zeros((2 * 64, 16), dtype=torch.int32, device="meta")
    tw = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):          # 48 twiddles asked of a T=8 pass
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw[:3], False)
    with pytest.raises(ValueError):          # a meta tensor is no CUDA tensor
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 3, tw, False)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_fused(F.FR, x, 2, 6, 12, tw, False)
