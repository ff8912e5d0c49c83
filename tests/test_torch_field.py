"""The port's field ops (plain PyTorch on CPU) equal the reference's,
bit for bit, over Fr and Fq, including the edges 0, 1, p-1 and R mod p;
the plain Montgomery multiply also equals the TPU kernel's own body
(pallas_field.mont_mul_rows, run eagerly on (8, B) planes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_aes_tpu.ops import field as JF
from halo2_aes_tpu.ops import pallas_field as PF
from halo2_aes_tpu_torch.ops import cuda_field as CF
from halo2_aes_tpu_torch.ops import field as F

torch.set_num_threads(1)

SPECS = {"fr": (F.FR, JF.FR), "fq": (F.FQ, JF.FQ)}
N = 96


def _values(spec, seed):
    rng = np.random.default_rng(seed)
    p = spec.modulus
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N)]
    return vals + [0, 1, p - 1, spec.r_mod_p]


@pytest.fixture(scope="module", params=sorted(SPECS))
def operands(request):
    spec, jspec = SPECS[request.param]
    a = F.ints_to_limbs_fast(_values(spec, 1))
    b = F.ints_to_limbs_fast(_values(spec, 2)[::-1])
    return spec, jspec, a, b


def _eq(t, j):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(j))


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops(operands, op):
    spec, jspec, a, b = operands
    got = getattr(F, op)(spec, F.limbs(a, "cpu"), F.limbs(b, "cpu"))
    assert _eq(got, getattr(JF, op)(jspec, jnp.asarray(a), jnp.asarray(b)))


def test_broadcast_mont_mul(operands):
    spec, jspec, a, b = operands
    got = F.mont_mul(spec, F.limbs(a, "cpu").reshape(4, -1, 16),
                     F.limbs(b[:25], "cpu"))
    exp = JF.mont_mul(jspec, jnp.asarray(a).reshape(4, -1, 16),
                      jnp.asarray(b[:25]))
    assert _eq(got, exp)


@pytest.mark.parametrize("op", ["neg", "inv", "batch_inv", "cumprod"])
def test_unary_ops(operands, op):
    spec, jspec, a, _ = operands
    assert _eq(getattr(F, op)(spec, F.limbs(a, "cpu")),
               getattr(JF, op)(jspec, jnp.asarray(a)))


def test_inv_single_element(operands):
    """One element at a time, as batch_inv inverts its total, including
    0 (inv(0) = 0), 1 and p-1."""
    spec, jspec, a, _ = operands
    for row in (a[-4], a[-3], a[-2], a[5]):
        assert _eq(F.inv(spec, F.limbs(row, "cpu")), JF.inv(jspec, jnp.asarray(row)))


def test_cumprod_segmented(operands):
    spec, jspec, a, _ = operands
    got = F.cumprod_segmented(spec, F.limbs(a, "cpu"), 25)
    assert _eq(got, JF.cumprod_segmented(jspec, jnp.asarray(a), 25))


def test_powers_and_dot(operands):
    spec, jspec, a, b = operands
    assert _eq(F.powers(spec, F.limbs(a[3], "cpu"), 37),
               JF.powers(jspec, jnp.asarray(a[3]), 37))
    assert _eq(F.dot(spec, F.limbs(a, "cpu"), F.limbs(b, "cpu")),
               JF.dot(jspec, jnp.asarray(a), jnp.asarray(b)))


def test_u16_and_bytes_to_field(operands):
    spec, jspec, _, _ = operands
    v = np.arange(0, 1 << 16, 997, dtype=np.uint32)
    assert _eq(F.u16_to_field(spec, torch.as_tensor(v.astype(np.int32))),
               JF.u16_to_field(jspec, jnp.asarray(v)))
    by = np.arange(256, dtype=np.uint8)
    assert _eq(F.bytes_to_field(spec, torch.as_tensor(by)),
               JF.bytes_to_field(jspec, jnp.asarray(by)))


def test_plain_mont_mul_equals_pallas_kernel_body(operands):
    """The TPU kernel's arithmetic (13-bit delayed-carry CIOS on (8, B)
    limb planes) against the plain version the CUDA kernel is held to."""
    spec, _, a, b = operands
    rows = a.shape[0] // 8 * 8
    planes = lambda x: [jnp.asarray(x[:rows, i].reshape(8, -1))
                        for i in range(16)]
    out = PF.mont_mul_rows(planes(a), planes(b),
                           tuple(PF.p13_limbs(spec.modulus)),
                           PF.n0inv13(spec.modulus))
    kernel = np.stack([np.asarray(o).reshape(-1) for o in out], axis=1)
    plain = CF.mont_mul_plain(spec, F.limbs(a[:rows], "cpu"),
                              F.limbs(b[:rows], "cpu"))
    assert np.array_equal(plain.numpy().astype(np.uint32), kernel)


def test_wrapper_refuses_mixed_devices(operands):
    spec, _, a, _ = operands
    meta = torch.empty((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        CF.mont_mul(spec, F.limbs(a[:2], "cpu"), meta)
