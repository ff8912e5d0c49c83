"""The probe kernels' plain versions (P1, P2a, P2b) against the bodies of
the TPU probes' Pallas kernels, run eagerly with numpy refs, and the
Montgomery probes against K1's plain version; exact equality at
N = 2^10 with the edge values 0, 1, p-1 and R mod p."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from halo2_aes_tpu_torch.ops import cuda_field, cuda_probe
from halo2_aes_tpu_torch.ops import field as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 1 << 10
SUB = 8


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mul_ref():
    return _load("mul_throughput_probe")


@pytest.fixture(scope="module")
def pack_ref():
    return _load("pallas_pack_probe")


def _run_body(kern, refs, rows):
    """Run a Pallas kernel body on whole numpy arrays as its refs."""
    out = np.zeros((rows, N // SUB), np.uint32)
    kern(*refs, out)
    return out.reshape(-1, N)


def _planes(limbs_np):
    """(N, 16) limbs -> (16, N) int32 planes (a torch tensor)."""
    return torch.from_numpy(np.ascontiguousarray(limbs_np.T).astype(np.int32))


def _field_planes(rng, spec, edges_first: bool):
    limbs = rng.integers(0, 1 << 16, (N, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), N)
    edges = F.ints_to_limbs_fast([0, 1, spec.modulus - 1, spec.r_mod_p])
    limbs[:4] = edges if edges_first else edges[::-1]
    limbs[4:8] = edges
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("k", [64, 512])
@pytest.mark.parametrize("mask16", [False, True])
def test_mul_probe_plain_equals_pallas_body(mul_ref, k, mask16):
    rng = np.random.default_rng(k + mask16)
    a = rng.integers(0, 1 << 32, (F.LIMBS, N), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (F.LIMBS, N), dtype=np.uint64).astype(np.uint32)
    a[:, :8] = rng.integers(0, 1 << 16, (F.LIMBS, 8))      # the probe's inputs
    want = _run_body(mul_ref._mk_kernel(k, mask16),
                     [a.reshape(-1, N // SUB), b.reshape(-1, N // SUB)],
                     F.LIMBS * SUB)
    got = cuda_probe.mul_probe(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)), k, mask16)
    assert got.dtype == torch.int32 and got.shape == (F.LIMBS, N)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_mul_probe_rejects_other_k():
    a = torch.zeros((F.LIMBS, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_probe.mul_probe(a, a, 100)


@pytest.mark.parametrize("variant", ["planes16", "planes13"])
def test_mont_mul_planes_plain_equals_pallas_body(pack_ref, variant):
    spec = F.FR
    rng = np.random.default_rng(5 if variant == "planes16" else 6)
    a = _field_planes(rng, spec, True)
    b = _field_planes(rng, spec, False)
    ap, bp = (x.T.reshape(-1, N // SUB) for x in (a, b))
    if variant == "planes16":
        refs = [np.asarray(spec.p_limbs, np.uint32).reshape(F.LIMBS, 1),
                np.array([[spec.n0inv]], np.uint32), ap, bp]
        want = _run_body(pack_ref._kernel_packed, refs, F.LIMBS * SUB)
        got = cuda_probe.mont_mul_planes16(spec, _planes(a), _planes(b))
    else:
        p13 = pack_ref._p13(spec.modulus)
        n0 = (-pow(spec.modulus, -1, 1 << 13)) % (1 << 13)
        refs = [np.asarray(p13, np.uint32).reshape(-1, 1),
                np.array([[n0]], np.uint32), ap, bp]
        want = _run_body(pack_ref._kernel13, refs, F.LIMBS * SUB)
        got = cuda_probe.mont_mul_planes13(spec, _planes(a), _planes(b))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # the same products as K1's plain version on the (N, 16) layout
    k1 = cuda_field.mont_mul_plain(spec, _planes(a).T, _planes(b).T).T
    assert torch.equal(got, k1)


@pytest.mark.parametrize("spec", [F.FR, F.FQ], ids=["fr", "fq"])
def test_planes13_column_bound(spec):
    """The delayed-carry columns stay below 2^32, so the kernel's uint32
    columns equal the plain version's exact int64 ones; both Montgomery
    probes agree with K1 on either field."""
    rng = np.random.default_rng(9)
    a = _planes(_field_planes(rng, spec, True))
    b = _planes(_field_planes(rng, spec, False))
    out, top = cuda_probe.mont_mul_planes13_plain(spec, a, b, col_max=True)
    assert top < 1 << 32
    k1 = cuda_field.mont_mul_plain(spec, a.T, b.T).T
    assert torch.equal(out, k1)
    assert torch.equal(cuda_probe.mont_mul_planes16_plain(spec, a, b), k1)


def test_probe_wrappers_raise_on_mixed_devices():
    a = torch.zeros((F.LIMBS, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_probe._check_planes("mont_mul_planes16", a, a)
