"""halo2 ParamsKZG ``.srs`` files (backend/srs_format.py of the port):
round trip, byte equality with the file the reference writes for the
same K=6 dev SRS, each package reading the other's file, and rejection of
trailing bytes, an off-curve point and an out-of-range field element."""

import hashlib
import os

import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import srs_format as ref_sf
from halo2_aes_tpu_torch.backend import srs as SRS
from halo2_aes_tpu_torch.backend import srs_format as SF
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F

torch.set_num_threads(1)
SEED = b"fmt-test"
K = 6
TAU = int.from_bytes(hashlib.blake2b(SEED, digest_size=64).digest(),
                     "little") % F.FR.modulus


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    srs = SRS.setup(K, "cpu", seed=SEED, cache_dir=None)
    path = str(tmp_path_factory.mktemp("srs") / f"kzg_bn254_{K}.srs")
    SF.write_srs(path, srs, tau=TAU)
    return srs, path


def test_srs_file_roundtrip(written):
    srs, path = written
    n = 1 << K
    assert os.path.getsize(path) == 4 + 2 * n * 64 + 256
    back = SF.read_srs(path, "cpu")
    assert back.k == K and back.device == torch.device("cpu")
    assert torch.equal(back.g1_x, srs.g1_x) and torch.equal(back.g1_y, srs.g1_y)
    assert back.g2 == srs.g2 and back.s_g2 == srs.s_g2
    assert back.identity_tag() == srs.identity_tag()
    assert back.g1_extra is None
    one = F.const(F.FQ, "one", "cpu").expand(n, F.LIMBS)
    pts = CV.to_affine_host((back.g1_x, back.g1_y, one))
    assert all(CV.py_is_on_curve(p) for p in pts)
    assert pts[0] == (CV.G1_X, CV.G1_Y)
    assert pts[1] == CV.py_mul((CV.G1_X, CV.G1_Y), TAU)


def test_lagrange_table_sums_to_generator(written):
    _, path = written
    n = 1 << K
    with open(path, "rb") as f:
        buf = f.read()
    off = 4 + n * 64
    lag = np.frombuffer(buf[off:off + n * 64], dtype="<u2")
    lag = lag.reshape(n, 2, F.LIMBS).astype(np.uint32)
    lpts = CV.to_affine_host((lag[:, 0], lag[:, 1],
                              np.tile(F.FQ.one_mont, (n, 1))))
    acc = None
    for p in lpts:
        assert CV.py_is_on_curve(p)
        acc = CV.py_add(acc, p)
    assert acc == (CV.G1_X, CV.G1_Y)


def test_file_equals_reference_file(written, tmp_path):
    """The same dev SRS written by both packages: the same bytes; each
    reads the other's file."""
    srs, path = written
    ref = ref_srs.setup(K, seed=SEED, cache_dir=None)
    ref_path = str(tmp_path / "ref.srs")
    ref_sf.write_srs(ref_path, ref, tau=TAU)
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
    back = SF.read_srs(ref_path, "cpu")
    assert torch.equal(back.g1_x, srs.g1_x) and back.s_g2 == srs.s_g2
    ref_back = ref_sf.read_srs(path)
    assert np.array_equal(np.asarray(ref_back.g1_x), F.to_numpy(srs.g1_x))
    assert ref_back.identity_tag() == back.identity_tag()


def test_write_needs_tau(written, tmp_path):
    with pytest.raises(ValueError, match="requires tau"):
        SF.write_srs(str(tmp_path / "x.srs"), written[0])


def _rewrite(path, out, fn):
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    fn(buf)
    with open(out, "wb") as f:
        f.write(buf)
    return str(out)


def test_trailing_bytes_raise(written, tmp_path):
    bad = _rewrite(written[1], tmp_path / "t.srs", lambda b: b.extend(b"\x00"))
    with pytest.raises(ValueError, match="1 trailing bytes"):
        SF.read_srs(bad, "cpu")


def test_off_curve_point_raises(written, tmp_path):
    def flip(b):
        b[4 + 64 * 2 + 32] ^= 1          # y of g[2], lowest byte

    bad = _rewrite(written[1], tmp_path / "c.srs", flip)
    with pytest.raises(ValueError, match=r"g\[2\] not on curve"):
        SF.read_srs(bad, "cpu")


def test_out_of_range_g2_raises(written, tmp_path):
    def fill(b):
        b[-32:] = b"\xff" * 32

    bad = _rewrite(written[1], tmp_path / "r.srs", fill)
    with pytest.raises(ValueError, match="out of range"):
        SF.read_srs(bad, "cpu")
