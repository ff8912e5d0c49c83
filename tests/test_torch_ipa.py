"""The port's IPA proving system (backend/ipa.py and its wiring) against
the reference, bit for bit: the transparent basis at k=4 and K=6 (arrays,
``u_pt``, ``w_pt``, identity tag), the golden K=6 IPA proofs (toy and
tagged toy, seeded; also through the forced sliced path), cross
verification both ways, tampering / truncation / the KZG verifier
rejecting, the proof length against the cost model, the prover's guards
and the backend registry.  The golden bytes come from the JAX reference
(scripts/make_torch_golden.py), so no test here runs the reference's
prover."""

import json
import pathlib

import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import ipa as ref_ipa
from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu_torch.backend import convert, get_backend
from halo2_aes_tpu_torch.backend import ipa as IPA
from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import GOLDEN_IPA_PROOFS, K, TOYS
from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import cost_model

torch.set_num_threads(1)
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())


@pytest.fixture(scope="module")
def bases():
    return IPA.setup(K, "cpu", cache_dir=None), ref_ipa.setup(K, cache_dir=None)


def _same_basis(port, ref):
    return (np.array_equal(F.to_numpy(port.g1_x), np.asarray(ref.g1_x))
            and np.array_equal(F.to_numpy(port.g1_y), np.asarray(ref.g1_y))
            and (port.u_pt, port.w_pt) == (ref.u_pt, ref.w_pt)
            and port.identity_tag() == ref.identity_tag()
            and port.g1_extra is None and ref.g1_extra is None)


def test_basis_k4_equals_reference():
    port = IPA.setup(4, "cpu", cache_dir=None)
    assert port.n == 16 and _same_basis(port, ref_ipa.setup(4, cache_dir=None))


def test_basis_k6_equals_reference(bases):
    assert _same_basis(*bases)


def test_basis_points_on_curve_distinct_and_seeded(bases):
    port = bases[0]
    pts = [IPA._mont_limbs_to_point(port.g1_x[i], port.g1_y[i])
           for i in range(port.n)]
    for p in pts + [port.u_pt, port.w_pt]:
        assert CV.py_is_on_curve(p)
    assert len(set(pts + [port.u_pt, port.w_pt])) == port.n + 2
    assert IPA.basis_point0(port) == pts[0] == ref_ipa.basis_point0(bases[1])
    other = IPA.setup(4, "cpu", seed=b"other", cache_dir=None)
    assert other.u_pt != IPA.setup(4, "cpu", cache_dir=None).u_pt


def test_basis_cache_file_is_shared(tmp_path):
    """The ``ipa_bn254_{k}_{tag}.npz`` file either package writes loads
    in the other, with the same identity tag."""
    port = IPA.setup(4, "cpu", cache_dir=str(tmp_path))
    files = sorted(p.name for p in tmp_path.glob("ipa_bn254_4_*.npz"))
    assert len(files) == 1
    assert _same_basis(IPA.setup(4, "cpu", cache_dir=str(tmp_path)),
                       ref_ipa.setup(4, cache_dir=str(tmp_path)))
    assert sorted(p.name for p in tmp_path.glob("ipa_bn254_4_*.npz")) == files
    assert port.identity_tag() != srs.setup(4, "cpu", cache_dir=None).identity_tag()


def test_lift_x_batch_equals_host_sqrt():
    q = F.FQ.modulus
    xs = IPA._candidate_xs(64, b"lift")
    assert xs == ref_ipa._candidate_xs(64, b"lift")
    y_m, ok = IPA._lift_x_batch(F.encode(F.FQ, xs, "cpu"))
    ys = F.FQ.decode(y_m)
    for x, y, good in zip(xs, ys, ok.tolist()):
        rhs = (x * x * x + 3) % q
        assert good == (pow(rhs, (q - 1) // 2, q) in (0, 1))
        if good:
            assert y * y % q == rhs


def test_convert_carries_ipa_points(bases):
    port, ref = bases
    conv = convert.srs_from_numpy(K, np.asarray(ref.g1_x), np.asarray(ref.g1_y),
                                  ref.g2, ref.s_g2, "cpu", u_pt=ref.u_pt,
                                  w_pt=ref.w_pt)
    assert _same_basis(conv, ref) and torch.equal(conv.g1_x, port.g1_x)


@pytest.fixture(scope="module", params=sorted(GOLDEN_IPA_PROOFS))
def proved(request, bases):
    name = request.param
    build, seed, instances = TOYS[GOLDEN_IPA_PROOFS[name]]
    layout, values = build()
    pk = keygen.keygen(layout, bases[0])
    proof = prover.prove(pk, values, seed=seed, multiopen="ipa")
    ref_pk = ref_keygen.keygen(build(ref_ir)[0], bases[1])
    return name, layout, values, seed, instances, pk, ref_pk, proof


def test_ipa_proof_equals_golden(proved):
    name, _, _, _, _, pk, ref_pk, proof = proved
    assert hex(pk.vk.digest) == GOLDEN[name]["vk_digest"]
    assert pk.vk.digest == ref_pk.vk.digest
    assert proof.hex() == GOLDEN[name]["proof"]


def test_ipa_cross_verification(proved, bases):
    """The port's verifier accepts the reference's proof (the golden
    bytes) and the reference's verifier accepts the port's (another
    seed, so bytes the reference never produced)."""
    name, _, values, seed, inst, pk, ref_pk, proof = proved
    golden = bytes.fromhex(GOLDEN[name]["proof"])
    assert IPA.verify(pk.vk, golden, instances=inst, srs=bases[0])
    other = prover.prove(pk, values, seed=seed + 1, multiopen="ipa")
    assert other != proof
    assert IPA.verify(pk.vk, other, instances=inst, srs=bases[0])
    assert ref_ipa.verify(ref_pk.vk, other, instances=inst, srs=bases[1])
    assert get_backend("ipa").verify(pk.vk, proof, instances=inst, srs=bases[0])


def test_ipa_forced_sliced_path_equals_golden(proved, bases, monkeypatch):
    name, layout, values, seed, _, _, _, _ = proved
    pk = keygen.keygen(layout, bases[0])
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    assert prover._get_phases(pk).large()
    sliced = prover.prove(pk, values, seed=seed, multiopen="ipa")
    assert sliced.hex() == GOLDEN[name]["proof"]


def test_ipa_proof_length_equals_cost_model(proved):
    _, layout, _, _, _, _, _, proof = proved
    assert len(proof) == cost_model.estimate(layout, multiopen="ipa").proof_bytes
    assert len(proof) > cost_model.estimate(layout).proof_bytes


def test_ipa_rejects_tampering(proved, bases):
    _, _, _, _, inst, pk, ref_pk, proof = proved
    for pos in (-1, -33, 5):        # f_fin, a_fin, an advice commitment
        bad = bytearray(proof)
        bad[pos] ^= 1
        with pytest.raises(verifier.VerifyError):
            IPA.verify(pk.vk, bytes(bad), instances=inst, srs=bases[0])
    with pytest.raises(verifier.VerifyError):
        IPA.verify(pk.vk, proof[:-40], instances=inst, srs=bases[0])
    with pytest.raises(verifier.VerifyError):
        IPA.verify(pk.vk, proof + b"\x00" * 32, instances=inst, srs=bases[0])
    bad = bytearray(proof)
    bad[-1] ^= 1
    with pytest.raises(ref_verifier.VerifyError):
        ref_ipa.verify(ref_pk.vk, bytes(bad), instances=inst, srs=bases[1])


def test_ipa_proof_rejected_by_kzg_verifier(proved):
    _, _, _, _, inst, pk, _, proof = proved
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, proof, instances=inst)


def test_ipa_wrong_basis_rejected(proved):
    _, _, _, _, inst, pk, _, proof = proved
    other = IPA.setup(K, "cpu", seed=b"other", cache_dir=None)
    with pytest.raises(verifier.VerifyError):
        IPA.verify(pk.vk, proof, instances=inst, srs=other)


def test_ipa_prove_with_checkpoints_clears_them(proved, tmp_path):
    name, _, values, seed, _, pk, _, _ = proved
    proof = prover.prove(pk, values, seed=seed, multiopen="ipa",
                         checkpoint_dir=str(tmp_path))
    assert proof.hex() == GOLDEN[name]["proof"]
    assert not [p for p in tmp_path.rglob("*") if p.is_file()]


def test_kzg_srs_with_ipa_raises_the_guard():
    layout, values = TOYS["toy"][0]()
    kzg = srs.setup(K, "cpu", cache_dir=None)
    pk = keygen.keygen(layout, kzg)
    # the dev SRS blinds the quotient pieces: the first guard
    with pytest.raises(AssertionError, match="KZG-blinded quotient pieces"):
        prover.prove(pk, values, seed=1, multiopen="ipa")
    # a ceremony-style SRS (no g1_extra) reaches the second
    bare = convert.srs_from_numpy(K, F.to_numpy(kzg.g1_x), F.to_numpy(kzg.g1_y),
                                  kzg.g2, kzg.s_g2, "cpu")
    with pytest.raises(AssertionError, match="requires an IPA transparent basis"):
        prover.prove(keygen.keygen(layout, bare), values, seed=1, multiopen="ipa")


def test_rand_scalar_follows_the_generator():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    got = [IPA._rand_scalar(a) for _ in range(4)]
    assert got == [ref_ipa._rand_scalar(b) for _ in range(4)]
    assert all(0 <= v < F.FR.modulus for v in got)
    assert IPA._rand_scalar(None) != IPA._rand_scalar(None)


def test_backend_registry_exposes_ipa():
    b = get_backend("ipa")
    assert b.name == "ipa"
    assert b.setup_srs is IPA.setup and b.verify is IPA.verify
    assert b.prove.keywords == {"multiopen": "ipa"}
    with pytest.raises(KeyError):
        get_backend("nope")
