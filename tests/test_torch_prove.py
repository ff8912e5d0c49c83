"""The port's SRS, keygen, prover and verifier against the reference at
K=6: the toy and tagged-toy proofs are byte-identical to the golden
fixtures the JAX reference produced (scripts/make_torch_golden.py),
both verifiers accept them, and corrupted proofs and bad witnesses are
rejected."""

import json
import pathlib

import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu_torch.backend import convert
from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import K, TOYS
from halo2_aes_tpu_torch.ops import field as F

torch.set_num_threads(1)
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())
# (row, column, value) of one cell that breaks each toy's constraints
BAD_CELL = {"toy": (6, 2, 6), "tagged": (6, 1, 10)}


@pytest.fixture(scope="module")
def srs_pair():
    return srs.setup(K, "cpu", cache_dir=None), ref_srs.setup(K, cache_dir=None)


def test_srs_equals_reference(srs_pair):
    port, ref = srs_pair
    assert np.array_equal(F.to_numpy(port.g1_x), np.asarray(ref.g1_x))
    assert np.array_equal(F.to_numpy(port.g1_y), np.asarray(ref.g1_y))
    assert (port.g2, port.s_g2, port.g1_extra) == (ref.g2, ref.s_g2, ref.g1_extra)
    assert port.identity_tag() == ref.identity_tag()


@pytest.fixture(scope="module", params=sorted(TOYS))
def keys(request, srs_pair):
    name = request.param
    build, seed = TOYS[name]
    layout, values = build()
    ref_layout, _ = build(ref_ir)
    pk = keygen.keygen(layout, srs_pair[0])
    ref_pk = ref_keygen.keygen(ref_layout, srs_pair[1])
    return name, seed, layout, values, pk, ref_pk


def _ref_fields(ref_pk):
    vk = ref_pk.vk
    return dict(
        ext_k=vk.ext_k, usable=vk.usable, fixed_ids=vk.fixed_ids,
        fixed_commitments=vk.fixed_commitments,
        sigma_commitments=vk.sigma_commitments,
        fixed_coeffs={c: np.asarray(v) for c, v in ref_pk.fixed_coeffs.items()},
        sigma_coeffs=np.asarray(ref_pk.sigma_coeffs),
        perm_maps=tuple(np.asarray(m) for m in ref_pk.perm_maps),
        l0=np.asarray(ref_pk.l0_coeffs), l_last=np.asarray(ref_pk.l_last_coeffs),
        l_active=np.asarray(ref_pk.l_active_coeffs))


def _same_fields(a: dict, b: dict) -> bool:
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            if x.keys() != y.keys() or not all(
                    np.array_equal(x[c], y[c]) for c in x):
                return False
        elif isinstance(x, tuple) and isinstance(x[0], np.ndarray):
            if not all(np.array_equal(u, v) for u, v in zip(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def test_vk_digest_equals_golden(keys):
    name, _, _, _, pk, ref_pk = keys
    assert hex(pk.vk.digest) == GOLDEN[name]["vk_digest"]
    assert pk.vk.digest == ref_pk.vk.digest


def test_keygen_equals_reference(keys):
    _, _, _, _, pk, ref_pk = keys
    assert _same_fields(convert.pk_to_numpy(pk), _ref_fields(ref_pk))


def test_convert_round_trips_reference_pk(keys, srs_pair):
    name, seed, layout, values, _, ref_pk = keys
    ref = srs_pair[1]
    conv_srs = convert.srs_from_numpy(K, np.asarray(ref.g1_x), np.asarray(ref.g1_y),
                                      ref.g2, ref.s_g2, "cpu",
                                      g1_extra=ref.g1_extra)
    fields = _ref_fields(ref_pk)
    pk = convert.pk_from_numpy(layout, conv_srs, **fields)
    assert _same_fields(convert.pk_to_numpy(pk), fields)
    assert pk.vk.digest == ref_pk.vk.digest
    assert prover.prove(pk, values, seed=seed).hex() == GOLDEN[name]["proof"]


def test_prove_equals_golden_and_verifies(keys):
    name, seed, _, values, pk, ref_pk = keys
    proof = prover.prove(pk, values, seed=seed)
    assert proof.hex() == GOLDEN[name]["proof"]
    assert verifier.verify(pk.vk, proof)
    assert ref_verifier.verify(ref_pk.vk, proof)


def test_verify_batch(keys):
    """Two proofs of one circuit (golden seed and another) fold into one
    pairing check; a corrupted member makes the batch fail."""
    name, _, _, values, pk, _ = keys
    golden = bytes.fromhex(GOLDEN[name]["proof"])
    other = prover.prove(pk, values, seed=3)
    assert other != golden
    assert verifier.verify_batch(pk.vk, [golden, other])
    bad = bytearray(other)
    bad[-1] ^= 1
    with pytest.raises(verifier.VerifyError):
        verifier.verify_batch(pk.vk, [golden, bytes(bad)])


def test_corrupted_proof_rejected(keys):
    name, _, _, _, pk, _ = keys
    bad = bytearray(bytes.fromhex(GOLDEN[name]["proof"]))
    bad[-1] ^= 1
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, bytes(bad))


def test_bad_witness_rejected(keys):
    name, _, _, values, pk, _ = keys
    row, col, v = BAD_CELL[name]
    bad = values.copy()
    bad[row, col] = v
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, prover.prove(pk, bad, seed=1))


def test_unported_options_raise(keys):
    _, _, _, values, pk, _ = keys
    for kw in ({"multiopen": "gwc"}, {"lookup_sort": "packed"},
               {"mesh": object()}, {"checkpoint_dir": "x"}):
        with pytest.raises(NotImplementedError):
            prover.prove(pk, values, seed=0, **kw)
