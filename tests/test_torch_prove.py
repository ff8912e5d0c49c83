"""The port's SRS, keygen, prover and verifier against the reference at
K=6: the toy, tagged-toy and instance-toy proofs, and the toys' GWC and
packed-lookup proofs, are byte-identical to the golden fixtures the JAX
reference produced (scripts/make_torch_golden.py), both verifiers
accept them, and corrupted proofs, bad witnesses and changed instances
are rejected."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import prover as ref_prover
from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu_torch.backend import convert, get_backend
from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import GOLDEN_PROOFS, K, PUBLIC, TOYS
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.parallel import comm

torch.set_num_threads(1)
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())
# (column, row, value) of one cell that breaks each toy's constraints
BAD_CELL = {"toy": (6, 2, 6), "tagged": (6, 1, 10), "instance": (4, 0, 3),
            "onecol": (1, 1, 10), "onecol_lookup": (3, 1, 10)}
VARIANTS = sorted(n for n in GOLDEN_PROOFS if GOLDEN_PROOFS[n][1])


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
    return _keys(request.param, srs_pair)


def _keys(name, srs_pair):
    build, seed, _ = TOYS[name]
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
    inst = TOYS[name][2]
    proof = prover.prove(pk, values, seed=seed)
    assert proof.hex() == GOLDEN[name]["proof"]
    assert verifier.verify(pk.vk, proof, instances=inst)
    assert ref_verifier.verify(ref_pk.vk, proof, instances=inst)


def test_verify_batch(keys):
    """Two proofs of one circuit (golden seed and another) fold into one
    pairing check; a corrupted member makes the batch fail."""
    name, _, _, values, pk, _ = keys
    inst = [TOYS[name][2]] * 2
    golden = bytes.fromhex(GOLDEN[name]["proof"])
    other = prover.prove(pk, values, seed=3)
    assert other != golden
    assert verifier.verify_batch(pk.vk, [golden, other], inst)
    bad = bytearray(other)
    bad[-1] ^= 1
    with pytest.raises(verifier.VerifyError):
        verifier.verify_batch(pk.vk, [golden, bytes(bad)], inst)


def test_corrupted_proof_rejected(keys):
    name, _, _, _, pk, _ = keys
    bad = bytearray(bytes.fromhex(GOLDEN[name]["proof"]))
    bad[-1] ^= 1
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, bytes(bad), instances=TOYS[name][2])


def test_bad_witness_rejected(keys):
    name, _, _, values, pk, _ = keys
    row, col, v = BAD_CELL[name]
    bad = values.copy()
    bad[row, col] = v
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, prover.prove(pk, bad, seed=1),
                        instances=TOYS[name][2])


def test_unported_options_raise(keys, monkeypatch, tmp_path):
    """A vk whose extended domain exceeds the field's two-adicity (what
    the reference's Domain refuses) raises ValueError; an unknown
    multiopen is a ValueError; checkpoints on a mesh of more than one
    rank are accepted, and a directory the rank cannot see raises
    FileNotFoundError before any collective."""
    _, _, _, values, pk, _ = keys
    mesh = comm.Mesh(None, "gloo", 0, 2, torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="checkpoint_dir"):
        prover.prove(pk, values, seed=0, mesh=mesh,
                     checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="unknown multiopen"):
        prover.prove(pk, values, seed=0, multiopen="fri")
    big = dataclasses.replace(pk, vk=dataclasses.replace(
        pk.vk, ext_k=F.FR.two_adicity + 1))
    with pytest.raises(ValueError, match=f"k={K}: the extended domain"):
        prover.prove(big, values, seed=0)


def test_instance_toy_changed_instance_rejected(srs_pair):
    """The instance path: the proof binds to the public values; a batch
    with one changed instance value fails, and so does a proof of a
    witness whose instance cells disagree with the public values."""
    _, seed, _, values, pk, ref_pk = _keys("instance", srs_pair)
    proof = bytes.fromhex(GOLDEN["instance"]["proof"])
    other = prover.prove(pk, values, seed=seed + 1)
    changed = [PUBLIC[0], PUBLIC[1] + 1, PUBLIC[2]]
    with pytest.raises(verifier.VerifyError):
        verifier.verify_batch(pk.vk, [proof, other], [[PUBLIC], [changed]])
    with pytest.raises(ref_verifier.VerifyError):
        ref_verifier.verify(ref_pk.vk, proof, instances=[changed])
    # explicit instances override the matrix's: the proof then binds to them
    lied = prover.prove(pk, values, instances=[changed], seed=seed)
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, lied, instances=[changed])


@pytest.mark.parametrize("name", VARIANTS)
def test_prove_variant_equals_golden(name, srs_pair):
    """GWC multiopen and packed lookup keys: the port's toy proofs equal
    the reference's bytes, and both verifiers (and the backend registry)
    accept them."""
    toy, opts = GOLDEN_PROOFS[name]
    _, seed, _, values, pk, ref_pk = _keys(toy, srs_pair)
    proof = prover.prove(pk, values, seed=seed, **opts)
    assert proof.hex() == GOLDEN[name]["proof"]
    multiopen = opts.get("multiopen", "shplonk")
    assert verifier.verify(pk.vk, proof, multiopen=multiopen)
    assert ref_verifier.verify(ref_pk.vk, proof, multiopen=multiopen)
    assert get_backend(f"kzg-{multiopen}").verify(pk.vk, proof)
    bad = bytearray(proof)
    bad[-1] ^= 1
    with pytest.raises(verifier.VerifyError):
        verifier.verify(pk.vk, bytes(bad), multiopen=multiopen)


def test_packed_sort_needs_byte_tables(srs_pair):
    layout, values = TOYS["toy"][0]()
    layout.fixed[3, 40] = 300            # a table value past one byte
    pk = keygen.keygen(layout, srs_pair[0])
    with pytest.raises(ValueError):
        prover.prove(pk, values, seed=0, lookup_sort="packed")


def test_cli_parses_decrypt_expose_and_gwc():
    from halo2_aes_tpu_torch import prove as cli

    args = cli.parser().parse_args(
        ["--k", "17", "--blocks", "384", "--sets", "4", "--decrypt",
         "--expose-ciphertext", "--backend", "kzg-gwc", "--device", "cuda"])
    assert (args.decrypt, args.expose_ciphertext, args.backend) == (
        True, True, "kzg-gwc")
    assert cli.parser().parse_args(["--backend", "ipa"]).backend == "ipa"
    with pytest.raises(SystemExit):
        cli.parser().parse_args(["--backend", "fri", "--device", "cuda"])


def test_cli_device_defaults_to_the_card(monkeypatch):
    """No ``--device``: the first CUDA card, and at once an error that
    says why where there is none; a named device is taken as it is."""
    from halo2_aes_tpu_torch import prove as cli
    from halo2_aes_tpu_torch.ops.timing import resolve_device

    assert cli.parser().parse_args([]).device is None
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is false"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.run(17, 1, 1, False, False, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)


def test_cli_parses_checkpoint_dir():
    """The k=20 command line of the reference prover binary's shape, with a
    checkpoint directory; none by default."""
    from halo2_aes_tpu_torch import prove as cli

    args = cli.parser().parse_args(
        ["--k", "20", "--sets", "4", "--blocks", "3082", "--tagged", "--verify",
         "--device", "cuda", "--checkpoint-dir", "ckpt"])
    assert (args.k, args.sets, args.blocks, args.checkpoint_dir) == (
        20, 4, 3082, "ckpt")
    assert cli.parser().parse_args(["--device", "cpu"]).checkpoint_dir is None


@pytest.mark.parametrize("shape", [(1 << 16,), (5, 6), (17, 6), (3,), ()])
@pytest.mark.parametrize("seed", [0, 7])
def test_rand_field_is_the_references_draw(shape, seed):
    """The blinding and random-poly draw equals the reference's, value for
    value, from the same generator."""
    got = prover._rand_field(np.random.default_rng(seed), *shape)
    want = np.asarray(ref_prover._rand_field(np.random.default_rng(seed), *shape))
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_rand_field_compares_ties_whole():
    """Candidates whose top 64-bit word equals r's are compared in full:
    r and r + 1 are rejected, r - 1 and r - 2 kept, in the draw's order."""

    r = F.FR.modulus

    class Bytes:
        def __init__(self, *rounds):
            self.rounds = list(rounds)

        def bytes(self, n):
            vals = self.rounds.pop(0)
            assert n == 32 * len(vals)
            return b"".join(v.to_bytes(32, "little") for v in vals)

    rounds = ([r, r - 1, r + 1, 5], [7, r - 2])
    got = prover._rand_field(Bytes(*rounds), 4)
    want = np.asarray(ref_prover._rand_field(Bytes(*rounds), 4))
    np.testing.assert_array_equal(got, want)
    assert [F.limbs_to_int(row) for row in got] == [7, r - 1, r - 2, 5]
