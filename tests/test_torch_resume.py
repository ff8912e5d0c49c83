"""Checkpoint/resume and the sanitizer of the port's prover at K=6
(the reference's tests/test_prove_verify.py:225-299 and
tests/test_devtools.py:46-80): a prove crashed after any phase resumes
from its checkpoints to the golden bytes without recomputing the saved
phases (also with the k >= 23 path forced), checkpoints key on the same
bytes as the reference's, and the phase-boundary canonicity checks pass
honest proves and catch a corrupted phase output."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import resume as ref_resume
from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.utils import sanitize as ref_sanitize
from halo2_aes_tpu_torch.backend import keygen, prover, rest, resume, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import K, TOYS
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.utils import sanitize as SAN

torch.set_num_threads(1)
GOLDEN = json.loads((pathlib.Path(__file__).resolve().parent.parent
                     / "halo2_aes_tpu_torch" / "testdata"
                     / "golden_k6.json").read_text())


@pytest.fixture(scope="module")
def toy():
    """The tagged toy: (values, port pk, reference pk, golden seed)."""
    build, seed, _ = TOYS["tagged"]
    layout, values = build()
    pk = keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None))
    ref_pk = ref_keygen.keygen(build(ref_ir)[0], ref_srs.setup(K, cache_dir=None))
    return values, pk, ref_pk, seed


# the phase functions that compute each checkpointed phase (both paths)
PHASE_FNS = {"advice": ["advice_phase"], "lookup": ["lookup_phase"],
             "products": ["perm_products", "lookup_products_all",
                          "lookup_products_streamed"],
             "quotient": ["quotient_subcoset"]}


@pytest.mark.parametrize("crash_after", resume.PHASES)
def test_checkpoint_resume(toy, tmp_path, monkeypatch, crash_after):
    """A prove killed right after a phase's checkpoint lands resumes at
    the next phase, replays the Fiat-Shamir absorbs from the saved
    points, and gives the golden bytes; success clears the checkpoint."""
    _crash_and_resume(toy, tmp_path, monkeypatch, crash_after)


@pytest.mark.parametrize("crash_after", resume.PHASES)
def test_checkpoint_resume_host_rest(toy, tmp_path, monkeypatch, crash_after):
    """The same with the k >= 23 switch forced (coefficient stacks saved
    from and restored to where they rest) on the sliced path: the golden
    bytes."""
    monkeypatch.setattr(rest, "HOST_REST_MIN_K", K)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    _crash_and_resume(toy, tmp_path, monkeypatch, crash_after)


def _crash_and_resume(toy, tmp_path, monkeypatch, crash_after):
    values, pk, ref_pk, seed = toy
    orig_save = resume.ProveCheckpoint.save

    def crashing_save(self, phase, arrays, points, rng=None):
        orig_save(self, phase, arrays, points, rng)
        if phase == crash_after:
            raise RuntimeError("injected crash")

    monkeypatch.setattr(resume.ProveCheckpoint, "save", crashing_save)
    with pytest.raises(RuntimeError, match="injected crash"):
        prover.prove(pk, values, seed=seed, checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(resume.ProveCheckpoint, "save", orig_save)

    # the resumed prove must not recompute the saved phases
    ph = prover._get_phases(pk)

    def boom(*a, **k):
        raise AssertionError("restored phase was recomputed")

    for phase in resume.PHASES[:resume.PHASES.index(crash_after) + 1]:
        for fn in PHASE_FNS[phase]:
            monkeypatch.setattr(ph, fn, boom)
    resumed = prover.prove(pk, values, seed=seed, checkpoint_dir=str(tmp_path))
    assert resumed.hex() == GOLDEN["tagged"]["proof"]
    assert verifier.verify(pk.vk, resumed)
    assert ref_verifier.verify(ref_pk.vk, resumed)
    for d in tmp_path.iterdir():
        assert not list(d.iterdir())


def test_checkpoint_keyed_on_inputs(toy, tmp_path):
    """A checkpoint directory of one (witness, seed) never serves a prove
    of other inputs."""
    values, pk, _, _ = toy

    def ckpt(vals, seed):
        return resume.ProveCheckpoint(str(tmp_path), resume.prove_key_material(
            pk.vk.digest, vals, [], seed, "shplonk"))

    a, b = ckpt(values, 7), ckpt(values, 8)
    assert a.dir != b.dir
    bad = values.copy()
    bad[6, 2] ^= 1
    assert ckpt(bad, 7).dir != a.dir


@pytest.mark.parametrize("multiopen,lookup_sort", [("shplonk", "field"),
                                                   ("gwc", "packed")])
def test_key_material_equals_reference(toy, multiopen, lookup_sort):
    """The same inputs give the reference's key bytes, whether the witness
    comes as the uint32 array or as the port's int32 tensor."""
    values, pk, _, _ = toy
    inst = [[3, 1, 4], [1, 5]]
    want = ref_resume.prove_key_material(pk.vk.digest, values, inst, 7,
                                         multiopen, lookup_sort)
    assert resume.prove_key_material(pk.vk.digest, values, inst, 7, multiopen,
                                     lookup_sort) == want
    as_tensor = torch.as_tensor(values.astype(np.int32))
    assert resume.prove_key_material(pk.vk.digest, as_tensor, inst, 7,
                                     multiopen, lookup_sort) == want


def test_sanitized_prove_and_determinism(toy, monkeypatch):
    """With HALO2_SANITIZE=1 an honest prove passes every phase-boundary
    canonicity check; seeded proves are byte-deterministic and unseeded
    ones differ."""
    values, pk, _, seed = toy
    monkeypatch.setenv("HALO2_SANITIZE", "1")
    a = prover.prove(pk, values, seed=seed)
    assert a.hex() == GOLDEN["tagged"]["proof"]
    assert verifier.verify(pk.vk, a)
    monkeypatch.delenv("HALO2_SANITIZE")
    assert prover.prove(pk, values, seed=seed) == a
    assert prover.prove(pk, values) != prover.prove(pk, values)


def test_sanitizer_catches_corrupt_phase(toy, monkeypatch):
    """A lookup phase that hands out a limb vector >= r fails at the
    lookup boundary when HALO2_SANITIZE=1, and only then."""
    values, pk, _, seed = toy
    ph = prover._get_phases(pk)
    honest = ph.lookup_phase

    def corrupt(*a, **k):
        ap, sp, ac, sc = honest(*a, **k)
        ac = ac.clone()
        ac[0] = F.limbs(F.int_to_limbs(F.FR.modulus), ac.device)
        return ap, sp, ac, sc

    monkeypatch.setattr(ph, "lookup_phase", corrupt)
    monkeypatch.setenv("HALO2_SANITIZE", "1")
    with pytest.raises(SAN.SanitizeError, match="lookup.a_coeffs"):
        prover.prove(pk, values, seed=seed)
    monkeypatch.delenv("HALO2_SANITIZE")
    prover.prove(pk, values, seed=seed)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_sanitize_canonicity(as_tensor):
    """Canonical limbs pass; >= modulus, limb overflow and bad shapes are
    flagged, as the reference flags them, for arrays and tensors alike."""
    conv = (lambda a: torch.as_tensor(a.astype(np.int32))) if as_tensor else np.asarray
    good = F.FR.encode([0, 1, F.FR.modulus - 1])
    assert SAN.noncanonical_count(F.FR, conv(good)) == 0

    bad = good.copy()
    bad[1] = F.int_to_limbs(F.FR.modulus)          # == r: non-canonical
    assert SAN.noncanonical_count(F.FR, conv(bad)) == 1
    assert ref_sanitize.noncanonical_count(F.FR, bad) == 1
    with pytest.raises(SAN.SanitizeError, match="non-canonical"):
        SAN.check_canonical(F.FR, conv(bad), "t")

    over = good.copy()
    over[0, 3] = 1 << 16                            # limb overflow
    assert SAN.noncanonical_count(F.FR, conv(over)) == 1

    with pytest.raises(SAN.SanitizeError, match="expected"):
        SAN.noncanonical_count(F.FR, conv(np.zeros((4, 3), np.uint32)))

    # check_phase does nothing unless HALO2_SANITIZE=1
    SAN.check_phase(F.FR, "p", t=conv(bad))
    os.environ["HALO2_SANITIZE"] = "1"
    try:
        with pytest.raises(SAN.SanitizeError):
            SAN.check_phase(F.FR, "p", t=conv(bad))
        SAN.check_phase(F.FR, "p", t=conv(good),
                        empty=conv(np.zeros((0, 16), np.uint32)), none=None)
    finally:
        del os.environ["HALO2_SANITIZE"]
