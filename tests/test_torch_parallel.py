"""The port's multi-device layer (``halo2_aes_tpu_torch/parallel/``) against
the reference's ``parallel/`` on the CPU.

Rank code runs in subprocesses over gloo (``python -m
halo2_aes_tpu_torch.parallel.dryrun``; the rendezvous is a file store
under the test's tmp directory), all jobs started at once by the
module's first test and read as each test needs them.  The reference
runs in this process on the conftest's 8-device CPU mesh.  Inputs come
from numpy seeds (``dryrun.ntt_input``, ``dryrun.msm_inputs``).

Also here: the public helpers the port added to match the reference's
(``poly.to_evals`` ...), each against the reference function.
"""

import json
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from halo2_aes_tpu import native as ref_native
from halo2_aes_tpu.backend import keygen as ref_keygen
from halo2_aes_tpu.backend import lookup as ref_lookup
from halo2_aes_tpu.backend import poly as ref_poly
from halo2_aes_tpu.backend import srs as ref_srs
from halo2_aes_tpu.backend import verifier as ref_verifier
from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.ops import aes as ref_aes
from halo2_aes_tpu.ops import curve as ref_curve
from halo2_aes_tpu.ops import field as ref_field
from halo2_aes_tpu.ops import msm as ref_msm
from halo2_aes_tpu.ops import ntt as ref_ntt
from halo2_aes_tpu.parallel import msm as ref_pmsm
from halo2_aes_tpu.parallel import ntt as ref_pntt
from halo2_aes_tpu_torch import native
from halo2_aes_tpu_torch.backend import keygen, lookup, poly, prover, srs, verifier
from halo2_aes_tpu_torch.circuit.toys import K, TOYS
from halo2_aes_tpu_torch.ops import aes, curve, msm
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import ntt as NTT
from halo2_aes_tpu_torch.parallel import comm
from halo2_aes_tpu_torch.parallel import dryrun as DR
from halo2_aes_tpu_torch.parallel import ntt as PNTT

torch.set_num_threads(1)
GOLDEN = json.loads((pathlib.Path(DR.TESTDATA) / "golden_k6.json").read_text())
MODULE = "halo2_aes_tpu_torch.parallel.dryrun"
SIZES = (1, 2, 4)
MESH_PROOFS = ["toy", "tagged", "instance", "toy_gwc", "toy_packed", "toy_ipa",
               "onecol", "onecol_lookup"]
# job name -> (world size, rank arguments); all start together
JOBS = {
    **{f"collectives{size}": (size, ["--task", "ntt,msm"]) for size in SIZES},
    "prove_a": (2, ["--task", "prove", "--proofs", "toy,tagged,instance"]),
    "prove_b": (2, ["--task", "prove", "--proofs", "toy_gwc,toy_packed,toy_ipa"]),
    "prove_c": (2, ["--task", "prove", "--proofs", "onecol,onecol_lookup",
                    "--seedless"]),
    "sliced": (2, ["--task", "prove", "--proofs", "toy", "--sliced"]),
}
JOB_OF_PROOF = {"toy": "prove_a", "tagged": "prove_a", "instance": "prove_a",
                "toy_gwc": "prove_b", "toy_packed": "prove_b", "toy_ipa": "prove_b",
                "onecol": "prove_c", "onecol_lookup": "prove_c"}
TIMEOUT = 900


class _Jobs:
    """The rank jobs of this module, started on first use, each waited
    for once, and the reference's MSM (a ~50 s compile) in a thread
    beside them."""

    def __init__(self, root):
        self.root = root
        self.started = {}
        self.done = {}
        self.pool = ThreadPoolExecutor(1)
        self.ref_msm = None

    def start(self):
        for name, (size, args) in JOBS.items():
            out = self.root / name
            self.started[name] = comm.RankProcesses(
                [MODULE, "--device", "cpu", "--out", str(out), *args], size, out)
        self.ref_msm = self.pool.submit(_ref_msm)

    def results(self, name):
        if name not in self.done:
            self.done[name] = DR.rank_results(self.started[name].wait(TIMEOUT))
        return self.done[name]

    def close(self):
        for job in self.started.values():
            job.kill()
        self.pool.shutdown()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = _Jobs(tmp_path_factory.mktemp("ranks"))
    j.start()
    yield j
    j.close()


@pytest.fixture(scope="module")
def ref_mesh():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the conftest's 8-device CPU mesh")
    return Mesh(np.array(devs[:4]), axis_names=("dp",))


def test_dryrun_multichip(jobs):
    """(First, so that the rank jobs run beside it.)  The dry run at world
    size 2: sharded mock counts equal the
    one-device counts, clean and with a cell outside rank 0's rows
    corrupted; the NTT round trip; the toy proved on the mesh."""
    res = DR.dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    counts = [r["results"]["dryrun"]["mock_counts_corrupted"] for r in res]
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    assert all(r["results"]["dryrun"]["corrupted_row_owner"] == 1 for r in res)
    assert [r["results"]["dryrun"]["toy_proof"] for r in res] == [
        GOLDEN["toy"]["proof"]] * 2


# -- sharded NTT ----------------------------------------------------------------

_REF_NTT = {}


def _ref_ntt(ref_mesh, case):
    if case not in _REF_NTT:
        k, count, inverse, shifted = case
        shift = jnp.asarray(DR.ntt_shift(k)) if shifted else None
        _REF_NTT[case] = np.asarray(ref_pntt.ntt_sharded_many(
            ref_mesh, "dp", ref_ntt.domain(ref_field.FR, k),
            jnp.asarray(DR.ntt_input(k, count)), count, inverse=inverse,
            shift_pows=shift))
    return _REF_NTT[case]


@pytest.mark.parametrize("case", DR.NTT_CASES,
                         ids=[DR.ntt_case_name(*c) for c in DR.NTT_CASES])
@pytest.mark.parametrize("size", SIZES)
def test_ntt_sharded_many_equals_reference(jobs, ref_mesh, size, case):
    """Every rank's whole result equals the reference's sharded transform
    and the port's one-device ``ntt_many``, bit for bit."""
    jobs.results(f"collectives{size}")
    k, count, inverse, shifted = case
    dom = NTT.domain(F.FR, k)
    shift = F.limbs(DR.ntt_shift(k), "cpu") if shifted else None
    serial = F.to_numpy(NTT.ntt_many(dom, F.limbs(DR.ntt_input(k, count), "cpu"),
                                     count, inverse=inverse, shift_pows=shift))
    ref = _ref_ntt(ref_mesh, case)
    for r in range(size):
        got = np.load(jobs.root / f"collectives{size}" / f"ntt_rank{r}.npz")[
            DR.ntt_case_name(*case)]
        assert np.array_equal(got, ref) and np.array_equal(got, serial)


@pytest.mark.parametrize("size,k", [(3, 6), (16, 6), (32, 9)])
def test_ntt_sharded_rejects_a_mesh_that_does_not_divide(size, k):
    mesh = comm.Mesh(None, "gloo", 0, size, torch.device("cpu"))
    dom = NTT.domain(F.FR, k)
    with pytest.raises(ValueError, match="does not divide"):
        PNTT.ntt_sharded_many(mesh, dom, F.zeros((dom.n,)), 1)


# -- sharded MSM ----------------------------------------------------------------

def _ref_msm():
    """The reference's table-sharded msm_sharded of the first scalar set
    on a 4-device mesh -> affine ints."""
    pts, scalars = DR.msm_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("dp",))
    px, py = (jnp.asarray(a) for a in ref_curve.affine_from_ints(pts))
    tables = ref_msm.build_tables((px, py), DR.MSM_WINDOW)
    return ref_curve.to_affine_host(ref_pmsm.msm_sharded(
        mesh, "dp", (px, py), ref_field.ints_to_limbs_fast(scalars[0]),
        c=DR.MSM_WINDOW, tables=tables))[0]


@pytest.fixture(scope="module")
def msm_expected(jobs, ref_mesh):
    """host_msm of every scalar set, the first equal to the reference's
    table-sharded msm_sharded."""
    pts, scalars = DR.msm_inputs()
    want = [curve.host_msm(pts, s) for s in scalars]
    assert jobs.ref_msm.result(timeout=TIMEOUT) == want[0]
    return want


@pytest.mark.parametrize("case", ["msm", "msm_tables", "msm_many"])
@pytest.mark.parametrize("size", SIZES)
def test_msm_sharded_equals_reference(jobs, msm_expected, size, case):
    """msm_sharded with and without tables and msm_many_sharded (c=4, 64
    points): every rank's affine results equal host_msm and the
    reference's msm_sharded."""
    for res in jobs.results(f"collectives{size}"):
        got = [tuple(int(v) for v in p) for p in res["results"]["msm"][case]]
        assert got == msm_expected[:len(got)]


# -- mesh proves ----------------------------------------------------------------

@pytest.mark.parametrize("name", MESH_PROOFS)
def test_mesh_prove_equals_golden(jobs, name):
    """prove(mesh=) at world size 2 returns the reference's golden bytes
    on every rank (SHPLONK, GWC, packed lookups and IPA, whose rounds run
    on each rank as the reference's do; the one-advice-column circuit
    with and without its lookup)."""
    proofs = [res["results"]["prove"][name] for res in jobs.results(JOB_OF_PROOF[name])]
    assert proofs == [GOLDEN[name]["proof"]] * 2


def test_mesh_prove_forced_sliced_equals_golden(jobs):
    """The k >= 19 path (forced on the toy) on a mesh: the golden bytes."""
    proofs = [res["results"]["prove"]["toy"] for res in jobs.results("sliced")]
    assert proofs == [GOLDEN["toy"]["proof"]] * 2


def test_mesh_prove_seedless_is_one_proof_that_verifies(jobs):
    """seed=None at world size 2: rank 0's os.urandom draws are broadcast,
    so both ranks return the same bytes, and both verifiers accept them."""
    proofs = [res["results"]["prove"]["seedless"]
              for res in jobs.results("prove_c")]
    assert proofs[0] == proofs[1] != GOLDEN["toy"]["proof"]
    proof = bytes.fromhex(proofs[0])
    layout, _ = TOYS["toy"][0]()
    assert verifier.verify(keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None)).vk,
                           proof)
    ref_layout, _ = TOYS["toy"][0](ref_ir)
    ref_pk = ref_keygen.keygen(ref_layout, ref_srs.setup(K, cache_dir=None))
    assert ref_verifier.verify(ref_pk.vk, proof)


@pytest.fixture(scope="module")
def toy_pk():
    layout, values = TOYS["toy"][0]()
    return keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None)), values


def test_prove_takes_mesh_axis_without_a_mesh(toy_pk):
    pk, values = toy_pk
    proof = prover.prove(pk, values, seed=TOYS["toy"][1], mesh_axis="dp")
    assert proof.hex() == GOLDEN["toy"]["proof"]


def test_prove_mesh_argument_checks(toy_pk, tmp_path):
    """A mesh axis the mesh does not have is a ValueError; checkpoints on
    more than one rank are not supported.  Both raise before any
    collective."""
    pk, values = toy_pk
    mesh = comm.Mesh(None, "gloo", 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh axis"):
        prover.prove(pk, values, seed=1, mesh=mesh, mesh_axis="tp")
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        prover.prove(pk, values, seed=1, mesh=mesh, checkpoint_dir=str(tmp_path))


def test_nccl_is_never_replaced_by_gloo(tmp_path):
    """Asking for NCCL where this PyTorch has none raises."""
    if torch.distributed.is_nccl_available():
        pytest.skip("this PyTorch has NCCL")
    with pytest.raises(RuntimeError, match="no NCCL"):
        comm.init_mesh("nccl", 0, 1, f"file://{tmp_path}/store", "cuda:0")


def test_entry_step_is_satisfied():
    step, args = DR.entry("cpu")
    assert {k: int(v) for k, v in step(*args).items()} == {
        "gates": 0, "lookups": 0, "copies": 0}


@pytest.mark.slow
def test_mesh_mini_prove_equals_golden(tmp_path):
    """The k=11 mini-AES golden proof at world size 2 (minutes on the
    CPU; the chip smoke's mesh phase proves it on the card)."""
    runs = comm.run_ranks([MODULE, "--device", "cpu", "--task", "mini"], 2,
                          tmp_path, 7200)
    golden = json.loads((pathlib.Path(DR.TESTDATA) / "golden_mini_k11.json")
                        .read_text())["mini"]["proof"]
    assert [r["results"]["mini"]["mini"] for r in DR.rank_results(runs)] == [golden] * 2


@pytest.mark.slow
def test_prove_keystream_on_a_mesh(tmp_path):
    """A two-chunk k=17 CTR bundle at world size 2 verifies and both ranks
    hold the same proofs (hours on the CPU; the chip smoke's mesh phase
    proves a full-width bundle)."""
    runs = comm.run_ranks([MODULE, "--device", "cpu", "--task", "ctr"], 2,
                          tmp_path, 6 * 3600)
    proofs = [r["results"]["ctr"]["proofs"] for r in DR.rank_results(runs)]
    assert proofs[0] == proofs[1] and len(proofs[0]) == 2


# -- the public helpers matched to the reference's ---------------------------------

def _rand_limbs(n, seed, spec=F.FR):
    rng = np.random.default_rng(seed)
    return spec.encode([int.from_bytes(rng.bytes(32), "little") % spec.modulus
                        for _ in range(n)])


@pytest.mark.parametrize("inverse", [False, True])
def test_to_evals_to_coeffs_equal_reference(inverse):
    x = _rand_limbs(1 << 7, 1)
    fn, ref_fn = ((poly.to_coeffs, ref_poly.to_coeffs) if inverse
                  else (poly.to_evals, ref_poly.to_evals))
    got = fn(NTT.domain(F.FR, 7), F.limbs(x, "cpu"))
    assert np.array_equal(F.to_numpy(got), np.asarray(
        ref_fn(ref_ntt.domain(ref_field.FR, 7), jnp.asarray(x))))


def test_divide_by_vanishing_equals_reference():
    k, ext_k = 5, 7
    x = _rand_limbs(1 << ext_k, 2)
    got = poly.divide_by_vanishing(k, NTT.domain(F.FR, ext_k), F.limbs(x, "cpu"))
    assert np.array_equal(F.to_numpy(got), np.asarray(ref_poly.divide_by_vanishing(
        k, ref_ntt.domain(ref_field.FR, ext_k), jnp.asarray(x))))


@pytest.mark.parametrize("rot", [-1, 0, 2])
def test_rotate_ext_equals_reference(rot):
    x = _rand_limbs(32, 3)
    got = poly.rotate_ext(F.limbs(x, "cpu"), rot, 4)
    assert np.array_equal(F.to_numpy(got),
                          np.asarray(ref_poly.rotate_ext(jnp.asarray(x), rot, 4)))


@pytest.mark.parametrize("shape", [(16,), (3, 16)])
def test_eval_at_equals_reference(shape):
    x = _rand_limbs(int(np.prod(shape)), 4).reshape(*shape, F.LIMBS)
    assert poly.eval_at(F.limbs(x, "cpu"), 12345) == ref_poly.eval_at(
        jnp.asarray(x), 12345)


def test_eval_poly_equals_reference():
    c = _rand_limbs(20, 5)
    pt = F.FR.encode([987654321])[0]
    got = NTT.eval_poly(F.FR, F.limbs(c, "cpu"), F.limbs(pt, "cpu"))
    assert np.array_equal(F.to_numpy(got), np.asarray(ref_ntt.eval_poly(
        ref_field.FR, jnp.asarray(c), jnp.asarray(pt))))


@pytest.mark.parametrize("k", [1, 5, 8])
def test_domain_bitrev_equals_reference(k):
    dom, ref = NTT.domain(F.FR, k), ref_ntt.domain(ref_field.FR, k)
    assert np.array_equal(dom.bitrev.numpy(), np.asarray(ref.bitrev))
    assert np.array_equal(dom.bitrev_flat(3).numpy(), np.asarray(ref.bitrev_flat(3)))


def test_msm_host_and_srs_identity_equal_reference():
    pts, scalars = DR.msm_inputs()
    pts, scal = pts[:8], scalars[0][:8]
    assert msm.msm_host(pts, scal) == ref_msm.msm_host(pts, scal) == curve.host_msm(
        pts, scal)
    assert keygen.srs_identity(srs.setup(K, "cpu", cache_dir=None)) == \
        ref_keygen.srs_identity(ref_srs.setup(K, cache_dir=None))


def test_permuted_indices_field_equals_reference():
    rng = np.random.default_rng(6)
    u = 48
    table = rng.integers(0, 1 << 20, u)
    inputs = table[rng.integers(0, u, u)]
    a, s = (ref_field.ints_to_limbs_fast([int(v) for v in vals])
            for vals in (inputs, table))
    got = lookup.permuted_indices_field(F.limbs(a, "cpu"), F.limbs(s, "cpu"), u)
    ref = ref_lookup.permuted_indices_field(jnp.asarray(a), jnp.asarray(s), u)
    assert all(np.array_equal(g.numpy(), np.asarray(r)) for g, r in zip(got, ref))


@pytest.mark.parametrize("which", ["block_pool", "dec_block_pool"])
def test_one_block_pools_equal_reference(which):
    rng = np.random.default_rng(7)
    key, block = rng.integers(0, 256, 16, dtype=np.uint8), rng.integers(
        0, 256, 16, dtype=np.uint8)
    _, rks = aes.expand_key(torch.as_tensor(key))
    _, ref_rks = ref_aes.expand_key(jnp.asarray(key))
    got = getattr(aes, which)(torch.as_tensor(block), rks)
    ref = getattr(ref_aes, which)(jnp.asarray(block), ref_rks)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_affine_to_jacobian_and_is_identity_equal_reference():
    pts = [curve.py_mul((curve.G1_X, curve.G1_Y), s) for s in (3, 5)]
    px, py = curve.affine_from_ints(pts)
    rpx, rpy = (jnp.asarray(a) for a in ref_curve.affine_from_ints(pts))
    got = curve.affine_to_jacobian((px, py))
    ref = ref_curve.affine_to_jacobian((rpx, rpy))
    assert all(np.array_equal(F.to_numpy(g), np.asarray(r)) for g, r in zip(got, ref))
    ident = curve.identity((2,))
    for p, rp in ((got, ref), (ident, ref_curve.identity((2,)))):
        assert curve.is_identity(p).tolist() == np.asarray(
            ref_curve.is_identity(rp)).tolist()


def test_field_eq_is_zero_zeros_equal_reference():
    a = _rand_limbs(4, 8)
    b = a.copy()
    b[1, 3] ^= 1
    a[2] = 0
    assert F.eq(F.limbs(a, "cpu"), F.limbs(b, "cpu")).tolist() == np.asarray(
        ref_field.eq(jnp.asarray(a), jnp.asarray(b))).tolist()
    assert F.is_zero(F.limbs(a, "cpu")).tolist() == np.asarray(
        ref_field.is_zero(jnp.asarray(a))).tolist()
    assert np.array_equal(F.to_numpy(F.zeros((2, 3))), np.asarray(ref_field.zeros((2, 3))))


def test_native_available_equals_reference():
    assert native.available() == ref_native.available()
