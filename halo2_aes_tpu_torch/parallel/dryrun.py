"""The multi-rank dry run and the rank entry point: the port of
``__graft_entry__.py`` (``entry`` :30, ``dryrun_multichip`` :46).

``entry(device)`` returns the one-device forward step on the AES layout
(k=17, one column set, 4 blocks): witness, assembly and the MockProver's
violation counts.  ``dryrun_multichip(n)`` starts n rank processes and
each runs ``dryrun_rank``:

  1. the sharded mock step on ``DRYRUN_BLOCKS`` blocks: each rank
     traces its share of the blocks, an all-gather joins the pools,
     ``assemble_values`` builds the matrix; each rank counts violations
     on its row block (plus a halo of the largest rotation) and its
     share of the copy pairs, and an all-reduce sums the counts.  They
     equal the one-device counts on every rank, clean and with the last
     witness cell corrupted (a row past rank 0's block at any mesh size
     up to 8);
  2. a distributed NTT round trip (parallel/ntt.py);
  3. the toy circuit (one gate, one lookup, one copy) keygen, a sharded
     prove (parallel/msm.py commitments), verify; the bytes equal the
     reference's golden proof of the toy.

Rank processes run ``python -m halo2_aes_tpu_torch.parallel.dryrun
--rank R --world-size N --init-method file://... --task T[,T...]``
(``comm.run_ranks`` starts them).  Tasks: ``dryrun``; ``ntt`` (every
case of ``NTT_CASES`` against the one-device ``ntt_many``; outputs to
``--out``); ``msm`` (``msm_sharded`` and ``msm_many_sharded`` with and
without tables against ``curve.host_msm``); ``prove`` (the golden K=6
entries named by ``--proofs`` on the mesh, each equal to its golden
bytes; ``--sliced`` forces the k >= 19 path, ``--seedless`` adds a
``seed=None`` prove; an IPA entry proves against the transparent
basis); ``mini`` (the k=11 mini-AES golden proof); ``ctr``
(a two-chunk k=17 keystream bundle).  Each rank prints one JSON line
last: its results and K1/K2/K3 launches.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from halo2_aes_tpu_torch.parallel import comm

# (k, count, inverse, shifted) of the ntt task
NTT_CASES = [(k, count, inverse, shifted) for k in (6, 8, 9) for count in (1, 3)
             for inverse in (False, True) for shifted in (False, True)]
MSM_POINTS = 64
MSM_WINDOW = 4
MSM_MANY = 3
# blocks of the dry run's mock step: their rows reach past half the k=17
# domain, so the last witness cell lies outside rank 0's row block
DRYRUN_BLOCKS = 64
# seconds a rank waits at a collective: ranks do the same work between
# collectives, so a wait this long means another rank died
RANK_TIMEOUT = 300.0
TESTDATA = pathlib.Path(__file__).resolve().parent.parent / "testdata"


@functools.lru_cache(maxsize=None)
def _layout(k: int = 17, n_blocks: int = 4):
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    return compile_circuit(AesConfig(k=k, n_sets=1, n_blocks=n_blocks))


def entry(device="cuda"):
    """(fn, example_args): the forward step on one device."""
    from halo2_aes_tpu_torch.circuit import mock, witness

    layout = _layout()
    dev = torch.device(device)

    def step(key, plaintexts):
        pool = witness.build_pool(key, plaintexts)
        return mock.violation_counts(layout, witness.assemble_values(layout, pool))

    key = torch.zeros(16, dtype=torch.uint8, device=dev)
    plaintexts = torch.arange(4 * 16, dtype=torch.uint8, device=dev).reshape(4, 16)
    return step, (key, plaintexts)


# -- the sharded mock step ---------------------------------------------------

def sharded_pool(mesh: comm.Mesh, key, plaintexts):
    """``witness.build_pool`` with the blocks split over the ranks: each
    traces its share, an all-gather joins them."""
    from halo2_aes_tpu_torch.ops import aes

    blocks = plaintexts.shape[0]
    if blocks % mesh.size:
        raise ValueError(f"{blocks} blocks do not split over {mesh.size} ranks")
    share = blocks // mesh.size
    ks_pool, rks = aes.expand_key(key)
    mine = aes.block_pool_batch(
        plaintexts[mesh.rank * share:(mesh.rank + 1) * share], rks)
    joined = comm.all_gather(mesh, mine.to(torch.int32))
    return torch.cat([ks_pool, joined.reshape(-1).to(ks_pool.dtype)])


def _max_rotation(layout) -> int:
    exprs = [g for _, g in layout.cs.gates]
    exprs += [e for lk in layout.cs.lookups for e, _ in lk.pairs]
    return max([abs(rot) for e in exprs for _, rot in e.columns()] + [0])


def sharded_violation_counts(mesh: comm.Mesh, layout, values) -> dict:
    """``mock.violation_counts`` split over the mesh: each rank evaluates
    the gates and lookups on its row block (with a halo of the largest
    rotation, wrapping at the ends as the one-device rolls do) and checks
    its share of the copy pairs; an all-reduce sums the counts."""
    from halo2_aes_tpu_torch.circuit import mock

    n, usable = layout.n, layout.usable_rows
    dev = values.device
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    b = n // mesh.size
    lo = mesh.rank * b
    h = _max_rotation(layout)
    rows = torch.arange(lo - h, lo + b + h, device=dev) % n
    get = mock._getter(values[:, rows])
    mine = slice(h, h + b)
    live = rows[mine] < usable
    gates = sum(((g.eval(mock.Int32Algebra, get)[mine] != 0) & live).sum()
                for _, g in layout.cs.gates)
    lookups = 0
    for i, lk in enumerate(layout.cs.lookups):
        keys = mock._pack([e.eval(mock.Int32Algebra, get)
                           for e, _ in lk.pairs])[mine]
        table = mock._sorted_table(layout, i, usable, dev)
        pos = torch.searchsorted(table, keys).clamp(0, usable - 1)
        lookups = lookups + ((table[pos] != keys) & live).sum()
    cp = mock._copy_pairs(layout, dev)
    m = cp.shape[0]
    cp = cp[mesh.rank * m // mesh.size:(mesh.rank + 1) * m // mesh.size]
    copies = (values[cp[:, 0], cp[:, 1]] != values[cp[:, 2], cp[:, 3]]).sum()
    counts = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                          for v in (gates, lookups, copies)])
    total = comm.all_reduce(mesh, counts)
    return {"gates": int(total[0]), "lookups": int(total[1]),
            "copies": int(total[2])}


# -- the dry run ---------------------------------------------------------------

def dryrun_rank(mesh: comm.Mesh) -> dict:
    """The three steps of the dry run on this rank (see the module
    docstring); raises AssertionError on any mismatch."""
    from halo2_aes_tpu_torch.backend import keygen, prover, srs, verifier
    from halo2_aes_tpu_torch.circuit import mock, toys, witness
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as NTT
    from halo2_aes_tpu_torch.parallel import ntt as PNTT

    dev = mesh.device
    t0 = time.perf_counter()
    out = {}

    def tick(msg):
        print(f"dryrun rank {mesh.rank}/{mesh.size}: {msg} "
              f"[t={time.perf_counter() - t0:.1f}s]", flush=True)

    # 1. sharded mock step, clean and with the last witness cell corrupted
    layout = _layout(n_blocks=DRYRUN_BLOCKS)
    key = torch.zeros(16, dtype=torch.uint8, device=dev)
    pts = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (DRYRUN_BLOCKS, 16), dtype=np.uint8), device=dev)
    pool = sharded_pool(mesh, key, pts)
    assert torch.equal(pool, witness.build_pool(key, pts)), "pool differs"
    values = witness.assemble_values(layout, pool)
    counts = sharded_violation_counts(mesh, layout, values)
    one = {k: int(v) for k, v in mock.violation_counts(layout, values).items()}
    assert counts == one == {"gates": 0, "lookups": 0, "copies": 0}, (counts, one)
    bad = values.clone()
    col, row = _last_witness_cell(layout)
    bad[col, row] += 1
    counts_bad = sharded_violation_counts(mesh, layout, bad)
    one_bad = {k: int(v) for k, v in mock.violation_counts(layout, bad).items()}
    assert counts_bad == one_bad and sum(one_bad.values()) > 0, (counts_bad, one_bad)
    out["mock_counts_corrupted"] = counts_bad
    out["corrupted_row_owner"] = row // (layout.n // mesh.size)
    tick("sharded mock step ok")

    # 2. distributed NTT round trip
    k_ntt = max(8, (mesh.size - 1).bit_length() + 4)
    dom = NTT.domain(F.FR, k_ntt)
    coeffs = F.limbs(F.FR.encode(list(range(1 << k_ntt))), dev)
    evals = PNTT.ntt_sharded(mesh, dom, coeffs)
    assert torch.equal(evals, NTT.ntt(dom, coeffs)), "sharded NTT differs"
    assert torch.equal(PNTT.ntt_sharded(mesh, dom, evals, inverse=True), coeffs)
    tick("ntt round trip ok")

    # 3. the toy circuit: keygen, sharded prove, verify; the golden bytes
    toy, values = toys.toy_circuit()
    pk = keygen.keygen(toy, srs.setup(toys.K, dev, cache_dir=None))
    proof = prover.prove(pk, values, seed=toys.TOYS["toy"][1], mesh=mesh,
                         mesh_axis=mesh.axis)
    assert verifier.verify(pk.vk, proof), "sharded proof rejected"
    golden = json.loads((TESTDATA / "golden_k6.json").read_text())["toy"]
    assert proof.hex() == golden["proof"], "sharded proof differs from golden"
    out["toy_proof"] = proof.hex()
    tick("sharded prove -> verify ok")
    return out


def _last_witness_cell(layout) -> tuple:
    """(column, row) of the witness-mapped cell in the highest row."""
    mapped = np.argwhere(np.asarray(layout.witness_map) >= 0)
    col, row = mapped[np.argmax(mapped[:, 1])]
    return int(col), int(row)


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device: str = "cuda", timeout: float = 900.0) -> list:
    """Run ``dryrun_rank`` in ``n_devices`` rank processes on the cards
    (rank r on card r mod count; ``device="cuda:0"`` shares one card,
    ``"cpu"`` runs on the CPU) over ``backend`` (default: NCCL when
    there is a card per rank, else gloo).  Returns each rank's results;
    raises RuntimeError if any rank failed."""
    if backend is None:
        cards = torch.cuda.device_count() if device.startswith("cuda") else 0
        backend = "nccl" if device == "cuda" and cards >= n_devices else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        runs = comm.run_ranks(
            ["halo2_aes_tpu_torch.parallel.dryrun", "--task", "dryrun",
             "--backend", backend, "--device", device],
            n_devices, tmp, timeout)
    return rank_results(runs)


def rank_results(runs) -> list:
    """Each rank's JSON line (its last); RuntimeError with the logs of
    the ranks that failed."""
    failed = [(r, rc, text) for r, (rc, text) in enumerate(runs) if rc != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"rank {r} exited {rc}:\n{text[-4000:]}" for r, rc, text in failed))
    return [json.loads(next(line for line in reversed(text.splitlines())
                            if line.startswith('{"rank"'))) for _, text in runs]


# -- tasks of the rank entry point ----------------------------------------------

def ntt_input(k: int, count: int) -> np.ndarray:
    """(count*2^k, 16) Montgomery limbs of random field elements, from a
    numpy seed."""
    from halo2_aes_tpu_torch.ops import field as F

    rng = np.random.default_rng(1000 * k + count)
    return F.FR.encode([int.from_bytes(rng.bytes(32), "little") % F.FR.modulus
                        for _ in range(count << k)])


def ntt_shift(k: int) -> np.ndarray:
    """(2^k, 16) powers of the coset generator."""
    from halo2_aes_tpu_torch.backend import poly as P
    from halo2_aes_tpu_torch.ops import field as F

    return F.FR.host_powers(P.GEN, 1 << k)


def ntt_case_name(k, count, inverse, shifted) -> str:
    return f"k{k}_c{count}_{'inv' if inverse else 'fwd'}{'_shift' if shifted else ''}"


def _task_ntt(mesh, args) -> dict:
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as NTT
    from halo2_aes_tpu_torch.parallel import ntt as PNTT

    dev = mesh.device
    outs = {}
    for k, count, inverse, shifted in NTT_CASES:
        dom = NTT.domain(F.FR, k)
        x = F.limbs(ntt_input(k, count), dev)
        shift = F.limbs(ntt_shift(k), dev) if shifted else None
        got = PNTT.ntt_sharded_many(mesh, dom, x, count, inverse=inverse,
                                    shift_pows=shift)
        name = ntt_case_name(k, count, inverse, shifted)
        assert torch.equal(got, NTT.ntt_many(dom, x, count, inverse=inverse,
                                             shift_pows=shift)), name
        outs[name] = F.to_numpy(got)
    if args.out:
        np.savez(pathlib.Path(args.out) / f"ntt_rank{mesh.rank}.npz", **outs)
    return {"cases": len(outs)}


def msm_inputs():
    """(points: affine int pairs, scalars: MSM_MANY lists of ints)."""
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F

    rng = np.random.default_rng(5)
    g = (CV.G1_X, CV.G1_Y)
    pts = [CV.py_mul(g, int(rng.integers(1, 1 << 48))) for _ in range(MSM_POINTS)]
    scalars = [[int.from_bytes(rng.bytes(32), "little") % F.FR.modulus
                for _ in range(MSM_POINTS)] for _ in range(MSM_MANY)]
    return pts, scalars


def _task_msm(mesh, args) -> dict:
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as M
    from halo2_aes_tpu_torch.parallel import msm as PMSM

    dev = mesh.device
    pts, scalars = msm_inputs()
    points = CV.affine_from_ints(pts, dev)
    sc = [F.limbs(F.ints_to_limbs_fast(s), dev) for s in scalars]
    tables = M.build_tables(points, MSM_WINDOW)
    want = [CV.host_msm(pts, s) for s in scalars]
    got = {
        "msm": CV.to_affine_host(PMSM.msm_sharded(mesh, points, sc[0], c=MSM_WINDOW))[0],
        "msm_tables": CV.to_affine_host(PMSM.msm_sharded(
            mesh, points, sc[0], c=MSM_WINDOW, tables=tables))[0],
        "msm_many": CV.to_affine_host(PMSM.msm_many_sharded(
            mesh, points, torch.cat(sc), MSM_MANY, MSM_WINDOW, tables)),
    }
    assert got["msm"] == want[0] and got["msm_tables"] == want[0], got
    assert got["msm_many"] == want, got
    return {name: [list(map(str, p)) for p in (v if name == "msm_many" else [v])]
            for name, v in got.items()}


def _task_prove(mesh, args) -> dict:
    from halo2_aes_tpu_torch.backend import ipa, keygen, prover, srs, verifier
    from halo2_aes_tpu_torch.circuit.toys import (GOLDEN_IPA_PROOFS,
                                                  GOLDEN_PROOFS, K, TOYS)

    golden = json.loads((TESTDATA / "golden_k6.json").read_text())
    if args.sliced:
        prover._LARGE_MIN_K = K
    s = srs.setup(K, mesh.device, cache_dir=None)
    pks, out = {}, {}
    for name in [p for p in args.proofs.split(",") if p]:
        if name in GOLDEN_IPA_PROOFS:     # against the transparent basis
            toy, opts = GOLDEN_IPA_PROOFS[name], {"multiopen": "ipa"}
            basis = ipa.setup(K, mesh.device, cache_dir=None)
        else:
            (toy, opts), basis = GOLDEN_PROOFS[name], s
        build, seed, instances = TOYS[toy]
        layout, values = build()
        key = (toy, basis is s)
        if key not in pks:
            pks[key] = keygen.keygen(layout, basis)
        proof = prover.prove(pks[key], values, seed=seed, mesh=mesh, **opts)
        assert proof.hex() == golden[name]["proof"], f"{name} differs from golden"
        out[name] = proof.hex()
    if args.seedless:
        layout, values = TOYS["toy"][0]()
        pk = pks.get(("toy", True)) or keygen.keygen(layout, s)
        proof = prover.prove(pk, values, mesh=mesh)
        assert verifier.verify(pk.vk, proof), "seed=None mesh proof rejected"
        out["seedless"] = proof.hex()
    return out


def _task_mini(mesh, args) -> dict:
    from halo2_aes_tpu_torch.backend import keygen, prover, srs
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.circuit.toys import (MINI_CONFIG, MINI_PROVE_SEED,
                                                  mini_inputs)
    from halo2_aes_tpu_torch.models import aes_mini as MINI

    golden = json.loads((TESTDATA / "golden_mini_k11.json").read_text())["mini"]
    dev = mesh.device
    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**MINI_CONFIG))
    key, pts = (torch.as_tensor(a, device=dev) for a in mini_inputs())
    values = witness.assemble_values(layout, MINI.build_pool_mini(key, pts))
    pk = keygen.keygen(layout, srs.setup(MINI_CONFIG["k"], dev, cache_dir=None))
    proof = prover.prove(pk, values, seed=MINI_PROVE_SEED, mesh=mesh)
    assert proof.hex() == golden["proof"], "mini proof differs from golden"
    return {"mini": proof.hex()}


def _task_ctr(mesh, args) -> dict:
    from halo2_aes_tpu_torch import ctr
    from halo2_aes_tpu_torch.backend import keygen, srs
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    layout = compile_circuit(AesConfig(k=17, n_sets=1, n_blocks=2,
                                       expose_ciphertext=True))
    pk = keygen.keygen(layout, srs.setup(17, mesh.device, cache_dir=None))
    bundle = ctr.prove_keystream(pk, np.arange(16, dtype=np.uint8),
                                 bytes(range(12)), 3, mesh=mesh)
    assert len(bundle.proofs) == 2 and ctr.verify_bundle(pk.vk, bundle)
    return {"proofs": [p.hex() for p in bundle.proofs]}


TASKS = {"dryrun": lambda mesh, _: dryrun_rank(mesh), "ntt": _task_ntt,
         "msm": _task_msm, "prove": _task_prove, "mini": _task_mini,
         "ctr": _task_ctr}


def _launches() -> dict:
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    return {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
            "K3": cuda_curve.LAUNCHES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (card rank %% count) or cuda:N (shared)")
    ap.add_argument("--task", required=True,
                    help="comma-separated: " + ", ".join(TASKS))
    ap.add_argument("--proofs", default="toy,tagged,instance",
                    help="golden K=6 entries of the prove task")
    ap.add_argument("--sliced", action="store_true",
                    help="prove task: force the k >= 19 path")
    ap.add_argument("--seedless", action="store_true",
                    help="prove task: add a seed=None prove of the toy")
    ap.add_argument("--out", default=None, help="directory for array outputs")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    device = args.device
    if device == "cuda":
        device = f"cuda:{args.rank % torch.cuda.device_count()}"
    mesh = comm.init_mesh(args.backend, args.rank, args.world_size,
                          args.init_method, device, timeout=RANK_TIMEOUT)
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    cuda_field.LAUNCHES = cuda_ntt.LAUNCHES = cuda_curve.LAUNCHES = 0
    comm.reset_counts()
    results = {}
    try:
        for task in args.task.split(","):
            t = time.perf_counter()
            results[task] = TASKS[task](mesh, args)
            print(f"rank {args.rank}: {task} ok in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
    finally:
        comm.destroy_mesh(mesh)
    print(json.dumps({"rank": args.rank, "results": results,
                      "launches": _launches(), "collectives": comm.CALLS}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
