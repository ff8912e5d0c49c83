#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

  python3 chip_smoke.py [golden,mock,ipa,mini,srs_format,mesh,mxu,large_forced,large_k23,
                         quotient_terms,grand_products,msm_buckets]

With no argument every phase runs; with a comma-separated list only the
device and build phases and the named ones do, and no ok line is printed.

Phases, each printing one JSON line as it ends:
  0 device      the card (fails without CUDA), its name and power limit
  1 build       nvcc-builds the kernels of csrc/ (K1 mont_mul, K2 the fused
                NTT pass, K3 curve add / fold / masked add / doublings, P1
                mul probe, P2a/P2b Montgomery probes on limb-major
                planes, K5 nibble products on the int8 tensor cores),
                one nvcc per source in parallel, and the host
                C++ library (the verifier's G1 MSM and pairing product),
                which must pass its self-test and be the route in force
  2 kernels     each kernel and entry against its plain PyTorch version,
                bit-exact, on card tensors at its path's shapes (K1 on
                2^20 random pairs of Fr and of Fq led by every ordered
                pair of the edge operands: 0, 1, p-1, p-2, R, R^2 mod p
                and top words at p's), with times
                and the card's bound for the same work (K1-K3 also at the
                k=20 prove's shapes, where one ntt_many must launch K2
                twice, K1 never and no PyTorch kernel; P1 also at the
                (16, 2^22) planes that fill the card); the composed
                transform (two polys of 2^23 points, two K2 passes; and
                with the row cap lowered, three passes at 2^17) against
                the same composition of K2's plain version
  3 golden      the K=6 golden proofs (toy, tagged toy, instance toy;
                GWC and packed-lookup proofs of the first two; the IPA
                proofs of the first two against the transparent basis)
                proved on the card equal the JAX reference's committed
                bytes and verify
  4 flagship    AES-128 at k=17, 4 sets, 384 blocks, tagged ops:
                setup, keygen, witness, warm-up prove, timed prove,
                verify, a flipped byte rejected; every kernel launched
  5 probes      the two probe scripts' paths (P1 multiply throughput,
                P2 Montgomery layouts against K1)
    mxu         K5 (nibble products on the int8 tensor cores, on B packed
                once per operand) against its plain version, bit-exact,
                at every product shape of FixedMul, DftMatmul(16) and
                ntt256 at a 2^17 batch and at the accumulator edge (N =
                32, all p-1; x 0xFFFF, B all 15, no fragment skipped),
                with times, bounds and torch._int_mm on the same
                products; its normalize entry (the carry in the
                epilogue, with the addend) at the paths' four carry
                sites, bit-exact and timed; FixedMul against K1 for
                random and edge operands; ntt256 against K2's ntt at k =
                8; the paths' device kernels per call under
                torch.profiler with carry_norm_ks made to raise; then
                the nibble-product probe's path (scripts/torch_mxu_probe.py)
  6 gwc_packed  on the flagship pk: one GWC prove and one packed-lookup
                prove, each verified and a flipped byte rejected; then
                (printed with quotient_terms and grand_products, below)
                SHPLONK, GWC and IPA proofs of the flagship with K4 equal
                those with the eager term fold, K4 launched once a
                sub-coset, and with K6 those with the eager grand products
    mesh        the multi-device prover (halo2_aes_tpu_torch/parallel/):
                (a) a mesh of world size 1 over NCCL in this process
                (file store under build/; no NCCL fails the phase): the
                flagship proved on the mesh equals the one-device proof
                byte for byte, verifies, a flipped byte is rejected, K1,
                K2 and K3 launched on the mesh path; a seed=None mesh
                proof verifies; a two-chunk CTR bundle proved on the
                mesh passes verify_bundle; warm mesh and plain proves
                timed in turns (medians of 3), collective calls and
                bytes per prove, peak memory;  (b) two rank processes
                sharing cuda:0 over gloo (CUDA tensors staged through
                host memory): the toy, tagged and instance golden proofs
                and the mini-AES golden proof on the mesh, and beside
                them dryrun_multichip(2) (sharded mock counts, NTT round
                trip, toy prove), and two more ranks proving the toy with
                checkpoints in one directory under build/, crashed on
                both ranks after each phase in turn and resumed to the
                golden bytes without recomputing a saved phase; each rank
                launched K2 and K3 at its sharded shapes; a rank's
                failure or timeout fails the phase
  7 ctr         a two-chunk (768-block) AES-CTR bundle at the flagship
                width with the keystream exposed: keystream = AES of the
                counter blocks, one verify_batch accepts the bundle, a
                changed keystream byte is rejected
  8 decrypt     full-capacity decryption at k=17, 4 sets, 384 blocks,
                plaintext exposed: recovered plaintext checked, proof
                verified with the plaintext instances, flipped byte rejected
  9 large       the k >= 19 prove path: the flagship proved once more with
                the sliced path forced (static evaluations recomputed)
                equals the ordinary proof byte for byte, and so do one
                with k=22's commitments forced (no MSM window tables)
                and one with the k=23 switch forced (the pk's and the
                prove's stacks parked in pinned host memory), the
                lookup pairs built one lookup at a time (k=22's form)
                and every transform three or four K2 passes (row cap 6), and the
                same crashed after its last checkpoint and resumed from
                checkpoints saved from the parked stacks; then, with the
                earlier phases' memory freed, the reference prover binary's shape
                (AES-128, k=20, 4 sets, 3,082 blocks, tagged ops): setup
                and keygen (cached in ptau/, 3.2 GB), witness, one
                prove, verify, a flipped byte rejected, peak memory; and
                a K=6 toy prove crashed after its products phase resumes
                from its checkpoints to the golden bytes
    quotient_terms  K4 (the quotient's constraint terms in one launch a
                sub-coset) on the benchmark cell's circuit (AES-128, 4
                sets, upstream's layout) over random stacks: a whole k=20
                sub-coset against the eager fold, a whole k=23 sub-coset
                against the plain version over a quarter of its rows (and
                K4 launched over those rows alone), bit-exact, with
                CUDA-event times and the bound; with the flagship proofs
                above
    grand_products  K6 (a grand-product column in three launches) at the
                benchmark cell's shapes (2^20 rows: 17 lookup columns, one
                launch sequence each and all 17 in one; 14 permutation
                columns in 5 chunks over a random sigma), zero
                denominators planted, against its plain version and the
                eager path, bit-exact, with CUDA-event times, the bound
                and each launch's device time; and SHPLONK, GWC and IPA
                proofs of the flagship with K6 equal those with the eager
                grand products, K6 launched three times a column
    msm_buckets K7 (the MSM as bucket sums, one set a commitment over its
                pre-scaled windows) against its plain version at small
                shapes, bit-exact at each step (digits, the sort's lists,
                the buckets, the weighted sums; with and without tables,
                every digit equal), then 8 commitments of 2^20 points
                (the main path's shape and the card's slice length)
                against the plain version, bit-exact at each step, and
                against the sorted-prefix tree (affine sums equal,
                CUDA-event times, peaks, the bound, each K7 kernel's
                device time; the sort against the plain sort); the
                flagship's and the k=20 SHPLONK, GWC and IPA proofs with
                K7 equal those with the tree, verify, launch K7 and never
                the tree; a tableless MSM of 2^23 points (one set a
                window, the Horner doublings) equals the tree's
    large_k23   the same circuit at k=23, 24,671 blocks (full
                capacity), nothing cached on disk: setup, keygen,
                witness, prove, verify, a flipped byte rejected; each
                step's seconds and peak, the memory held before the
                prove, the most pinned host bytes the parked stacks held,
                K2 launches per transform (two at 2^23); the peak over
                setup, keygen and the prove must stay within 90% of the
                card's memory
 10 mock        the vectorized MockProver on the card: at the flagship
                layout and at the reference's mock bench shape (k=17, 2
                sets, 192 blocks) the witness satisfies every constraint,
                and a corrupted rcon cell, a corrupted lookup input and a
                broken copy are each counted; blocks/s of the warm
                witness + check step; then the reference's own MockProver
                configuration (k=20, 3 sets, 1000 encryptions, zero key
                and plaintext): satisfied, seconds, peak memory
 11 ipa         the IPA proving system at the flagship shape: transparent
                basis (cached in ptau/), keygen, warm-up and timed prove,
                verify, a flipped last byte and a flipped early byte
                rejected, the KZG verifier rejects the proof, its length
                is the cost model's; every kernel and K3 entry launched
 12 mini        mini-AES (GF(2^4)) at k=11, 2 sets, 2 blocks: mock
                satisfied, proved, verified, bytes equal the golden proof
 13 srs_format  the flagship's dev SRS written in halo2's ParamsKZG
                format and read back: same points and identity tag, and a
                proof made with the re-read SRS verifies
 14 native      every verify above ran through the native host library;
                the flagship proof verified again through the pure-Python
                route gives the same verdicts (valid and flipped byte),
                with the seconds of each route
Phases 4, 5-8, mxu, mesh, the k=20 prove of 9, large_k23 and 11 each set the launch counts to 0
before they drive their path and fail if a kernel of the path never
launched.  Then the card line, the kernels record and, last, the ok
line.  Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=True)
FLAGSHIP_PROOF_BYTES = 5056      # the reference's proof length at this shape
# the reference prover binary's shape (its src/main.rs: K=20, N=4 column sets;
# 3,082 blocks as BASELINE.md sizes it)
LARGE = dict(k=20, n_sets=4, n_blocks=3082, tagged_ops=True)
# the same circuit at k=23, at its full capacity: the first k whose idle
# proof state rests in host memory (backend/rest.py)
LARGE23 = dict(k=23, n_sets=4, n_blocks=24671, tagged_ops=True)
# the share of the card's memory the k=23 setup, keygen and prove may peak at
LARGE23_MEM_SHARE = 0.9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _script(name: str):
    """A probe script of scripts/, imported by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_device():
    import torch

    from halo2_aes_tpu_torch.ops.timing import card_line

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    line = card_line()
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return torch.device("cuda", 0)


def phase_build():
    from halo2_aes_tpu_torch.ops import _build

    from halo2_aes_tpu_torch import native

    path, seconds, log = _build.build()
    _build.library()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    t0 = time.perf_counter()
    native.library()                 # raises if the build or self-test fails
    if native.route() != "native":
        raise AssertionError(f"the host route is {native.route()!r}, not native")
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, REPO),
          "ptxas": regs, "host_library_seconds": time.perf_counter() - t0,
          "host_library": os.path.relpath(_build.build_host(), REPO)})


def _random_field(spec, rows: int, rng, device):
    """Uniform-ish canonical limbs: the top limb stays below p's."""
    import numpy as np

    from halo2_aes_tpu_torch.ops import field as F

    limbs = rng.integers(0, 1 << 16, (rows, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), rows)
    return F.limbs(limbs.astype(np.uint32), device)


# H100 SXM peaks the bounds are stated against: device memory 3.35 TB/s;
# 32-bit integer multiply-adds at half the 67 TFLOP/s float32 rate's 33.5e12
# fused multiply-adds a second (64 of an SM's 128 lanes multiply integers)
MEM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
MONT_MUL_IMADS = 136        # 8 x 8 products, 8 x 8 reduction, 8 for m
ELEM_BYTES = 64             # one field element in the int32 limb layout
ADD_IMADS = 12 * MONT_MUL_IMADS
DOUBLE_IMADS = 8 * MONT_MUL_IMADS


def bound(nbytes: float, imads: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the multiply-adds at the
    integer rate, whichever is larger."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = imads / IMAD_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "imads": imads}


def add_bound(a: dict, b: dict) -> dict:
    """The bound of two calls timed together (their times are summed)."""
    return bound(a["bytes"] + b["bytes"], a["imads"] + b["imads"]) if a else b


def ntt_pass_bound(count: int, k: int, lt: int, mul_in: bool, mul_out) -> dict:
    """One fused pass: the stack in and out, the tables it multiplies by
    read once, the twiddles; lt/2 butterflies an element plus the
    multiplies on load and in the epilogue."""
    n = 1 << k
    tables = (n if mul_in else 0) + (mul_out or 0) + (1 << lt) // 2
    muls = lt / 2 + bool(mul_in) + bool(mul_out)
    return bound((2 * count * n + tables) * ELEM_BYTES,
                 count * n * muls * MONT_MUL_IMADS)


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version, bit-exact, with times."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt, cuda_probe
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import time_ms as _time_ms

    rng = np.random.default_rng(1)
    rec = {}

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    # K1: 2^20 random pairs per field, the first rows every ordered pair
    # of the edge operands
    k1 = {"errors": {}, "ms": 0.0, "plain_ms": 0.0}
    for spec in (F.FR, F.FQ):
        a = _random_field(spec, 1 << 20, rng, dev)
        b = _random_field(spec, 1 << 20, rng, dev)
        edges = F.limbs(F.ints_to_limbs_fast(cuda_field.edge_operands(spec)), dev)
        e2 = edges.shape[0] ** 2
        a[:e2] = edges.repeat_interleave(edges.shape[0], 0)
        b[:e2] = edges.repeat(edges.shape[0], 1)
        out = cuda_field.mont_mul(spec, a, b)
        ref = cuda_field.mont_mul_plain(spec, a, b)
        e = err(out, ref)
        if e:
            raise AssertionError(f"K1 {spec.name}: max abs err {e}")
        k1["errors"][spec.name] = e
        k1["ms"] += _time_ms(lambda: cuda_field.mont_mul(spec, a, b), 100)
        k1["plain_ms"] += _time_ms(lambda: cuda_field.mont_mul_plain(spec, a, b), 3, 3)
    k1["shape"] = "2 x (2^20 pairs)"
    k1.update(bound(2 * 3 * ELEM_BYTES << 20, 2 * MONT_MUL_IMADS << 20))
    rec["K1"] = k1

    # K2: the fused passes of k=17 (T=512 then T=256; count 4 and the odd
    # count 3) with a shift row on load and the mid table in the epilogue,
    # the single-pass form (k=6 and k=11, n^-1 for the inverse), forward
    # and inverse; an NTT round trip at k=17; ntt_many on the card against
    # the plain composition on the host at k=12
    k2 = {"errors": {}, "ms": 0.0, "plain_ms": 0.0}
    k2_bound = None
    for k, count in ((17, 4), (17, 3), (6, 4), (11, 1)):
        n = 1 << k
        for inverse in (False, True):
            x = _random_field(F.FR, count * n, rng, dev)
            shift = _random_field(F.FR, n, rng, dev)
            if k <= N.ROW_CAP:
                n_inv = F.encode(F.FR, N.domain(F.FR, k).n_inv, dev) if inverse else None
                steps = [(k, 1, shift, n_inv)]
            else:
                k1_ = (k + 1) // 2
                steps = [(k1_, 1, shift, N._mid_table(F.FR, k, k1_, inverse, dev)),
                         (k - k1_, 1 << k1_, None, None)]
            for lt, stride, mul_in, mul_out in steps:
                tw = N._twiddles(F.FR, lt, inverse, dev)
                args = (F.FR, x, count, k, lt, tw, stride, mul_in, mul_out)
                out = cuda_ntt.ntt_fused(*args)
                e = err(out, cuda_ntt.ntt_fused_plain(*args))
                name = f"k{k}_x{count}_lt{lt}_{'inv' if inverse else 'fwd'}"
                if e:
                    raise AssertionError(f"K2 {name}: err {e}")
                k2["errors"][name] = e
                if (k, count, inverse) == (17, 4, False):
                    k2["ms"] += _time_ms(lambda: cuda_ntt.ntt_fused(*args), 100)
                    k2["plain_ms"] += _time_ms(
                        lambda: cuda_ntt.ntt_fused_plain(*args), 2, 3)
                    k2_bound = add_bound(k2_bound, ntt_pass_bound(
                        count, k, lt, mul_in is not None,
                        0 if mul_out is None else mul_out.numel() // F.LIMBS))
                x = out
    dom = N.domain(F.FR, 17)
    x = _random_field(F.FR, 4 << 17, rng, dev)
    back = N.ntt_many(dom, N.ntt_many(dom, x, 4), 4, inverse=True)
    if not torch.equal(back, x):
        raise AssertionError("K2: ntt_many round trip at k=17 differs")
    dom = N.domain(F.FR, 12)
    x = _random_field(F.FR, 3 << 12, rng, dev)
    shift = _random_field(F.FR, 1 << 12, rng, dev)
    for inverse in (False, True):
        got = N.ntt_many(dom, x, 3, inverse=inverse, shift_pows=shift)
        want = N.ntt_many(dom, x.cpu(), 3, inverse=inverse, shift_pows=shift.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError("K2: ntt_many at k=12 differs from the host's")
    k2["composed"] = composed_transforms(dev)
    k2["shape"] = ("k=17 count=4, shift and mid table inside: (1024, 512) + "
                   "(2048, 256) rows x lanes")
    k2.update(k2_bound)
    rec["K2"] = k2

    # K3: 2^16 pairs of G1 points, with identity + P, P + P, P + (-P)
    npts = 1 << 16
    scal = [int(v) for v in rng.integers(1, 1 << 62, npts)]
    px, py = SRS._points_from_scalars(scal, dev)
    one = F.const(F.FQ, "one", dev).expand(npts, F.LIMBS)
    lam = _random_field(F.FQ, npts, rng, dev)
    lam[lam.eq(0).all(-1)] = F.const(F.FQ, "one", dev)
    p = tuple(cuda_field.mont_mul_plain(F.FQ, c, lam) for c in (px, py, one))
    perm = torch.randperm(npts, device=dev)
    q = tuple(c[perm].clone() for c in p)
    zero = torch.zeros(F.LIMBS, dtype=torch.int32, device=dev)
    for c, v in zip(q, (zero, F.const(F.FQ, "one", dev), zero)):
        c[0] = v                                     # P + identity
    for c, src in zip(q, p):
        c[1] = src[1]                                # P + P
    q[0][2], q[1][2], q[2][2] = p[0][2], F.neg(F.FQ, p[1][2]), p[2][2]  # P + (-P)
    for c, v in zip(p, (zero, F.const(F.FQ, "one", dev), zero)):
        c[3] = v                                     # identity + Q
    out = cuda_curve.add(p, q)
    ref = cuda_curve.add_plain(p, q)
    e = max(err(a, b) for a, b in zip(out, ref))
    if e:
        raise AssertionError(f"K3: max abs err {e}")
    if not (out[2][2] == 0).all():
        raise AssertionError("K3: P + (-P) is not the identity")
    rec["K3"] = {"errors": {"all": e}, "shape": "2^16 point pairs",
                 "ms": _time_ms(lambda: cuda_curve.add(p, q), 100),
                 "plain_ms": _time_ms(lambda: cuda_curve.add_plain(p, q), 2, 3),
                 **bound(9 * ELEM_BYTES * npts, ADD_IMADS * npts)}
    rec.update(phase_k3_entries(dev, rng, p, q))

    # P1: (16, 2^17) planes of full-range words, k in {64, 512}, mask16
    # off and on; the four times summed
    n = 1 << 17
    a, b = (torch.as_tensor(rng.integers(0, 1 << 32, (F.LIMBS, n), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32), device=dev)
            for _ in range(2))
    p1 = {"errors": {}, "ms": 0.0, "plain_ms": 0.0, "cases": {},
          "shape": "(16, 2^17) planes; k in {64, 512} x mask16 off/on, summed"}
    for k in (64, 512):
        for mask16 in (False, True):
            name = f"k{k}" + ("_mask16" if mask16 else "")
            e = err(cuda_probe.mul_probe(a, b, k, mask16),
                    cuda_probe.mul_probe_plain(a, b, k, mask16))
            if e:
                raise AssertionError(f"P1 {name}: max abs err {e}")
            case = {"ms": _time_ms(lambda: cuda_probe.mul_probe(a, b, k, mask16), 100),
                    "plain_ms": _time_ms(
                        lambda: cuda_probe.mul_probe_plain(a, b, k, mask16), 2, 3)}
            p1["errors"][name] = e
            p1["cases"][name] = case
            p1["ms"] += case["ms"]
            p1["plain_ms"] += case["plain_ms"]
    # four cases: three (16, n) planes moved and n * k multiplies each
    p1.update(bound(4 * 3 * ELEM_BYTES * n, 2 * (64 + 512) * n))
    rec["P1"] = p1

    # P1 at the size that fills the card: (16, 2^22) planes, k = 512 (the
    # row above is four launch-sized calls)
    n = 1 << 22
    a, b = (torch.randint(-(1 << 31), (1 << 31) - 1, (F.LIMBS, n), device=dev,
                          dtype=torch.int32) for _ in range(2))
    e = err(cuda_probe.mul_probe(a, b, 512, False),
            cuda_probe.mul_probe_plain(a, b, 512, False))
    if e:
        raise AssertionError(f"P1 at (16, 2^22): max abs err {e}")
    rec["P1_full"] = {
        "errors": {"k512": e}, "shape": "(16, 2^22) planes, k = 512",
        "ms": _time_ms(lambda: cuda_probe.mul_probe(a, b, 512, False), 20),
        "plain_ms": _time_ms(lambda: cuda_probe.mul_probe_plain(a, b, 512, False), 1, 1),
        **bound(3 * ELEM_BYTES * n, 512 * n)}
    del a, b

    # P2a, P2b: (16, 2^20) Fr planes with the edges 0, 1, p-1, R mod p,
    # against their plain versions and K1's plain version on the
    # transposed values; K1 timed on the same values in (N, 16) rows
    pack = _script("torch_pack_probe")
    a = pack.field_planes(1 << 20, rng, dev)
    b = pack.field_planes(1 << 20, rng, dev, edges_first=False)
    want = cuda_field.mont_mul_plain(F.FR, a.T, b.T).T
    rows_a, rows_b = a.T.contiguous(), b.T.contiguous()
    if err(cuda_field.mont_mul(F.FR, rows_a, rows_b).T, want):
        raise AssertionError("K1 on the P2 values differs")
    k1_ms = _time_ms(lambda: cuda_field.mont_mul(F.FR, rows_a, rows_b), 100)
    for key, kern, plain, limbs in (
            ("P2a", cuda_probe.mont_mul_planes16, cuda_probe.mont_mul_planes16_plain, 16),
            ("P2b", cuda_probe.mont_mul_planes13, cuda_probe.mont_mul_planes13_plain, 20)):
        out = kern(F.FR, a, b)
        errors = {"plain": err(out, plain(F.FR, a, b)), "k1_plain": err(out, want)}
        if max(errors.values()):
            raise AssertionError(f"{key}: max abs err {errors}")
        rec[key] = {"errors": errors, "shape": "(16, 2^20) Fr planes",
                    "ms": _time_ms(lambda: kern(F.FR, a, b), 100),
                    "plain_ms": _time_ms(lambda: plain(F.FR, a, b), 2, 3),
                    "k1_ms_same_values": k1_ms,
                    # a CIOS on L limbs is 2 L^2 + L multiply-adds: 16 or 20 limbs
                    **bound(3 * ELEM_BYTES << 20, (2 * limbs * limbs + limbs) << 20)}
    top = cuda_probe.mont_mul_planes13_plain(F.FR, a, b, col_max=True)[1]
    if top >= 1 << 32:
        raise AssertionError(f"P2b: a 13-bit column reached {top} >= 2^32")
    rec["P2b"]["column_max"] = top
    for key, k20 in kernels_k20(dev, rng, p, q).items():
        rec.setdefault(key, {})["k20"] = k20
    torch.cuda.synchronize()
    emit({"phase": "kernels", **rec})
    return rec


def composed_transforms(dev) -> dict:
    """The composed transform on the card (K2 launches) against the same
    composition of K2's plain version on the card, bit-exact: two polys
    of 2^23 points with a coset shift and inverse (two passes of rows of
    2^12 and 2^11), and with the row cap lowered to 6, three passes at
    2^17 (first, middle and last strides); the 2^23 transform timed,
    with its K2 launches and its bound."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import time_ms as _time_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def random_fr(rows):
        x = torch.randint(0, 1 << 16, (rows, F.LIMBS), generator=gen,
                          device=dev, dtype=torch.int32)
        x[:, -1] %= int(F.FR.p_limbs[-1])
        return x

    out, keep = {}, N.ROW_CAP
    try:
        for k, count, cap in ((23, 2, keep), (17, 3, 6)):
            N.ROW_CAP = cap
            dom = N.domain(F.FR, k)
            x, shift = random_fr(count << k), random_fr(1 << k)
            for inverse, sp in ((False, shift), (True, None)):
                before = cuda_ntt.LAUNCHES
                got = N.ntt_many(dom, x, count, inverse=inverse, shift_pows=sp)
                launches = cuda_ntt.LAUNCHES - before
                want = N._ntt_flat_composed(dom, x, count, inverse, sp,
                                            fused=cuda_ntt.ntt_fused_plain)
                name = f"2^{k}_x{count}_passes{N.pass_lengths(k)}_" + (
                    "inv" if inverse else "shift")
                if not torch.equal(got, want):
                    raise AssertionError(f"K2: the composed transform {name} "
                                         "differs from its plain composition")
                out[name] = {"max_abs_err": 0, "k2_launches": launches}
                del got, want
            if k == 23:
                lts = N.pass_lengths(k)
                b = None
                for t, lt in enumerate(lts):
                    b = add_bound(b, ntt_pass_bound(
                        count, k, lt, t == 0, (1 << k) >> sum(lts[:t])
                        if t < len(lts) - 1 else 0))
                out["ms_2^23_x2_shift"] = _time_ms(
                    lambda: N.ntt_many(dom, x, count, shift_pows=shift), 3)
                out["bound_2^23_x2_shift"] = b
            del x, shift
            torch.cuda.empty_cache()
    finally:
        N.ROW_CAP = keep
    return out


def same(name: str, got, want) -> int:
    if not all(torch_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")
    return 0


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a, b)


def phase_k3_entries(dev, rng, p, q) -> dict:
    """K3's other entries on the 2^16 points ``p``, ``q`` (row 3 of p and
    row 0 of q are the identity): the adder on strided halves and
    broadcast operands, the multi-level fold (every level, with P + (-P),
    P + P, O + O, P + O and O + P among its pairs; an odd group width),
    the masked gathered add and the in-kernel doublings, each bit-exact
    against its plain version, with times."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_curve
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import time_ms as _time_ms

    npts = p[0].shape[0]
    groups, m = 8, npts // 8
    half = m // 2
    rec = {}

    # strided halves of a (G, m) level read in place; a broadcast identity
    # and a broadcast point as either operand
    lvl = [t.reshape(groups, m, F.LIMBS) for t in p]
    lo, hi = [t[:, :half] for t in lvl], [t[:, half:] for t in lvl]
    before = cuda_curve.LAUNCHES
    errors = {"halves": same("K3 add on strided halves", cuda_curve.add(lo, hi),
                             cuda_curve.add_plain(lo, hi))}
    if any(cuda_curve._strides(t) is None for t in (*lo, *hi)):
        raise AssertionError("K3 add: a (G, m) half has no stride description")
    ident = CV.identity(device=dev)
    point = tuple(t[7] for t in q)
    full = [t.expand(npts, F.LIMBS) for t in ident]
    errors["identity_plus_q"] = same("K3 add O + Q", cuda_curve.add(ident, q),
                                     cuda_curve.add_plain(full, q))
    errors["p_plus_point"] = same(
        "K3 add P + a point", cuda_curve.add(p, point),
        cuda_curve.add_plain(p, [t.expand(npts, F.LIMBS) for t in point]))
    if cuda_curve.LAUNCHES - before != 3:
        raise AssertionError("K3 add: a strided or broadcast add is not one launch")
    rec["K3_strided"] = {
        "errors": errors, "shape": "halves of an (8, 2^13) level, read in place",
        "ms": _time_ms(lambda: cuda_curve.add(lo, hi), 100),
        "plain_ms": _time_ms(lambda: cuda_curve.add_plain(lo, hi), 2, 3),
        **bound(9 * ELEM_BYTES * npts // 2, ADD_IMADS * npts // 2)}

    # the fold: every level of (8, 2^13) and of the odd-width (3, 12)
    lvl = tuple(t.clone() for t in p)
    zero = torch.zeros(F.LIMBS, dtype=torch.int32, device=dev)
    one = F.const(F.FQ, "one", dev)
    lvl[0][half], lvl[2][half] = lvl[0][0], lvl[2][0]          # P + (-P)
    lvl[1][half] = F.neg(F.FQ, lvl[1][0])
    for t, v in zip(lvl, (zero, one, zero)):
        t[half + 1] = t[1]                                      # P + P
        t[2] = t[half + 2] = v                                  # O + O
        t[half + 4] = v                                         # P + O
    depth = m.bit_length() - 1
    errors = {}
    before = cuda_curve.LAUNCHES
    got = cuda_curve.fold(lvl, groups, m, depth)
    launches = cuda_curve.LAUNCHES - before
    if launches != (depth + 1) // 2:
        raise AssertionError(f"K3 fold: {launches} launches for {depth} levels")
    for i, (a, b) in enumerate(zip(got, cuda_curve.fold_plain(lvl, groups, m, depth))):
        errors[f"level{i + 1}"] = same(f"K3 fold level {i + 1}", a, b)
    small = tuple(t[:36].contiguous() for t in lvl)
    for i, (a, b) in enumerate(zip(cuda_curve.fold(small, 3, 12, 2),
                                   cuda_curve.fold_plain(small, 3, 12, 2))):
        errors[f"odd_level{i + 1}"] = same(f"K3 fold (3, 12) level {i + 1}", a, b)
    rec["K3_fold"] = {
        "errors": errors, "shape": "two levels of an (8, 2^13) level",
        "ms": _time_ms(lambda: cuda_curve.fold(lvl, groups, m, 2), 100),
        "plain_ms": _time_ms(lambda: cuda_curve.fold_plain(lvl, groups, m, 2), 2, 3),
        **bound(3 * ELEM_BYTES * (npts + npts // 2 + npts // 4),
                ADD_IMADS * 3 * npts // 4)}

    # the masked gathered add: a Fenwick level
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    index = torch.randint(0, npts, (npts,), generator=gen, device=dev)
    mask = torch.randint(0, 2, (npts,), generator=gen, device=dev).bool()
    index[:2] = 3                    # the gathered identity, bit set and clear
    mask[:2] = torch.tensor([True, False], device=dev)
    errors = {
        "acc": same("K3 masked add", cuda_curve.masked_add(q, p, index, mask),
                    cuda_curve.masked_add_plain(q, p, index, mask)),
        "identity_acc": same("K3 masked add from the identity",
                             cuda_curve.masked_add(ident, p, index, mask),
                             cuda_curve.masked_add_plain(ident, p, index, mask))}
    rec["K3_masked"] = {
        "errors": errors, "shape": "2^16 rows gathered from 2^16 nodes",
        "ms": _time_ms(lambda: cuda_curve.masked_add(q, p, index, mask), 100),
        "plain_ms": _time_ms(
            lambda: cuda_curve.masked_add_plain(q, p, index, mask), 2, 3),
        **bound((6 * npts + 3 * int(mask.sum())) * ELEM_BYTES + 9 * npts,
                ADD_IMADS * npts)}

    # doublings in the kernel: once (curve.double) and a window's 13
    errors = {f"times{t}": same(f"K3 double_n({t})", cuda_curve.double_n(p, t),
                                cuda_curve.double_n_plain(p, t))
              for t in (0, 1, 13)}
    if not (cuda_curve.double_n(p, 13)[2][3] == 0).all():
        raise AssertionError("K3 double_n: the identity did not stay the identity")
    rec["K3_double"] = {
        "errors": errors, "shape": "2^16 points, 13 doublings each",
        "ms": _time_ms(lambda: cuda_curve.double_n(p, 13), 20),
        "plain_ms": _time_ms(lambda: cuda_curve.double_n_plain(p, 13), 1, 2),
        **bound(6 * ELEM_BYTES * npts, 13 * DOUBLE_IMADS * npts)}
    return rec


def kernels_k20(dev, rng, p, q, count: int = 45, reps: int = 8) -> dict:
    """K1, K2 and K3 at the shapes of the k=20 prove, each against its
    plain version (bit-exact) and timed (plain: one call after a warm-up):
    K1 on a 45 x 2^20 stack against a broadcast 2^20 row, K2 on the fused
    passes of a forward (coset shift on load) and an inverse transform of
    a 45 x 2^20 stack (the quotient's dynamic stack), one ``ntt_many``
    counted and profiled (two K2 launches, nothing else), K3 on 2^19
    point pairs (an MSM tree's first level), two tree levels of an
    (8, 2^16) level, a Fenwick level and a window group's doublings;
    ``p``, ``q`` are the 2^16 K3 pairs, rescaled to fresh
    representatives."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import time_ms as _time_ms

    def check(name, out, ref):
        same(f"{name} at the k=20 shape", out, ref)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))

    def random_fr(rows):
        """Canonical-range limbs made on the card (the top limb below p's)."""
        x = torch.randint(0, 1 << 16, (rows, F.LIMBS), generator=gen,
                          device=dev, dtype=torch.int32)
        x[:, -1] %= int(F.FR.p_limbs[-1])
        return x

    out = {}
    n = 1 << 20
    stack = random_fr(count * n).reshape(count, n, F.LIMBS)
    row = random_fr(n)
    check("K1", [cuda_field.mont_mul(F.FR, stack, row)],
          [cuda_field.mont_mul_plain(F.FR, stack, row)])
    out["K1"] = {"shape": "(45, 2^20) x broadcast (2^20,)", "max_abs_err": 0,
                 "ms": _time_ms(lambda: cuda_field.mont_mul(F.FR, stack, row), 10),
                 "plain_ms": _time_ms(
                     lambda: cuda_field.mont_mul_plain(F.FR, stack, row), 1, 1),
                 **bound((2 * count + 1) * n * ELEM_BYTES,
                         count * n * MONT_MUL_IMADS)}
    # K2: both fused passes of a 45 x 2^20 stack, forward (shift on load)
    # and inverse, each against its plain version; then the whole
    # ntt_many, which must be two K2 launches and nothing else
    k2 = {"shape": "45 x 2^20, shift and mid table inside: (46080, 1024) "
                   "rows x lanes, twice; forward and inverse",
          "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0}
    k2_bound = None
    flat = stack.reshape(count * n, F.LIMBS)
    for inverse in (False, True):
        tw = N._twiddles(F.FR, 10, inverse, dev)
        x = flat
        for stride, mul_in, mul_out in (
                (1, None if inverse else row, N._mid_table(F.FR, 20, 10, inverse, dev)),
                (1 << 10, None, None)):
            args = (F.FR, x, count, 20, 10, tw, stride, mul_in, mul_out)
            got = cuda_ntt.ntt_fused(*args)
            check("K2", [got], [cuda_ntt.ntt_fused_plain(*args)])
            k2["ms"] += _time_ms(lambda: cuda_ntt.ntt_fused(*args), 10)
            k2["plain_ms"] += _time_ms(lambda: cuda_ntt.ntt_fused_plain(*args), 1, 1)
            k2_bound = add_bound(k2_bound, ntt_pass_bound(
                count, 20, 10, mul_in is not None, n if mul_out is not None else 0))
            x = got
        del x, got
    k2.update(k2_bound)
    out["K2"] = k2
    dom = N.domain(F.FR, 20)
    N.ntt_many(dom, flat, count, shift_pows=row)            # tables cached
    before = (cuda_field.LAUNCHES, cuda_ntt.LAUNCHES)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        N.ntt_many(dom, flat, count, shift_pows=row)
        N.ntt_many(dom, flat, count, inverse=True)
        torch.cuda.synchronize()
    launched = (cuda_field.LAUNCHES - before[0], cuda_ntt.LAUNCHES - before[1])
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if launched != (0, 4) or any("ntt_fused_kernel" not in nm for nm in names):
        raise AssertionError(f"ntt_many at k=20: K1, K2 launches {launched} for "
                             f"two transforms, device kernels {names}")
    out["ntt_many"] = {
        "shape": "45 x 2^20 with a coset shift", "k1_launches": 0,
        "k2_launches_per_transform": 2, "device_kernels": names,
        "ms": _time_ms(lambda: N.ntt_many(dom, flat, count, shift_pows=row), 5, 3)}
    del row, stack, flat
    lam = random_fr(reps * p[0].shape[0])           # < r < q: a valid Fq value
    lam[lam.eq(0).all(-1)] = F.const(F.FQ, "one", dev)
    pp = tuple(cuda_field.mont_mul_plain(F.FQ, c.repeat(reps, 1), lam) for c in p)
    qq = tuple(cuda_field.mont_mul_plain(F.FQ, c.repeat(reps, 1), lam.flip(0))
               for c in q)
    npairs = pp[0].shape[0]
    check("K3", cuda_curve.add(pp, qq), cuda_curve.add_plain(pp, qq))
    out["K3"] = {"shape": "2^19 point pairs", "max_abs_err": 0,
                 "ms": _time_ms(lambda: cuda_curve.add(pp, qq), 20),
                 "plain_ms": _time_ms(lambda: cuda_curve.add_plain(pp, qq), 1, 1),
                 **bound(9 * ELEM_BYTES * npairs, ADD_IMADS * npairs)}
    # two tree levels of an (8, 2^16) level in one launch
    for a, b in zip(cuda_curve.fold(pp, 8, npairs // 8, 2),
                    cuda_curve.fold_plain(pp, 8, npairs // 8, 2)):
        check("K3 fold", a, b)
    out["K3_fold"] = {
        "shape": "two levels of an (8, 2^16) level", "max_abs_err": 0,
        "ms": _time_ms(lambda: cuda_curve.fold(pp, 8, npairs // 8, 2), 20),
        "plain_ms": _time_ms(lambda: cuda_curve.fold_plain(pp, 8, npairs // 8, 2), 1, 1),
        **bound(3 * ELEM_BYTES * (npairs + npairs // 2 + npairs // 4),
                ADD_IMADS * 3 * npairs // 4)}
    # a Fenwick level: 8 windows x 2^13 buckets gathered from 2^19 nodes
    rows = 8 << 13
    index = torch.randint(0, npairs, (rows,), generator=gen, device=dev)
    mask = torch.randint(0, 2, (rows,), generator=gen, device=dev).bool()
    acc = tuple(t[:rows].contiguous() for t in qq)
    check("K3 masked add", cuda_curve.masked_add(acc, pp, index, mask),
          cuda_curve.masked_add_plain(acc, pp, index, mask))
    out["K3_masked"] = {
        "shape": "2^16 rows gathered from 2^19 nodes", "max_abs_err": 0,
        "ms": _time_ms(lambda: cuda_curve.masked_add(acc, pp, index, mask), 20),
        "plain_ms": _time_ms(
            lambda: cuda_curve.masked_add_plain(acc, pp, index, mask), 1, 1),
        **bound((6 * rows + 3 * int(mask.sum())) * ELEM_BYTES + 9 * rows,
                ADD_IMADS * rows)}
    # the roots of 8 windows doubled 13 times (the bucket weights' B - 1)
    roots = tuple(t[:8].contiguous() for t in pp)
    check("K3 double_n", cuda_curve.double_n(roots, 13),
          cuda_curve.double_n_plain(roots, 13))
    out["K3_double"] = {
        "shape": "8 points, 13 doublings each", "max_abs_err": 0,
        "ms": _time_ms(lambda: cuda_curve.double_n(roots, 13), 20),
        "plain_ms": _time_ms(lambda: cuda_curve.double_n_plain(roots, 13), 1, 1),
        **bound(6 * ELEM_BYTES * 8, 13 * DOUBLE_IMADS * 8)}
    torch.cuda.empty_cache()
    return out


def phase_golden(dev):
    """Toy proofs on the card == the reference's golden bytes, verified."""
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.backend import ipa as IPA
    from halo2_aes_tpu_torch.circuit.toys import (GOLDEN_IPA_PROOFS,
                                                  GOLDEN_PROOFS, K, TOYS)

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_k6.json")) as f:
        golden = json.load(f)
    srs = SRS.setup(K, dev, cache_dir=None)
    pks = {}
    out = {}
    basis = IPA.setup(K, dev, cache_dir=None)
    for name, toy in GOLDEN_IPA_PROOFS.items():
        build, seed, instances = TOYS[toy]
        layout, values = build()
        pk = KG.keygen(layout, basis)
        if hex(pk.vk.digest) != golden[name]["vk_digest"]:
            raise AssertionError(f"golden {name}: vk digest differs")
        proof = PV.prove(pk, values, seed=seed, multiopen="ipa")
        if proof.hex() != golden[name]["proof"]:
            raise AssertionError(f"golden {name}: proof bytes differ")
        IPA.verify(pk.vk, proof, instances=instances, srs=basis)
        out[name] = len(proof)
    for name, (toy, opts) in GOLDEN_PROOFS.items():
        build, seed, instances = TOYS[toy]
        layout, values = build()
        if toy not in pks:
            pks[toy] = KG.keygen(layout, srs)
        pk = pks[toy]
        if hex(pk.vk.digest) != golden[name]["vk_digest"]:
            raise AssertionError(f"golden {name}: vk digest differs")
        proof = PV.prove(pk, values, seed=seed, **opts)
        if proof.hex() != golden[name]["proof"]:
            raise AssertionError(f"golden {name}: proof bytes differ")
        VF.verify(pk.vk, proof, instances=instances,
                  multiopen=opts.get("multiopen", "shplonk"))
        out[name] = len(proof)
    torch.cuda.synchronize()
    emit({"phase": "golden", "identical": True, "verified": True,
          "proof_bytes": out})


K3_ENTRIES = {"K3_add": "add", "K3_fold": "fold", "K3_masked": "masked_add",
              "K3_double": "double_n"}
# every prove with window tables commits through K7 alone: K3 runs in the
# SRS's setup, the tables' build, a mesh's reduction across ranks and the
# tableless Horner tail, so the paths that have those require it too
PATH_KERNELS = ("K1", "K2", "K4", "K6", "K7")
TABLELESS_KERNELS = (*PATH_KERNELS, "K3")
PROBE_KERNELS = {"P1": "mul_probe", "P2a": "mont_mul_planes16",
                 "P2b": "mont_mul_planes13"}
K5_ENTRIES = {"K5_product": "product", "K5_normalize": "normalize"}


def reset_counts():
    from halo2_aes_tpu_torch.ops import (cuda_curve, cuda_field, cuda_grand, cuda_msm,
                                         cuda_nibble, cuda_ntt, cuda_probe,
                                         cuda_quotient)

    for mod in (cuda_field, cuda_ntt, cuda_curve, cuda_quotient, cuda_nibble,
                cuda_grand, cuda_msm):
        mod.LAUNCHES = 0
    for entry in cuda_curve.ENTRY_LAUNCHES:
        cuda_curve.ENTRY_LAUNCHES[entry] = 0
    for entry in cuda_msm.ENTRY_LAUNCHES:
        cuda_msm.ENTRY_LAUNCHES[entry] = 0
    for entry in cuda_nibble.ENTRY_LAUNCHES:
        cuda_nibble.ENTRY_LAUNCHES[entry] = 0
    cuda_probe.reset_counts()


def read_counts() -> dict:
    from halo2_aes_tpu_torch.ops import (cuda_curve, cuda_field, cuda_grand, cuda_msm,
                                         cuda_nibble, cuda_ntt, cuda_probe,
                                         cuda_quotient)

    out = {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
           "K3": cuda_curve.LAUNCHES, "K4": cuda_quotient.LAUNCHES,
           "K5": cuda_nibble.LAUNCHES, "K6": cuda_grand.LAUNCHES,
           "K7": cuda_msm.LAUNCHES}
    out.update({key: cuda_curve.ENTRY_LAUNCHES[name]
                for key, name in K3_ENTRIES.items()})
    out.update({key: cuda_probe.LAUNCHES[name]
                for key, name in PROBE_KERNELS.items()})
    out.update({key: cuda_nibble.ENTRY_LAUNCHES[name]
                for key, name in K5_ENTRIES.items()})
    return out


def require_launched(phase: str, counts: dict, kernels) -> None:
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched: {missing} {counts}")


def rejects_flipped_byte(verify, proof: bytes) -> bool:
    bad = bytearray(proof)
    bad[-1] ^= 1
    try:
        verify(bytes(bad))
    except ValueError:            # VerifyError or a malformed transcript
        return True
    return False


def phase_flagship(dev) -> dict:
    """The main path once, at the flagship shape; returns launch counts."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    cfg = FLAGSHIP
    reset_counts()
    t = {}
    t0 = time.perf_counter()
    layout = compile_circuit(AesConfig(**cfg))
    srs = SRS.setup(cfg["k"], dev, cache_dir=None)
    torch.cuda.synchronize()
    t["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = KG.keygen(layout, srs)
    torch.cuda.synchronize()
    t["keygen_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (cfg["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    t0 = time.perf_counter()
    PV.prove(pk, values)
    torch.cuda.synchronize()
    t["warmup_prove_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    proof = PV.prove(pk, values)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    VF.verify(pk.vk, proof)
    t["verify_s"] = time.perf_counter() - t0
    bad = bytearray(proof)
    bad[-1] ^= 1
    try:
        VF.verify(pk.vk, bytes(bad))
    except ValueError:            # VerifyError or a malformed transcript
        rejected = True
    else:
        rejected = False
    counts = read_counts()
    if not rejected:
        raise AssertionError("flagship: a proof with a flipped byte verified")
    if len(proof) != FLAGSHIP_PROOF_BYTES:
        raise AssertionError(f"flagship: proof is {len(proof)} bytes, "
                             f"expected {FLAGSHIP_PROOF_BYTES}")
    require_launched("flagship", counts, PATH_KERNELS)
    emit({"phase": "flagship", **cfg, "blocks_per_s": cfg["n_blocks"] / prove_s,
          "prove_s": prove_s, **t, "proof_bytes": len(proof), "verified": True,
          "flipped_byte_rejected": rejected, "peak_mem_bytes": peak,
          "launches": counts})
    return counts, pk, values, proof


def eager_terms_proof(pk, values, **opts) -> bytes:
    """A proof whose quotient terms take the eager fold in place of K4."""
    from halo2_aes_tpu_torch.backend import prover as PV

    route = PV._Phases.quotient_subcoset
    PV._Phases.quotient_subcoset = PV._Phases.quotient_subcoset_eager
    try:
        return PV.prove(pk, values, **opts)
    finally:
        PV._Phases.quotient_subcoset = route


def quotient_terms_proofs(pk, values, dev) -> dict:
    """On the flagship's pk (and an IPA pk of the same circuit): SHPLONK,
    GWC and IPA proofs with K4 equal those with the eager fold, byte for
    byte, and K4 launched once a sub-coset."""
    from halo2_aes_tpu_torch.backend import ipa as IPA
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    out = {}
    ipa_pk = KG.keygen_cached(compile_circuit(AesConfig(**FLAGSHIP)),
                              IPA.setup(FLAGSHIP["k"], dev,
                                        cache_dir=os.path.join(REPO, "ptau")),
                              cache_dir=os.path.join(REPO, "ptau"))
    for multiopen, key in (("shplonk", pk), ("gwc", pk), ("ipa", ipa_pk)):
        reset_counts()
        proof = PV.prove(key, values, seed=5, multiopen=multiopen)
        launches = read_counts()["K4"]
        if launches != PV._get_phases(key).ratio:
            raise AssertionError(f"quotient_terms: {launches} K4 launches in a "
                                 f"{multiopen} prove")
        if proof != eager_terms_proof(key, values, seed=5, multiopen=multiopen):
            raise AssertionError(f"quotient_terms: the flagship {multiopen} proof "
                                 "with K4 differs from the eager fold's")
        out[multiopen] = {"proof_bytes": len(proof), "k4_launches": launches,
                          "equals_eager": True}
    return out


def quotient_terms_kernels(dev) -> dict:
    """K4 on the benchmark cell's circuit, one launch a sub-coset: at k=20
    against the eager fold, at k=23 against the plain version over a
    quarter of the rows; bit-exact, with CUDA-event times and the
    bound."""
    kt = _script("torch_kernel_times")
    rec = {"k20": kt.quotient_terms_times(dev, 20)}
    free()
    rec["k23"] = kt.quotient_terms_times(dev, 23)
    free()
    for key, r in rec.items():
        if r["launches"] != 1:
            raise AssertionError(f"quotient_terms: {r['launches']} K4 launches "
                                 f"for a {key} sub-coset")
    return rec


@contextlib.contextmanager
def eager_grand_products():
    """The grand products' columns by the eager field ops in place of K6."""
    from halo2_aes_tpu_torch.backend import lookup as LK
    from halo2_aes_tpu_torch.backend import permutation as PERM

    saved = LK.grand_product, LK.grand_product_many, PERM.grand_products
    LK.grand_product, LK.grand_product_many, PERM.grand_products = (
        LK.grand_product_eager, LK.grand_product_many_eager,
        PERM.grand_products_eager)
    try:
        yield
    finally:
        LK.grand_product, LK.grand_product_many, PERM.grand_products = saved


def grand_products_proofs(pk, values, dev) -> dict:
    """On the flagship's pk (and an IPA pk of the same circuit): SHPLONK,
    GWC and IPA proofs with K6 equal those with the eager grand products,
    byte for byte, and K6 launched three times a column (the small
    path's lookups are one batched column)."""
    from halo2_aes_tpu_torch.backend import ipa as IPA
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    out = {}
    ipa_pk = KG.keygen_cached(compile_circuit(AesConfig(**FLAGSHIP)),
                              IPA.setup(FLAGSHIP["k"], dev,
                                        cache_dir=os.path.join(REPO, "ptau")),
                              cache_dir=os.path.join(REPO, "ptau"))
    for multiopen, key in (("shplonk", pk), ("gwc", pk), ("ipa", ipa_pk)):
        reset_counts()
        proof = PV.prove(key, values, seed=5, multiopen=multiopen)
        launches = read_counts()["K6"]
        ph = PV._get_phases(key)
        columns = ph.chunks + (ph.n_lk if ph.large() else min(ph.n_lk, 1))
        if launches != 3 * columns:
            raise AssertionError(f"grand_products: {launches} K6 launches in a "
                                 f"{multiopen} prove, expected {3 * columns}")
        with eager_grand_products():
            eager = PV.prove(key, values, seed=5, multiopen=multiopen)
        if proof != eager:
            raise AssertionError(f"grand_products: the flagship {multiopen} proof "
                                 "with K6 differs from the eager path's")
        out[multiopen] = {"proof_bytes": len(proof), "k6_launches": launches,
                          "equals_eager": True}
    return out


def grand_products_kernels(dev) -> dict:
    """K6 at the benchmark cell's shapes (2^20 rows: 17 lookup columns, 5
    permutation chunks over 14 columns) against its plain version and the
    eager path, bit-exact, with CUDA-event times and the bound."""
    rec = _script("torch_kernel_times").grand_products_times(dev, 20)
    free()
    return rec


@contextlib.contextmanager
def tree_msm():
    """The MSM by the sorted-prefix tree (``msm.msm_tree``,
    ``msm_many_tree``) in place of K7."""
    from halo2_aes_tpu_torch.ops import msm as MSM

    saved = MSM.msm, MSM.msm_many
    MSM.msm, MSM.msm_many = MSM.msm_tree, MSM.msm_many_tree
    try:
        yield
    finally:
        MSM.msm, MSM.msm_many = saved


@contextlib.contextmanager
def no_tree():
    """The tree's window sums made to raise: a prove must not reach them."""
    from halo2_aes_tpu_torch.ops import msm as MSM

    saved = MSM._window_sums

    def refuse(*a, **k):
        raise AssertionError("msm_buckets: a prove ran the sorted-prefix tree")

    MSM._window_sums = refuse
    try:
        yield
    finally:
        MSM._window_sums = saved


def msm_buckets_proofs(pk, values, dev, key: str, cfg: dict) -> dict:
    """SHPLONK and GWC proofs on ``pk`` (of the circuit ``cfg``) and an
    IPA proof of the same circuit with K7 equal those with the
    sorted-prefix tree, byte for byte, verify, and launch K7 and never
    the tree."""
    from halo2_aes_tpu_torch.backend import ipa as IPA
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    cache = os.path.join(REPO, "ptau")
    basis = None

    def keys():
        """The KZG pk's proofs, then the IPA pk, made only when needed."""
        nonlocal basis
        yield "shplonk", pk
        yield "gwc", pk
        basis = IPA.setup(cfg["k"], dev, cache_dir=cache)
        yield "ipa", KG.keygen_cached(compile_circuit(AesConfig(**cfg)), basis,
                                      cache_dir=cache)

    out = {}
    for multiopen, k in keys():
        reset_counts()
        with no_tree():
            proof = PV.prove(k, values, seed=5, multiopen=multiopen)
        counts = read_counts()
        require_launched(f"msm_buckets {key} {multiopen}", counts, PATH_KERNELS)
        with tree_msm():
            tree = PV.prove(k, values, seed=5, multiopen=multiopen)
        if proof != tree:
            raise AssertionError(f"msm_buckets: the {key} {multiopen} proof with K7 "
                                 "differs from the tree's")
        if multiopen == "ipa":
            IPA.verify(k.vk, proof, srs=basis)
        else:
            VF.verify(k.vk, proof, multiopen=multiopen)
        out[multiopen] = {"proof_bytes": len(proof), "k7_launches": counts["K7"],
                          "k3_launches": counts["K3"], "equals_tree": True,
                          "verified": True}
        del k, proof, tree
    return out


def msm_buckets_k20(dev) -> dict:
    """The upstream prover binary's shape (k=20, 4 sets, 3,082 blocks; keys
    cached in ptau/): SHPLONK, GWC and IPA proofs with K7 equal the
    tree's."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    cache = os.path.join(REPO, "ptau")
    layout = compile_circuit(AesConfig(**LARGE))
    pk = KG.keygen_cached(layout, SRS.setup(LARGE["k"], dev, cache_dir=cache),
                          cache_dir=cache)
    rng = np.random.default_rng(3)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (LARGE["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    return msm_buckets_proofs(pk, values, dev, "k20", LARGE)


def msm_buckets_tableless(dev, lg: int = 23) -> dict:
    """A tableless MSM (the k >= 22 commitments: one set a window and the
    Horner doublings) of 2^lg points, the 2^20 SRS points repeated, with
    K7 equal to the tree's."""
    import torch

    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as MSM
    from halo2_aes_tpu_torch.ops.timing import time_ms

    srs = SRS.setup(20, dev, cache_dir=os.path.join(REPO, "ptau"))
    reps = 1 << (lg - 20)
    pts = (srs.g1_x.repeat(reps, 1), srs.g1_y.repeat(reps, 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(lg)
    scal = torch.randint(0, 1 << 16, (1 << lg, F.LIMBS), generator=gen,
                         device=dev, dtype=torch.int32)
    scal[:, -1] %= int(F.FR.p_limbs[-1])
    reset_counts()
    got = CV.to_affine_host(MSM.msm(pts, scal))
    k7 = read_counts()["K7"]
    if got != CV.to_affine_host(MSM.msm_tree(pts, scal)):
        raise AssertionError(f"msm_buckets: a tableless MSM of 2^{lg} points "
                             "differs from the tree's")
    rec = {"lg": lg, "window": MSM.default_window(1 << lg), "k7_launches": k7,
           "equals_tree": True, "k7_ms": time_ms(lambda: MSM.msm(pts, scal), 1, 3),
           "tree_ms": time_ms(lambda: MSM.msm_tree(pts, scal), 1, 3)}
    del pts, scal
    return rec


def msm_buckets_kernels(dev) -> dict:
    """K7 against its plain version (bit for bit, small shapes and the
    cell's shape: 8 commitments of 2^20 points) and at the cell's shape
    against the tree, timed beside its bound; the k=20 SHPLONK, GWC and
    IPA proofs with K7 equal the tree's; a tableless 2^23-point MSM
    equals the tree's."""
    kt = _script("torch_kernel_times")
    rec = {"check": kt.msm_buckets_check(dev)}
    free()
    rec["times"] = kt.msm_buckets_times(dev, 20, 8)
    free()
    rec["k20_proofs"] = msm_buckets_k20(dev)
    free()
    rec["tableless"] = msm_buckets_tableless(dev)
    free()
    return rec


def phase_probes(dev) -> dict:
    """The probe scripts' paths: P1 throughput and P2 against K1."""
    import torch

    mul = _script("torch_mul_throughput_probe")
    pack = _script("torch_pack_probe")
    reset_counts()
    p1 = mul.run(str(dev), 17, 3)
    p2 = pack.run(str(dev), 17, 3)
    torch.cuda.synchronize()
    counts = read_counts()
    require_launched("probes", counts, PROBE_KERNELS)
    emit({"phase": "probes", "mul_throughput": p1, "pack": p2,
          "launches": counts})
    return counts


def _int_mm_pairs(x, B):
    """``torch._int_mm`` operands for K5's product (the yardstick only):
    pre-expanded nibbles and B, padded to multiples of 8, one pair a group."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_nibble

    k, m = B.shape[1:]
    kp, mp = -(-k // 8) * 8, -(-m // 8) * 8
    a = torch.nn.functional.pad(cuda_nibble.nibbles(x), (0, kp - k))
    b = torch.nn.functional.pad(B, (0, mp - m, 0, kp - k))
    return [(a[i].contiguous(), b[i].contiguous()) for i in range(x.shape[0])]


def _mxu_paths_without_torch_carry(dev, a, rng) -> dict:
    """FixedMul, DftMatmul(16), BatchedDftMatmul (ntt256's stage 2) and
    ntt256 on the card with ``carry_norm_ks`` made to raise, and the
    device kernels one call of each launches (torch.profiler).  FixedMul
    must launch K5 three times (its counter and the profile agree) and
    its other kernels must be no more than ``F._cond_sub_p``'s own plus
    four slices and casts: no int64 carry pass is left on the path."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_nibble
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX

    probe = _script("torch_mxu_probe")
    fixed = MX.FixedMul(F.FR, int.from_bytes(rng.bytes(32), "little") % F.FR.modulus)
    dft = probe.dft16()
    d2 = MX._ntt256_stages(F.FR)[1]
    vectors = a.reshape(-1, 256, F.LIMBS)
    calls = {"fixed_mul": lambda: fixed(a),
             "dft_matmul16": lambda: dft(a.reshape(-1, 16, F.LIMBS)),
             "batched_dft_ntt256_stage2": lambda: d2(vectors.reshape(-1, 16, 16, F.LIMBS)),
             "ntt256": lambda: MX.ntt256(F.FR, vectors)}

    def refuse(*args, **kwargs):
        raise AssertionError("mxu: carry_norm_ks ran on a CUDA tensor")

    saved, MX.carry_norm_ks = MX.carry_norm_ks, refuse
    try:
        before = cuda_nibble.ENTRY_LAUNCHES["normalize"]
        calls["fixed_mul"]()
        k5_fixed = cuda_nibble.ENTRY_LAUNCHES["normalize"] - before
        kernels = {name: probe.device_kernels(fn) for name, fn in calls.items()}
    finally:
        MX.carry_norm_ks = saved
    r = torch.zeros((a.shape[0], F.LIMBS), dtype=torch.int64, device=dev)
    cond = sum(probe.device_kernels(lambda: F._cond_sub_p(F.FR, r)).values())
    out = {}
    for name, by_name in kernels.items():
        k5 = sum(c for k, c in by_name.items() if "nibble_mma_kernel" in k)
        out[name] = {"device_kernels": sum(by_name.values()), "k5": k5,
                     "names": by_name}
    fm = out["fixed_mul"]
    if k5_fixed != 3 or fm["k5"] != 3 or fm["device_kernels"] > 3 + cond + 4:
        raise AssertionError(f"mxu: FixedMul launched {fm['device_kernels']} device "
                             f"kernels ({fm['k5']} K5 seen, {k5_fixed} counted; "
                             f"_cond_sub_p alone {cond}): {fm['names']}")
    out["cond_sub_p_kernels"] = cond
    return out


def phase_mxu(dev, log2n: int = 17):
    """K5 against its plain versions at every product shape of the probe's
    paths (2^17 batch) and at the accumulator edge, bit-exact, with times,
    bounds and ``torch._int_mm`` on the same products; its normalize entry
    at the paths' four carry sites (with the addend), bit-exact, timed;
    FixedMul against K1 and ntt256 against K2 on the card; the paths'
    device kernels per call with no torch carry pass; then the probe's
    path with the counts reset.  Returns (the K5 record, the path's launch
    counts)."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import cuda_field, cuda_nibble
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX
    from halo2_aes_tpu_torch.ops import ntt
    from halo2_aes_tpu_torch.ops.timing import time_ms

    probe = _script("torch_mxu_probe")
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    cases = probe.k5_cases(log2n, rng, dev)
    path_cases = list(cases)
    # the accumulator edge at N = 32: every x limb and every w entry p-1;
    # and the worst case the kernel admits (x limbs 0xFFFF, B all 15)
    p = F.FR.modulus
    edge = MX.DftMatmul(F.FR, [[p - 1] * 32] * 32)
    rows32 = (1 << log2n) // 32
    cases["edge_dft32_p-1"] = (
        F.limbs(np.tile(F.int_to_limbs(p - 1), (rows32, 32)), dev)[None],
        MX._on(edge._dev, edge._W, dev, MX._COLS)[0], 127)
    cases["edge_all15_2048x4064"] = (
        torch.full((1, 256, 512), 0xFFFF, dtype=torch.int32, device=dev),
        torch.full((1, 2048, 32 * 127), 15, dtype=torch.int8, device=dev), 127)
    packed = {name: cuda_nibble.pack(B, block) for name, (_, B, block) in cases.items()}
    host_s = time.perf_counter() - t0
    per, errors = {}, {}
    for name, (x, B, block) in cases.items():
        pk = packed[name]
        out = cuda_nibble.nibble_product(x, B, block, pk)
        e = int((out.to(torch.int64)
                 - cuda_nibble.nibble_product_plain(x, B, block).to(torch.int64))
                .abs().max().item())
        if e:
            raise AssertionError(f"K5 {name}: max abs err {e}")
        errors[name] = e
        pairs = _int_mm_pairs(x, B)
        lib = [torch._int_mm(a, b) for a, b in pairs]
        m = B.shape[-1]
        lib_out = cuda_nibble.fold(torch.stack(lib)[..., :m].to(torch.int64), block or m)
        kept = cuda_nibble._kept(pk)
        per[name] = {
            "shape": [list(x.shape), list(B.shape), block],
            "max_out": int(out.max().item()),
            "library_agrees": bool(torch.equal(lib_out, out)),
            "fragments_kept": int(kept.sum().item()),
            "fragments": kept.numel(),
            "ms": time_ms(lambda: cuda_nibble.nibble_product(x, B, block, pk), 20),
            "plain_ms": time_ms(
                lambda: cuda_nibble.nibble_product_plain(x, B, block), 2, 3),
            "library_ms": time_ms(lambda: [torch._int_mm(a, b) for a, b in pairs],
                                  20),
            **probe.k5_bound(x, B, block)}
        del lib, lib_out, pairs
    if per["edge_all15_2048x4064"]["max_out"] != 225 * 2048 * 4369:
        raise AssertionError(f"K5 edge: {per['edge_all15_2048x4064']['max_out']}")
    if per["edge_all15_2048x4064"]["fragments_kept"] != per["edge_all15_2048x4064"]["fragments"]:
        raise AssertionError("K5 edge: a fragment of the all-15 B was skipped")
    # the normalize entry at the paths' four carry sites, with the addend
    normalize = {}
    for name, (x, B, block, width, add) in probe.k5_normalize_cases(log2n, rng, dev).items():
        pk = cuda_nibble.pack(B, block)
        out = cuda_nibble.nibble_normalize(x, B, block, width, add, pk)
        e = int((out.to(torch.int64) - cuda_nibble.nibble_normalize_plain(
            x, B, block, width, add).to(torch.int64)).abs().max().item())
        if e:
            raise AssertionError(f"K5 normalize {name}: max abs err {e}")
        errors[f"normalize_{name}"] = e
        if add is not None:
            # an addend entry outside 16 bits is taken mod 2^16 on the card
            # as on the CPU
            wild = torch.randint(-(1 << 31), (1 << 31) - 1, add.shape,
                                 dtype=torch.int32, device=dev)
            e = int((cuda_nibble.nibble_normalize(x, B, block, width, wild, pk)
                     .to(torch.int64) - cuda_nibble.nibble_normalize_plain(
                         x, B, block, width, wild).to(torch.int64)).abs().max().item())
            if e:
                raise AssertionError(f"K5 normalize {name}, addend mod 2^16: "
                                     f"max abs err {e}")
            errors[f"normalize_{name}_addend_mod_2^16"] = e
            del wild
        normalize[name] = {
            "shape": [list(x.shape), list(B.shape), block, width,
                      None if add is None else list(add.shape)],
            "ms": time_ms(lambda: cuda_nibble.nibble_normalize(x, B, block, width,
                                                               add, pk), 20),
            "plain_ms": time_ms(lambda: cuda_nibble.nibble_normalize_plain(
                x, B, block, width, add), 2, 3),
            **probe.k5_bound(x, B, block, width, add)}
    rec = {"errors": errors, "cases": per, "normalize": normalize,
           "normalize_summed": {
               "errors": {k: v for k, v in errors.items() if k.startswith("normalize_")},
               "library_ms": None,
               **{key: sum(r[key] for r in normalize.values())
                  for key in ("ms", "plain_ms")},
               **probe.bound(sum(r["bytes"] for r in normalize.values()),
                             sum(r["macs"] for r in normalize.values()))},
           "host_matrices_s": host_s,
           "shape": "the five product shapes of the probe's paths at 2^17, summed"}
    for key in ("ms", "plain_ms", "library_ms"):
        rec[key] = sum(per[name][key] for name in path_cases)
    rec.update(probe.bound(sum(per[name]["bytes"] for name in path_cases),
                           sum(per[name]["macs"] for name in path_cases)))
    rec["share"] = rec["bound_ms"] / rec["ms"]
    del cases, packed
    # FixedMul against K1, and ntt256 against K2, on the card
    a = probe.random_fr(1 << log2n, rng, dev)
    a[:3] = F.limbs(F.ints_to_limbs_fast([0, 1, p - 1]), dev)
    fixed = {}
    for label, b in (("random", int.from_bytes(rng.bytes(32), "little") % p),
                     ("0", 0), ("1", 1), ("p-1", p - 1),
                     ("2^255 mod p", (1 << 255) % p)):
        want = cuda_field.mont_mul(F.FR, a, F.limbs(F.int_to_limbs(b), dev))
        fixed[label] = torch.equal(MX.FixedMul(F.FR, b)(a), want)
    if not all(fixed.values()):
        raise AssertionError(f"mxu: FixedMul differs from K1: {fixed}")
    vectors = a.reshape(-1, 256, F.LIMBS)
    dom = ntt.domain(F.FR, 8)
    got = MX.ntt256(F.FR, vectors)
    k2 = torch.equal(got, ntt.ntt_many(dom, vectors.reshape(-1, F.LIMBS),
                                       vectors.shape[0]).reshape(vectors.shape))
    k2 = k2 and torch.equal(got[0], ntt.ntt(dom, vectors[0]))
    if not k2:
        raise AssertionError("mxu: ntt256 differs from K2's ntt at k = 8")
    kernels = _mxu_paths_without_torch_carry(dev, a, rng)
    # the probe's path, counted
    reset_counts()
    rows = probe.run(str(dev), log2n, 3)
    torch.cuda.synchronize()
    counts = read_counts()
    require_launched("mxu", counts, ("K5", *K5_ENTRIES))
    emit({"phase": "mxu", "k5": rec, "fixed_mul_equals_k1": fixed,
          "ntt256_equals_k2": k2, "path_kernels": kernels, "probe": rows,
          "launches": counts})
    return rec, counts


def phase_gwc_packed(pk, values) -> None:
    """GWC multiopen and packed lookup keys on the flagship pk."""
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import verifier as VF

    rec = {}
    for label, opts in (("gwc", {"multiopen": "gwc"}),
                        ("packed", {"lookup_sort": "packed"})):
        reset_counts()
        t0 = time.perf_counter()
        proof = PV.prove(pk, values, **opts)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        counts = read_counts()
        require_launched(label, counts, PATH_KERNELS)
        multiopen = opts.get("multiopen", "shplonk")
        t0 = time.perf_counter()
        VF.verify(pk.vk, proof, multiopen=multiopen)
        verify_s = time.perf_counter() - t0
        if not rejects_flipped_byte(
                lambda p: VF.verify(pk.vk, p, multiopen=multiopen), proof):
            raise AssertionError(f"{label}: a proof with a flipped byte verified")
        rec[label] = {"prove_s": prove_s, "verify_s": verify_s,
                      "proof_bytes": len(proof), "verified": True,
                      "flipped_byte_rejected": True, "launches": counts}
    emit({"phase": "gwc_packed", **rec})


def phase_mesh(pk, values, dev) -> dict:
    """The multi-device prover: (a) world size 1 over NCCL in this
    process at the flagship; (b) two rank processes on cuda:0 over gloo.
    Returns the launch counts of (a)'s last warm mesh prove."""
    import shutil
    import statistics

    import numpy as np
    import torch

    from halo2_aes_tpu_torch import ctr
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import resume as RES
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.parallel import comm
    from halo2_aes_tpu_torch.parallel import dryrun as DR

    with open(os.path.join(DR.TESTDATA, "golden_k6.json")) as f:
        golden_toy = json.load(f)["toy"]["proof"]
    root = os.path.join(REPO, "build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    seed = 7
    mesh = comm.init_mesh("nccl", 0, 1, f"file://{root}/store", dev, timeout=300)
    try:
        plain = PV.prove(pk, values, seed=seed)
        reset_counts()
        comm.reset_counts()
        proof = PV.prove(pk, values, seed=seed, mesh=mesh)
        torch.cuda.synchronize()
        first = {"launches": read_counts(), "calls": dict(comm.CALLS),
                 "bytes": dict(comm.BYTES)}
        require_launched("mesh", first["launches"], PATH_KERNELS)
        if proof != plain:
            raise AssertionError("mesh: the world-size-1 proof differs from the "
                                 "one-device proof")
        VF.verify(pk.vk, proof)
        if not rejects_flipped_byte(lambda p: VF.verify(pk.vk, p), proof):
            raise AssertionError("mesh: a proof with a flipped byte verified")
        times = {"plain": [], "mesh": []}
        for _ in range(3):
            for label, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
                reset_counts()
                comm.reset_counts()
                t0 = time.perf_counter()
                PV.prove(pk, values, seed=seed, **kw)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
        counts = read_counts()            # the last warm mesh prove's
        require_launched("mesh", counts, PATH_KERNELS)
        warm = {"calls": dict(comm.CALLS), "bytes": dict(comm.BYTES)}
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        seedless = PV.prove(pk, values, mesh=mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        VF.verify(pk.vk, seedless)
        if seedless == plain:
            raise AssertionError("mesh: a seed=None proof equals the seeded one")
        cfg = dict(FLAGSHIP, expose_ciphertext=True)
        ctr_pk = KG.keygen(compile_circuit(AesConfig(**cfg)), pk.srs)
        key = np.frombuffer(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"),
                            np.uint8)
        bundle = ctr.prove_keystream(ctr_pk, key, bytes(range(12)),
                                     2 * cfg["n_blocks"], mesh=mesh)
        ctr.verify_bundle(ctr_pk.vk, bundle)
        del ctr_pk, bundle
    finally:
        comm.destroy_mesh(mesh)
    free()
    world1 = {
        "backend": "nccl", "world_size": 1, **FLAGSHIP,
        "identical_to_one_device": True, "verified": True,
        "flipped_byte_rejected": True, "seedless_verified": True,
        "ctr_bundle_verified": True, "ctr_blocks": 2 * FLAGSHIP["n_blocks"],
        "plain_prove_s": times["plain"], "mesh_prove_s": times["mesh"],
        "plain_prove_median_s": statistics.median(times["plain"]),
        "mesh_prove_median_s": statistics.median(times["mesh"]),
        "first_mesh_prove": first, "collectives_per_warm_prove": warm,
        "seedless_peak_mem_bytes": peak, "launches": counts}
    # the golden proves' two ranks, the checkpoint run's two and the dry
    # run's two run side by side
    t0 = time.perf_counter()
    rank_args = ["halo2_aes_tpu_torch.parallel.dryrun", "--backend", "gloo",
                 "--device", "cuda:0"]
    ranks = comm.RankProcesses(
        [*rank_args, "--task", "prove,mini", "--proofs", "toy,tagged,instance"],
        2, os.path.join(root, "ranks"))
    ck_ranks = comm.RankProcesses(
        [*rank_args, "--task", "checkpoint", "--checkpoint-dir",
         os.path.join(root, "shared")], 2, os.path.join(root, "ckpt"))
    try:
        dry = DR.dryrun_multichip(2, backend="gloo", device="cuda:0", timeout=600)
        dryrun_s = time.perf_counter() - t0
        res = DR.rank_results(ranks.wait(600))
        proves_s = time.perf_counter() - t0
        ck = DR.rank_results(ck_ranks.wait(600))
        ck_s = time.perf_counter() - t0
    finally:
        ranks.kill()
        ck_ranks.kill()
    for r in res + dry + ck:
        require_launched(f"mesh rank {r['rank']}", r["launches"], ("K2", "K3"))
    resumed = {phase: [r["results"]["checkpoint"][phase] for r in ck]
               for phase in RES.PHASES}
    for phase, runs in resumed.items():
        if [run["proof"] for run in runs] != [golden_toy] * 2:
            raise AssertionError(f"mesh: the proof resumed after {phase} on two "
                                 "ranks differs from golden")
        if any(run["recomputed"] or run["files_left"] for run in runs):
            raise AssertionError(f"mesh: resumed after {phase}, a saved phase "
                                 "was recomputed or the store was not cleared")
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "mesh", "world1_nccl": world1, "world2_gloo_cuda0": {
        "golden_identical": ["toy", "tagged", "instance", "mini"],
        "proves_wall_s": proves_s, "launches": [r["launches"] for r in res],
        "collectives": [r["collectives"] for r in res],
        "dryrun_wall_s": dryrun_s,
        "dryrun_mock_counts_corrupted": [r["results"]["dryrun"][
            "mock_counts_corrupted"] for r in dry],
        "dryrun_launches": [r["launches"] for r in dry],
        "checkpoint_resumed_golden_after": list(RES.PHASES),
        "checkpoint_wall_s": ck_s,
        "checkpoint_launches": [r["launches"] for r in ck],
        "checkpoint_collectives": [r["collectives"] for r in ck]}})
    return counts


def phase_ctr(srs, dev) -> None:
    """Two chunks of AES-CTR keystream at the flagship width, exposed."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch import ctr
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend.verifier import VerifyError
    from halo2_aes_tpu_torch.models.aes128 import (AesConfig, capacities,
                                                    compile_circuit, configure)
    from halo2_aes_tpu_torch.ops import aes

    cfg = dict(FLAGSHIP, expose_ciphertext=True)
    probe = AesConfig(**dict(cfg, n_blocks=1))
    bpp = sum(capacities(probe, configure(probe)[0]))
    if bpp != cfg["n_blocks"]:
        raise AssertionError(f"ctr: capacity {bpp} != {cfg['n_blocks']}")
    layout = compile_circuit(AesConfig(**cfg))
    reset_counts()
    t0 = time.perf_counter()
    pk = KG.keygen(layout, srs)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key = np.frombuffer(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), np.uint8)
    nonce = bytes(range(12))
    chunk_s, last = [], [time.perf_counter()]

    def progress(i, total):
        torch.cuda.synchronize()
        now = time.perf_counter()
        chunk_s.append(now - last[0])
        last[0] = now

    bundle = ctr.prove_keystream(pk, key, nonce, 2 * bpp, progress=progress)
    counts = read_counts()
    require_launched("ctr", counts, PATH_KERNELS)
    want = aes.encrypt(torch.as_tensor(ctr.counter_blocks(nonce, 0, 2 * bpp), device=dev),
                       torch.as_tensor(key.copy(), device=dev)).cpu().numpy()
    if len(bundle.proofs) != 2 or not np.array_equal(bundle.keystream, want):
        raise AssertionError("ctr: keystream differs from AES of the counters")
    t0 = time.perf_counter()
    ctr.verify_bundle(pk.vk, bundle)
    verify_s = time.perf_counter() - t0
    bundle.keystream[5, 3] ^= 1
    try:
        ctr.verify_bundle(pk.vk, bundle)
    except VerifyError:
        pass
    else:
        raise AssertionError("ctr: a bundle with a changed keystream byte verified")
    emit({"phase": "ctr", "blocks": 2 * bpp, "blocks_per_proof": bpp,
          "keygen_s": keygen_s, "chunk_s": chunk_s,
          "proof_bytes": [len(p) for p in bundle.proofs],
          "bundle_verify_s": verify_s, "verified": True,
          "tampered_keystream_rejected": True, "launches": counts})


def phase_decrypt(srs, dev) -> None:
    """Full-capacity decryption at k=17, 4 sets, plaintext exposed."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128_dec import (AesDecConfig, capacities,
                                                        compile_circuit, configure)
    from halo2_aes_tpu_torch.ops import aes

    probe = AesDecConfig(k=FLAGSHIP["k"], n_sets=FLAGSHIP["n_sets"], n_blocks=1)
    blocks = sum(capacities(probe, configure(probe)[0]))
    cfg = AesDecConfig(k=FLAGSHIP["k"], n_sets=FLAGSHIP["n_sets"],
                       n_blocks=blocks, expose_plaintext=True)
    layout = compile_circuit(cfg)
    reset_counts()
    t0 = time.perf_counter()
    pk = KG.keygen(layout, srs)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    cts = aes.encrypt(torch.as_tensor(pts, device=dev), key)
    pool = witness.build_dec_pool(key, cts)
    values = witness.assemble_values(layout, pool)
    ks_len = layout.meta["ks_pool_len"]
    recovered = pool[ks_len:].reshape(blocks, -1)[:, -16:].cpu().numpy()
    inst = layout.instance_ids()[0]
    exposed = values[inst, :16 * blocks].cpu().numpy()
    if not (np.array_equal(recovered, pts) and np.array_equal(exposed, pts.reshape(-1))):
        raise AssertionError("decrypt: the witness does not recover the plaintexts")
    t0 = time.perf_counter()
    proof = PV.prove(pk, values)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    counts = read_counts()
    require_launched("decrypt", counts, PATH_KERNELS)
    instances = [[int(v) for v in pts.reshape(-1)]]
    t0 = time.perf_counter()
    VF.verify(pk.vk, proof, instances=instances)
    verify_s = time.perf_counter() - t0
    if not rejects_flipped_byte(
            lambda p: VF.verify(pk.vk, p, instances=instances), proof):
        raise AssertionError("decrypt: a proof with a flipped byte verified")
    emit({"phase": "decrypt", "k": cfg.k, "n_sets": cfg.n_sets, "blocks": blocks,
          "keygen_s": keygen_s, "prove_s": prove_s, "verify_s": verify_s,
          "proof_bytes": len(proof), "verified": True,
          "flipped_byte_rejected": True, "launches": counts})


def large_forced(pk, values) -> dict:
    """The flagship proved with the large path forced (switch lowered to
    its k, static sub-coset evaluations recomputed by evals_sliced)
    equals the ordinary proof of the same seed, byte for byte; so do the
    flagship proved with the k=22 commitments forced (no MSM window
    tables) and the flagship proved with the k=23 switch forced (the
    pk's and the prove's coefficient stacks parked in pinned host
    memory), the permuted lookup pairs built one lookup at a time (the
    pair sort's limit lowered to 0: the form k >= 22 takes) and the
    NTT's row cap lowered to 6 (every transform three or four K2
    passes), also when that prove is crashed after its last checkpoint
    and resumed."""
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import resume as RES
    from halo2_aes_tpu_torch.backend import rest
    from halo2_aes_tpu_torch.ops import msm as MSM
    from halo2_aes_tpu_torch.ops import ntt as N

    ordinary = PV.prove(pk, values, seed=5)
    saved = PV._LARGE_MIN_K
    PV._LARGE_MIN_K = pk.vk.k
    try:
        t0 = time.perf_counter()
        sliced = PV.prove(pk, values, seed=5)
        torch.cuda.synchronize()
        sliced_s = time.perf_counter() - t0
    finally:
        PV._LARGE_MIN_K = saved
    if sliced != ordinary:
        raise AssertionError("large: the forced sliced k=17 proof differs")
    # and the k=22 commitments: no window tables (MSM.TABLELESS_MIN_N
    # lowered to the SRS's size, its tables set aside for the prove)
    srs, saved_n = pk.srs, MSM.TABLELESS_MIN_N
    tables = srs._msm_tables
    MSM.TABLELESS_MIN_N = srs.n
    object.__setattr__(srs, "_msm_tables", None)
    try:
        reset_counts()
        t0 = time.perf_counter()
        tableless = PV.prove(pk, values, seed=5)
        torch.cuda.synchronize()
        tableless_s = time.perf_counter() - t0
        tableless_counts = read_counts()
        if srs._msm_tables is not None:
            raise AssertionError("large: the SRS built tables below the switch")
    finally:
        MSM.TABLELESS_MIN_N = saved_n
        object.__setattr__(srs, "_msm_tables", tables)
    if tableless != ordinary:
        raise AssertionError("large: the k=17 proof without window tables differs")
    require_launched("large_forced tableless", tableless_counts, TABLELESS_KERNELS)
    # and the k=23 switch with streamed pairs and three-pass transforms
    # (the pk re-made so that its own stacks rest in host memory too); then
    # a checkpointed prove of the same, crashed after its last phase was
    # saved from the parked stacks, resumed from every saved phase
    saved = (PV._LARGE_MIN_K, rest.HOST_REST_MIN_K, N.ROW_CAP,
             PV.PAIR_SORT_MAX_BYTES)
    PV._LARGE_MIN_K = rest.HOST_REST_MIN_K = pk.vk.k
    N.ROW_CAP = 6
    PV.PAIR_SORT_MAX_BYTES = 0
    rest.reset()
    try:
        pk_rested = dataclasses.replace(pk)
        if pk_rested.sigma_coeffs.device.type != "cpu":
            raise AssertionError("large: the forced host-rest pk kept its stacks "
                                 "on the card")
        ph = PV._get_phases(pk_rested)
        if not PV.streamed_pairs(ph.n, ph.n_lk):
            raise AssertionError("large: the forced prove sorts its pairs batched")
        t0 = time.perf_counter()
        rested = PV.prove(pk_rested, values, seed=5)
        torch.cuda.synchronize()
        rested_s = time.perf_counter() - t0
        checkpointed, resumed = crash_and_resume(
            pk_rested, values, 5, os.path.join(REPO, "build", "smoke_checkpoints_k17"),
            RES.PHASES[-1])
    finally:
        (PV._LARGE_MIN_K, rest.HOST_REST_MIN_K, N.ROW_CAP,
         PV.PAIR_SORT_MAX_BYTES) = saved
    del pk_rested, ph
    if rested != ordinary:
        raise AssertionError("large: the k=17 proof with its stacks in host "
                             "memory, streamed pairs and three-pass transforms "
                             "differs")
    if resumed != ordinary:
        raise AssertionError("large: the k=17 proof resumed from checkpoints of "
                             "parked stacks differs")
    if not rest.PINNED["peak_bytes"]:
        raise AssertionError("large: the forced host-rest prove parked nothing")
    return {"k": pk.vk.k, "identical": True, "sliced_prove_s": sliced_s,
            "tableless_identical": True, "tableless_prove_s": tableless_s,
            "tableless_launches": {k: tableless_counts[k] for k in TABLELESS_KERNELS},
            "host_rest_streamed_pairs_row_cap6_identical": True,
            "host_rest_row_cap6_prove_s": rested_s,
            "host_rest_pinned_peak_bytes": rest.PINNED["peak_bytes"],
            "host_rest_checkpoints_before_resume": checkpointed,
            "host_rest_resumed_identical": True}


def crash_and_resume(pk, values, seed: int, root: str, crash_after: str):
    """A checkpointed prove crashed right after ``crash_after``'s
    checkpoint, then the same prove again: (the phases saved before the
    crash, the resumed proof).  The directory is removed afterwards."""
    import shutil

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import resume as RES

    shutil.rmtree(root, ignore_errors=True)
    save = RES.ProveCheckpoint.save

    def crashing_save(self, phase, arrays, points, rng=None):
        save(self, phase, arrays, points, rng)
        if phase == crash_after:
            raise RuntimeError(f"crash after {crash_after}")

    RES.ProveCheckpoint.save = crashing_save
    try:
        PV.prove(pk, values, seed=seed, checkpoint_dir=root)
    except RuntimeError as e:
        if f"crash after {crash_after}" not in str(e):
            raise
    else:
        raise AssertionError("large: the injected crash did not happen")
    finally:
        RES.ProveCheckpoint.save = save
    saved = sorted(os.listdir(os.path.join(root, os.listdir(root)[0])))
    resumed = PV.prove(pk, values, seed=seed, checkpoint_dir=root)
    shutil.rmtree(root)
    return saved, resumed


def large_prove(dev, cfg: dict, cache: str | None) -> dict:
    """AES-128 at ``cfg`` on the large path: setup, keygen (cached in
    ``cache``, or nothing cached where it is None), witness, one SHPLONK
    prove (field-ordered lookups), verify, a flipped byte rejected.
    Each step's seconds and peak; the peak over setup, keygen and the
    prove; what the prove found held; the launches from setup through
    the prove, and the prove's K2 launches per transform by size; the
    most pinned host bytes parked stacks held (the pk's and the
    prove's) and the host's memory."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import poly as P
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import rest
    from halo2_aes_tpu_torch.ops import cuda_ntt
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N

    t, peaks = {}, {}

    def timed(name, fn, *a, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        t[f"{name}_s"] = time.perf_counter() - t0
        peaks[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        return out

    reset_counts()
    layout = timed("compile", compile_circuit, AesConfig(**cfg))
    srs = timed("setup", SRS.setup, cfg["k"], dev, cache_dir=cache)
    if cache is None:
        pk = timed("keygen", KG.keygen, layout, srs)
    else:
        pk = timed("keygen", KG.keygen_cached, layout, srs, cache_dir=cache)
    ph = PV._get_phases(pk)
    if not ph.large():
        raise AssertionError(f"large: k={cfg['k']} does not take the large path")
    # a powers table built on the card (K1) against the host loop
    shift = P.GEN * pow(N.domain(F.FR, ph.ext_k).omega, 1, F.FR.modulus) % F.FR.modulus
    if not np.array_equal(
            F.to_numpy(PV._subcoset_tables(ph.k, ph.ext_k, 1, dev)[0]),
            F.FR.host_powers(shift, ph.n)):
        raise AssertionError("large: a powers table built on the card differs")
    rng = np.random.default_rng(3)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (cfg["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = timed("witness", lambda: witness.assemble_values(
        layout, witness.build_pool(key, pts)))
    held = torch.cuda.memory_allocated(dev)     # keys, tables, witness
    transforms = {}                             # k -> [calls, K2 launches]
    composed = N._ntt_flat_composed

    def counted(dom, *a, **kw):
        before = cuda_ntt.LAUNCHES
        try:
            return composed(dom, *a, **kw)
        finally:
            rec = transforms.setdefault(dom.k, [0, 0])
            rec[0] += 1
            rec[1] += cuda_ntt.LAUNCHES - before

    rest.reset()
    N._ntt_flat_composed = counted
    try:
        proof = timed("prove", PV.prove, pk, values)
    finally:
        N._ntt_flat_composed = composed
    counts = read_counts()
    timed("verify", VF.verify, pk.vk, proof)
    if not rejects_flipped_byte(lambda p: VF.verify(pk.vk, p), proof):
        raise AssertionError(f"large: a k={cfg['k']} proof with a flipped "
                             "byte verified")
    kernels = PATH_KERNELS if srs._msm_tables is not None else TABLELESS_KERNELS
    require_launched("large", counts, kernels)
    peak = max(peaks[f"{name}_peak_bytes"] for name in ("setup", "keygen", "prove"))
    with open("/proc/meminfo") as f:
        meminfo = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f}
    return {**cfg, **t, **peaks, "blocks_per_s": cfg["n_blocks"] / t["prove_s"],
            "host_rest": ph.host_rest(),
            "pinned_peak_bytes": rest.PINNED["peak_bytes"],
            "host_memory_bytes": {"total": meminfo["MemTotal"],
                                  "available_after": meminfo["MemAvailable"]},
            "k2_launches_per_transform": {
                str(k): [calls, launches / calls]
                for k, (calls, launches) in sorted(transforms.items())},
            "card_table_equals_host": True,
            "proof_bytes": len(proof), "verified": True,
            "flipped_byte_rejected": True, "peak_mem_bytes": peaks["prove_peak_bytes"],
            "setup_keygen_prove_peak_bytes": peak,
            "held_before_prove_bytes": held,
            "window_tables": srs._msm_tables is not None,
            "launches": {k: counts[k] for k in kernels}}


def large_k20(dev) -> dict:
    """The reference prover binary's shape (keys cached in ptau/)."""
    return large_prove(dev, LARGE, os.path.join(REPO, "ptau"))


def large_k23(dev) -> dict:
    """The same circuit at k=23, full capacity (24,671 blocks), nothing
    cached on disk: the pk's and the prove's coefficient stacks rest in
    pinned host memory, every transform is two K2 passes (rows of 2^12
    and 2^11), and the commitments run without window tables; the peak
    over setup, keygen and the prove must stay within LARGE23_MEM_SHARE
    of the card's memory."""
    import torch

    rec = large_prove(dev, LARGE23, None)
    total = torch.cuda.get_device_properties(dev).total_memory
    rec["card_total_memory_bytes"] = total
    rec["peak_share_of_card"] = rec["setup_keygen_prove_peak_bytes"] / total
    if rec["peak_share_of_card"] > LARGE23_MEM_SHARE:
        raise AssertionError(
            f"large: the k=23 peak is {rec['peak_share_of_card']:.1%} of the "
            f"card's memory, above {LARGE23_MEM_SHARE:.0%}")
    if rec["window_tables"]:
        raise AssertionError("large: the k=23 SRS built window tables")
    if not rec["host_rest"] or not rec["pinned_peak_bytes"]:
        raise AssertionError("large: the k=23 prove parked no stack in host memory")
    if rec["k2_launches_per_transform"].get("23", [0, 0])[1] != 2:
        raise AssertionError("large: a 2^23 transform was not two K2 launches: "
                             f"{rec['k2_launches_per_transform']}")
    return rec


def large_resume(dev) -> dict:
    """A K=6 toy prove crashed right after its products checkpoint
    resumes from the saved phases to the golden bytes."""
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.circuit.toys import K, TOYS

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_k6.json")) as f:
        golden = json.load(f)["toy"]["proof"]
    build, seed, _ = TOYS["toy"]
    layout, values = build()
    pk = KG.keygen(layout, SRS.setup(K, dev, cache_dir=None))
    saved, resumed = crash_and_resume(
        pk, values, seed, os.path.join(REPO, "build", "smoke_checkpoints"),
        "products")
    if resumed.hex() != golden:
        raise AssertionError("large: the resumed K=6 proof differs from golden")
    return {"checkpoints_before_resume": saved, "resumed_equals_golden": True}


def corrupted_counts(layout, values) -> dict:
    """``violation_counts`` of three single-cell corruptions of a
    satisfying AES values matrix: the rcon cell of the key schedule (a
    gate), the output of the first AddRoundKey xor of block 0 (a lookup
    input, and the copy that reads it), and plaintext byte 0 of block 0
    (the source of a copy)."""
    from halo2_aes_tpu_torch.circuit import mock

    cols = layout.meta["columns"]
    base = int(layout.meta["block_starts"][0])
    adv = cols.chip_sets[0].advice
    cells = {"gate": (cols.words, 20, 0xFF), "lookup": (adv[2], base + 16, 1),
             "copy": (adv[0], base, 1)}
    out = {}
    for name, (col, row, flip) in cells.items():
        bad = values.clone()
        bad[col, row] ^= flip
        out[name] = {k: int(v) for k, v in mock.violation_counts(layout, bad).items()}
    if not (out["gate"]["gates"] > 0 and out["lookup"]["lookups"] > 0
            and out["lookup"]["copies"] > 0 and out["copy"]["copies"] > 0):
        raise AssertionError(f"mock: a corrupted cell was not counted: {out}")
    return out


def phase_mock(dev) -> None:
    """The vectorized MockProver on the card (no kernel of csrc/ is on
    this path: gates, lookups and copies are PyTorch integer ops)."""
    import torch

    from halo2_aes_tpu_torch.circuit import mock, witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    bench = _script("torch_bench_mock")
    rec = {}
    for label, cfg in (("flagship", FLAGSHIP),
                       ("bench", dict(k=17, n_sets=2, n_blocks=192, tagged_ops=False))):
        layout = compile_circuit(AesConfig(**cfg))
        run = bench.run(dev, layout, reps=3)
        key = torch.zeros(16, dtype=torch.uint8, device=dev)
        pts = (torch.arange(cfg["n_blocks"] * 16, device=dev) % 256).to(
            torch.uint8).reshape(-1, 16)
        values = witness.assemble_values(layout, witness.build_pool(key, pts))
        if values.device.type != "cuda":
            raise AssertionError("mock: the values matrix is not on the card")
        mock.assert_satisfied(layout, values)
        rec[label] = {**cfg, "blocks_per_s": run["value"], "step_s": run["step_s"],
                      "first_step_s": run["first_step_s"],
                      "held_before_bytes": run["held_before_bytes"],
                      "peak_mem_bytes": run["peak_mem_bytes"], "satisfied": True,
                      "corrupted": corrupted_counts(layout, values)}
        del layout, values
    # the reference's own MockProver configuration
    cfg = dict(k=20, n_sets=3, n_blocks=1000)
    free()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)     # earlier phases' cached tables
    t0 = time.perf_counter()
    layout = compile_circuit(AesConfig(**cfg))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = witness.assemble_values(layout, witness.build_pool(
        torch.zeros(16, dtype=torch.uint8, device=dev),
        torch.zeros((cfg["n_blocks"], 16), dtype=torch.uint8, device=dev)))
    counts = {k: int(v) for k, v in mock.violation_counts(layout, values).items()}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = mock.check(layout, values)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    if any(counts.values()) or not report.ok:
        raise AssertionError(f"mock: k=20 not satisfied: {counts} {report.message()}")
    rec["mockprover_k20"] = {**cfg, "compile_s": compile_s,
                             "witness_and_counts_s": first_s, "check_s": check_s,
                             "satisfied": True, "held_before_bytes": held,
                             "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    emit({"phase": "mock", **rec})


def phase_ipa(dev) -> dict:
    """The IPA proving system at the flagship shape; returns launch counts."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import ipa as IPA
    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.utils import cost_model

    cfg = FLAGSHIP
    cache = os.path.join(REPO, "ptau")
    t = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    layout = compile_circuit(AesConfig(**cfg))
    srs = timed("setup_s", IPA.setup, cfg["k"], dev, cache_dir=cache)
    again = timed("setup_cached_s", IPA.setup, cfg["k"], dev, cache_dir=cache)
    if not (torch.equal(again.g1_x, srs.g1_x) and again.u_pt == srs.u_pt
            and again.identity_tag() == srs.identity_tag()):
        raise AssertionError("ipa: the cached basis differs from the built one")
    del again
    pk = timed("keygen_s", KG.keygen_cached, layout, srs, cache_dir=cache)
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (cfg["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    timed("warmup_prove_s", PV.prove, pk, values, multiopen="ipa")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    proof = timed("prove_s", PV.prove, pk, values, multiopen="ipa")
    peak = torch.cuda.max_memory_allocated(dev)
    counts = read_counts()
    timed("verify_s", IPA.verify, pk.vk, proof, srs=srs)
    for label, pos in (("last", -1), ("early", 5)):
        bad = bytearray(proof)
        bad[pos] ^= 1
        try:
            IPA.verify(pk.vk, bytes(bad), srs=srs)
        except ValueError:            # VerifyError or a malformed transcript
            continue
        raise AssertionError(f"ipa: a proof with a flipped {label} byte verified")
    try:
        VF.verify(pk.vk, proof)
    except ValueError:
        pass
    else:
        raise AssertionError("ipa: the KZG verifier accepted an IPA proof")
    want = cost_model.estimate(layout, multiopen="ipa").proof_bytes
    if len(proof) != want:
        raise AssertionError(f"ipa: proof is {len(proof)} bytes, the cost model "
                             f"says {want}")
    require_launched("ipa", counts, PATH_KERNELS)
    emit({"phase": "ipa", **cfg, **t, "blocks_per_s": cfg["n_blocks"] / t["prove_s"],
          "proof_bytes": len(proof), "cost_model_proof_bytes": want,
          "verified": True, "flipped_bytes_rejected": True,
          "kzg_verifier_rejects": True, "peak_mem_bytes": peak,
          "launches": counts})
    return counts


def phase_mini(dev) -> None:
    """Mini-AES at k=11, 2 sets, 2 blocks: mock, prove, verify, golden."""
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import mock, witness
    from halo2_aes_tpu_torch.circuit.toys import (MINI_CONFIG, MINI_PROVE_SEED,
                                                  mini_inputs)
    from halo2_aes_tpu_torch.models import aes_mini as MINI

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_mini_k11.json")) as f:
        golden = json.load(f)["mini"]
    layout = MINI.compile_mini_circuit(MINI.MiniAesConfig(**MINI_CONFIG))
    key, pts = (torch.as_tensor(a, device=dev) for a in mini_inputs())
    pool = MINI.build_pool_mini(key, pts)
    values = witness.assemble_values(layout, pool)
    mock.assert_satisfied(layout, values)
    bad = pool.clone()
    bad[400] ^= 1
    counts = mock.violation_counts(layout, witness.assemble_values(layout, bad))
    if sum(int(v) for v in counts.values()) == 0:
        raise AssertionError("mini: a corrupted nibble was not counted")
    pk = KG.keygen(layout, SRS.setup(MINI_CONFIG["k"], dev, cache_dir=None))
    if hex(pk.vk.digest) != golden["vk_digest"]:
        raise AssertionError("mini: vk digest differs from the golden one")
    t0 = time.perf_counter()
    proof = PV.prove(pk, values, seed=MINI_PROVE_SEED)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    if proof.hex() != golden["proof"]:
        raise AssertionError("mini: proof bytes differ from the golden proof")
    VF.verify(pk.vk, proof)
    if not rejects_flipped_byte(lambda p: VF.verify(pk.vk, p), proof):
        raise AssertionError("mini: a proof with a flipped byte verified")
    emit({"phase": "mini", **MINI_CONFIG, "mock_satisfied": True,
          "corrupted_nibble_counted": True, "prove_s": prove_s,
          "proof_bytes": len(proof), "identical": True, "verified": True,
          "flipped_byte_rejected": True})


def phase_srs_format(dev) -> None:
    """The flagship's dev SRS through halo2's ParamsKZG file format."""
    import hashlib
    import shutil

    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import srs_format as SF
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops import field as F

    cfg = FLAGSHIP
    k = cfg["k"]
    seed = b"halo2_aes_tpu dev srs"           # SRS.setup's default seed
    tau = int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(),
                         "little") % F.FR.modulus
    srs = SRS.setup(k, dev, cache_dir=None)
    root = os.path.join(REPO, "build", "smoke_srs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, f"kzg_bn254_{k}.srs")
    t0 = time.perf_counter()
    SF.write_srs(path, srs, tau=tau)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    if size != 4 + 2 * (1 << k) * 64 + 256:
        raise AssertionError(f"srs_format: the file is {size} bytes")
    t0 = time.perf_counter()
    back = SF.read_srs(path, dev)
    read_s = time.perf_counter() - t0
    shutil.rmtree(root)
    if not (back.k == k and torch.equal(back.g1_x, srs.g1_x)
            and torch.equal(back.g1_y, srs.g1_y)
            and (back.g2, back.s_g2) == (srs.g2, srs.s_g2)
            and back.identity_tag() == srs.identity_tag()):
        raise AssertionError("srs_format: the re-read SRS differs")
    del srs
    layout = compile_circuit(AesConfig(**cfg))
    pk = KG.keygen(layout, back)
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (cfg["n_blocks"], 16),
                                       dtype=np.uint8), device=dev)
    values = witness.assemble_values(layout, witness.build_pool(key, pts))
    proof = PV.prove(pk, values)
    VF.verify(pk.vk, proof)
    if not rejects_flipped_byte(lambda p: VF.verify(pk.vk, p), proof):
        raise AssertionError("srs_format: a proof with a flipped byte verified")
    emit({"phase": "srs_format", "k": k, "file_bytes": size, "write_s": write_s,
          "read_s": read_s, "same_points": True, "same_identity_tag": True,
          "proof_bytes": len(proof), "verified_with_reread_srs": True})


def phase_native(vk, proof: bytes) -> None:
    """Every verify so far took the native route; the flagship proof once
    more through each route, with the same verdicts."""
    from halo2_aes_tpu_torch import native
    from halo2_aes_tpu_torch.backend import verifier as VF

    calls = dict(native.CALLS)
    if native.route() != "native" or calls["native"] == 0 or calls["python"]:
        raise AssertionError(f"native: the verifies did not all take the native "
                             f"route: {native.route()} {calls}")
    rec = {"calls_before": calls}
    for route in ("native", "python"):
        native.set_route(route)
        try:
            before = native.CALLS[route]
            t0 = time.perf_counter()
            VF.verify(vk, proof)
            rec[f"verify_{route}_s"] = time.perf_counter() - t0
            if not rejects_flipped_byte(lambda p: VF.verify(vk, p), proof):
                raise AssertionError(f"native: the {route} route accepted a "
                                     "flipped byte")
            if native.CALLS[route] == before:
                raise AssertionError(f"native: the {route} route was not taken")
        finally:
            native.set_route(None)
    emit({"phase": "native", **rec, "routes_agree": True})


def kernels_record(rec: dict, counts: dict, ipa_counts: dict,
                   mesh_counts: dict) -> dict:
    """One row per kernel and entry: the launches of the flagship path's
    run (``ipa_launches``: of the IPA path's; ``mesh_launches``: of the
    world-size-1 mesh prove's), and this run's error, times
    and bound at the kernels phase's shapes (K5: at the ``mxu`` phase's,
    its launches those of the probe's path).  No PyTorch call computes a
    BN254 Montgomery product, an NTT over Fr or a G1 addition, so
    ``library_ms`` is null for K1-K3 and the probes; K5's is
    ``torch._int_mm`` (cuBLASLt int8) on the same products, without the
    fold; null for K5's normalize entry (no PyTorch call carries limbs),
    whose row sums the ``mxu`` phase's four carry sites."""
    from halo2_aes_tpu_torch.ops import (cuda_curve, cuda_field, cuda_grand, cuda_msm,
                                         cuda_nibble, cuda_ntt, cuda_probe,
                                         cuda_quotient)

    k3 = (cuda_curve.SOURCE, cuda_curve.REPLACES)
    rows = [("K1", "K1", "mont_mul", cuda_field.SOURCE, cuda_field.REPLACES),
            ("K2", "K2", "ntt_fused", cuda_ntt.SOURCE, cuda_ntt.REPLACES),
            ("K3", "K3_add", "curve_add", *k3),
            ("K3_strided", "K3_add", "curve_add_strided", *k3),
            ("K3_fold", "K3_fold", "curve_fold", *k3),
            ("K3_masked", "K3_masked", "curve_add_masked", *k3),
            ("K3_double", "K3_double", "curve_double_n", *k3)]
    rows += [(key, key, name, cuda_probe.SOURCE[name], cuda_probe.REPLACES[name])
             for key, name in PROBE_KERNELS.items()]
    rows.append(("P1_full", "P1", "mul_probe_full", cuda_probe.SOURCE["mul_probe"],
                 cuda_probe.REPLACES["mul_probe"]))
    rows.append(("K4", "K4", "quotient_terms", cuda_quotient.SOURCE,
                 cuda_quotient.REPLACES))
    rows.append(("K6", "K6", "grand_product", cuda_grand.SOURCE,
                 cuda_grand.REPLACES))
    rows.append(("K7", "K7", "msm_buckets", cuda_msm.SOURCE, cuda_msm.REPLACES))
    rows.append(("K5", "K5_product", "nibble_product", cuda_nibble.SOURCE,
                 cuda_nibble.REPLACES))
    rows.append(("K5_normalize", "K5_normalize", "nibble_normalize",
                 cuda_nibble.SOURCE, cuda_nibble.REPLACES))
    out = []
    for key, count_key, name, source, replaces in rows:
        r = rec[key]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": counts[count_key],
                    "ipa_launches": ipa_counts[count_key],
                    "mesh_launches": mesh_counts[count_key],
                    "max_abs_err": max(r["errors"].values()),
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r.get("library_ms")})
    return {"kernels": out}


def free() -> None:
    """Return the freed phase's cached device memory to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main(only: str = "") -> int:
    sys.path.insert(0, REPO)
    # the k=23 prove's large stacks among transients fragment the caching
    # allocator's fixed segments (backend/rest.py); set before the card is used
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    import halo2_aes_tpu_torch.ops.field  # noqa: F401  (the port must be here)
    from halo2_aes_tpu_torch.ops.timing import card_line

    dev = phase_device()
    phase_build()
    if only:
        # development aid: some of the later phases alone (no ok line)
        for name in only.split(","):
            if name in ("mesh", "large_forced", "quotient_terms", "grand_products",
                        "msm_buckets"):
                _, pk, values, _ = phase_flagship(dev)
                if name == "mesh":
                    phase_mesh(pk, values, dev)
                elif name == "msm_buckets":
                    proofs = msm_buckets_proofs(pk, values, dev, "flagship", FLAGSHIP)
                    del pk, values
                    free()
                    emit({"phase": "msm_buckets", "flagship_proofs": proofs,
                          **msm_buckets_kernels(dev)})
                    continue
                elif name == "quotient_terms":
                    proofs = quotient_terms_proofs(pk, values, dev)
                    del pk, values
                    free()
                    emit({"phase": "quotient_terms", "flagship_proofs": proofs,
                          "kernels": quotient_terms_kernels(dev)})
                    continue
                elif name == "grand_products":
                    proofs = grand_products_proofs(pk, values, dev)
                    del pk, values
                    free()
                    emit({"phase": "grand_products", "flagship_proofs": proofs,
                          "kernels": grand_products_kernels(dev)})
                    continue
                else:
                    emit({"phase": "large_forced",
                          "forced_sliced_k17": large_forced(pk, values)})
                del pk, values
            else:
                {"golden": phase_golden, "mock": phase_mock, "ipa": phase_ipa,
                 "mini": phase_mini, "srs_format": phase_srs_format,
                 "mxu": phase_mxu,
                 "large_k23": lambda d: emit({"phase": "large_k23",
                                              "k23": large_k23(d)})}[name](dev)
            free()
        return 0
    rec = phase_kernels(dev)
    phase_golden(dev)
    counts, pk, values, flagship_proof = phase_flagship(dev)
    flagship_vk = pk.vk
    probe_counts = phase_probes(dev)
    counts.update({key: probe_counts[key] for key in PROBE_KERNELS})
    rec["K5"], mxu_counts = phase_mxu(dev)
    rec["K5_normalize"] = rec["K5"]["normalize_summed"]
    counts.update({key: mxu_counts[key] for key in ("K5", *K5_ENTRIES)})
    free()
    phase_gwc_packed(pk, values)
    q_proofs = quotient_terms_proofs(pk, values, dev)
    g_proofs = grand_products_proofs(pk, values, dev)
    m_proofs = msm_buckets_proofs(pk, values, dev, "flagship", FLAGSHIP)
    free()
    mesh_counts = phase_mesh(pk, values, dev)
    srs = pk.srs
    phase_ctr(srs, dev)
    free()
    phase_decrypt(srs, dev)
    forced = large_forced(pk, values)
    del pk, values, srs
    free()
    emit({"phase": "large", "forced_sliced_k17": forced, "k20": large_k20(dev),
          "resume_k6": large_resume(dev)})
    free()
    emit({"phase": "large_k23", "k23": large_k23(dev)})
    free()
    q_kernels = quotient_terms_kernels(dev)
    emit({"phase": "quotient_terms", "flagship_proofs": q_proofs,
          "kernels": q_kernels})
    k20 = q_kernels["k20"]
    rec["K4"] = {"errors": {"k20": 0, "k23": 0}, "ms": k20["k4_ms"],
                 "plain_ms": k20["reference_ms"], "bound_ms": k20["bound_ms"],
                 "bound_by": k20["bound_by"]}
    g_kernels = grand_products_kernels(dev)
    emit({"phase": "grand_products", "flagship_proofs": g_proofs,
          "kernels": g_kernels})
    rec["K6"] = {"errors": {"k20": 0}, "ms": g_kernels["k6_all_ms"],
                 "plain_ms": g_kernels["plain_perm_ms"]
                 + g_kernels["lookups"] * g_kernels["plain_lookup_ms"],
                 "bound_ms": g_kernels["bound_all_ms"], "bound_by": "bytes"}
    m_kernels = msm_buckets_kernels(dev)
    emit({"phase": "msm_buckets", "flagship_proofs": m_proofs, **m_kernels})
    k7 = m_kernels["times"]
    rec["K7"] = {"errors": {"small_shapes": 0,
                            "k20": sum(k7["plain"]["errors"].values())},
                 "shape": f"{k7['polys']} commitments of 2^{k7['lg']} points",
                 "ms": k7["k7_ms"], "plain_ms": k7["plain"]["plain_ms"],
                 "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"]}
    phase_mock(dev)
    free()
    ipa_counts = phase_ipa(dev)
    free()
    phase_mini(dev)
    phase_srs_format(dev)
    free()
    phase_native(flagship_vk, flagship_proof)
    print(card_line(), flush=True)
    emit(kernels_record(rec, counts, ipa_counts, mesh_counts))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
