#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, each printing one JSON line as it ends:
  0 device      the card (fails without CUDA), its name and power limit
  1 build       nvcc-builds the kernels of csrc/ (K1 mont_mul, K2 ntt
                pass, K3 curve add, P1 mul probe, P2a/P2b Montgomery
                probes on limb-major planes)
  2 kernels     each kernel against its plain PyTorch version, bit-exact,
                on card tensors at its path's shapes, with times (K1-K3
                also at the k=20 prove's shapes)
  3 golden      the K=6 golden proofs (toy, tagged toy, instance toy;
                GWC and packed-lookup proofs of the first two) proved on
                the card equal the JAX reference's committed bytes and
                verify
  4 flagship    AES-128 at k=17, 4 sets, 384 blocks, tagged ops:
                setup, keygen, witness, warm-up prove, timed prove,
                verify, a flipped byte rejected; every kernel launched
  5 probes      the two probe scripts' paths (P1 multiply throughput,
                P2 Montgomery layouts against K1)
  6 gwc_packed  on the flagship pk: one GWC prove and one packed-lookup
                prove, each verified and a flipped byte rejected
  7 ctr         a two-chunk (768-block) AES-CTR bundle at the flagship
                width with the keystream exposed: keystream = AES of the
                counter blocks, one verify_batch accepts the bundle, a
                changed keystream byte is rejected
  8 decrypt     full-capacity decryption at k=17, 4 sets, 384 blocks,
                plaintext exposed: recovered plaintext checked, proof
                verified with the plaintext instances, flipped byte rejected
  9 large       the k >= 19 prove path: the flagship proved once more with
                the sliced path forced (static evaluations recomputed)
                equals the ordinary proof byte for byte; then, with the
                earlier phases' memory freed, the reference prover binary's shape
                (AES-128, k=20, 4 sets, 3,082 blocks, tagged ops): setup
                and keygen (cached in ptau/, 3.2 GB), witness, one
                prove, verify, a flipped byte rejected, peak memory; and
                a K=6 toy prove crashed after its products phase resumes
                from its checkpoints to the golden bytes
Phases 4, 5-8 and the k=20 prove of 9 each set the launch counts to 0
before they drive their path and fail if a kernel of the path never
launched.  Then the card line, the kernels record and, last, the ok
line.  Any failure raises and the exit code is non-zero.
"""

from __future__ import annotations

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

    path, seconds, log = _build.build()
    _build.library()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, REPO),
          "ptxas": regs})


def _random_field(spec, rows: int, rng, device):
    """Uniform-ish canonical limbs: the top limb stays below p's."""
    import numpy as np

    from halo2_aes_tpu_torch.ops import field as F

    limbs = rng.integers(0, 1 << 16, (rows, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), rows)
    return F.limbs(limbs.astype(np.uint32), device)


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

    # K1: 2^20 random pairs per field plus the edges 0, 1, p-1, R mod p
    k1 = {"errors": {}, "ms": 0.0, "plain_ms": 0.0}
    for spec in (F.FR, F.FQ):
        a = _random_field(spec, 1 << 20, rng, dev)
        b = _random_field(spec, 1 << 20, rng, dev)
        edges = F.limbs(F.ints_to_limbs_fast(
            [0, 1, spec.modulus - 1, spec.r_mod_p]), dev)
        a[:4] = edges
        b[:4] = edges.flip(0)
        a[4:8] = edges
        b[4:8] = edges
        out = cuda_field.mont_mul(spec, a, b)
        ref = cuda_field.mont_mul_plain(spec, a, b)
        e = err(out, ref)
        if e:
            raise AssertionError(f"K1 {spec.name}: max abs err {e}")
        k1["errors"][spec.name] = e
        k1["ms"] += _time_ms(lambda: cuda_field.mont_mul(spec, a, b), 100)
        k1["plain_ms"] += _time_ms(lambda: cuda_field.mont_mul_plain(spec, a, b), 3, 3)
    k1["shape"] = "2 x (2^20 pairs)"
    rec["K1"] = k1

    # K2: the passes of k=17 count=4 (T=512 and T=256), forward and
    # inverse, and k=6 (single pass); plus an NTT round trip at k=17
    k2 = {"errors": {}, "ms": 0.0, "plain_ms": 0.0}
    for k, count in ((17, 4), (6, 4)):
        n = 1 << k
        if k <= cuda_ntt.MAX_LT:
            shapes = [(count, k)]
        else:
            k1_ = (k + 1) // 2
            shapes = [(count * (n >> k1_), k1_), (count * (1 << k1_), k - k1_)]
        for inverse in (False, True):
            for rows, lt in shapes:
                x = _random_field(F.FR, rows << lt, rng, dev).reshape(rows, 1 << lt, F.LIMBS)
                tw = F.limbs(N._stage_tables(F.FR, lt, inverse), dev)
                out = cuda_ntt.ntt_pass(F.FR, x, tw)
                ref = cuda_ntt.ntt_pass_plain(F.FR, x, tw)
                e = err(out, ref)
                if e:
                    raise AssertionError(f"K2 k={k} lt={lt} inv={inverse}: err {e}")
                k2["errors"][f"k{k}_lt{lt}_{'inv' if inverse else 'fwd'}"] = e
                if k == 17 and not inverse:
                    k2["ms"] += _time_ms(lambda: cuda_ntt.ntt_pass(F.FR, x, tw), 100)
                    k2["plain_ms"] += _time_ms(
                        lambda: cuda_ntt.ntt_pass_plain(F.FR, x, tw), 2, 3)
    dom = N.domain(F.FR, 17)
    x = _random_field(F.FR, 4 << 17, rng, dev)
    back = N.ntt_many(dom, N.ntt_many(dom, x, 4), 4, inverse=True)
    if not torch.equal(back, x):
        raise AssertionError("K2: ntt_many round trip at k=17 differs")
    k2["shape"] = "k=17 count=4: (1024, 512) + (2048, 256) rows x lanes"
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
                 "plain_ms": _time_ms(lambda: cuda_curve.add_plain(p, q), 2, 3)}

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
    rec["P1"] = p1

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
    for key, kern, plain in (
            ("P2a", cuda_probe.mont_mul_planes16, cuda_probe.mont_mul_planes16_plain),
            ("P2b", cuda_probe.mont_mul_planes13, cuda_probe.mont_mul_planes13_plain)):
        out = kern(F.FR, a, b)
        errors = {"plain": err(out, plain(F.FR, a, b)), "k1_plain": err(out, want)}
        if max(errors.values()):
            raise AssertionError(f"{key}: max abs err {errors}")
        rec[key] = {"errors": errors, "shape": "(16, 2^20) Fr planes",
                    "ms": _time_ms(lambda: kern(F.FR, a, b), 100),
                    "plain_ms": _time_ms(lambda: plain(F.FR, a, b), 2, 3),
                    "k1_ms_same_values": k1_ms}
    top = cuda_probe.mont_mul_planes13_plain(F.FR, a, b, col_max=True)[1]
    if top >= 1 << 32:
        raise AssertionError(f"P2b: a 13-bit column reached {top} >= 2^32")
    rec["P2b"]["column_max"] = top
    for key, k20 in kernels_k20(dev, rng, p, q).items():
        rec[key]["k20"] = k20
    torch.cuda.synchronize()
    emit({"phase": "kernels", **rec})
    return rec


def kernels_k20(dev, rng, p, q, count: int = 45, reps: int = 8) -> dict:
    """K1, K2 and K3 at the shapes of the k=20 prove, each against its
    plain version (bit-exact) and timed (plain: one call after a warm-up):
    K1 on a 45 x 2^20 stack against a broadcast 2^20 row (the coset
    shift of the quotient's dynamic stack), K2 on both passes of a
    45 x 2^20 stack, K3 on 2^19 point pairs (an MSM tree's first level);
    ``p``, ``q`` are the 2^16 K3 pairs, rescaled to fresh
    representatives."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import time_ms as _time_ms

    def check(name, out, ref):
        if not all(torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"{name} at the k=20 shape differs from plain")

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
                     lambda: cuda_field.mont_mul_plain(F.FR, stack, row), 1, 1)}
    del row
    k2 = {"shape": "45 x 2^20: (46080, 1024) rows x lanes, twice",
          "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0}
    x = stack.reshape(count * 1024, 1024, F.LIMBS)
    for inverse in (False, True):
        tw = F.limbs(N._stage_tables(F.FR, 10, inverse), dev)
        check("K2", [cuda_ntt.ntt_pass(F.FR, x, tw)],
              [cuda_ntt.ntt_pass_plain(F.FR, x, tw)])
        k2["ms"] += _time_ms(lambda: cuda_ntt.ntt_pass(F.FR, x, tw), 10)
        k2["plain_ms"] += _time_ms(lambda: cuda_ntt.ntt_pass_plain(F.FR, x, tw), 1, 1)
    out["K2"] = k2                     # a forward and an inverse pass
    del stack, x
    lam = random_fr(reps * p[0].shape[0])           # < r < q: a valid Fq value
    lam[lam.eq(0).all(-1)] = F.const(F.FQ, "one", dev)
    pp = tuple(cuda_field.mont_mul_plain(F.FQ, c.repeat(reps, 1), lam) for c in p)
    qq = tuple(cuda_field.mont_mul_plain(F.FQ, c.repeat(reps, 1), lam.flip(0))
               for c in q)
    check("K3", cuda_curve.add(pp, qq), cuda_curve.add_plain(pp, qq))
    out["K3"] = {"shape": "2^19 point pairs", "max_abs_err": 0,
                 "ms": _time_ms(lambda: cuda_curve.add(pp, qq), 20),
                 "plain_ms": _time_ms(lambda: cuda_curve.add_plain(pp, qq), 1, 1)}
    torch.cuda.empty_cache()
    return out


def phase_golden(dev):
    """Toy proofs on the card == the reference's golden bytes, verified."""
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit.toys import GOLDEN_PROOFS, K, TOYS

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_k6.json")) as f:
        golden = json.load(f)
    srs = SRS.setup(K, dev, cache_dir=None)
    pks = {}
    out = {}
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


PATH_KERNELS = ("K1", "K2", "K3")
PROBE_KERNELS = {"P1": "mul_probe", "P2a": "mont_mul_planes16",
                 "P2b": "mont_mul_planes13"}


def reset_counts():
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt, cuda_probe

    for mod in (cuda_field, cuda_ntt, cuda_curve):
        mod.LAUNCHES = 0
    cuda_probe.reset_counts()


def read_counts() -> dict:
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt, cuda_probe

    out = {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
           "K3": cuda_curve.LAUNCHES}
    out.update({key: cuda_probe.LAUNCHES[name]
                for key, name in PROBE_KERNELS.items()})
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
    return counts, pk, values


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
    equals the ordinary proof of the same seed, byte for byte."""
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV

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
    return {"k": pk.vk.k, "identical": True, "sliced_prove_s": sliced_s}


def large_k20(dev) -> dict:
    """The reference prover binary's shape on the large path: setup, keygen,
    witness, one SHPLONK prove (field-ordered lookups), verify."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import poly as P
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N

    cfg = LARGE
    cache = os.path.join(REPO, "ptau")
    t = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        t[name] = time.perf_counter() - t0
        return out

    reset_counts()
    layout = timed("compile_s", compile_circuit, AesConfig(**cfg))
    srs = timed("setup_s", SRS.setup, cfg["k"], dev, cache_dir=cache)
    pk = timed("keygen_s", KG.keygen_cached, layout, srs, cache_dir=cache)
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
    values = timed("witness_s", lambda: witness.assemble_values(
        layout, witness.build_pool(key, pts)))
    torch.cuda.reset_peak_memory_stats(dev)
    proof = timed("prove_s", PV.prove, pk, values)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = read_counts()
    timed("verify_s", VF.verify, pk.vk, proof)
    if not rejects_flipped_byte(lambda p: VF.verify(pk.vk, p), proof):
        raise AssertionError("large: a k=20 proof with a flipped byte verified")
    require_launched("large", counts, PATH_KERNELS)
    return {**cfg, **t, "blocks_per_s": cfg["n_blocks"] / t["prove_s"],
            "card_table_equals_host": True,
            "proof_bytes": len(proof), "verified": True,
            "flipped_byte_rejected": True, "peak_mem_bytes": peak,
            "launches": {k: counts[k] for k in PATH_KERNELS}}


def large_resume(dev) -> dict:
    """A K=6 toy prove crashed right after its products checkpoint
    resumes from the saved phases to the golden bytes."""
    import shutil

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import resume as RES
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.circuit.toys import K, TOYS

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_k6.json")) as f:
        golden = json.load(f)["toy"]["proof"]
    build, seed, _ = TOYS["toy"]
    layout, values = build()
    pk = KG.keygen(layout, SRS.setup(K, dev, cache_dir=None))
    root = os.path.join(REPO, "build", "smoke_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    save = RES.ProveCheckpoint.save

    def crashing_save(self, phase, arrays, points, rng=None):
        save(self, phase, arrays, points, rng)
        if phase == "products":
            raise RuntimeError("crash after products")

    RES.ProveCheckpoint.save = crashing_save
    try:
        PV.prove(pk, values, seed=seed, checkpoint_dir=root)
    except RuntimeError as e:
        if "crash after products" not in str(e):
            raise
    else:
        raise AssertionError("large: the injected crash did not happen")
    finally:
        RES.ProveCheckpoint.save = save
    saved = sorted(os.listdir(os.path.join(root, os.listdir(root)[0])))
    resumed = PV.prove(pk, values, seed=seed, checkpoint_dir=root)
    shutil.rmtree(root)
    if resumed.hex() != golden:
        raise AssertionError("large: the resumed K=6 proof differs from golden")
    return {"checkpoints_before_resume": saved, "resumed_equals_golden": True}


def kernels_record(rec: dict, counts: dict) -> dict:
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt, cuda_probe

    rows = [("K1", "mont_mul", cuda_field.SOURCE, cuda_field.REPLACES),
            ("K2", "ntt_pass", cuda_ntt.SOURCE, cuda_ntt.REPLACES),
            ("K3", "curve_add", cuda_curve.SOURCE, cuda_curve.REPLACES)]
    rows += [(key, name, cuda_probe.SOURCE[name], cuda_probe.REPLACES[name])
             for key, name in PROBE_KERNELS.items()]
    out = []
    for key, name, source, replaces in rows:
        r = rec[key]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": counts[key],
                    "max_abs_err": max(r["errors"].values()),
                    "ms": r["ms"], "plain_ms": r["plain_ms"]})
    return {"kernels": out}


def free() -> None:
    """Return the freed phase's cached device memory to the card."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import halo2_aes_tpu_torch.ops.field  # noqa: F401  (the port must be here)
    from halo2_aes_tpu_torch.ops.timing import card_line

    dev = phase_device()
    phase_build()
    rec = phase_kernels(dev)
    phase_golden(dev)
    counts, pk, values = phase_flagship(dev)
    probe_counts = phase_probes(dev)
    counts.update({key: probe_counts[key] for key in PROBE_KERNELS})
    phase_gwc_packed(pk, values)
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
    print(card_line(), flush=True)
    emit(kernels_record(rec, counts))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
