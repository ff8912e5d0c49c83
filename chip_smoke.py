#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

  python3 chip_smoke.py

Phases, each printing one JSON line as it ends:
  0 device    the card (fails without CUDA), its name and power limit
  1 build     nvcc-builds the three kernels of csrc/ (K1 mont_mul,
              K2 ntt pass, K3 curve add)
  2 kernels   each kernel against its plain PyTorch version, bit-exact,
              on card tensors at the main path's shapes, with times
  3 golden    the K=6 toy and tagged-toy proofs proved on the card equal
              the committed golden bytes of the JAX reference and verify
  4 flagship  AES-128 at k=17, 4 sets, 384 blocks, tagged ops:
              setup, keygen, witness, warm-up prove, timed prove,
              verify, a flipped byte rejected; every kernel launched
Then the card line, the kernels record and, last, the ok line.  Any
failure raises and the exit code is non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(k=17, n_sets=4, n_blocks=384, tagged_ops=True)
FLAGSHIP_PROOF_BYTES = 5056      # the reference's proof length at this shape


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch

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


def _time_ms(fn, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of ``iters`` calls each,
    in ms per call, after one warm-up call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def _random_field(spec, rows: int, rng, device):
    """Uniform-ish canonical limbs: the top limb stays below p's."""
    import numpy as np

    from halo2_aes_tpu_torch.ops import field as F

    limbs = rng.integers(0, 1 << 16, (rows, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), rows)
    return F.limbs(limbs.astype(np.uint32), device)


def phase_kernels(dev) -> dict:
    """K1, K2, K3 against their plain versions, bit-exact, with times."""
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N

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
    torch.cuda.synchronize()
    emit({"phase": "kernels", **rec})
    return rec


def phase_golden(dev):
    """Toy proofs on the card == the reference's golden bytes, verified."""
    import torch

    from halo2_aes_tpu_torch.backend import keygen as KG
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend import verifier as VF
    from halo2_aes_tpu_torch.circuit.toys import K, TOYS

    with open(os.path.join(REPO, "halo2_aes_tpu_torch", "testdata",
                           "golden_k6.json")) as f:
        golden = json.load(f)
    srs = SRS.setup(K, dev, cache_dir=None)
    out = {}
    for name, (build, seed) in TOYS.items():
        layout, values = build()
        pk = KG.keygen(layout, srs)
        if hex(pk.vk.digest) != golden[name]["vk_digest"]:
            raise AssertionError(f"golden {name}: vk digest differs")
        proof = PV.prove(pk, values, seed=seed)
        if proof.hex() != golden[name]["proof"]:
            raise AssertionError(f"golden {name}: proof bytes differ")
        VF.verify(pk.vk, proof)
        out[name] = len(proof)
    torch.cuda.synchronize()
    emit({"phase": "golden", "identical": True, "verified": True,
          "proof_bytes": out})


def reset_counts():
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    for mod in (cuda_field, cuda_ntt, cuda_curve):
        mod.LAUNCHES = 0


def read_counts() -> dict:
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    return {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
            "K3": cuda_curve.LAUNCHES}


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
    if min(counts.values()) <= 0:
        raise AssertionError(f"flagship: a kernel never launched: {counts}")
    emit({"phase": "flagship", **cfg, "blocks_per_s": cfg["n_blocks"] / prove_s,
          "prove_s": prove_s, **t, "proof_bytes": len(proof), "verified": True,
          "flipped_byte_rejected": rejected, "peak_mem_bytes": peak,
          "launches": counts})
    return counts


def kernels_record(rec: dict, counts: dict) -> dict:
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt

    out = []
    for key, name, mod in (("K1", "mont_mul", cuda_field),
                           ("K2", "ntt_pass", cuda_ntt),
                           ("K3", "curve_add", cuda_curve)):
        r = rec[key]
        out.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                    "replaces": mod.REPLACES, "launches": counts[key],
                    "max_abs_err": max(r["errors"].values()),
                    "ms": r["ms"], "plain_ms": r["plain_ms"]})
    return {"kernels": out}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import halo2_aes_tpu_torch.ops.field  # noqa: F401  (the port must be here)

    dev = phase_device()
    phase_build()
    rec = phase_kernels(dev)
    phase_golden(dev)
    counts = phase_flagship(dev)
    torch.cuda.synchronize()
    print(card_line(), flush=True)
    emit(kernels_record(rec, counts))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
