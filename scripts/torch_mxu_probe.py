"""The nibble-product path on the card: FixedMul, DftMatmul and ntt256
through K5 (int8 tensor cores) against K1 and K2.

  python scripts/torch_mxu_probe.py --device cuda [log2n] [reps] [--tree DIR]

The counterpart of ``scripts/mxu_probe.py`` (defaults: 2^17 elements, 5
timing windows).  For a 2^log2n batch of random Fr values it reports, as
CUDA-event medians:
  * K1 ``mont_mul`` against one broadcast operand             Mmul/s
  * ``FixedMul`` (three K5 launches, carries in K5's epilogue)  Mmul/s
  * ``DftMatmul(16)``: effective Mmul/s, counting the 16^2 products of
    each of the 2^log2n / 16 vectors
  * ``ntt256`` on 2^log2n / 256 vectors, Mpt/s, beside ``ntt.ntt_many``
    at k = 8 (K2) on the same vectors
  * K5 alone at each product shape of those paths (the fold-only
    entry, on the packed operand), and its normalize entry at the four
    carry sites of the paths (``k5_normalize_cases``), each beside its
    bound (bytes over 3.35 TB/s, or the band's non-zero multiply-adds
    over the int8 tensor cores' dense 989.5e12/s) and its share of it.
  * the device kernels (and memory operations) one call of FixedMul,
    DftMatmul(16) and ntt256 launches, under torch.profiler.
It ends with the on-device spot check (FixedMul against K1, ntt256
against K2), then prints the card's name and power limit and one JSON
line per row.  ``--tree`` imports ``halo2_aes_tpu_torch`` from another
checkout (default: this one), so a parent and a change can be timed in
turns in one run; K5 is then timed through what that tree has (a tree
without ``cuda_nibble.pack`` takes B as it is and has no normalize
entry).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MEM_BYTES_PER_S = 3.35e12
TC_INT8_MACS_PER_S = 989.5e12     # 1,979 dense int8 TOPS, two ops a multiply-add
DFT_N = 16


def random_fr(n: int, rng, device):
    """(n, 16) int32 canonical Fr limbs, uniform-ish: the top limb stays
    below p's."""
    import numpy as np

    from halo2_aes_tpu_torch.ops import field as F

    limbs = rng.integers(0, 1 << 16, (n, F.LIMBS), dtype=np.int64)
    limbs[:, -1] = rng.integers(0, int(F.FR.p_limbs[-1]), n)
    return F.limbs(limbs.astype(np.uint32), device)


def dft16():
    """The probe's DftMatmul(16): omega^(j*k) for the 16th root of unity."""
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX

    p = F.FR.modulus
    omega = pow(F.FR.generator, (p - 1) // DFT_N, p)
    return MX.DftMatmul(F.FR, [[pow(omega, j * k, p) for k in range(DFT_N)]
                               for j in range(DFT_N)])


def k5_cases(log2n: int, rng, device) -> dict:
    """name -> (x, B, block): K5's inputs at every product shape of the
    probe's paths for a 2^log2n batch, with the paths' own matrices."""
    import torch

    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX

    n = 1 << log2n
    dev = torch.device(device)
    def on(host):
        return torch.from_numpy(host).to(dev)

    fixed = MX.FixedMul(F.FR, F.FR.modulus - 2)
    NP, P = (on(m[None]) for m in MX._reducer_mats(F.FR.modulus))
    wide = torch.randint(0, 1 << 16, (1, n, MX.RP_LIMBS), dtype=torch.int32,
                         device=dev)
    dft = dft16()
    d2 = MX._ntt256_stages(F.FR)[1]
    return {
        "fixed_64x127": (random_fr(n, rng, dev)[None], on(fixed._B), None),
        "reduce_68x68": (wide, NP, None),
        "reduce_68x131": (wide, P, None),
        "dft16_1024x2032": (random_fr(n, rng, dev).reshape(1, n // DFT_N, -1),
                            on(dft._W), 127),
        "ntt256_stage2_16x1024x2032": (
            random_fr(n, rng, dev).reshape(16, n // 256, -1), on(d2._W), 127),
    }


def k5_normalize_cases(log2n: int, rng, device) -> dict:
    """name -> (x, B, block, width, addend): K5's normalize entry at the
    four carry sites of the probe's paths for a 2^log2n batch (FixedMul's
    product, the reducer's two, a DFT's outputs; the DFT site at both
    DftMatmul(16)'s and ntt256's second stage's shapes), the addend the
    canonical t of FixedMul (32 limbs) or of the DFT path (33)."""
    import torch

    cases = k5_cases(log2n, rng, device)
    n = 1 << log2n
    dev = torch.device(device)
    t32, t33 = (torch.randint(0, 1 << 16, (1, n, w), dtype=torch.int32, device=dev)
                for w in (32, 33))
    wide = cases["reduce_68x68"][0]
    P = cases["reduce_68x131"][1]
    return {
        "fixed_64x127_w32": (*cases["fixed_64x127"], 32, None),
        "reduce_68x68_w17": (*cases["reduce_68x68"], 17, None),
        "reduce_68x131_w34_t32": (wide, P, None, 34, t32),
        "reduce_68x131_w34_t33": (wide, P, None, 34, t33),
        "dft16_1024x2032_w33": (*cases["dft16_1024x2032"], 33, None),
        "ntt256_stage2_16x1024x2032_w33": (*cases["ntt256_stage2_16x1024x2032"],
                                           33, None),
    }


def k5_bound(x, B, block=None, width=None, addend=None) -> dict:
    """The least time the card could take for one K5 call: x, B, the
    addend and out each moved once at the memory rate, or the band's
    non-zero entries times the rows at the int8 tensor-core rate,
    whichever is larger.  ``width``: the normalize entry's limbs a block
    (out then has (M / block) * width limbs a row)."""
    from halo2_aes_tpu_torch.ops import cuda_nibble

    g, rows, _ = x.shape
    m = B.shape[-1]
    block = block or m
    limbs = (m // block) * width if width else cuda_nibble.out_limbs(m, block)
    in_bytes = 4 * x.numel() + B.numel() + (0 if addend is None else 4 * addend.numel())
    return bound(in_bytes + 4 * g * rows * limbs, rows * int((B != 0).sum().item()))


def bound(nbytes: float, macs: float) -> dict:
    """The larger of the two times: bytes at the memory rate, multiply-adds
    at the int8 tensor-core rate."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = macs / TC_INT8_MACS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "macs": macs}


def kernel_name(name: str) -> str:
    """A profiler kernel name cut to what tells kernels apart: the
    operation's own identifiers inside PyTorch's templates."""
    if "nibble_mma_kernel" in name:
        return "nibble_mma_kernel"
    generic = {"elementwise_kernel", "vectorized_elementwise_kernel",
               "unrolled_elementwise_kernel", "gpu_kernel_impl",
               "gpu_kernel_impl_nocast", "memory", "AUnaryFunctor",
               "BinaryFunctor", "TensorIteratorBase", "TensorIterator"}
    words = re.findall(r"at::native::(?:\(anonymous namespace\)::)?(\w+)", name)
    kept = list(dict.fromkeys(w for w in words if w not in generic))
    return "/".join(kept)[:80] or name[:80]


def device_kernels(fn, calls: int = 3, sessions: int = 5) -> dict:
    """Device kernels (and memory operations) that one warm call of ``fn``
    launches, by (shortened) name, under torch.profiler.  A profile can
    miss kernel records (seen on the H100 after earlier profiles in the
    same process), never invent them, so each of ``sessions`` profiles
    drops a warm-up step and counts ``calls`` calls, and each name keeps
    its highest count a call over the sessions."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(sessions):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=calls, repeat=1)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=schedule) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = kernel_name(e.key)
                seen[key] = seen.get(key, 0) + e.count
        for key, count in seen.items():
            best[key] = max(best.get(key, 0), count / calls)
    return {k: int(v) if v == int(v) else v for k, v in best.items()}


def spot_check(a, b_val: int, vectors) -> None:
    """FixedMul against K1's mont_mul on ``a``; ntt256 against ntt_many at
    k = 8 (K2 on a card) on ``vectors`` (V, 256, 16).  Raises on a
    difference."""
    import torch

    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX
    from halo2_aes_tpu_torch.ops import ntt

    b = F.limbs(F.int_to_limbs(b_val), a.device)
    if not torch.equal(MX.FixedMul(F.FR, b_val)(a), F.mont_mul(F.FR, a, b)):
        raise AssertionError("FixedMul differs from mont_mul")
    v = vectors.shape[0]
    want = ntt.ntt_many(ntt.domain(F.FR, 8), vectors.reshape(-1, F.LIMBS),
                        v).reshape(v, 256, F.LIMBS)
    if not torch.equal(MX.ntt256(F.FR, vectors), want):
        raise AssertionError("ntt256 differs from ntt.ntt_many at k = 8")


def run(device: str, log2n: int = 17, reps: int = 5) -> list:
    import numpy as np
    import torch

    from halo2_aes_tpu_torch.ops import cuda_nibble
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import mxu_field as MX
    from halo2_aes_tpu_torch.ops import ntt
    from halo2_aes_tpu_torch.ops.timing import time_ms

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probe measures a CUDA card, not {dev}")
    n = 1 << log2n
    rng = np.random.default_rng(7)
    a = random_fr(n, rng, dev)
    b_val = int.from_bytes(rng.bytes(32), "little") % F.FR.modulus
    b = F.limbs(F.int_to_limbs(b_val), dev)
    fixed = MX.FixedMul(F.FR, b_val)
    dft = dft16()
    xv = a.reshape(n // DFT_N, DFT_N, F.LIMBS)
    nv = n // 256
    vectors = a.reshape(nv, 256, F.LIMBS)
    dom = ntt.domain(F.FR, 8)
    flat = vectors.reshape(-1, F.LIMBS)
    iters = 20
    rows = []

    def row(name, fn, **per_ms):
        ms = time_ms(fn, iters, reps)
        rows.append({"name": name, "log2n": log2n, "ms": ms,
                     **{k: v / ms / 1e3 for k, v in per_ms.items()}})

    row("k1_mont_mul", lambda: F.mont_mul(F.FR, a, b), mmul_per_s=n)
    row("fixed_mul", lambda: fixed(a), mmul_per_s=n)
    row("dft_matmul16", lambda: dft(xv), mmul_per_s_effective=n * DFT_N)
    # two stages of 16 DFT-16s a vector
    row("ntt256", lambda: MX.ntt256(F.FR, vectors), mpt_per_s=n,
        mmul_per_s_effective=nv * 2 * 16 * 256)
    row("ntt_many_k8", lambda: ntt.ntt_many(dom, flat, nv), mpt_per_s=n)
    for name, fn in (("fixed_mul", lambda: fixed(a)), ("dft_matmul16", lambda: dft(xv)),
                     ("ntt256", lambda: MX.ntt256(F.FR, vectors))):
        by_name = device_kernels(fn)
        rows.append({"name": f"kernels_{name}", "log2n": log2n,
                     "device_kernels": sum(by_name.values()), "names": by_name})
    packs = hasattr(cuda_nibble, "pack")
    for name, (x, B, block) in k5_cases(log2n, rng, dev).items():
        args = (x, B, block, cuda_nibble.pack(B, block)) if packs else (x, B, block)
        ms = time_ms(lambda: cuda_nibble.nibble_product(*args), iters, reps)
        bd = k5_bound(x, B, block)
        rows.append({"name": f"k5_{name}", "log2n": log2n, "ms": ms,
                     "shape": [list(x.shape), list(B.shape), block],
                     **bd, "share": bd["bound_ms"] / ms,
                     "tensor_core_macs_per_s": bd["macs"] / ms * 1e3})
    cases = k5_normalize_cases(log2n, rng, dev) if packs else {}
    for name, (x, B, block, width, add) in cases.items():
        pk = cuda_nibble.pack(B, block)
        ms = time_ms(lambda: cuda_nibble.nibble_normalize(x, B, block, width, add, pk),
                     iters, reps)
        bd = k5_bound(x, B, block, width, add)
        rows.append({"name": f"k5_normalize_{name}", "log2n": log2n, "ms": ms,
                     **bd, "share": bd["bound_ms"] / ms})
    spot_check(a[:8], b_val, vectors)
    torch.cuda.synchronize()
    rows.append({"name": "spot_check", "fixed_mul_equals_k1": True,
                 "ntt256_equals_k2": True})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log2n", type=int, nargs="?", default=17)
    ap.add_argument("reps", type=int, nargs="?", default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the probe measures "
                         "a CUDA card only)")
    ap.add_argument("--tree", default=None,
                    help="checkout to import halo2_aes_tpu_torch from")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the probe measures the card only")
    from halo2_aes_tpu_torch.ops.timing import card_line, resolve_device

    import halo2_aes_tpu_torch

    rows = run(str(resolve_device(args.device)), args.log2n, args.reps)
    print(card_line(), flush=True)
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(halo2_aes_tpu_torch.__file__)))}), flush=True)
    for rec in rows:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
