#!/usr/bin/env python3
"""Times of K1, K2, K3 and of the transforms and MSMs built on them, at the
shapes of a k=20 prove, on one CUDA card.

  python3 scripts/torch_kernel_times.py [--tree DIR] [--lg 20] [--count 45]
      [--polys 8] [--split-lg 23] [--only-splits] [--out FILE]

``--tree`` imports ``halo2_aes_tpu_torch`` from another checkout (default:
this one), so two trees can be timed in turns on one card in one run;
the script only calls what both an old and a new tree have (the K2 pass
pair goes through ``cuda_ntt.ntt_pass`` where the tree still has it,
else through ``cuda_ntt.ntt_fused``).  CUDA-event medians
(``ops/timing.time_ms``):

  K1        mont_mul of 2^lg pairs, and of a (count, 2^lg) stack by one row
  K2        a forward and an inverse pass over (count * 2^(lg/2), 2^(lg/2))
  ntt_many  count transforms of 2^lg with a coset shift, K1/K2 launches
  K3        curve add of 2^(lg-1) point pairs; where the tree has it, two
            tree levels of 2^12 .. 2^22 rows in one launch against one
            launch a level
  msm_many  ``polys`` commitments over 2^lg points (SRS and window tables
            cached in ``ptau/``), K3 launches, peak device memory
  splits    with ``--split-lg L`` (where the tree has ``ops/ntt.ROW_CAP``):
            count transforms of 2^L with a coset shift, and inverse, at
            each row cap that gives another split of L (rows of at most
            2^11: ceil(L / 11) passes; of 2^12: ceil(L / 12)), with the
            passes' row lengths, K2 launches and peak device memory;
            ``--only-splits`` times nothing else

Prints one JSON line with the card's name and power limit; ``--out`` also
writes it to a file.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fold_times(cuda_curve, p, time_ms) -> dict:
    """Two levels of ``fold`` over 8 groups: the two-level kernel against
    two one-level launches, by rows in the level it starts from."""
    import torch

    keep = cuda_curve.FOLD2_MAX_ROWS
    out = {}
    try:
        for lg_rows in range(12, 24, 2):
            rows = 1 << lg_rows
            reps = -(-rows // p[0].shape[0])
            lvl = tuple(t.repeat(reps, 1)[:rows].contiguous() for t in p)
            res = {}
            for name, cap in (("two_level_kernel", rows), ("one_level_launches", 0)):
                cuda_curve.FOLD2_MAX_ROWS = cap
                res[name] = time_ms(lambda: cuda_curve.fold(lvl, 8, rows // 8, 2),
                                    50 if lg_rows < 20 else 10)
            out[f"2^{lg_rows}"] = res
            del lvl
    finally:
        cuda_curve.FOLD2_MAX_ROWS = keep
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--lg", type=int, default=20)
    ap.add_argument("--count", type=int, default=45)
    ap.add_argument("--polys", type=int, default=8)
    ap.add_argument("--split-lg", type=int, default=0)
    ap.add_argument("--only-splits", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no card")
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as MSM
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import card_line, time_ms

    dev = torch.device("cuda", 0)
    lg, count, n = args.lg, args.count, 1 << args.lg
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def random_fr(rows):
        x = torch.randint(0, 1 << 16, (rows, F.LIMBS), generator=gen,
                          device=dev, dtype=torch.int32)
        x[:, -1] %= int(F.FR.p_limbs[-1])
        return x

    out = {"tree": os.path.relpath(os.path.abspath(args.tree), REPO),
           "card": card_line(), "lg": lg, "count": count}
    if args.split_lg:
        out["splits"] = split_times(N, cuda_ntt, F, random_fr, args.split_lg,
                                    count, time_ms, dev)
    if args.only_splits:
        return _emit(out, args.out)
    a, b = random_fr(n), random_fr(n)
    out["k1_pairs_ms"] = time_ms(lambda: cuda_field.mont_mul(F.FR, a, b), 100)
    stack = random_fr(count * n)
    st3 = stack.reshape(count, n, F.LIMBS)
    out["k1_stack_ms"] = time_ms(lambda: cuda_field.mont_mul(F.FR, st3, a), 10)

    lt = lg // 2
    if hasattr(cuda_ntt, "ntt_pass"):
        rows = stack.reshape(-1, 1 << lt, F.LIMBS)
        tws = [F.limbs(N._stage_tables(F.FR, lt, inv), dev) for inv in (False, True)]
        passes = [lambda tw=tw: cuda_ntt.ntt_pass(F.FR, rows, tw) for tw in tws]
        out["k2_entry"] = "ntt_pass"
    else:
        tws = [N._twiddles(F.FR, lt, inv, dev) for inv in (False, True)]
        # the natural-order store: an output stride (newer trees) or False
        natural = 1 << (lg - lt) if hasattr(N, "ROW_CAP") else False
        passes = [lambda tw=tw: cuda_ntt.ntt_fused(F.FR, stack, count, lg, lt, tw,
                                                   natural) for tw in tws]
        out["k2_entry"] = "ntt_fused"
    out["k2_pass_pair_ms"] = sum(time_ms(fn, 10) for fn in passes)

    dom = N.domain(F.FR, lg)
    N.ntt_many(dom, stack, count, shift_pows=a)
    before = (cuda_field.LAUNCHES, cuda_ntt.LAUNCHES)
    N.ntt_many(dom, stack, count, shift_pows=a)
    out["ntt_many_launches"] = {"K1": cuda_field.LAUNCHES - before[0],
                                "K2": cuda_ntt.LAUNCHES - before[1]}
    out["ntt_many_shift_ms"] = time_ms(
        lambda: N.ntt_many(dom, stack, count, shift_pows=a), 5)
    out["ntt_many_inverse_ms"] = time_ms(
        lambda: N.ntt_many(dom, stack, count, inverse=True), 5)
    one = random_fr(n)
    out["ntt_one_ms"] = time_ms(lambda: N.ntt_many(dom, one, 1), 20)
    del stack, st3, one

    t0 = time.perf_counter()
    srs = SRS.setup(lg, dev)
    srs.warm_tables()
    torch.cuda.synchronize()
    out["srs_and_tables_s"] = time.perf_counter() - t0
    half = n // 2
    p = (srs.g1_x[:half], srs.g1_y[:half],
         F.const(F.FQ, "one", dev).expand(half, F.LIMBS).contiguous())
    q = (srs.g1_x[half:], srs.g1_y[half:], p[2])
    out["k3_add_ms"] = time_ms(lambda: cuda_curve.add(p, q), 20)
    if hasattr(cuda_curve, "FOLD2_MAX_ROWS"):
        out["fold_two_levels_ms"] = fold_times(cuda_curve, p, time_ms)
    del p, q

    c = MSM.default_window(n)
    scalars = random_fr(args.polys * n)
    points = (srs.g1_x, srs.g1_y)

    def commit():
        return MSM.msm_many(points, scalars, args.polys, c, srs._msm_tables)

    commit()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = cuda_curve.LAUNCHES
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        commit()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    out["msm_many"] = {"polys": args.polys, "window": c, "s": runs,
                       "median_s": sorted(runs)[1],
                       "k3_launches": (cuda_curve.LAUNCHES - before) // 3,
                       "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return _emit(out, args.out)


def _emit(out: dict, path) -> int:
    line = json.dumps(out)
    print(line, flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(line + "\n")
    return 0


def split_times(N, cuda_ntt, F, random_fr, lg: int, count: int, time_ms,
                dev) -> dict:
    """``ntt_many`` of count x 2^lg (shift on load; and inverse) at the row
    caps 11 and 12, each split's passes, K2 launches and peak memory."""
    import torch

    keep = N.ROW_CAP
    stack, row = random_fr(count << lg), random_fr(1 << lg)
    dom = N.domain(F.FR, lg)
    out = {}
    try:
        for cap in (11, 12):
            N.ROW_CAP = cap
            N.ntt_many(dom, stack, count, shift_pows=row)      # tables cached
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = cuda_ntt.LAUNCHES
            N.ntt_many(dom, stack, count, shift_pows=row)
            launches = cuda_ntt.LAUNCHES - before
            out[f"cap{cap}"] = {
                "passes": N.pass_lengths(lg), "k2_launches": launches,
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "shift_ms": time_ms(lambda: N.ntt_many(dom, stack, count,
                                                       shift_pows=row), 2, 3),
                "inverse_ms": time_ms(lambda: N.ntt_many(dom, stack, count,
                                                         inverse=True), 2, 3)}
    finally:
        N.ROW_CAP = keep
    del stack, row
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
