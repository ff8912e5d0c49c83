#!/usr/bin/env python3
"""Times of K1, K2, K3 and of the transforms and MSMs built on them, at the
shapes of a k=20 prove, on one CUDA card.

  python3 scripts/torch_kernel_times.py [--tree DIR] [--lg 20] [--count 45]
      [--polys 8] [--quotient-k 20,23] [--split-lg 23] [--only-splits]
      [--out FILE]

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
  K4        with ``--quotient-k K,..`` (where the tree has
            ``ops/cuda_quotient.py``; default 20): the quotient's
            constraint terms of the benchmark cell's circuit (AES-128, 4
            sets, upstream's layout) over random stacks of one sub-coset
            at 2^K, K4 (one launch) against the eager fold, bit-exact, with
            the bound of the work the constraint system asks; from
            ``rest.HOST_REST_MIN_K`` on one row chunk of the host-rest
            form (the second of ``_QUOTIENT_ROW_CHUNKS``) of a sub-coset
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


def cell_phases(dev, k: int):
    """The prover's ``_Phases`` of the benchmark cell's circuit (AES-128,
    4 sets, upstream's layout) at 2^k rows, without keys (the quotient
    reads only the constraint system and the domain)."""
    import dataclasses
    import types

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit

    # the constraint system does not depend on k: lay out at 2^17, prove at 2^k
    layout = dataclasses.replace(
        compile_circuit(AesConfig(k=17, n_sets=4, n_blocks=384)), k=k)
    cs = layout.cs
    vk = types.SimpleNamespace(cs=cs, k=k, usable=layout.usable_rows,
                               ext_k=k + max(1, (cs.degree() - 2).bit_length()))
    return PV._Phases(types.SimpleNamespace(vk=vk, layout=layout, device=dev))


def random_stack(F, polys: int, n: int, gen, dev):
    """(polys * n, 16) random canonical limbs (the top limb below p's)."""
    import torch

    x = torch.empty((polys * n, F.LIMBS), dtype=torch.int32, device=dev)
    for p in range(polys):
        part = x[p * n:(p + 1) * n]
        part.random_(0, 1 << 16, generator=gen)
        part[:, -1] %= int(F.FR.p_limbs[-1])
    return x


def quotient_terms_times(dev, k: int) -> dict:
    """K4 against the eager fold on the benchmark cell's circuit at 2^k
    rows a sub-coset (random canonical stacks and challenges): a whole
    sub-coset below ``rest.HOST_REST_MIN_K``, from it the second row
    chunk of its host-rest form; bit-exact, CUDA-event times of both,
    and the bound of the work the constraint system asks (each poly the
    terms read and the result once; ``muls`` products a row)."""
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.ops import cuda_quotient as CQ
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import time_ms

    ph = cell_phases(dev, k)
    n = ph.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    static = random_stack(F, len(ph.q_static_keys), n, gen, dev)
    dyn = random_stack(F, len(ph.q_dyn_keys), n, gen, dev)
    shift, zh_inv = PV._subcoset_tables(k, ph.ext_k, 1, dev)
    scal = [F.encode(F.FR, v, dev) for v in (0x1234567, 0x89ABCDEF, 0xFEDCBA9, 0x7654321)]
    args = (static, dyn, *scal, shift, zh_inv)
    chunks = PV._QUOTIENT_ROW_CHUNKS[ph.host_rest()]
    if chunks == 1:
        lo, hi = 0, n

        def fused():
            return ph.quotient_subcoset_fused(*args)

        def eager():
            return ph.quotient_subcoset_sliced(*args)
    else:
        lo, hi = n // chunks, 2 * n // chunks
        theta, beta, gamma, y = scal
        table = CQ.constant_table(ph._terms_consts, y, zh_inv, theta, beta, gamma,
                                  F.mont_mul(F.FR, ph._delta_pows, shift[1]))
        omega = ph.dom.omega_powers(dev)
        out = torch.empty((hi - lo, F.LIMBS), dtype=torch.int32, device=dev)

        def fused():
            return CQ.quotient_terms(ph._terms_code, ph.terms.slots, table,
                                     static, dyn, omega, lo, out)

        def eager():
            terms = PV.PROTO.constraint_terms(ph.cs, ph._subcoset_ctx(
                static, dyn, theta, beta, gamma, shift, (lo, hi)))
            acc = ph._quotient_terms_slice(terms, ph.n_constraint_terms(), y)
            return F.mont_mul(F.FR, acc, zh_inv)

    before = CQ.LAUNCHES
    got = fused()
    launches = CQ.LAUNCHES - before
    want = eager()
    if not torch.equal(got, want):
        raise AssertionError(f"K4: rows [{lo}, {hi}) of a 2^{k} sub-coset "
                             "differ from the eager fold")
    del want
    rows = hi - lo
    t = ph.terms
    by_bytes = (t.polys + 1) * rows * 64 / 3.35e12 * 1e3
    by_ops = t.muls * rows * 136 / 16.75e12 * 1e3
    rec = {"k": k, "rows": [lo, hi], "launches": launches, "bit_exact": True,
           "instructions": int(t.code.shape[0]), "slots": t.slots,
           "muls": t.muls, "polys": t.polys, "terms": t.terms,
           "k4_ms": time_ms(fused, 3, 3), "eager_ms": time_ms(eager, 1, 3),
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    rec["share_of_bound"] = rec["bound_ms"] / rec["k4_ms"]
    del static, dyn, args
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--lg", type=int, default=20)
    ap.add_argument("--count", type=int, default=45)
    ap.add_argument("--polys", type=int, default=8)
    ap.add_argument("--quotient-k", default="20")
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
    if args.quotient_k and os.path.exists(os.path.join(
            os.path.abspath(args.tree), "halo2_aes_tpu_torch", "ops",
            "cuda_quotient.py")):
        out["quotient_terms"] = [quotient_terms_times(dev, int(k))
                                 for k in args.quotient_k.split(",")]
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
