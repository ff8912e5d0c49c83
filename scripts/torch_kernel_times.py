#!/usr/bin/env python3
"""Times of K1, K2, K3 and of the transforms and MSMs built on them, at the
shapes of a k=20 prove, on one CUDA card.

  python3 scripts/torch_kernel_times.py [--tree DIR] [--lg 20] [--count 45]
      [--polys 8] [--quotient-k 20,23] [--grand-k 20] [--msm-lg 20]
      [--no-msm-plain] [--tableless-lg 22] [--only-msm] [--split-lg 23]
      [--only-splits] [--out FILE]

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
            ``_Phases.quotient_subcoset_eager``; default 20): the
            quotient's constraint terms of the benchmark cell's circuit
            (AES-128, 4 sets, upstream's layout) over random stacks of one
            sub-coset at 2^K, K4 (one launch) against the eager fold,
            bit-exact, with the bound of the work the constraint system
            asks; from ``rest.HOST_REST_MIN_K`` on, against the plain
            version over a quarter of the rows
  K6        with ``--grand-k K,..`` (where the tree has
            ``ops/cuda_grand.py``): the benchmark cell's grand products at
            2^K rows (17 lookup columns, 14 permutation columns in 5
            chunks) over random columns with zero denominators planted,
            K6 against its plain version and the eager path, bit-exact,
            with times, the bound and each launch's device time
  K7        with ``--msm-lg L`` (where the tree has ``ops/cuda_msm.py``):
            K7 against its plain version at small shapes, bit for bit at
            each step, then ``polys`` commitments over 2^L points with the
            window tables, K7 against the sorted-prefix tree (affine
            sums equal, times, peaks), K7's launches, each K7 kernel's
            device time and the bound of the MSM's work (``--no-msm-plain``
            leaves out the plain chain at that shape, ~60 s); with
            ``--tableless-lg L``, one commitment over 2^L points without
            tables (the k=22 cell's form: a bucket set a window, K3's
            Horner doublings; the 2^20 SRS's points repeated), its time,
            each kernel's device time and the bound of
            ``commit_roofline.tableless``; ``--only-msm`` times nothing
            after them
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
    """K4 on the benchmark cell's circuit at 2^k rows a sub-coset (random
    canonical stacks and challenges), one launch a sub-coset as the
    prover runs it, bit-exact against a reference: below
    ``rest.HOST_REST_MIN_K`` the eager fold over the whole sub-coset;
    from it, where the eager fold does not fit beside the stacks, K4 and
    the plain version over rows [n/4, n/2) (a first row that is not 0),
    and the whole launch's rows there.  CUDA-event times of K4 over the
    sub-coset and of the reference, and the bound of the work the
    constraint system asks (each poly the terms read and the result
    once; ``muls`` products a row)."""
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

    def k4():
        return ph.quotient_subcoset(*args)

    before = CQ.LAUNCHES
    got = k4()
    launches = CQ.LAUNCHES - before
    if ph.host_rest():
        lo, hi = n // 4, n // 2
        theta, beta, gamma, y = scal
        table = ph.terms_table(theta, beta, gamma, y, shift, zh_inv)
        omega = ph.dom.omega_powers(dev)
        part = CQ.quotient_terms(ph._terms_code, ph.terms.slots, table, static,
                                 dyn, omega, lo,
                                 torch.empty((hi - lo, F.LIMBS),
                                             dtype=torch.int32, device=dev))

        def reference():
            return CQ.quotient_terms_plain(ph._terms_code, table, static, dyn,
                                           omega, lo, hi - lo)
    else:
        lo, hi = 0, n
        part = got

        def reference():
            return ph.quotient_subcoset_eager(*args)

    want = reference()
    if not (torch.equal(got[lo:hi], want) and torch.equal(part, want)):
        raise AssertionError(f"K4: rows [{lo}, {hi}) of a 2^{k} sub-coset "
                             "differ from the reference")
    del want, part, got
    t = ph.terms
    by_bytes = (t.polys + 1) * n * 64 / 3.35e12 * 1e3
    by_ops = t.muls * n * 136 / 16.75e12 * 1e3
    rec = {"k": k, "launches": launches, "checked_rows": [lo, hi],
           "reference": "plain" if ph.host_rest() else "eager",
           "bit_exact": True, "instructions": int(t.code.shape[0]),
           "slots": t.slots, "muls": t.muls, "polys": t.polys, "terms": t.terms,
           "k4_ms": time_ms(k4, 3, 3), "reference_ms": time_ms(reference, 1, 3),
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    rec["share_of_bound"] = rec["bound_ms"] / rec["k4_ms"]
    del static, dyn, args
    torch.cuda.empty_cache()
    return rec


def grand_products_times(dev, k: int, bf: int | None = None) -> dict:
    """K6 on the benchmark cell's grand products at 2^k rows: its 17
    lookup columns (one launch sequence each, as the k >= 19 path runs
    them, and all 17 in one) and its 14 permutation columns in 5 chunks,
    over random canonical columns and a random sigma, with zero
    denominators planted in every column; bit-exact against K6's plain
    version and against the eager path; CUDA-event medians of K6, the
    plain version and the eager path; the bound of the work the argument
    asks (each input column read and z written once; 7 products a
    lookup row, 4c + 4 a row of a chunk of c columns); each K6 launch's
    device time from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_aes_tpu_torch.backend import lookup as LK
    from halo2_aes_tpu_torch.backend import permutation as PERM
    from halo2_aes_tpu_torch.ops import cuda_grand as CG
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import time_ms

    ph = cell_phases(dev, k)
    FR = F.FR
    n = 1 << k
    bf = ph.bf if bf is None else bf
    usable = n - bf - 1
    L, m, chunk_len = ph.n_lk, len(ph.cs.perm_columns), ph.chunk_len
    chunks = -(-m // chunk_len)
    gen = torch.Generator(device=dev)
    gen.manual_seed(k + 1000)
    beta, gamma = (F.encode(FR, v, dev) for v in (0x1234567, 0x89ABCDEF))
    a, s, ap, sp = (random_stack(F, L, n, gen, dev) for _ in range(4))
    lk_blind = random_stack(F, L, bf, gen, dev).reshape(L, bf, F.LIMBS)
    planted = [1, n // 3, usable - 1]          # zero denominators: A' = -beta
    for lk in range(L):
        ap[[lk * n + r for r in planted]] = F.neg(FR, beta)
    fld = random_stack(F, m, n, gen, dev)
    cells = torch.randperm(m * n, generator=gen, device=dev)
    map_col, map_row = (cells // n).reshape(m, n), (cells % n).reshape(m, n)
    del cells
    omega, delta = PERM._label_tables(k, m, dev)
    for c, r in ((0, 2), (m // 2, n // 2), (m - 1, usable - 1)):   # sigma's factor 0
        sig = F.mont_mul(FR, delta[map_col[c, r]], omega[map_row[c, r]])
        fld[c * n + r] = F.neg(FR, F.add(FR, F.mont_mul(FR, beta, sig), gamma))
    perm_blind = random_stack(F, chunks, bf, gen, dev).reshape(chunks, bf, F.LIMBS)
    one = F.const(FR, "one", dev)
    table = torch.stack([beta, gamma])
    col = [slice(lk * n, (lk + 1) * n) for lk in range(L)]
    perm_args = (k, usable, chunk_len, fld, list(range(m)), map_col, map_row,
                 omega, delta, beta, gamma, perm_blind)

    def k6_lookups():
        return [LK.grand_product(a[c], s[c], ap[c], sp[c], usable, beta, gamma,
                                 lk_blind[i]) for i, c in enumerate(col)]

    def k6_lookups_batched():
        return CG.lookup_z(a, s, ap, sp, usable, beta, gamma, lk_blind)

    def plain_lookup(i):
        c = col[i]
        return CG.grand_product_plain(
            *CG.lookup_factors(a[c], s[c], ap[c], sp[c], table), n, usable,
            one[None], lk_blind[i:i + 1])

    def k6_perm():
        return PERM.grand_products(*perm_args)

    def plain_perm():
        ptable = CG.perm_table(beta, gamma, delta)
        out, init = [], one
        for t in range(chunks):
            cols = [(i, i) for i in range(t * chunk_len, min((t + 1) * chunk_len, m))]
            out.append(CG.grand_product_plain(
                *CG.perm_factors(fld, n, cols, map_col, map_row, omega, ptable),
                n, usable, init[None], perm_blind[t:t + 1]))
            init = out[-1][usable]
        return torch.cat(out)

    before = CG.LAUNCHES
    got = k6_lookups()
    launches_lookups = CG.LAUNCHES - before
    for i in range(L):
        if not torch.equal(got[i], plain_lookup(i)):
            raise AssertionError(f"K6: lookup column {i} at 2^{k} differs from "
                                 "its plain version")
    if not torch.equal(got[0], LK.grand_product_eager(
            a[col[0]], s[col[0]], ap[col[0]], sp[col[0]], usable, beta, gamma,
            lk_blind[0])):
        raise AssertionError("K6: lookup column 0 differs from the eager path")
    if not torch.equal(torch.cat(got), k6_lookups_batched()):
        raise AssertionError("K6: the 17 lookups in one launch sequence differ "
                             "from one sequence a lookup")
    del got
    before = CG.LAUNCHES
    z_perm = k6_perm()
    launches_perm = CG.LAUNCHES - before
    if not torch.equal(z_perm, plain_perm()):
        raise AssertionError(f"K6: the permutation columns at 2^{k} differ "
                             "from the plain version")
    if not torch.equal(z_perm, PERM.grand_products_eager(*perm_args)):
        raise AssertionError(f"K6: the permutation columns at 2^{k} differ "
                             "from the eager path")
    del z_perm

    def bound(polys, muls, rows):
        by_bytes = (polys + 1) * rows * 64 / 3.35e12 * 1e3
        by_ops = muls * rows * 136 / 16.75e12 * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    lk_bound = bound(4, LK.MULS_PER_ROW, n)
    sizes = [min(chunk_len, m - t * chunk_len) for t in range(chunks)]
    perm_bound = sum(bound(c, 4 * c + 4, n)[0] for c in sizes)
    rec = {"k": k, "rows": n, "usable": usable, "blinding_rows": bf,
           "lookups": L, "perm_columns": m, "chunk_len": chunk_len,
           "chunks": chunks, "bit_exact": True, "zero_denominators_planted":
           {"lookup_rows": planted, "perm_cells": 3},
           "launches": {"lookups": launches_lookups, "perm": launches_perm},
           "k6_lookup_ms": time_ms(lambda: LK.grand_product(
               a[col[0]], s[col[0]], ap[col[0]], sp[col[0]], usable, beta, gamma,
               lk_blind[0]), 10, 5),
           "k6_lookups_ms": time_ms(k6_lookups, 2, 5),
           "k6_lookups_batched_ms": time_ms(k6_lookups_batched, 2, 5),
           "k6_perm_ms": time_ms(k6_perm, 3, 5),
           "plain_lookup_ms": time_ms(lambda: plain_lookup(0), 1, 3),
           "plain_perm_ms": time_ms(plain_perm, 1, 3),
           "eager_lookup_ms": time_ms(lambda: LK.grand_product_eager(
               a[col[0]], s[col[0]], ap[col[0]], sp[col[0]], usable, beta, gamma,
               lk_blind[0]), 1, 3),
           "eager_perm_ms": time_ms(lambda: PERM.grand_products_eager(*perm_args),
                                    1, 3),
           "bound_lookup_ms": lk_bound[0], "bound_lookup_by": lk_bound[1],
           "bound_perm_ms": perm_bound}
    rec["bound_all_ms"] = L * lk_bound[0] + perm_bound
    rec["k6_all_ms"] = rec["k6_lookups_ms"] + rec["k6_perm_ms"]
    rec["eager_all_ms"] = L * rec["eager_lookup_ms"] + rec["eager_perm_ms"]
    rec["share_of_bound"] = rec["bound_all_ms"] / rec["k6_all_ms"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k6_lookups()
        k6_perm()
        torch.cuda.synchronize()
    rec["kernels_us"] = {e.key: {"calls": e.count,
                                 "device_us": getattr(e, "device_time_total",
                                                      getattr(e, "cuda_time_total", 0))}
                         for e in prof.key_averages() if "grand_" in e.key}
    del a, s, ap, sp, fld, map_col, map_row
    torch.cuda.empty_cache()
    return rec


def msm_buckets_check(dev) -> dict:
    """K7 against its plain version at small shapes, bit for bit at each
    step (digits, the counting sort's lists, the buckets at a given slice
    length, the weighted sums): with tables (3 commitments of 2^10
    points at c = 6, 2 of 2^12 at c = 12, one with every digit 5) and
    without (2^10 points at c = 7, one set a window); and the affine sums
    equal the host's."""
    import torch

    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import cuda_msm as CM
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as MSM

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cpu = torch.device("cpu")
    out = []
    for lg, count, c, tabled, slice, equal in (
            (10, 3, 6, True, 32, False), (12, 2, 12, True, 64, False),
            (10, 1, 6, True, 37, True), (10, 1, 7, False, 32, False)):
        n = 1 << lg
        srs = SRS.setup(lg, dev, cache_dir=None)
        pts = (srs.g1_x, srs.g1_y)
        tables = MSM.build_tables(pts, c) if tabled else None
        if equal:
            v = sum(5 << (c * w) for w in range(CM.windows(c) - 1))
            scal = F.limbs(F.ints_to_limbs_fast([v] * n), dev)
        else:
            scal = torch.randint(0, 1 << 16, (count * n, F.LIMBS), generator=gen,
                                 device=dev, dtype=torch.int32)
            scal[:, -1] %= int(F.FR.p_limbs[-1])
        W = CM.windows(c)
        sets, R = (count, W * n) if tabled else (W, n)
        if tables is not None:
            dx, dy = tables[:, :F.LIMBS], tables[:, F.LIMBS:]
            hx, hy = dx.to(cpu), dy.to(cpu)
        else:
            dx, dy = pts
            hx, hy = dx.to(cpu), dy.to(cpu)
        digs = CM.digits(scal, count, c).reshape(sets, R)
        hdigs = CM.digits_plain(scal.to(cpu), count, c).reshape(sets, R)
        same_digits = torch.equal(digs.to(cpu).to(torch.int64) & 0xFFFF, hdigs)
        rows, starts = CM.sort(digs, c)
        hrows, hstarts = CM.sort_plain(hdigs, c)
        total = int(hstarts[-1])
        same_lists = (torch.equal(starts.to(cpu), hstarts)
                      and torch.equal(rows[:total].to(cpu), hrows[:total]))
        bucket = CM.accumulate(dx, dy, rows, starts, slice)
        hbucket = CM.accumulate_plain(hx, hy, hrows, hstarts, slice)
        same_buckets = all(torch.equal(a.to(cpu), b) for a, b in zip(bucket, hbucket))
        sums = CM.reduce(bucket, sets, c)
        hsums = CM.reduce_plain(hbucket, sets, c)
        same_sums = all(torch.equal(a.to(cpu), b) for a, b in zip(sums, hsums))
        got = CV.to_affine_host(MSM.msm_many(pts, scal, count, c, tables)
                                if tabled else MSM.msm(pts, scal, c=c))
        host_pts = list(zip(F.FQ.decode(srs.g1_x), F.FQ.decode(srs.g1_y)))
        want = [CV.host_msm(host_pts, F.FR.decode(
            F.to_mont(F.FR, scal[i * n:(i + 1) * n].to(cpu)))) for i in range(count)]
        rec = {"lg": lg, "count": count, "c": c, "tables": tabled, "slice": slice,
               "every_digit_5": equal, "listed_rows": total,
               "digits_equal": same_digits, "lists_equal": same_lists,
               "buckets_equal": same_buckets, "sums_equal": same_sums,
               "affine_equal_host": got == want}
        out.append(rec)
        if not all(v for k, v in rec.items() if k.endswith(("_equal", "_host"))):
            raise AssertionError(f"K7 differs from its plain version: {rec}")
    return {"cases": out, "bit_exact": True}


def msm_buckets_plain(scal, tables, polys: int, n: int, c: int, slice: int) -> dict:
    """K7's four steps against their plain versions on the same card
    tensors, at the main path's shape and the card's slice length, bit
    for bit at each step: the plain chain (``digits_plain``,
    ``sort_plain``, ``accumulate_plain``, ``reduce_plain``) runs on the
    card beside K7's.  Returns each step's differing entries (0: equal),
    the plain steps' times (one synchronised call each, ms), and the
    sort step timed on its own: K7's sort against ``sort_plain`` on
    K7's digits, CUDA-event medians and the peak memory each allocates
    above what it is given."""
    import torch

    from halo2_aes_tpu_torch.ops import cuda_msm as CM
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.timing import time_ms

    sets, R = polys, CM.windows(c) * n
    px, py = tables[:, :F.LIMBS], tables[:, F.LIMBS:]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def differ(a, b):
        return int((a != b).reshape(a.shape[0], -1).any(-1).sum())

    digs = CM.digits(scal, polys, c).reshape(sets, R)
    sort = {"k7_ms": time_ms(lambda: CM.sort(digs, c), 1, 5),
            "plain_ms": time_ms(lambda: CM.sort_plain(digs, c), 1, 3),
            "k7_peak_bytes": peak(lambda: CM.sort(digs, c)),
            "plain_peak_bytes": peak(lambda: CM.sort_plain(digs, c))}
    ms, errors = {}, {}
    hdigs, ms["digits"] = timed(lambda: CM.digits_plain(scal, polys, c).reshape(sets, R))
    errors["digits"] = differ(digs.to(torch.int64) & 0xFFFF, hdigs)
    rows, starts = CM.sort(digs, c)
    del digs
    (hrows, hstarts), ms["sort"] = timed(lambda: CM.sort_plain(hdigs, c))
    del hdigs
    total = int(hstarts[-1])
    errors["starts"] = differ(starts, hstarts)
    errors["rows"] = differ(rows[:total], hrows[:total])
    bucket = CM.accumulate(px, py, rows, starts, slice)
    del rows, starts
    hbucket, ms["accumulate"] = timed(
        lambda: CM.accumulate_plain(px, py, hrows, hstarts, slice))
    del hrows, hstarts
    errors["buckets"] = sum(differ(a, b) for a, b in zip(bucket, hbucket))
    sums = CM.reduce(bucket, sets, c)
    hsums, ms["reduce"] = timed(lambda: CM.reduce_plain(hbucket, sets, c))
    errors["sums"] = sum(differ(a, b) for a, b in zip(sums, hsums))
    rec = {"slice": slice, "listed_rows": total, "errors": errors,
           "bit_exact": not any(errors.values()), "plain_step_ms": ms,
           "plain_ms": sum(ms.values()), "sort": sort}
    if not rec["bit_exact"]:
        raise AssertionError(f"K7 differs from its plain version at {polys} x {n}: {rec}")
    return rec


def msm_buckets_times(dev, lg: int, polys: int, plain: bool = True) -> dict:
    """``polys`` commitments of random scalars over 2^lg SRS points with
    the window tables (the prover's ``msm_many`` shape): K7's affine sums
    equal the sorted-prefix tree's, and each of K7's steps its plain
    version's (``msm_buckets_plain``); CUDA-event medians of K7 and the
    tree, K7's launches and each K7 kernel's device time from
    torch.profiler, the peak memory of each route, and the bound of the
    work (``benchmark/metrics/commit_roofline.work``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import roofline
    from benchmark.metrics import commit_roofline
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import cuda_curve as CC
    from halo2_aes_tpu_torch.ops import cuda_msm as CM
    from halo2_aes_tpu_torch.ops import curve as CV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as MSM
    from halo2_aes_tpu_torch.ops.timing import time_ms

    n = 1 << lg
    srs = SRS.setup(lg, dev)
    srs.warm_tables()
    c = MSM.default_window(n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(lg)
    scal = torch.randint(0, 1 << 16, (polys * n, F.LIMBS), generator=gen,
                         device=dev, dtype=torch.int32)
    scal[:, -1] %= int(F.FR.p_limbs[-1])
    pts = (srs.g1_x, srs.g1_y)

    def k7():
        return MSM.msm_many(pts, scal, polys, c, srs._msm_tables)

    def tree():
        return MSM.msm_many_tree(pts, scal, polys, c, srs._msm_tables)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = CV.to_affine_host(fn())
        return got, torch.cuda.max_memory_allocated(dev) - base

    before = (CM.LAUNCHES, CC.LAUNCHES)
    got, k7_peak = peak(k7)
    launches = {"K7": CM.LAUNCHES - before[0], "K3": CC.LAUNCHES - before[1]}
    want, tree_peak = peak(tree)
    if got != want:
        raise AssertionError(f"K7: {polys} commitments at 2^{lg} differ from the tree's")
    bound_s, bound_by = roofline.least_seconds(*commit_roofline.work(polys, n))
    rec = {"lg": lg, "polys": polys, "window": c, "windows": CM.windows(c),
           "equal_tree": True, "launches": launches,
           "k7_ms": time_ms(k7, 1, 5), "tree_ms": time_ms(tree, 1, 3),
           "k7_peak_bytes": k7_peak, "tree_peak_bytes": tree_peak,
           "bound_ms": bound_s * 1e3,
           "bound_by": "bytes" if bound_by == "memory" else "operations",
           "slice": CM.slice_len(polys * CM.windows(c) * n, polys << c, dev)}
    rec["share_of_bound"] = rec["bound_ms"] / rec["k7_ms"]
    if plain:
        rec["plain"] = msm_buckets_plain(scal, srs._msm_tables, polys, n, c,
                                         rec["slice"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        k7()
        torch.cuda.synchronize()
    rec["kernels_us"] = {e.key: {"calls": e.count,
                                 "device_us": getattr(e, "device_time_total",
                                                      getattr(e, "cuda_time_total", 0))}
                         for e in prof.key_averages()}
    del scal
    torch.cuda.empty_cache()
    return rec


def msm_tableless_times(dev, lg: int) -> dict:
    """One commitment of random scalars over 2^lg points without window
    tables (``msm.msm``: a bucket set a window, then K3's Horner
    doublings), the 2^20 SRS's points repeated: CUDA-event median, each
    kernel's device time from torch.profiler and the bound of the work
    ``commit_roofline.tableless`` counts."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import roofline
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import msm as MSM
    from halo2_aes_tpu_torch.ops.timing import time_ms

    spec = importlib.util.spec_from_file_location(
        "commit_roofline_tableless",
        os.path.join(REPO, "benchmark", "metrics", "commit_roofline.tableless.py"))
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    n = 1 << lg
    srs = SRS.setup(20, dev)
    reps = -(-n // srs.g1_x.shape[0])
    pts = tuple(t.repeat(reps, 1)[:n].contiguous() for t in (srs.g1_x, srs.g1_y))
    gen = torch.Generator(device=dev)
    gen.manual_seed(lg)
    scal = torch.randint(0, 1 << 16, (n, F.LIMBS), generator=gen, device=dev,
                         dtype=torch.int32)
    scal[:, -1] %= int(F.FR.p_limbs[-1])
    bound_s, bound_by = roofline.least_seconds(*metric.work(1, n))
    rec = {"lg": lg, "window": MSM.default_window(n),
           "ms": time_ms(lambda: MSM.msm(pts, scal), 1, 5),
           "bound_ms": bound_s * 1e3,
           "bound_by": "bytes" if bound_by == "memory" else "operations"}
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        MSM.msm(pts, scal)
        torch.cuda.synchronize()
    rec["kernels_us"] = {e.key: {"calls": e.count,
                                 "device_us": getattr(e, "device_time_total",
                                                      getattr(e, "cuda_time_total", 0))}
                         for e in prof.key_averages()}
    del pts, scal
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--lg", type=int, default=20)
    ap.add_argument("--count", type=int, default=45)
    ap.add_argument("--polys", type=int, default=8)
    ap.add_argument("--quotient-k", default="20")
    ap.add_argument("--grand-k", default="")
    ap.add_argument("--split-lg", type=int, default=0)
    ap.add_argument("--msm-lg", type=int, default=0)
    ap.add_argument("--no-msm-plain", action="store_true")
    ap.add_argument("--tableless-lg", type=int, default=0)
    ap.add_argument("--only-msm", action="store_true")
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
    from halo2_aes_tpu_torch.backend import prover as PV

    if args.quotient_k and hasattr(PV._Phases, "quotient_subcoset_eager"):
        out["quotient_terms"] = [quotient_terms_times(dev, int(k))
                                 for k in args.quotient_k.split(",")]
    if args.grand_k:
        out["grand_products"] = [grand_products_times(dev, int(k))
                                 for k in args.grand_k.split(",")]
    if args.msm_lg and os.path.exists(os.path.join(
            args.tree, "halo2_aes_tpu_torch", "ops", "cuda_msm.py")):
        out["msm_buckets"] = {"check": msm_buckets_check(dev),
                              "times": msm_buckets_times(dev, args.msm_lg,
                                                         args.polys,
                                                         not args.no_msm_plain)}
    if args.tableless_lg:
        out["msm_tableless"] = msm_tableless_times(dev, args.tableless_lg)
    if args.only_msm:
        return _emit(out, args.out)
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
