#!/usr/bin/env python3
"""Steady-state AES prove timing of the PyTorch port on one device.

  python scripts/torch_prove_steady.py --device cuda [k] [blocks] [sets]
      [--tagged] [--lookup-sort field|packed] [--tables] [--phases]
      [--static-compare N] [--proves N] [--profile] [--memory-map]
      [--tree DIR] [--cache-dir DIR|none] [--out FILE]

The counterpart of ``scripts/prove_steady.py`` (defaults: k=17, 4
blocks, one column set): compiles the AES-128 circuit, sets up the SRS
and keys (cached in ``--cache-dir``, default ``ptau/``; ``none`` caches
nothing, as k=22's 13 GB would need), builds the witness, then times a
cold, a warm and a steady prove (blinding seeds 1, 2, 3), each with its
peak device memory, the memory held when it began and its kernel
launches, and a verify.  Setup, keygen and the witness each report their
seconds and peak too, and ``held_bytes`` splits what is held before a
prove (SRS points, MSM window tables, the pk's coefficient stacks and
permutation maps, the witness).  From k=19 on the proves take the sliced
large path; k=21 to k=23 (full capacity 6,167, 12,335 and 24,671
blocks at 4 sets) run as they are:

  python scripts/torch_prove_steady.py --device cuda 23 24671 4 --tagged \
      --phases --cache-dir none

``--tables`` first times the tables of the large path at this k, one
by one (each is cached per process, so the cold prove then runs
without them).  ``--phases`` times one more prove phase by phase, the device
seconds of the prover's phase spans (``utils/timers.py``), with each
phase's peak device memory and the memory held when it began (printed
as each phase ends).
``--static-compare N`` then proves 2N more times in turns, with the
static sub-coset evaluations cached (by this script, for all R
sub-cosets) and recomputed (what the large path does).
``--proves N`` times N more warm proves and reports their median;
``--profile`` runs one more under ``torch.profiler`` (launches and device
time of every CUDA kernel).  ``--memory-map`` records the allocator's
history from the start and maps one prove before the others: for each
phase, the bytes held when it began and at its peak, by the line of the
package that allocated them (``torch_phases.memory_map``).  Where idle
stacks rest in pinned host memory (k >= 23, ``backend/rest.py``), each
prove and each phase also reports the most pinned bytes they held, and
the run the pinned allocator's own counts (``host_memory_stats``); from
k=23 the script runs the CUDA allocator with expandable segments unless
``PYTORCH_CUDA_ALLOC_CONF`` is set (reported as ``alloc_conf``).
``--tree`` imports ``halo2_aes_tpu_torch`` from another checkout
(default: this one), so two trees can be timed on one card in one run.
Prints one JSON line; ``--out`` also writes it to a file.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tables(k: int, ext_k: int, d: int, n_perm: int, dev) -> dict:
    """Seconds to build, from cleared caches, each table of a large-path
    prove at this k on ``dev`` (on a CUDA device the powers tables are
    built by K1, elsewhere by host loops; they land in keygen and the
    first prove)."""
    import torch

    from halo2_aes_tpu_torch.backend import permutation as PERM
    from halo2_aes_tpu_torch.backend import poly as P
    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N

    R = (1 << ext_k) >> k
    k1 = (k + 1) // 2
    jobs = {f"subcoset_tables_x{R}": lambda: [PV._subcoset_tables(k, ext_k, s, dev)
                                              for s in range(R)],
            "finish_split_tables": lambda: PV._finish_split_tables(k, ext_k, d, dev),
            "shplonk_h_tables": lambda: PV._shplonk_h_tables(k, dev),
            "omega_powers": lambda: N.domain(F.FR, k).omega_powers(dev),
            "coset_points": lambda: PV._coset_points(k, dev),
            "shift_powers_x2": lambda: [P._shift_powers(k, inv, dev)
                                        for inv in (False, True)],
            "ntt_mid_tables_x2": lambda: [N._mid_table(F.FR, k, k1, inv, dev)
                                          for inv in (False, True)],
            "perm_label_tables": lambda: PERM._label_tables(k, n_perm, dev)}
    for fn in (PV._subcoset_tables, PV._finish_split_tables, PV._shplonk_h_tables,
               PV._coset_points, P._shift_powers, N._mid_table, N._powers_table,
               PERM._label_tables):
        fn.cache_clear()
    out = {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        job()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = time.perf_counter() - t0
    out["total"] = sum(out.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k", type=int, nargs="?", default=17)
    ap.add_argument("blocks", type=int, nargs="?", default=4)
    ap.add_argument("sets", type=int, nargs="?", default=1)
    ap.add_argument("--tagged", action="store_true",
                    help="tagged-op lookup tables (the flagship layout)")
    ap.add_argument("--lookup-sort", default="field", choices=["field", "packed"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without a card, "
                         "pass --device cpu)")
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--static-compare", type=int, default=0, metavar="N")
    ap.add_argument("--proves", type=int, default=0, metavar="N",
                    help="N more warm proves, reported with their median")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--memory-map", action="store_true")
    ap.add_argument("--tree", default=REPO,
                    help="checkout to import halo2_aes_tpu_torch from")
    ap.add_argument("--cache-dir", default="ptau",
                    help="SRS and key cache directory; 'none' caches nothing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cache = None if args.cache_dir == "none" else args.cache_dir
    if args.k >= 23:
        # from k=23 (backend/rest.py) large stacks among transients fragment
        # the caching allocator's fixed segments; set before the card is used
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    from halo2_aes_tpu_torch.backend import prover as PV
    from halo2_aes_tpu_torch.backend import srs as SRS
    from halo2_aes_tpu_torch.backend.keygen import keygen, keygen_cached
    from halo2_aes_tpu_torch.backend.verifier import verify
    from halo2_aes_tpu_torch.circuit import witness
    from halo2_aes_tpu_torch.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu_torch.ops import cuda_curve, cuda_field, cuda_ntt
    from halo2_aes_tpu_torch.ops.timing import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if args.memory_map:
        if not cuda:
            raise SystemExit("--memory-map needs a CUDA device")
        torch.cuda.memory._record_memory_history(
            context="alloc", stacks="python", max_entries=4_000_000)
    out = {"tree": os.path.relpath(os.path.abspath(args.tree), REPO),
           "k": args.k, "blocks": args.blocks, "sets": args.sets,
           "tagged": args.tagged, "lookup_sort": args.lookup_sort,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
           "device": torch.cuda.get_device_name(dev) if cuda else str(dev)}
    if cuda:
        from halo2_aes_tpu_torch.ops.timing import card_line

        out["card"] = card_line()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        sync()
        return res, time.perf_counter() - t0

    def step(name, fn, *a, **kw):
        """fn's result; its seconds and (on a card) peak bytes into out."""
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        res, out[f"{name}_s"] = timed(fn, *a, **kw)
        if cuda:
            out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"{name}: {out[f'{name}_s']:.2f} s, peak "
              f"{out.get(f'{name}_peak_bytes', 0) / 1e9:.2f} GB", flush=True)
        return res

    def launches():
        return {"K1": cuda_field.LAUNCHES, "K2": cuda_ntt.LAUNCHES,
                "K3": cuda_curve.LAUNCHES}

    try:                       # where idle stacks rest (trees since it came)
        from halo2_aes_tpu_torch.backend import rest
    except ImportError:
        rest = None

    layout = step("compile", compile_circuit, AesConfig(
        k=args.k, n_sets=args.sets, n_blocks=args.blocks, tagged_ops=args.tagged))
    srs = step("setup", SRS.setup, args.k, dev, cache_dir=cache)
    if cache is None:
        pk = step("keygen", keygen, layout, srs)
    else:
        pk = step("keygen", keygen_cached, layout, srs, cache_dir=cache)
    rng = np.random.default_rng(0)
    key = torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8), device=dev)
    pts = torch.as_tensor(rng.integers(0, 256, (args.blocks, 16), dtype=np.uint8),
                          device=dev)
    values = step("witness", lambda: witness.assemble_values(
        layout, witness.build_pool(key, pts)))
    out["held_bytes"] = held_bytes(pk, values)
    if rest is not None:
        out["host_rest"] = rest.on_host(args.k)
    print(f"held: {out['held_bytes']}", flush=True)
    ph = PV._get_phases(pk)
    out["large_path"] = ph.large()
    if args.tables:
        out["tables_s"] = tables(args.k, ph.ext_k, ph.d,
                                 len(layout.cs.perm_columns), dev)

    def prove(seed, **kw):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) if cuda else None
        if rest is not None:
            rest.reset()
        before = launches()
        proof, s = timed(PV.prove, pk, values, seed=seed,
                         lookup_sort=args.lookup_sort, **kw)
        rec = {"s": s, "blocks_per_s": args.blocks / s,
               "launches": {k_: v - before[k_] for k_, v in launches().items()}}
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            rec["held_before_bytes"] = held
        if rest is not None:
            rec["pinned_peak_bytes"] = rest.PINNED["peak_bytes"]
        return proof, rec

    if args.memory_map:
        from torch_phases import memory_map        # beside this script

        out["memory_map"] = memory_map(
            lambda: PV.prove(pk, values, seed=7, lookup_sort=args.lookup_sort), dev)
        torch.cuda.memory._record_memory_history(enabled=None)
        print(json.dumps({"memory_map": out["memory_map"]}), flush=True)
        if "out_of_memory" in out["memory_map"]:
            raise SystemExit("the mapped prove ran out of device memory")
    for seed, label in ((1, "cold"), (2, "warm"), (3, "steady")):
        proof, out[label] = prove(seed)
        print(f"prove {label}: {out[label]['s']:.2f} s, peak "
              f"{out[label].get('peak_bytes', 0) / 1e9:.2f} GB", flush=True)
    if args.proves:
        more = [prove(10 + i)[1] for i in range(args.proves)]
        out["more"] = {"s": [r["s"] for r in more],
                       "median_s": float(np.median([r["s"] for r in more])),
                       "launches": more[-1]["launches"],
                       "peak_bytes": max(r.get("peak_bytes", 0) for r in more)}
    if cuda and hasattr(torch.cuda, "host_memory_stats"):
        out["host_memory_stats"] = {
            k_: v for k_, v in torch.cuda.host_memory_stats().items()
            if k_.startswith(("allocated_bytes", "reserved_bytes"))}
    out["proof_bytes"] = len(proof)
    _, out["verify_s"] = timed(verify, pk.vk, proof)
    out["verified"] = True
    if args.phases:
        out["phase_pinned_peak_bytes"] = {}
        (out["phases_s"], out["phase_peak_bytes"],
         out["phase_held_bytes"]) = _phases(PV, pk, values, dev, args, rest,
                                            out["phase_pinned_peak_bytes"])
    if args.profile:
        from torch_phases import profiled_prove    # beside this script

        if not cuda:
            raise SystemExit("--profile needs a CUDA device")
        out["profile"] = profiled_prove(
            lambda: PV.prove(pk, values, seed=6, lookup_sort=args.lookup_sort), dev)
    if args.static_compare:
        out["static_compare"] = _static_compare(ph, prove, args.static_compare)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def held_bytes(pk, values) -> dict:
    """Bytes of what a prove finds held: on the device, the SRS's points
    and MSM window tables, the pk's coefficient stacks and permutation
    maps, and the witness matrix; in host memory, the pk's coefficient
    stacks where they rest there (``pk_coeffs_host``)."""
    def size(*tensors, on="cuda"):
        return sum(t.numel() * t.element_size() for t in tensors
                   if t is not None and t.device.type == on)

    srs = pk.srs
    coeffs = (*pk.fixed_coeffs.values(), pk.sigma_coeffs, pk.l0_coeffs,
              pk.l_last_coeffs, pk.l_active_coeffs)
    return {"srs_points": size(srs.g1_x, srs.g1_y),
            "msm_tables": size(getattr(srs, "_msm_tables", None)),
            "pk_coeffs": size(*coeffs), "pk_coeffs_host": size(*coeffs, on="cpu"),
            "perm_maps": size(*pk.perm_maps),
            "witness": size(values)}


def _phases(PV, pk, values, dev, args, rest, pinned: dict):
    """The phase-by-phase prove; ``pinned`` gets, per challenge, the most
    pinned host bytes parked stacks held since the one before."""
    from torch_phases import phase_prove       # beside this script

    if dev.type != "cuda":
        raise SystemExit("--phases needs a CUDA device")
    if rest is not None:
        rest.reset()

    def log(label, s, peak, allocated):
        host = ""
        if rest is not None:
            pinned[label] = rest.PINNED["peak_bytes"]
            host = f", pinned {pinned[label] / 1e9:.2f} GB"
            rest.reset()
        print(f"phase mark {label}: {s:.3f} s, peak {peak / 1e9:.2f} GB, "
              f"allocated {allocated / 1e9:.2f} GB{host}", flush=True)

    return phase_prove(lambda: PV.prove(pk, values, seed=4,
                                        lookup_sort=args.lookup_sort), dev, log)


def _static_compare(ph, prove, rounds: int) -> dict:
    """Proves with the static sub-coset evaluations cached and recomputed,
    in turns (recompute, cache, cache, recompute, ...).  The cache shadows
    ``ph.static_subcoset_evals`` on the instance; it is dropped before
    each recomputing prove and filled, untimed, before each cached one,
    so each mode's peak is its own."""
    import statistics

    runs = {"cache": [], "recompute": []}
    order = [m for i in range(rounds)
             for m in (("recompute", "cache") if i % 2 == 0
                       else ("cache", "recompute"))]
    try:
        for i, m in enumerate(order):
            ph.__dict__.pop("static_subcoset_evals", None)
            if m == "cache":
                ph.static_subcoset_evals = [
                    ph.static_subcoset_evals(s) for s in range(ph.ratio)].__getitem__
            runs[m].append(prove(5 + i)[1])
    finally:
        ph.__dict__.pop("static_subcoset_evals", None)
    return {m: {"s": [r["s"] for r in rs],
                "median_s": statistics.median(r["s"] for r in rs),
                "peak_bytes": max(r.get("peak_bytes", 0) for r in rs)}
            for m, rs in runs.items()}


if __name__ == "__main__":
    sys.exit(main())
