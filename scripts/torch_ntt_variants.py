#!/usr/bin/env python3
"""Time K2 (``csrc/ntt.cu``) built with other tile shapes, on one CUDA card.

  python3 scripts/torch_ntt_variants.py [--lg 20] [--count 45] [--out FILE]

The fused NTT pass fixes two shapes at compile time: the stages a thread
runs in registers between exchanges (``NTT_R``: 3, 8 elements a thread) and
the tile width chosen from the row length (``ntt_tile_width``).  This
script copies ``csrc/`` under ``build/``, rewrites those two lines, builds
each variant through ``ops/_build.py`` and times, for each, a forward and an
inverse bare pass over a count x 2^lg stack, ``ntt_many`` of the stack with
a coset shift, of one poly, and of 4 x 2^17; every variant's transform must
equal the first one's.  It is how the shipped values were chosen.  Prints
one JSON line per variant after the card's name and power limit; ``--out``
also writes them to a file.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

R_LINE = "#define NTT_R 3"
W_LINE = "int W = lt >= 11 ? 1 : lt == 10 ? 2 : 4;"
VARIANTS = {"shipped": {},
            "two_stages_a_round": {R_LINE: "#define NTT_R 2"},
            "one_column_tiles": {W_LINE: "int W = 1;"}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lg", type=int, default=20)
    ap.add_argument("--count", type=int, default=45)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: no card")
    from halo2_aes_tpu_torch.ops import _build, cuda_ntt
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops import ntt as N
    from halo2_aes_tpu_torch.ops.timing import card_line, time_ms

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def random_fr(rows):
        x = torch.randint(0, 1 << 16, (rows, F.LIMBS), generator=gen,
                          device=dev, dtype=torch.int32)
        x[:, -1] %= int(F.FR.p_limbs[-1])
        return x

    lg, count = args.lg, args.count
    stack, row = random_fr(count << lg), random_fr(1 << lg)
    dom, dom17 = N.domain(F.FR, lg), N.domain(F.FR, 17)
    shipped_src = _build.CSRC
    first, lines = None, []
    try:
        for name, edits in VARIANTS.items():
            src = os.path.join(REPO, "build", "ntt_variants", name)
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(shipped_src, src)
            path = os.path.join(src, "ntt.cu")
            with open(path) as f:
                text = f.read()
            for old, new in edits.items():
                if old not in text:
                    raise SystemExit(f"{name}: ntt.cu no longer has the line {old!r}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            _build.CSRC = src
            _build.library.cache_clear()
            log = _build.build()[2].splitlines()
            at = next(i for i, ln in enumerate(log)
                      if "Compiling entry function" in ln and "ntt_fused" in ln)
            out = N.ntt_many(dom, stack, count, shift_pows=row)
            first = out if first is None else first
            if not torch.equal(out, first):
                raise AssertionError(f"{name}: the transform differs")
            del out
            lt = lg // 2
            tws = [N._twiddles(F.FR, lt, inv, dev) for inv in (False, True)]
            rec = {"variant": name, "ptxas": [ln.strip() for ln in log[at + 1:at + 4]],
                   "pass_pair_ms": sum(
                       time_ms(lambda tw=tw: cuda_ntt.ntt_fused(
                           F.FR, stack, count, lg, lt, tw, 1 << (lg - lt)), 10)
                       for tw in tws),
                   "ntt_many_shift_ms": time_ms(
                       lambda: N.ntt_many(dom, stack, count, shift_pows=row), 5),
                   "ntt_one_ms": time_ms(lambda: N.ntt_many(dom, row, 1), 20),
                   "ntt_many_4x2^17_ms": time_ms(
                       lambda: N.ntt_many(dom17, stack[:4 << 17], 4), 50)}
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    finally:
        _build.CSRC = shipped_src
        _build.library.cache_clear()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
