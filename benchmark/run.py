#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs a CUDA card (the cell's "chips"
of them); without one it exits 2 and prints no result.  The last line
of standard output is one JSON object: correct, attempted, failed,
metrics, device (and breakdown with --trace 1), then the numbers the
reference compared, each beside its limit, which are also the last
lines of standard error.  ``--control packed|altered`` runs the
program off what the configuration states (another lookup order; one
plaintext bit flipped) to show that the check fails; the benchmark's
own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    cell, _ = harness.find_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START, ROOT,
                           control=args.control)
    bad = harness.banned_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
