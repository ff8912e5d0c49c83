"""Multi-process prover collectives of the PyTorch port on one host.

N rank processes joined by ``torch.distributed`` (one process per rank,
as a multi-host deployment runs them) run the port's two sharded
primitives across the process boundary:

  * the distributed four-step NTT (halo2_aes_tpu_torch/parallel/ntt.py),
    whose columns -> rows all-to-all and final all-gather cross the
    processes, every case of ``dryrun.NTT_CASES`` checked on every rank
    against the one-device transform;
  * the point- and table-sharded MSM (parallel/msm.py), partial sums
    all-gathered and tree-added, checked against the host oracle
    ``curve.host_msm``.

The ranks are ``python -m halo2_aes_tpu_torch.parallel.dryrun --task
ntt,msm``; any rank's failure makes the demo exit non-zero.

Usage:
  python scripts/torch_multihost_demo.py [--ranks N] [--device cuda|cpu]
                                         [--backend nccl|gloo]

``--device`` defaults to the card (rank r on card r mod the card count)
and raises where there is none; ``--device cpu`` runs on the CPU.
``--backend`` defaults to NCCL when there are N cards and to gloo
otherwise (gloo stages CUDA tensors through host memory).  One card can
show that the ranks agree bit for bit, not how the work scales.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from halo2_aes_tpu_torch.ops.timing import resolve_device
    from halo2_aes_tpu_torch.parallel import comm
    from halo2_aes_tpu_torch.parallel import dryrun as DR

    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = args.backend or ("nccl" if cards >= args.ranks else "gloo")
    rank_device = "cpu" if device.type == "cpu" else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        runs = comm.run_ranks(
            ["halo2_aes_tpu_torch.parallel.dryrun", "--task", "ntt,msm",
             "--backend", backend, "--device", rank_device],
            args.ranks, tmp, args.timeout)
    failed = [r for r, (rc, _) in enumerate(runs) if rc != 0]
    for r in failed:
        print(f"rank {r} exited {runs[r][0]}:\n{runs[r][1][-4000:]}",
              file=sys.stderr)
    if failed:
        print(f"FAILED: ranks {failed}", file=sys.stderr)
        return 1
    res = DR.rank_results(runs)
    print(json.dumps({"ranks": args.ranks, "backend": backend,
                      "device": rank_device, "cards": cards,
                      "ntt_cases": res[0]["results"]["ntt"]["cases"],
                      "msm_cases": len(res[0]["results"]["msm"]),
                      "launches": [r["launches"] for r in res],
                      "collectives": [r["collectives"] for r in res]}))
    print(f"multihost demo ok: {args.ranks} processes over {backend}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
