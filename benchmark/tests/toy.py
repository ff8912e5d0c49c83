"""A stand-in circuit kind for the CPU tests: the port's K=6 toy
circuit (an add gate, a two-column lookup x -> 7x mod 256 for x < 32, a
copy constraint) whose three lookup rows take their x from the
request's first plaintext block, and a checkout root that runs it."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from halo2_aes_tpu_torch.circuit import toys

A0, A1 = 4, 5
ROWS = (0, 1, 10)
CELL = "toy-k6.closed"


def _values(ir, req):
    layout, values = toys.toy_circuit(ir=ir)
    values = np.asarray(values, dtype=np.int64).copy()
    for row, x in zip(ROWS, req.pts[0, :3].astype(np.int64) % 32):
        values[A0, row] = x
        values[A1, row] = 7 * x % 256
    return layout, values


class Toy:
    def program_layout(self, config):
        return toys.toy_circuit()[0]

    def program_values(self, layout, req, device):
        import torch

        return torch.as_tensor(_values(None, req)[1], device=device)

    def reference_layout(self, config):
        from benchmark.reference.frozen import ir

        return toys.toy_circuit(ir=ir)[0]

    def reference_values(self, layout, req):
        from benchmark.reference.frozen import ir

        return _values(ir, req)[1]


def make_root(tmp, repo) -> str:
    """A checkout root holding a benchmark of the one toy cell, with the
    repository's traffic mix and metric readers."""
    root = os.path.join(tmp, "root")
    bdir = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(repo, "benchmark", "traffic"), os.path.join(bdir, "traffic"))
    shutil.copytree(os.path.join(repo, "benchmark", "metrics"), os.path.join(bdir, "metrics"))
    os.makedirs(os.path.join(bdir, "configs"))
    with open(os.path.join(bdir, "configs", "toy-k6.json"), "w") as f:
        json.dump({"circuit": "toy", "k": 6, "n_blocks": 1, "lookup_sort": "field",
                   "multiopen": "shplonk"}, f)
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "toy-k6", "source": "benchmark/tests/toy.py",
                         "file": "benchmark/configs/toy-k6.json", "reduced": [],
                         "why": "CPU stand-in"}]
    bench["workloads"] = [{"name": CELL, "config": "toy-k6", "traffic": "closed",
                           "chips": 1, "why": "CPU stand-in"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
