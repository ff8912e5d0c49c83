"""The forms a k=22 proof takes, judged by the plain reference on the CPU:
the toy cell run by ``harness.run_cell`` with the pair sort's limit and
the MSM's tableless threshold lowered to the toy (the permuted pairs one
lookup at a time, every commitment a device MSM without window tables
and its Horner fold, the sliced path), host rest left as it is, comes
out correct, and not correct with a plaintext bit flipped under it.
(The cell's per-layer readers are held on the toy's spans in
``tests/test_torch_trace.py``.)"""

import time

import pytest
import torch

from benchmark import circuits, harness
from benchmark.tests import toy
from benchmark.tests.conftest import REPO

SEED = 2 ** 31 + 23


@pytest.fixture
def k22_forms(monkeypatch):
    from halo2_aes_tpu_torch.backend import keygen, prover
    from halo2_aes_tpu_torch.circuit.toys import K
    from halo2_aes_tpu_torch.ops import msm

    monkeypatch.setitem(circuits.KINDS, "toy", toy.Toy())
    monkeypatch.setattr(prover, "PAIR_SORT_MAX_BYTES", 0)
    monkeypatch.setattr(prover, "_LARGE_MIN_K", K)
    monkeypatch.setattr(msm, "TABLELESS_MIN_N", 1 << K)
    monkeypatch.setattr(keygen, "HOST_MSM_MAX_N", 0)


@pytest.mark.parametrize("control", [None, "altered"])
def test_k22_forms_are_judged_by_the_reference(k22_forms, tmp_path, control):
    from halo2_aes_tpu_torch.backend import rest

    root = toy.make_root(str(tmp_path), REPO)
    bench = harness.load_benchmark(root)
    out = harness.run_cell(bench, toy.CELL, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), root, control=control,
                           log=lambda m: None)
    assert not rest.on_host(6)
    assert out["correct"] is (control is None)
    assert out["attempted"] >= 1
