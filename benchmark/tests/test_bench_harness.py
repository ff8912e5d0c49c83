"""The harness on the CPU: BENCHMARK.json keeps to the contract, every
configuration, traffic mix and metric loads by name, a run's last line
has its keys, new files are picked up without an edit, and a run with
the timed path broken underneath comes out not correct."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import circuits, harness
from benchmark import traffic as TR
from benchmark.tests import toy
from benchmark.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def toy_kind(monkeypatch):
    monkeypatch.setitem(circuits.KINDS, "toy", toy.Toy())


@pytest.fixture
def root(tmp_path):
    return toy.make_root(str(tmp_path), REPO)


def _run(root, traced=False, control=None, seconds=0.5):
    bench = harness.load_benchmark(root)
    return harness.run_cell(bench, toy.CELL, SEED, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), root, control=control,
                            log=lambda m: None)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for n in names + [w["name"] for w in BENCH["workloads"]]:
        assert NAME.match(n)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_loads_by_name(entry):
    with open(os.path.join(REPO, entry["file"])) as f:
        config = json.load(f)
    assert config["circuit"] in circuits.KINDS
    assert config["n_blocks"] <= config["capacity_blocks"]
    layout = circuits.KINDS[config["circuit"]].reference_layout(config)
    assert sum(layout.meta["capacities"]) == config["capacity_blocks"]


@pytest.mark.parametrize("name", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_traffic_loads_by_name(name):
    assert TR.load(name, os.path.join(REPO, "benchmark")) == {}
    gen = TR.Generator({"n_blocks": 3}, SEED)
    a, b = gen.request(4), gen.request(4)
    assert (a.key == b.key).all() and (a.pts == b.pts).all() and a.blind_seed == b.blind_seed
    assert a.pts.shape == (3, 16) and gen.request(5).blind_seed != a.blind_seed


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(name):
    assert callable(harness.load_reader(name, os.path.join(REPO, "benchmark")).read)


def test_result_line_keys(root):
    out = _run(root)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert all(c["limit"] == 0 and c["value"] == 0 for c in out["check"].values())


def test_traced_run_picks_up_new_files(root):
    """A configuration, a cell and a per-layer metric added as new files
    and entries, with no existing file of the harness edited."""
    bdir = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(bdir, "configs", "toy-k6.json"),
                os.path.join(bdir, "configs", "toy-k6-copy.json"))
    with open(os.path.join(bdir, "metrics", "proofs_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.phases)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="toy-k6-copy",
                                 file="benchmark/configs/toy-k6-copy.json"))
    bench["workloads"] = [dict(bench["workloads"][0], name="toy-copy.closed",
                               config="toy-k6-copy")]
    bench["per_layer"].append({"name": "proofs_traced", "unit": "proofs",
                               "better": "higher", "source": "program_span",
                               "layer": "entry", "moves": "prove_blocks_per_s"})
    for m in bench["per_layer"]:
        m["workloads"] = ["toy-copy.closed"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = harness.run_cell(bench, "toy-copy.closed", SEED, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), root, log=lambda m: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "check"]
    assert out["correct"]
    assert out["metrics"]["proofs_traced"]["value"] == out["attempted"]
    assert out["metrics"]["phase_s.quotient"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(out["device"])


def _flip_byte(monkeypatch):
    from halo2_aes_tpu_torch.backend import prover

    real = prover.prove

    def prove(*a, **kw):
        proof = bytearray(real(*a, **kw))
        proof[-40] ^= 1
        return bytes(proof)

    monkeypatch.setattr(prover, "prove", prove)


def _half_batch(monkeypatch):
    real = toy.Toy.program_values

    def program_values(self, layout, req, device):
        values = real(self, layout, req, device).clone()
        for row in toy.ROWS[:2]:                   # two of the three lookup rows left out
            values[toy.A0, row] = 0
            values[toy.A1, row] = 0
        return values

    monkeypatch.setattr(toy.Toy, "program_values", program_values)


@pytest.mark.parametrize("fault", ["flipped_byte", "half_batch", "packed", "altered"])
def test_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    control = None
    if fault == "flipped_byte":
        _flip_byte(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        control = fault
    out = _run(root, control=control)
    assert out["correct"] is False and out["failed"] >= 1
    assert list(out)[-1] == "check"


def _cli(cwd, seed=SEED):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
         "--seed", str(seed), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    p = _cli(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_lone_benchmark_directory_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


K22 = {"circuit": "aes128", "k": 22, "n_sets": 4, "n_blocks": 12335, "tagged_ops": False,
       "lookup_sort": "field", "multiopen": "shplonk", "srs": "dev"}
REF_PEAK = re.compile(r"reference judged .* s, device peak ([0-9.]+) GB")


@pytest.mark.chip
def test_k22_proof_is_judged_on_the_card(card, tmp_path, monkeypatch):
    """Upstream's AES-128 layout at k=22 (N=4, 12,335 blocks, the
    capacity; SHPLONK, field-ordered lookups, dev SRS), added as a
    configuration file and a cell of a temporary root: one proof on the
    card is judged correct by the reference within 60 GB of device
    memory, and not correct with a plaintext bit flipped under it.  The
    program proves on its host-rest path (idle stacks in host memory, the
    lookups' pairs one at a time), its own from k=23, lowered to 22: its
    k=22 default runs out of the card's memory in the lookup phase."""
    from halo2_aes_tpu_torch.backend import rest

    monkeypatch.setattr(rest, "HOST_REST_MIN_K", 22)
    root = toy.make_root(str(tmp_path), REPO)
    with open(os.path.join(root, "benchmark", "configs", "aes128-k22-n4.json"), "w") as f:
        json.dump(K22, f)
    bench = harness.load_benchmark(root)
    bench["configs"] = [{"name": "aes128-k22-n4", "source": "benchmark/tests",
                         "file": "benchmark/configs/aes128-k22-n4.json", "reduced": [],
                         "why": "k=22 on one card"}]
    bench["workloads"] = [{"name": "aes128-k22-n4.closed", "config": "aes128-k22-n4",
                           "traffic": "closed", "chips": 1, "why": "k=22 on one card"}]
    for control in (None, "altered"):
        lines = []

        def log(msg):
            lines.append(msg)
            harness._log(msg)

        out = harness.run_cell(bench, "aes128-k22-n4.closed", SEED, 1.0, False, card,
                               time.perf_counter(), root, control=control, log=log)
        harness._log(json.dumps(out))
        assert out["correct"] is (control is None) and out["attempted"] == 1
        peak = float(next(REF_PEAK.search(m) for m in lines if REF_PEAK.search(m))[1])
        assert peak <= 60.0, peak
