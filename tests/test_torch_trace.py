"""The port's program spans (utils/timers.py) on the K=6 toy, on the CPU:
off they record and construct nothing; recording leaves the proof bytes
as they are; on, a prove is one ``prove`` tree whose phases tile it in
order, whose ``ntt`` and ``commit`` spans carry the shapes of their
calls, and whose host times are the profiler's; the benchmark's span
readers read it."""

import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from halo2_aes_tpu_torch.backend import keygen, prover, srs
from halo2_aes_tpu_torch.backend.transcript import TranscriptWriter
from halo2_aes_tpu_torch.circuit import witness
from halo2_aes_tpu_torch.circuit.toys import K, toy_circuit
from halo2_aes_tpu_torch.ops import ntt as NTT
from halo2_aes_tpu_torch.utils import timers

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 5
PHASES = {"shplonk": ["advice", "lookup_permuted", "grand_products", "quotient",
                      "evals", "shplonk_h", "shplonk_l"],
          "gwc": ["advice", "lookup_permuted", "grand_products", "quotient",
                  "evals", "gwc_open"]}
READERS = ["span_s.quotient", "span_s.grand_products", "span_s.quotient_terms",
           "span_s.commit", "span_s.witness", "ntt_many_roofline.in_proof",
           "quotient_terms_roofline", "grand_products_roofline"]


@pytest.fixture(scope="module")
def toy():
    layout, values = toy_circuit()
    return keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None)), values


def _recorded(pk, values, multiopen="shplonk"):
    timers.clear()
    with timers.recording():
        proof = prover.prove(pk, values, seed=SEED, multiopen=multiopen)
    return proof, timers.last_tree("prove")


def test_off_records_and_constructs_nothing(toy, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("tracing is off")

    for name in ("Event", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    timers.clear()
    prover.prove(*toy, seed=SEED)
    assert timers.spans() == [] and timers.last_tree() is None


@pytest.mark.parametrize("multiopen", ["shplonk", "gwc"])
def test_recording_leaves_proof_bytes(toy, multiopen):
    off = prover.prove(*toy, seed=SEED, multiopen=multiopen)
    on, tree = _recorded(*toy, multiopen)
    assert on == off and tree is not None


@pytest.mark.parametrize("multiopen", ["shplonk", "gwc"])
def test_phases_tile_the_prove_root(toy, multiopen):
    tree = _recorded(*toy, multiopen)[1]
    roots = [r for r in timers.spans() if r.parent is None]
    assert [r.name for r in roots] == ["prove"]
    assert tree.root.attrs == {"k": K, "multiopen": multiopen}
    phases = [r for r in tree.spans if r.parent == tree.root.id]
    assert [r.name for r in phases] == PHASES[multiopen]
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    assert tree.root.start_ns <= phases[0].start_ns
    assert phases[-1].end_ns <= tree.root.end_ns
    covered = sum(r.end_ns - r.start_ns for r in phases)
    assert covered >= 0.99 * (tree.root.end_ns - tree.root.start_ns)
    for r in tree.spans:         # on the CPU the device times are the host times
        assert (r.device_start_ns, r.device_end_ns) == (r.start_ns, r.end_ns)


def test_ntt_and_commit_spans_carry_their_shapes(toy, monkeypatch):
    calls, points = [], []
    composed = NTT._ntt_flat_composed

    def spy(dom, flat, count, inverse, shift_pows, **kw):
        calls.append({"count": count, "log_n": dom.k,
                      "shifted": shift_pows is not None, "inverse": inverse})
        assert flat.shape == (count << dom.k, 16)
        return composed(dom, flat, count, inverse, shift_pows, **kw)

    write_point = TranscriptWriter.write_point

    def count_point(self, pt):
        points.append(pt)
        return write_point(self, pt)

    monkeypatch.setattr(NTT, "_ntt_flat_composed", spy)
    monkeypatch.setattr(TranscriptWriter, "write_point", count_point)
    _, tree = _recorded(*toy)
    assert [r.attrs for r in tree.spans if r.name == "ntt"] == calls and calls
    commits = [r for r in tree.spans if r.name == "commit"]
    assert sum(r.attrs["polys"] for r in commits) == len(points)
    assert all(r.attrs["points"] == 1 << K for r in commits)
    terms = [r for r in tree.spans if r.name == "quotient.terms"]
    assert terms and all(r.attrs["terms"] > 0 for r in terms)


def test_grand_product_spans_sit_under_their_phase(toy):
    """One ``grand_products.lookup`` span a lookup column (one for the
    batched columns of the small path) and one ``grand_products.perm``
    span a permutation chunk, inside the ``grand_products`` phase, with
    the argument's work; ``fused`` 0: the CPU takes K6's plain version."""
    pk, _ = toy
    tree = _recorded(*toy)[1]
    phase = next(r for r in tree.spans if r.name == "grand_products"
                 and r.parent == tree.root.id)
    ph = prover._get_phases(pk)
    lk = [r for r in tree.spans if r.name == "grand_products.lookup"]
    perm = [r for r in tree.spans if r.name == "grand_products.perm"]
    assert len(perm) == ph.chunks and len(lk) == (1 if ph.n_lk else 0)
    assert all(r.parent == phase.id for r in lk + perm)
    assert all(phase.start_ns <= r.start_ns <= r.end_ns <= phase.end_ns
               for r in lk + perm)
    assert [r.attrs for r in lk] == [{"fused": 0, "rows": ph.n_lk * ph.n,
                                      "polys": 4, "muls": 7}] * len(lk)
    polys = [len(pk.vk.cs.perm_columns[t * ph.chunk_len:(t + 1) * ph.chunk_len])
             for t in range(ph.chunks)]
    assert [r.attrs for r in perm] == [{"fused": 0, "rows": ph.n, "polys": c,
                                        "muls": 4 * c + 4} for c in polys]


def test_spans_share_the_profilers_clock(toy):
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prover.prove(*toy, seed=SEED)
    recs = timers.spans()
    names = {r.name for r in recs}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {"prove", "quotient", "ntt", "commit"} <= names
    for name in names:
        ours = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(events[name])
        assert len(ours) == len(theirs)
        for (s0, e0), (s1, e1) in zip(ours, theirs):
            assert abs(s0 - s1) <= 500_000 and abs(e0 - e1) <= 500_000


def test_benchmark_readers_read_the_toy(toy):
    pk, values = toy
    timers.clear()
    rng = np.random.default_rng(SEED)
    with timers.recording():
        witness.build_pool(torch.as_tensor(rng.integers(0, 256, 16, dtype=np.uint8)),
                           torch.as_tensor(rng.integers(0, 256, (2, 16), dtype=np.uint8)))
        prover.prove(pk, values, seed=SEED)
    ctx = type("Ctx", (), {"log": staticmethod(lambda m: None)})()
    got = {name: harness.load_reader(name, str(REPO / "benchmark")).read(ctx)
           for name in READERS}
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0
               for v in got.values()), got
    assert got["span_s.quotient_terms"] <= got["span_s.quotient"]
    assert got["ntt_many_roofline.in_proof"] <= 100
    assert got["quotient_terms_roofline"] <= 100
    assert got["grand_products_roofline"] <= 100


K22_READERS = ["span_s.lookup_pairs", "commit_roofline.tableless"]


@pytest.fixture(scope="module")
def k22_forms():
    """(pk, prove tree) of a toy prove recorded with the k=22 forms forced
    (the permuted pairs one lookup at a time, the device MSM without
    window tables, the sliced path) and host rest left as it is."""
    from halo2_aes_tpu_torch.ops import msm as MSM

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prover, "PAIR_SORT_MAX_BYTES", 0)
        mp.setattr(prover, "_LARGE_MIN_K", K)
        mp.setattr(MSM, "TABLELESS_MIN_N", 1 << K)
        mp.setattr(keygen, "HOST_MSM_MAX_N", 0)
        layout, values = toy_circuit()
        pk = keygen.keygen(layout, srs.setup(K, "cpu", cache_dir=None))
        return pk, _recorded(pk, values)[1]


def _read(names):
    ctx = type("Ctx", (), {"log": staticmethod(lambda m: None)})()
    return {name: harness.load_reader(name, str(REPO / "benchmark")).read(ctx)
            for name in names}


@pytest.mark.parametrize("tree", ["k22_forms", "without_the_spans"])
def test_k22_forms_record_their_spans(tree, k22_forms, monkeypatch):
    """With the k=22 forms forced on the toy: a ``lookup.pairs`` span a
    lookup (``streamed`` 1) in the lookup phase, every ``commit`` span
    ``tables`` 0 and one ``msm.horner`` span a commitment's fold (c, W
    as the window gives them); the two readers of those spans give a
    finite positive number, and None on the same tree as a program
    without these spans and attributes records it."""
    from halo2_aes_tpu_torch.ops import cuda_msm as CM
    from halo2_aes_tpu_torch.ops import msm as MSM

    pk, rec = k22_forms
    pairs = [r for r in rec.spans if r.name == "lookup.pairs"]
    commits = [r for r in rec.spans if r.name == "commit"]
    horner = [r for r in rec.spans if r.name == "msm.horner"]
    c = MSM.default_window(1 << K)
    phase = next(r for r in rec.spans if r.name == "lookup_permuted")
    assert len(pairs) == len(pk.vk.cs.lookups)
    assert all(r.parent == phase.id for r in pairs)
    assert all(r.attrs == {"streamed": 1, "lookups": 1, "rows": pk.vk.usable}
               for r in pairs)
    assert commits and all(r.attrs["tables"] == 0 for r in commits)
    assert len(horner) >= sum(r.attrs["polys"] for r in commits)
    assert all(r.attrs == {"windows": CM.windows(c), "c": c} for r in horner)
    if tree == "without_the_spans":
        stripped = timers.Tree(rec.root, [
            dataclasses.replace(r, attrs={k: v for k, v in r.attrs.items()
                                          if k != "tables"})
            for r in rec.spans if r.name not in ("lookup.pairs", "msm.horner")],
            rec.before)
        monkeypatch.setattr(timers, "last_tree", lambda name="prove": stripped)
        assert _read(K22_READERS) == dict.fromkeys(K22_READERS)
        return
    got = _read(K22_READERS)
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0
               for v in got.values()), got
    assert got["commit_roofline.tableless"] <= 100


def test_phase_timers_open_spans_and_table():
    timers.clear()
    t = timers.PhaseTimers(verbose=False)
    with timers.recording():
        with t.phase("outer"):
            with timers.span("inner", n=1):
                pass
            with timers.span("inner", n=2):
                pass
    rows = timers.span_table(timers.spans())
    assert [r[:2] for r in rows] == [["outer", 1], ["outer/inner", 2]]
    assert rows[0][2] >= rows[1][2] >= 0
    assert "outer" in t.report()
