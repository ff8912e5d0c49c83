"""The port's dev tools (utils/cost_model.py, utils/layout_viz.py,
utils/timers.py) against the reference: ``estimate`` and ``field_muls``
give the same numbers for the AES, decryption and toy layouts under all
three multiopens, ``layout_viz.render`` writes the same PNG bytes, and
``PhaseTimers`` / ``device_trace`` behave as the reference's."""

import json
import os

import pytest
import torch

from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.models import aes128 as ref_aes128
from halo2_aes_tpu.models import aes128_dec as ref_dec
from halo2_aes_tpu.utils import cost_model as ref_cost_model
from halo2_aes_tpu.utils import layout_viz as ref_layout_viz
from halo2_aes_tpu_torch.circuit.toys import TOYS
from halo2_aes_tpu_torch.models import aes128, aes128_dec
from halo2_aes_tpu_torch.utils import cost_model, layout_viz, timers

MULTIOPENS = ("shplonk", "gwc", "ipa")


def _layouts(name):
    if name == "aes":
        cfg = dict(k=17, n_sets=2, n_blocks=100)
        return (aes128.compile_circuit(aes128.AesConfig(**cfg)),
                ref_aes128.compile_circuit(ref_aes128.AesConfig(**cfg)))
    if name == "aes_tagged":
        cfg = dict(k=17, n_sets=1, n_blocks=2, tagged_ops=True)
        return (aes128.compile_circuit(aes128.AesConfig(**cfg)),
                ref_aes128.compile_circuit(ref_aes128.AesConfig(**cfg)))
    if name == "dec":
        cfg = dict(k=17, n_sets=2, n_blocks=100)
        return (aes128_dec.compile_circuit(aes128_dec.AesDecConfig(**cfg)),
                ref_dec.compile_circuit(ref_dec.AesDecConfig(**cfg)))
    build = TOYS[name][0]
    return build()[0], build(ref_ir)[0]


@pytest.fixture(scope="module", params=["aes", "aes_tagged", "dec", *sorted(TOYS)])
def layouts(request):
    return request.param, *_layouts(request.param)


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_estimate_equals_reference(layouts, multiopen):
    _, layout, ref_layout = layouts
    cm = cost_model.estimate(layout, multiopen=multiopen)
    ref = ref_cost_model.estimate(ref_layout, multiopen=multiopen)
    assert cm.__dict__ == ref.__dict__
    assert cm.proof_bytes == 32 * (cm.proof_points + cm.proof_scalars)
    assert json.loads(cm.json()) == cm.__dict__


@pytest.mark.parametrize("multiopen", MULTIOPENS)
def test_field_muls_equals_reference(layouts, multiopen):
    _, layout, ref_layout = layouts
    muls = cost_model.field_muls(layout, multiopen=multiopen)
    assert muls == ref_cost_model.field_muls(ref_layout, multiopen=multiopen)
    assert muls["total"] == sum(v for k, v in muls.items() if k != "total")


def test_cost_model_aes_numbers():
    layout = _layouts("aes")[0]
    cm = cost_model.estimate(layout)
    assert (cm.k, cm.ext_k, cm.lookups, cm.gates, cm.advice_columns,
            cm.max_degree) == (17, 19, 9, 1, 7, 5)
    ipa = cost_model.estimate(layout, multiopen="ipa")
    assert ipa.proof_bytes == cm.proof_bytes + 32 * (2 * 17 - 1 + 2)


@pytest.mark.parametrize("name", ["aes_tagged", "toy"])
def test_layout_render_equals_reference(name, tmp_path):
    layout, ref_layout = _layouts(name)
    path, ref_path = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    layout_viz.render(layout, path, max_rows=256)
    ref_layout_viz.render(ref_layout, ref_path, max_rows=256)
    with open(path, "rb") as f, open(ref_path, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 100


def test_phase_timers(capsys):
    t = timers.PhaseTimers(verbose=True, device="cpu")
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with pytest.raises(KeyError):
        with t.phase("b"):
            raise KeyError("x")
    assert set(t.report()) == {"a", "b"} and t.times["a"] >= 0.0
    assert capsys.readouterr().out.count("[a]") == 2
    quiet = timers.PhaseTimers(verbose=False)
    with quiet.phase("c"):
        pass
    assert capsys.readouterr().out == "" and "c" in quiet.report()


def test_device_trace_writes_chrome_trace(tmp_path):
    with timers.device_trace(None):
        pass
    out = tmp_path / "trace"
    with timers.device_trace(str(out)):
        torch.arange(8).sum()
    with open(out / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert os.path.getsize(out / "trace.json") > 0
