"""The port's host-only circuit compiler equals the reference's.

compile_circuit is copied numpy code; these tests pin it, field by
field, at the flagship configuration and at one set untagged."""

import numpy as np
import pytest
import torch

from halo2_aes_tpu.circuit import ir as ref_ir
from halo2_aes_tpu.models import aes128 as ref_aes
from halo2_aes_tpu_torch.circuit import ir
from halo2_aes_tpu_torch.models import aes128

torch.set_num_threads(1)

CONFIGS = {
    "flagship": dict(k=17, n_sets=4, n_blocks=384, tagged_ops=True),
    "one_set_untagged": dict(k=17, n_sets=1, n_blocks=96, tagged_ops=False),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def layouts(request):
    cfg = CONFIGS[request.param]
    return (aes128.compile_circuit(aes128.AesConfig(**cfg)),
            ref_aes.compile_circuit(ref_aes.AesConfig(**cfg)))


@pytest.mark.parametrize("field", ["fixed", "witness_map", "copy_pairs"])
def test_layout_arrays_equal(layouts, field):
    port, ref = layouts
    assert np.array_equal(getattr(port, field), getattr(ref, field))


def test_constraint_system_bytes_equal(layouts):
    port, ref = layouts
    assert ir.cs_bytes(port.cs) == ref_ir.cs_bytes(ref.cs)
    assert port.usable_rows == ref.usable_rows
    assert port.pool_len == ref.pool_len
