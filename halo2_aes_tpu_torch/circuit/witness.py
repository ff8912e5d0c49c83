"""Witness assembly: AES trace pool -> column value matrix (port of
``circuit/witness.py``): one batched AES trace, encryption or
decryption, plus one gather per the precomputed witness map."""

from __future__ import annotations

import numpy as np
import torch

from halo2_aes_tpu_torch.circuit.ir import CompiledCircuit
from halo2_aes_tpu_torch.ops import aes
from halo2_aes_tpu_torch.utils import timers


def build_pool(key, plaintexts):
    """key uint8[16], plaintexts uint8[B,16] tensors -> int64 global
    witness pool on their device (a ``witness.build_pool`` span)."""
    with timers.span("witness.build_pool", blocks=int(plaintexts.shape[0])):
        ks_pool, rks = aes.expand_key(key)
        pools = aes.block_pool_batch(plaintexts, rks)
        return torch.cat([ks_pool, pools.reshape(-1)])


def build_dec_pool(key, ciphertexts):
    """Decryption witness pool (``models/aes128_dec.py`` layout): the
    same forward key expansion, then batched inverse-cipher traces."""
    ks_pool, rks = aes.expand_key(key)
    pools = aes.dec_block_pool_batch(ciphertexts, rks)
    return torch.cat([ks_pool, pools.reshape(-1)])


def _layout_tables(layout: CompiledCircuit, device):
    """(gather index, mapped mask, fixed values) of a compiled layout as
    int32 / bool tensors on ``device``, moved there once per device and
    kept on the layout (a layout is not changed after it is compiled):
    uploading the two (num_columns, n) arrays on every call costs more
    than the rest of a warm witness + check step."""
    cache = layout.meta.setdefault("_witness_tables_device", {})
    key = str(device)
    if key not in cache:
        wm = torch.as_tensor(np.asarray(layout.witness_map, dtype=np.int32),
                             device=device)
        cache[key] = (wm.clamp(min=0).reshape(-1), wm >= 0, torch.as_tensor(
            layout.fixed.astype(np.int32), device=device))
    return cache[key]


def assemble_values(layout: CompiledCircuit, pool):
    """-> int32 (num_columns, n) on the pool's device: advice values
    from the pool merged with the fixed-column values (a
    ``witness.assemble_values`` span of the layout's blocks)."""
    blocks = getattr(layout.meta.get("config"), "n_blocks", 0)
    with timers.span("witness.assemble_values", blocks=blocks):
        index, mapped, fixed = _layout_tables(layout, pool.device)
        advice = torch.where(mapped, pool[index].reshape(mapped.shape), 0)
        return (advice + fixed).to(torch.int32)
