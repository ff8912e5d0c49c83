"""Witness assembly: AES trace pool -> column value matrix (port of
``circuit/witness.py``, encryption path): one batched AES trace plus
one gather per the precomputed witness map."""

from __future__ import annotations

import torch

from halo2_aes_tpu_torch.circuit.ir import CompiledCircuit
from halo2_aes_tpu_torch.ops import aes


def build_pool(key, plaintexts):
    """key uint8[16], plaintexts uint8[B,16] tensors -> int64 global
    witness pool on their device."""
    ks_pool, rks = aes.expand_key(key)
    pools = aes.block_pool_batch(plaintexts, rks)
    return torch.cat([ks_pool, pools.reshape(-1)])


def assemble_values(layout: CompiledCircuit, pool):
    """-> int32 (num_columns, n) on the pool's device: advice values
    from the pool merged with the fixed-column values."""
    dev = pool.device
    wm = torch.as_tensor(layout.witness_map, dtype=torch.int64, device=dev)
    gathered = pool[wm.clamp(min=0).reshape(-1)].reshape(wm.shape)
    advice = torch.where(wm >= 0, gathered, 0)
    fixed = torch.as_tensor(layout.fixed.astype("int64"), device=dev)
    return (advice + fixed).to(torch.int32)
