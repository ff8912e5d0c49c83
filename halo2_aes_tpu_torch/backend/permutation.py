"""Permutation (copy-constraint) argument: keygen cycles + grand products
(port of ``backend/permutation.py``).

Identity labels: cell (perm column i, row j) gets delta^i * omega^j,
with delta = g^(2^s), so labels are globally unique.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from halo2_aes_tpu_torch.ops import cuda_grand as CG
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.ntt import domain
from halo2_aes_tpu_torch.utils import timers

FR = F.FR


@functools.lru_cache(maxsize=None)
def delta() -> int:
    return pow(7, 1 << FR.two_adicity, FR.modulus)


@functools.lru_cache(maxsize=None)
def _label_tables(k: int, m: int, device):
    """(omega_pows (n,16), delta_pows (m,16)) Montgomery tables."""
    w = domain(FR, k).omega
    return (F.powers_table(FR, w, 1 << k, device),
            F.limbs(FR.host_powers(delta(), m), device))


@dataclass
class PermutationAssembly:
    """sigma mapping: for perm-column i, row j -> (col', row')."""

    perm_columns: list          # global column ids, order = delta exponent
    map_col: np.ndarray         # (m, n) int32
    map_row: np.ndarray         # (m, n) int32


def build_assembly(perm_columns, n: int, copy_pairs: np.ndarray) -> PermutationAssembly:
    """Union copy pairs into cycles; sigma = one cyclic rotation per class
    (host numpy, identical to the reference's)."""
    m = len(perm_columns)
    N = m * n
    if N == 0:
        z = np.zeros((0, n), dtype=np.int32)
        return PermutationAssembly(list(perm_columns), z, z)
    pairs = np.asarray(copy_pairs, dtype=np.int64).reshape(-1, 4)
    parent = np.arange(N, dtype=np.int64)

    if len(pairs):
        pos_lut = np.full(int(max(perm_columns)) + 1, -1, dtype=np.int64)
        for i, c in enumerate(perm_columns):
            pos_lut[c] = i
        ca, ra, cb, rb = pairs.T
        pa_, pb_ = pos_lut[ca], pos_lut[cb]
        assert (pa_ >= 0).all() and (pb_ >= 0).all(), (
            "copy pair references a column without equality enabled")
        a = pa_ * n + ra
        b = pb_ * n + rb

        while True:
            la, lb = parent[a], parent[b]
            lo, hi = np.minimum(la, lb), np.maximum(la, lb)
            np.minimum.at(parent, hi, lo)
            while True:
                nxt = parent[parent]
                if np.array_equal(nxt, parent):
                    break
                parent = nxt
            if np.array_equal(parent[a], parent[b]):
                break

    roots = parent
    order = np.argsort(roots, kind="stable")
    sr = roots[order]
    is_start = np.empty(N, dtype=bool)
    is_start[0] = True
    np.not_equal(sr[1:], sr[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    nxt_pos = np.arange(1, N + 1, dtype=np.int64)
    run_ends = np.concatenate([starts[1:] - 1, [N - 1]])
    nxt_pos[run_ends] = starts
    nxt = np.empty(N, dtype=np.int64)
    nxt[order] = order[nxt_pos]
    return PermutationAssembly(
        list(perm_columns),
        (nxt // n).astype(np.int32).reshape(m, n),
        (nxt % n).astype(np.int32).reshape(m, n),
    )


def grand_products(k: int, usable: int, chunk_len: int, all_fld,
                   perm_columns, map_col, map_row, omega_pows, delta_pows,
                   beta_m, gamma_m, blinding):
    """Chunked permutation grand-product columns, FLAT (chunks*n, 16):
    z_t[0] = z_{t-1}[usable] (chunk linking), z_0[0] = 1; rows past the
    blinding boundary take ``blinding`` (chunks, blind_rows, 16).  One
    K6 launch sequence a chunk on a CUDA tensor, its plain version on a
    CPU tensor (``ops/cuda_grand.py``); sigma's labels are gathered from
    the maps inside it, and chunk t reads its link from chunk t-1's
    column on the device.  One ``grand_products.perm`` span a chunk."""
    n = 1 << k
    m = len(perm_columns)
    chunks = -(-m // chunk_len)
    dev = all_fld.device
    table = CG.perm_table(beta_m, gamma_m, delta_pows)
    out = torch.empty((chunks * n, F.LIMBS), dtype=torch.int32, device=dev)
    init = F.const(FR, "one", dev)
    for t in range(chunks):
        cols = [(perm_columns[i], i)
                for i in range(t * chunk_len, min((t + 1) * chunk_len, m))]
        with timers.span("grand_products.perm", fused=int(dev.type == "cuda"),
                         rows=n, polys=len(cols), muls=4 * len(cols) + 4):
            CG.perm_z(all_fld, cols, map_col, map_row, omega_pows, table,
                      usable, init, blinding[t], out[t * n:(t + 1) * n])
        init = out[t * n + usable]
    return out


def grand_products_eager(k: int, usable: int, chunk_len: int, all_fld,
                         perm_columns, map_col, map_row, omega_pows, delta_pows,
                         beta_m, gamma_m, blinding):
    """``grand_products`` by the field's eager ops (sigma and the identity
    labels rebuilt, batch_inv, cumprod): the tests' reference for K6.
    Chunked permutation grand-product columns, FLAT (chunks*n, 16):
    z_t[0] = z_{t-1}[usable] (chunk linking), z_0[0] = 1; rows past the
    blinding boundary take ``blinding`` (chunks, blind_rows, 16)."""
    n = 1 << k
    m = len(perm_columns)
    chunks = -(-m // chunk_len)
    dev = all_fld.device
    one = F.const(FR, "one", dev)
    active = torch.arange(n, device=dev) < usable
    zs = []
    init = one
    for t in range(chunks):
        num_r = den_r = None
        for i in range(t * chunk_len, min((t + 1) * chunk_len, m)):
            v = all_fld[perm_columns[i] * n:(perm_columns[i] + 1) * n]
            sig = F.mont_mul(FR, delta_pows[map_col[i]], omega_pows[map_row[i]])
            idv = F.mont_mul(FR, delta_pows[i], omega_pows)
            num_i = F.add(FR, v, F.add(FR, F.mont_mul(FR, beta_m, idv), gamma_m))
            den_i = F.add(FR, v, F.add(FR, F.mont_mul(FR, beta_m, sig), gamma_m))
            num_r = num_i if num_r is None else F.mont_mul(FR, num_r, num_i)
            den_r = den_i if den_r is None else F.mont_mul(FR, den_r, den_i)
        row_ratio = F.mont_mul(FR, num_r, F.batch_inv(FR, den_r))
        row_ratio = F.select(active, row_ratio, one)
        cum = F.cumprod(FR, row_ratio)
        z = torch.cat([one[None], cum[:-1]])
        z = F.mont_mul(FR, z, init)
        init = F.mont_mul(FR, init, cum[usable - 1])
        z = torch.cat([z[:n - blinding.shape[1]], blinding[t]])
        zs.append(z)
    return torch.cat(zs)
