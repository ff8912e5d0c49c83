"""Distributed NTT by the four-step (Bailey) decomposition: the port of
``parallel/ntt.py``.

A length-n transform of ``count`` stacked polys is an (n1 x n2) matrix
per poly, x[j1*n2 + j2] at (j1, j2), with k1 = k // 2 (the reference's
split; the one-device ``ops/ntt.py`` takes ceil(k/2), and either is
exact).  The input is replicated on every rank, as in the prover.  Rank
r of P owns the column block j2 in [r*n2/P, (r+1)*n2/P):

  1. the optional coset shift, on the rank's block (K1 on a card);
  2. column NTTs of size n1 (``ops/ntt.ntt_many``: one K2 launch);
  3. the twiddle w^(k1*j2) (K1);
  4. ONE all-to-all, columns -> rows: rank r then owns rows k1 in
     [r*n1/P, (r+1)*n1/P) with every column;
  5. row NTTs of size n2 (one K2 launch);
  6. ONE all-gather of the row blocks and the transpose: every rank
     holds the whole result in natural order, X[k2*n1 + k1].  (The
     reference's result is replicated by XLA; here it is explicit.)

With j = j1*n2 + j2 and k = k2*n1 + k1,
  X[k] = sum_j2 w_n2^(j2 k2) (w^(j2 k1) sum_j1 w_n1^(j1 k1) x[j1*n2+j2]);
w^-1 and the sub-transforms' 1/n1, 1/n2 give the inverse.  Every block
handed to a transform is a fresh contiguous tensor (K2's second pass
writes in place), and the result equals ``ops/ntt.ntt_many`` bit for bit.
"""

from __future__ import annotations

import functools

import torch

from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops.ntt import Domain, domain, ntt_many
from halo2_aes_tpu_torch.parallel import comm

LIMBS = F.LIMBS


def _split(k: int) -> tuple:
    k1 = k // 2
    return 1 << k1, 1 << (k - k1)


def _twiddle_matrix(dom: Domain, n1: int, n2: int, inverse: bool, device):
    """(n1, n2, 16) table of w^(k1*j2), gathered from the powers of w."""
    full = dom.omega_powers(device, inverse=inverse)
    k1 = torch.arange(n1, dtype=torch.int64, device=full.device)[:, None]
    j2 = torch.arange(n2, dtype=torch.int64, device=full.device)[None, :]
    return full[k1 * j2]


@functools.lru_cache(maxsize=None)
def _twiddle_block(dom: Domain, rank: int, size: int, inverse: bool, device):
    """Rank's (n2/size, n1, 16) slice of the twiddle matrix, column-major
    like its column block."""
    n1, n2 = _split(dom.k)
    b2 = n2 // size
    tw = _twiddle_matrix(dom, n1, n2, inverse, device)
    return tw[:, rank * b2:(rank + 1) * b2].transpose(0, 1).contiguous()


def ntt_sharded_many(mesh: comm.Mesh, dom: Domain, flat, count: int,
                     inverse: bool = False, shift_pows=None):
    """Distributed NTT of ``count`` stacked polys: FLAT (count*n, 16),
    poly i at rows [i*n, (i+1)*n), the same on every rank of ``mesh``;
    ``shift_pows`` (n, 16) first multiplies every poly onto a coset.
    Returns the whole (count*n, 16) result on every rank.  The mesh size
    must divide both n1 and n2."""
    spec, k, n = dom.spec, dom.k, dom.n
    n1, n2 = _split(k)
    size, rank = mesh.size, mesh.rank
    if n1 % size or n2 % size:
        raise ValueError(f"a mesh of {size} does not divide the {n1} x {n2} "
                         f"matrix of a 2^{k} transform")
    if flat.shape != (count * n, LIMBS):
        raise ValueError(f"expected ({count * n}, {LIMBS}), got {tuple(flat.shape)}")
    b1, b2 = n1 // size, n2 // size
    cols = slice(rank * b2, (rank + 1) * b2)
    # 1-2. the rank's columns, one per row, (count, b2, n1); shift; NTT_n1
    x = flat.reshape(count, n1, n2, LIMBS)[:, :, cols].transpose(1, 2).contiguous()
    if shift_pows is not None:
        x = F.mont_mul(spec, x, shift_pows.reshape(n1, n2, LIMBS)[:, cols]
                       .transpose(0, 1))
    x = ntt_many(domain(spec, k // 2),
                 x.reshape(count * b2 * n1, LIMBS), count * b2, inverse=inverse)
    # 3. twiddle w^(k1*j2)
    x = F.mont_mul(spec, x.reshape(count, b2, n1, LIMBS),
                   _twiddle_block(dom, rank, size, inverse, x.device))
    # 4. all-to-all: row block q of every column goes to rank q
    send = x.reshape(count, b2, size, b1, LIMBS).permute(2, 0, 1, 3, 4)
    recv = comm.all_to_all(mesh, send.reshape(-1, LIMBS))
    # recv[s, c, j2', k1'] holds column s*b2 + j2', row rank*b1 + k1'
    rows = recv.reshape(size, count, b2, b1, LIMBS).permute(1, 3, 0, 2, 4)
    # 5. row NTTs of size n2 over (count, b1, n2)
    y = ntt_many(domain(spec, k - k // 2), rows.reshape(-1, LIMBS),
                 count * b1, inverse=inverse)
    # 6. all-gather (size, count, b1, n2) -> (count, n2, n1): X[k2*n1 + k1]
    g = comm.all_gather(mesh, y.reshape(count, b1, n2, LIMBS))
    return g.permute(1, 3, 0, 2, 4).reshape(count * n, LIMBS)


def ntt_sharded(mesh: comm.Mesh, dom: Domain, x, inverse: bool = False):
    """Distributed NTT of one poly x (n, 16)."""
    return ntt_sharded_many(mesh, dom, x, 1, inverse=inverse)
