"""Point- and table-sharded MSM with a collective reduce: the port of
``parallel/msm.py``.

Each rank runs the one-device windowed MSM (``ops/msm.py``: K3 on a
card) on its slice of the points AND of the SRS's 2^(cw)-shifted window
tables, so no rank pays the Horner doubling tail.  The partial sums (one
projective point per rank and commitment) are all-gathered and
tree-added on every rank (``msm._tree_add``): size-1 extra adds, and
the result is the same on every rank for the host transcript.

The window tables are window-major, (W*n, 32), so a rank's point range
is W strided row blocks: ``srs_shard`` copies the rank's points and
tables into contiguous tensors once per (SRS, mesh) and keeps them on
the SRS; ``commit`` and ``commit_many``, the prover's commitments, read
that copy.  ``msm_sharded`` and ``msm_many_sharded`` take whole,
replicated inputs, as the reference's does, and slice them per call.
"""

from __future__ import annotations

import torch

from halo2_aes_tpu_torch.ops import curve as CV
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.ops import msm as M
from halo2_aes_tpu_torch.parallel import comm

LIMBS = F.LIMBS


def _rows(n: int, mesh: comm.Mesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} points do not split over {mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard(mesh: comm.Mesh, points, tables=None) -> tuple:
    """This rank's (x, y, tables) slices as contiguous copies; tables
    (W*n, 32) -> (W*n/size, 32), window-major like the whole."""
    px, py = points
    rows = _rows(px.shape[0], mesh)
    local = None
    if tables is not None:
        local = tables.reshape(-1, px.shape[0], 2 * LIMBS)[:, rows].reshape(
            -1, 2 * LIMBS).contiguous()
    return px[rows].contiguous(), py[rows].contiguous(), local


def _reduce(mesh: comm.Mesh, part) -> tuple:
    """Tree-add every rank's projective partial sums (3 x (..., 16))."""
    gathered = comm.all_gather(mesh, torch.stack(part))
    return M._tree_add(tuple(gathered[:, i] for i in range(3)))


def msm_sharded(mesh: comm.Mesh, points, scalars, c: int | None = None,
                tables=None):
    """sum_i scalars[i] * points[i] over the mesh.  points (x, y) each
    (n, 16) and scalars (n, 16) PLAIN, the same on every rank, n
    divisible by the mesh size; ``tables`` the (W*n, 32) ``build_tables``
    output, which needs ``c``, the window it was built with (a rank's
    default window would differ from the whole's).  Returns the same
    projective point on every rank."""
    if tables is not None and c is None:
        raise ValueError("explicit window required with tables")
    px, py, local = shard(mesh, points, tables)
    rows = _rows(points[0].shape[0], mesh)
    return _reduce(mesh, M.msm((px, py), scalars[rows], c=c, tables=local))


def msm_many_sharded(mesh: comm.Mesh, points, scalars_flat, count: int,
                     c: int, tables):
    """``count`` MSMs over the same points in one pass of each rank's
    slice and ONE all-gather: scalars_flat FLAT (count*n, 16) PLAIN,
    commitment i at rows [i*n, (i+1)*n).  Returns a projective triple of
    (count, 16) tensors, the same on every rank."""
    px, py, local = shard(mesh, points, tables)
    n = points[0].shape[0]
    rows = _rows(n, mesh)
    scal = scalars_flat.reshape(count, n, LIMBS)[:, rows].reshape(-1, LIMBS)
    return _reduce(mesh, M.msm_many((px, py), scal, count, c, local))


def srs_shard(srs, mesh: comm.Mesh) -> tuple:
    """This rank's contiguous (x, y, tables) of ``srs``, copied once per
    mesh and kept on the SRS."""
    cache = getattr(srs, "_mesh_shards", None)
    if cache is None:
        cache = {}
        object.__setattr__(srs, "_mesh_shards", cache)
    if mesh not in cache:
        srs.warm_tables()
        cache[mesh] = shard(mesh, (srs.g1_x, srs.g1_y), srs._msm_tables)
    return cache[mesh]


def _local_scalars(srs, mesh: comm.Mesh, coeffs):
    """PLAIN scalars of this rank's rows of a coefficient poly (m <= n
    rows, Montgomery), zero past m."""
    rows = _rows(srs.n, mesh)
    part = coeffs[rows.start:min(rows.stop, coeffs.shape[0])]
    part = torch.nn.functional.pad(
        part, (0, 0, 0, rows.stop - rows.start - part.shape[0]))
    return F.from_mont(F.FR, part)


def commit(mesh: comm.Mesh, srs, coeffs) -> tuple:
    """KZG commitment of one coefficient poly over the mesh -> affine
    point (plain ints), the same on every rank."""
    px, py, tables = srs_shard(srs, mesh)
    part = M.msm((px, py), _local_scalars(srs, mesh, coeffs),
                 c=M.default_window(srs.n), tables=tables)
    return CV.to_affine_host(_reduce(mesh, part))[0]


def commit_many(mesh: comm.Mesh, srs, polys, batch: int) -> list:
    """Commitments of ``polys`` over the mesh, ``batch`` a pass: one
    ``msm_many`` of the rank's slice and one all-gather per group."""
    px, py, tables = srs_shard(srs, mesh)
    c = M.default_window(srs.n)
    out = []
    for lo in range(0, len(polys), batch):
        chunk = polys[lo:lo + batch]
        scal = torch.cat([_local_scalars(srs, mesh, p) for p in chunk])
        out += CV.to_affine_host(_reduce(
            mesh, M.msm_many((px, py), scal, len(chunk), c, tables)))
    return out
