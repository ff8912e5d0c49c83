"""The "weights" bridge: the reference's SRS arrays and proving-key fields
(numpy arrays plus host ints) -> this package's objects on a device.

The tests use it to feed both implementations the same key.
"""

from __future__ import annotations

import numpy as np
import torch

from halo2_aes_tpu_torch.backend.keygen import ProvingKey, VerifyingKey
from halo2_aes_tpu_torch.backend.permutation import PermutationAssembly
from halo2_aes_tpu_torch.backend.srs import SRS, _tag_from_host
from halo2_aes_tpu_torch.ops import field as F


def srs_from_numpy(k: int, g1_x, g1_y, g2, s_g2, device, g1_extra=None,
                   cache_dir=None, u_pt=None, w_pt=None) -> SRS:
    """(n, 16) uint32 affine Montgomery G1 powers + G2 ints -> SRS; an
    IPA basis brings its ``u_pt`` and ``w_pt`` (and its identity tag is
    then the IPA one)."""
    device = torch.device(device)
    srs = SRS(k, F.limbs(g1_x, device), F.limbs(g1_y, device), g2, s_g2,
              cache_dir=cache_dir, g1_extra=g1_extra, u_pt=u_pt, w_pt=w_pt)
    if u_pt is not None:
        object.__setattr__(srs, "_tag", _tag_from_host(
            np.asarray(g1_x), np.asarray(g1_y), ("ipa2", u_pt, w_pt)))
    return srs


def pk_from_numpy(layout, srs: SRS, *, ext_k: int, usable: int, fixed_ids,
                  fixed_commitments, sigma_commitments, fixed_coeffs: dict,
                  sigma_coeffs, perm_maps, l0, l_last, l_active) -> ProvingKey:
    """Reference pk fields as numpy (limb arrays uint32 (.., 16), maps
    int32 (m, n)) plus host-int commitments -> ProvingKey on the SRS's
    device.  The vk digest is recomputed from the same inputs."""
    dev = srs.device
    vk = VerifyingKey(layout.k, ext_k, usable, layout.cs, list(fixed_ids),
                      list(fixed_commitments), list(sigma_commitments),
                      g2=srs.g2, s_g2=srs.s_g2)
    vk.digest = vk._compute_digest()
    map_col, map_row = (np.asarray(m, dtype=np.int32) for m in perm_maps)
    return ProvingKey(
        vk=vk, srs=srs, layout=layout,
        assembly=PermutationAssembly(list(layout.cs.perm_columns), map_col,
                                     map_row),
        fixed_coeffs={c: F.limbs(v, dev) for c, v in fixed_coeffs.items()},
        sigma_coeffs=F.limbs(np.asarray(sigma_coeffs).reshape(-1, F.LIMBS), dev),
        perm_maps=tuple(torch.from_numpy(m.astype(np.int64)).to(dev)
                        for m in (map_col, map_row)),
        l0_coeffs=F.limbs(l0, dev), l_last_coeffs=F.limbs(l_last, dev),
        l_active_coeffs=F.limbs(l_active, dev))


def pk_to_numpy(pk: ProvingKey) -> dict:
    """The keyword arguments of ``pk_from_numpy`` from a port pk (host
    numpy), for round trips and comparisons with the reference."""
    vk = pk.vk
    return dict(
        ext_k=vk.ext_k, usable=vk.usable, fixed_ids=list(vk.fixed_ids),
        fixed_commitments=list(vk.fixed_commitments),
        sigma_commitments=list(vk.sigma_commitments),
        fixed_coeffs={c: F.to_numpy(v) for c, v in pk.fixed_coeffs.items()},
        sigma_coeffs=F.to_numpy(pk.sigma_coeffs),
        perm_maps=tuple(m.cpu().numpy().astype(np.int32) for m in pk.perm_maps),
        l0=F.to_numpy(pk.l0_coeffs), l_last=F.to_numpy(pk.l_last_coeffs),
        l_active=F.to_numpy(pk.l_active_coeffs))
