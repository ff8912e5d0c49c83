"""Proving-backend registry (port of ``backend/__init__.py``).

Circuit code is written once against a small backend interface and the
backend is picked at run time by name.  Registered here:
"kzg-shplonk" (the default) and "kzg-gwc" (the same pipeline with the
plonk-style per-point multiopen).  The reference's third backend,
"ipa", is not ported yet (ROADMAP A12) and raises NotImplementedError.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

_REGISTRY: dict = {}


@dataclass(frozen=True)
class Backend:
    name: str
    setup_srs: Callable       # (k, device, **kw) -> SRS
    keygen: Callable          # (layout, srs, **kw) -> ProvingKey (.vk)
    prove: Callable           # (pk, values, instances=None, seed=None,
    #                           checkpoint_dir=None) -> bytes
    verify: Callable          # (vk, proof, instances=None) -> True or raises


def register(backend: Backend) -> None:
    _REGISTRY[backend.name] = backend


def get_backend(name: str = "kzg-shplonk") -> Backend:
    if name not in _REGISTRY:
        if name in ("kzg-shplonk", "kzg-gwc"):
            from halo2_aes_tpu_torch.backend import keygen as KG
            from halo2_aes_tpu_torch.backend import prover as PV
            from halo2_aes_tpu_torch.backend import srs as S
            from halo2_aes_tpu_torch.backend import verifier as VF

            engine = name.split("-", 1)[1]
            register(Backend(name, S.setup, KG.keygen_cached,
                             functools.partial(PV.prove, multiopen=engine),
                             functools.partial(VF.verify, multiopen=engine)))
        elif name == "ipa":
            raise NotImplementedError(
                "the IPA backend is not ported (ROADMAP A12)")
        else:
            raise KeyError(
                f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
