"""Runtime sanitizers: limb-canonicity checks at the prover's phase
boundaries (port of ``utils/sanitize.py``).

With ``HALO2_SANITIZE=1`` the prover checks, at every phase boundary,
that the tensors it is about to commit are canonical field elements
(every 16 x 16-bit limb vector < the modulus).  A non-canonical limb
vector is the limb-arithmetic analog of a NaN: later Montgomery ops
wrap silently and the proof fails verification with no sign of where
the corruption happened.  Seeded proves are byte-reproducible (the
tests compare proof bytes across runs and across a crash and resume);
the sanitizer adds the data-side half.
"""

from __future__ import annotations

import os

import numpy as np

from halo2_aes_tpu_torch.ops import field as F


class SanitizeError(AssertionError):
    """A sanitizer invariant failed (non-canonical limbs, bad shape)."""


def enabled() -> bool:
    return os.environ.get("HALO2_SANITIZE") == "1"


def noncanonical_count(field_cls, arr) -> int:
    """Number of rows of ``arr`` (m, 16) (tensor on any device, or
    array) that are >= the modulus or exceed 16 bits in a limb.  Copies
    to the host (a debug tool, not a hot path)."""
    a = F.to_numpy(arr)
    if a.ndim != 2 or a.shape[1] != F.LIMBS:
        raise SanitizeError(f"expected (m, {F.LIMBS}) limbs, got {a.shape}")
    overflow = (a >> 16).any(axis=1)
    mod = np.asarray(F.int_to_limbs(field_cls.modulus), dtype=np.uint32)
    lt = np.zeros(a.shape[0], bool)
    gt = np.zeros(a.shape[0], bool)
    for i in range(F.LIMBS - 1, -1, -1):
        li, ri = a[:, i], mod[i]
        lt |= ~gt & (li < ri)
        gt |= ~lt & (li > ri)
    return int((~lt | overflow).sum())


def check_canonical(field_cls, arr, name: str) -> None:
    bad = noncanonical_count(field_cls, arr)
    if bad:
        raise SanitizeError(
            f"{name}: {bad} non-canonical limb vector(s) "
            f"(>= modulus or limb overflow)")


def check_phase(field_cls, name: str, **tensors) -> None:
    """Sanitize a prover phase's output tensors when HALO2_SANITIZE=1."""
    if not enabled():
        return
    for tname, t in tensors.items():
        if t is None or getattr(t, "shape", (0,))[0] == 0:
            continue
        check_canonical(field_cls, t, f"{name}.{tname}")
