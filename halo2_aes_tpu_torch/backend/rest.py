"""Where idle proof state waits: on the card below ``HOST_REST_MIN_K``,
in pinned host memory from it.

A k = 23 proof's coefficient stacks (the pk's fixed, sigma and
selector polys, and the prove's advice, lookup, product and random
polys: 81 polys of 2^23 points, 43.5 GB) do not fit one 80 GB card
beside the stacks a phase works on.  None of them is read between the
phase that makes it and the quotient, and from the quotient on every
reader takes a few polys at a time (``prover._Phases.evals_sliced``,
the evaluations' stacks, ``shplonk_fold_large``).  So from the
threshold on each stack is copied to pinned host memory once it is made
(``park``: the pk's by ``ProvingKey``, the prove's by the prover), and
a reader copies back the polys it takes, when it takes them
(``prover._Phases.stack``).  Host memory is storage only: every
operation on the data runs on the card, and the bytes of a proof do not
depend on where its stacks waited.

Host rest is the k = 23 form only: a k = 22 proof keeps its stacks on
the card (AES-128 at 12,335 blocks peaks at 73.4 GB of the 85 GB card)
and fits by the forms the prover picks by size (its permuted lookup pairs
one lookup at a time, ``prover.streamed_pairs``).

A k = 23 prove allocates stacks of up to 43.5 GB among transients of
every size, and the caching allocator's fixed segments fragment: a
second prove in one process failed on an 18 GB stack with 23 GB free in
pieces.  The process that runs such proves starts with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` (the ``prove``
command line and ``scripts/torch_prove_steady.py`` from this k on,
``chip_smoke.py`` always).  The prover changes no allocator setting.
Below this threshold, from ``prover.RELEASE_CACHE_MIN_K`` (22), it
builds its tables before its first transient and empties the cache as
each prove starts and ends, which is what keeps a k = 22 process's
proves from fragmenting it; from the threshold on it does neither, and
expandable segments alone keep a process's k = 23 proves whole.

On a CPU device the stacks are in host memory already: ``park`` hands
the tensor back.  Tests lower the threshold to hold the parking path
against the golden proofs.
"""

from __future__ import annotations

import weakref

import torch

# from this k on, idle proof state rests in pinned host memory
HOST_REST_MIN_K = 23

# pinned bytes held by parked stacks now, and the most held since reset()
PINNED = {"bytes": 0, "peak_bytes": 0}


def on_host(k: int) -> bool:
    """Whether a k's idle stacks rest in host memory."""
    return k >= HOST_REST_MIN_K


def reset() -> None:
    """Restart the peak at what is held now."""
    PINNED["peak_bytes"] = PINNED["bytes"]


def _release(nbytes: int) -> None:
    PINNED["bytes"] -= nbytes


def park(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the card tensor ``t`` (a CPU tensor is
    returned as it is).  The copy is complete when ``park`` returns (the
    current stream is synchronised), so the host copy may be read on the
    host at once (a checkpoint, a canonicity check) and ``t`` freed."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    nbytes = host.numel() * host.element_size()
    PINNED["bytes"] += nbytes
    PINNED["peak_bytes"] = max(PINNED["peak_bytes"], PINNED["bytes"])
    weakref.finalize(host, _release, nbytes)
    return host
