"""The one traffic generator: a traffic mix is a JSON object of
parameters in ``benchmark/traffic/``, found by its name.

Every mix is a closed loop of one client: a request starts when the
previous one ends, and fills the configuration's blocks per proof.  The
generator knows no parameter yet (``PARAMS``), so the one mix,
``closed``, is the empty object; a later mix that needs one adds it
here and a file of its own.

Request i of a run with seed s draws its AES key, its plaintext blocks
and its blinding seed from ``numpy.random.default_rng([s, i])``; the
warm-up request is index WARMUP.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP = 1 << 40
PARAMS: set = set()


@dataclass
class Request:
    index: int
    key: np.ndarray          # uint8 (16,)
    pts: np.ndarray          # uint8 (blocks, 16)
    blind_seed: int


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        spec = json.load(f)
    if not isinstance(spec, dict) or set(spec) - PARAMS:
        raise ValueError(f"traffic {name!r}: parameters {sorted(spec)}, known {sorted(PARAMS)}")
    return spec


class Generator:
    def __init__(self, config: dict, seed: int):
        self.blocks = config["n_blocks"]
        self.seed = seed

    def request(self, i: int) -> Request:
        rng = np.random.default_rng([self.seed, i])
        key = rng.integers(0, 256, 16, dtype=np.uint8)
        pts = rng.integers(0, 256, (self.blocks, 16), dtype=np.uint8)
        return Request(i, key, pts, int(rng.integers(0, 1 << 62)))

    def checked_indices(self, done: int, count: int) -> list:
        """``count`` of the ``done`` completed requests, drawn from the
        seed, for the reference to judge."""
        rng = np.random.default_rng([self.seed, WARMUP + 1])
        k = min(count, done)
        return sorted(int(i) for i in rng.choice(done, size=k, replace=False)) if k else []
