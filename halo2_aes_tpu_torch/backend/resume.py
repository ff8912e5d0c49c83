"""Per-phase prove checkpoints: a crashed prove resumes at the first
incomplete phase (port of ``backend/resume.py``).

A k=20 prove can lose minutes of transforms and MSMs to one late
out-of-memory error, so each heavy phase's outputs (coefficient
tensors, commitment points and the blinding RNG's state) are saved, and
a rerun of ``prove(..., checkpoint_dir=...)`` replays the Fiat-Shamir
absorbs from the saved points and computes from the first incomplete
phase on.

The blake2b transcript state cannot be serialised, but every absorb is
a function of (vk digest, instances, saved commitment points), so
resume re-absorbs instead.  With a seeded RNG the state after each phase
is saved so resumed draws continue the same stream; with the default
CSPRNG (seed=None) later draws are simply fresh, which is sound: the
restored phases' blinding is fixed in their saved outputs.

Tensors are saved as CPU numpy uint32 limbs in the reference's file
format, and checkpoints key on the same bytes as the reference's (vk
digest, witness as uint32, instances, seed, multiopen, lookup order),
so a stale directory can never splice mismatched phases and the same
inputs name the same directory in either package.

On a mesh of more than one rank (parallel/comm.py) the directory is
one directory that every rank sees, as the reference's single
controller sees it, and it must exist when ``prove`` is called: a rank
that cannot see it raises before any collective, and a rank that sees
another directory than rank 0's fails the handshake, on every rank.
Every rank holds the same phase outputs (the sharded NTT and MSM end in
all-gathers), so rank 0 alone writes a phase and every rank passes a
barrier before going on; on resume rank 0 loads a phase and broadcasts
whether it is complete, so a half-written file cannot make ranks
diverge, and every rank then loads the same files and restores the same
RNG state.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from halo2_aes_tpu_torch.backend.transcript import point_from_bytes, point_to_bytes
from halo2_aes_tpu_torch.ops import field as F
from halo2_aes_tpu_torch.parallel import comm

# absorb/compute order of the checkpointable phases
PHASES = ("advice", "lookup", "products", "quotient")


class ProveCheckpoint:
    """One prove attempt's phase store under ``dir/prove_<key>/``; with
    a ``mesh`` of more than one rank, shared by its ranks (rank 0
    writes)."""

    def __init__(self, root: str, key_material: bytes, mesh=None):
        h = hashlib.blake2b(key_material, digest_size=12)
        self.dir = os.path.join(root, f"prove_{h.hexdigest()}")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is None:
            os.makedirs(self.dir, exist_ok=True)
            return
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"rank {self.mesh.rank}: checkpoint_dir {root!r} is not a "
                "directory this rank can see; on a mesh of more than one rank "
                "it must exist beforehand, one directory shared by every rank")
        self._handshake()

    def _handshake(self) -> None:
        """Rank 0 creates the store and a token file named by random
        bytes it broadcasts; every rank must find that file."""
        token = None
        if self.mesh.rank == 0:
            os.makedirs(self.dir, exist_ok=True)
            token = os.urandom(16)
            with open(os.path.join(self.dir, f".rank0_{token.hex()}"), "w"):
                pass
        token = comm.broadcast_bytes(self.mesh, token, 16)
        path = os.path.join(self.dir, f".rank0_{token.hex()}")
        blind = self._any_rank(not os.path.exists(path))
        if self.mesh.rank == 0:
            os.remove(path)
        if blind:
            raise RuntimeError(
                "checkpoint_dir is not one directory shared by every rank: "
                f"rank(s) {blind} cannot see the file rank 0 wrote there")

    def _any_rank(self, flag: bool) -> list:
        """The ranks whose ``flag`` is true, on every rank."""
        mine = torch.zeros(self.mesh.size, dtype=torch.int32,
                           device=self.mesh.device)
        mine[self.mesh.rank] = int(flag)
        return torch.nonzero(comm.all_reduce(self.mesh, mine)).flatten().tolist()

    def _paths(self, phase: str):
        return (os.path.join(self.dir, f"{phase}.npz"),
                os.path.join(self.dir, f"{phase}.json"))

    def load(self, phase: str):
        """(arrays: dict of numpy uint32, points, rng_state) or None.  A
        half-written checkpoint (a crash during save) loads as None: the
        .json marker is written last.  On a mesh, rank 0's load decides
        for every rank."""
        if self.mesh is None:
            return self._load(phase)
        mine = self._load(phase) if self.mesh.rank == 0 else None
        done = comm.broadcast_bytes(
            self.mesh, None if self.mesh.rank else bytes([mine is not None]), 1)
        if not done[0]:
            return None
        if self.mesh.rank:
            mine = self._load(phase)
        failed = self._any_rank(mine is None)
        if failed:
            raise RuntimeError(
                f"checkpoint phase {phase!r}: rank(s) {failed} cannot read "
                "what rank 0 wrote")
        return mine

    def _load(self, phase: str):
        npz_path, meta_path = self._paths(phase)
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            data = np.load(npz_path)
            arrays = {k: data[k] for k in data.files}
        except Exception:
            return None
        points = [point_from_bytes(bytes.fromhex(p)) for p in meta["points"]]
        return arrays, points, meta.get("rng_state")

    def save(self, phase: str, arrays: dict, points, rng=None) -> None:
        """Write a phase (on a mesh: rank 0 writes, every rank waits for
        it at a barrier)."""
        if self.mesh is None or self.mesh.rank == 0:
            self._save(phase, arrays, points, rng)
        if self.mesh is not None:
            comm.barrier(self.mesh)

    def _save(self, phase: str, arrays: dict, points, rng) -> None:
        npz_path, meta_path = self._paths(phase)
        np.savez(npz_path, **{k: F.to_numpy(v) for k, v in arrays.items()})
        meta = {
            "points": [point_to_bytes(p).hex() for p in points],
            "rng_state": _rng_state(rng),
        }
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)  # the marker lands atomically, last

    def clear(self) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            for phase in PHASES:
                for p in self._paths(phase):
                    if os.path.exists(p):
                        os.remove(p)
        if self.mesh is not None:
            comm.barrier(self.mesh)


def _rng_state(rng):
    if rng is None:
        return None
    st = rng.bit_generator.state
    # Generator state dicts hold ints, strs and lists: JSON-safe once the
    # (possibly uint64) state arrays are lists
    return json.loads(json.dumps(st, default=lambda o: o.tolist()))


def restore_rng(rng, state) -> None:
    if rng is not None and state is not None:
        rng.bit_generator.state = state


def prove_key_material(vk_digest: int, values, instances, seed,
                       multiopen: str, lookup_sort: str = "field") -> bytes:
    """The checkpoint key: ``values`` (a tensor on any device, or an
    array) is hashed as the uint32 matrix the reference hashes."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    values = np.ascontiguousarray(np.asarray(values).astype(np.uint32))
    h = hashlib.blake2b(b"halo2_aes_tpu prove ckpt v1", digest_size=32)
    h.update(int(vk_digest).to_bytes(32, "little"))
    h.update(values.tobytes())
    for vals in instances:
        h.update(b"i")
        for v in vals:
            h.update(int(v).to_bytes(8, "little"))
    h.update(repr(seed).encode())
    h.update(multiopen.encode())
    h.update(lookup_sort.encode())
    return h.digest()
