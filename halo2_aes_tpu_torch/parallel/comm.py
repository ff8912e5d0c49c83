"""Process groups and the collectives of the multi-device prover.

PyTorch has no one-process program over several devices: a mesh here is
one process per rank, joined by ``torch.distributed``.  ``Mesh`` is the
value the sharded transforms, the sharded MSM and ``prove(mesh=...)``
take; ``init_mesh`` builds it.  Every tensor crossing ranks is int32
limbs (or bytes), in four collectives:

  all_to_all       equal row blocks, block j to rank j (the NTT's
                   columns -> rows exchange);
  all_gather       a stack of every rank's tensor (the NTT's output, the
                   MSM's partial sums, the dry run's witness pools);
  broadcast_bytes  bytes from rank 0 (the prover's blinding draws);
  all_reduce       an elementwise sum (the dry run's violation counts;
                   ``barrier`` and the checkpoints' rank flags).

With ``backend="nccl"`` they run on the CUDA tensors themselves.  With
``backend="gloo"`` a CUDA tensor is copied to host memory and back
around the collective, since gloo has no CUDA all-to-all; that staging
is what choosing gloo means, never a reaction to an NCCL error.  Asking
for NCCL where this PyTorch has none raises.

``CALLS`` and ``BYTES`` count, per collective, the calls this process
made and the payload bytes it handed in (the tensor each rank passes:
at world size P an all-to-all sends (P-1)/P of it to other ranks, an
all-gather sends all of it to each of P-1 ranks).  Callers reset them.

``RankProcesses`` starts one Python process per rank with a file store
for the rendezvous (no TCP port to race for); ``run_ranks`` also waits
for them.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXIS = "dp"
CALLS = {"all_to_all": 0, "all_gather": 0, "broadcast": 0, "all_reduce": 0}
BYTES = dict.fromkeys(CALLS, 0)


def reset_counts() -> None:
    for d in (CALLS, BYTES):
        for key in d:
            d[key] = 0


@dataclass(eq=False)
class Mesh:
    """One rank's view of a one-axis device mesh."""

    group: object            # the torch.distributed process group
    backend: str             # "nccl" or "gloo"
    rank: int
    size: int
    device: torch.device     # where this rank's tensors live
    axis: str = AXIS


def init_mesh(backend: str, rank: int, world_size: int, init_method: str,
              device, axis: str = AXIS, timeout: float = 120.0) -> Mesh:
    """Join the default process group and return this rank's ``Mesh``.
    ``timeout`` (seconds) bounds the rendezvous and every collective, so
    a rank that died fails the others instead of hanging them."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend='nccl' asked for, but this PyTorch has no "
                           "NCCL")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL meshes hold CUDA tensors")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return Mesh(dist.group.WORLD, backend, rank, world_size, device, axis)


def destroy_mesh(mesh: Mesh) -> None:
    dist.destroy_process_group(mesh.group)


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend is handed: gloo takes host memory."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" else x


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x (size*m, ...): row block j goes to rank j.  Returns the same
    shape: row block i is what rank i sent here."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
    src = _staged(mesh, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    CALLS["all_to_all"] += 1
    BYTES["all_to_all"] += src.numel() * src.element_size()
    return out.to(x.device)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in rank order, on every rank."""
    src = _staged(mesh, x)
    out = torch.empty(mesh.size * src.numel(), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src.reshape(-1), group=mesh.group)
    CALLS["all_gather"] += 1
    BYTES["all_gather"] += src.numel() * src.element_size()
    return out.reshape(mesh.size, *x.shape).to(x.device)


def broadcast_bytes(mesh: Mesh, data: bytes | None, nbytes: int) -> bytes:
    """Rank 0's ``data`` (``nbytes`` long) on every rank."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    if mesh.rank == 0:
        if len(data) != nbytes:
            raise ValueError(f"{len(data)} bytes, {nbytes} announced")
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, 0, group=mesh.group)
    CALLS["broadcast"] += 1
    BYTES["broadcast"] += nbytes
    return buf.cpu().numpy().tobytes()


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's x, on every rank."""
    buf = _staged(mesh, x).clone()
    dist.all_reduce(buf, group=mesh.group)
    CALLS["all_reduce"] += 1
    BYTES["all_reduce"] += buf.numel() * buf.element_size()
    return buf.to(x.device)


def barrier(mesh: Mesh) -> None:
    """Return once every rank has called it (an all-reduce of one int32,
    counted as one)."""
    all_reduce(mesh, torch.zeros(1, dtype=torch.int32, device=mesh.device))


class RankZeroRandom:
    """A byte source with ``numpy.random.Generator.bytes``'s interface:
    rank 0 draws from ``os.urandom`` and broadcasts, so every rank
    consumes the same CSPRNG bytes (ranks that blinded differently would
    exchange shards of different polynomials)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def bytes(self, nbytes: int) -> bytes:
        data = os.urandom(nbytes) if self.mesh.rank == 0 else None
        return broadcast_bytes(self.mesh, data, nbytes)


class RankProcesses:
    """``python -m <module_args...> --rank r --world-size N --init-method
    file://<store_dir>/store`` started for every rank at once, from the
    directory that holds the package; each rank's output goes to
    ``<store_dir>/rank<r>.log``."""

    def __init__(self, module_args, world_size: int, store_dir,
                 env: dict | None = None):
        self.dir = pathlib.Path(store_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        store = self.dir / "store"
        if store.exists():
            store.unlink()
        root = pathlib.Path(__file__).resolve().parents[2]
        self.procs = []
        for r in range(world_size):
            with open(self.dir / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", *module_args, "--rank", str(r),
                     "--world-size", str(world_size),
                     "--init-method", f"file://{store}"],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=root))

    def wait(self, timeout: float) -> list:
        """[(exit code, log text)] in rank order.  When a rank fails, or
        ``timeout`` seconds pass, the ranks still running are killed
        (those report -9, or 124 after the timeout)."""
        deadline = time.monotonic() + timeout
        rcs = [p.poll() for p in self.procs]
        while None in rcs and not any(rc not in (None, 0) for rc in rcs):
            if time.monotonic() > deadline:
                rcs = [124 if rc is None else rc for rc in rcs]
                break
            time.sleep(0.05)
            rcs = [p.poll() for p in self.procs]
        self.kill()
        return [(p.returncode if rc is None else rc,
                 (self.dir / f"rank{r}.log").read_text())
                for r, (p, rc) in enumerate(zip(self.procs, rcs))]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_ranks(module_args, world_size: int, store_dir, timeout: float,
              env: dict | None = None) -> list:
    """Start ``RankProcesses`` and wait for them."""
    return RankProcesses(module_args, world_size, store_dir, env).wait(timeout)
