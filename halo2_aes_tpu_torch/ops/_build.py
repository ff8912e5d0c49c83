"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> one .so, ctypes).

The library is compiled at first use from the package's own sources
into ``build/torch_kernels/<hash>/`` at the repository root, where the
hash covers every ``csrc`` file, so an edited kernel is rebuilt and an
unchanged one is loaded as is.  Each C entry point returns the
``cudaGetLastError()`` of its launch; ``check`` raises on a non-zero
code.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_U = ctypes.c_uint32
# entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # out, a, b, n, a_rows, b_rows, p[8] (host), n0inv, stream
    "mont_mul_launch": [_P, _P, _P, _I, _I, _I, _P, _U, _P],
    # out, x, tw, rows, lt, p[8] (host), n0inv, stream
    "ntt_pass_launch": [_P, _P, _P, _I, ctypes.c_int, _P, _U, _P],
    # x3, y3, z3, x1, y1, z1, x2, y2, z2, n, p[8] (host), n0inv, stream
    "curve_add_launch": [_P] * 9 + [_I, _P, _U, _P],
    # out, a, b, n, k, mask16, stream
    "mul_probe_launch": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, _P],
    # out, a, b, n, p as 16 16-bit limbs (host), -p^-1 mod 2^16, stream
    "mont_mul_planes16_launch": [_P, _P, _P, _I, _P, _U, _P],
    # out, a, b, n, p as 20 13-bit limbs (host), -p^-1 mod 2^13, stream
    "mont_mul_planes13_launch": [_P, _P, _P, _I, _P, _U, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[str, float, str]:
    """Compile the library if its hash directory lacks it.

    Returns (path, seconds spent compiling (0.0 when cached), nvcc log)."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib = os.path.join(out_dir, "libhalo2_kernels.so")
    log_path = os.path.join(out_dir, "nvcc.log")
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return lib, 0.0, log
    os.makedirs(out_dir, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *cu],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


@functools.lru_cache(maxsize=None)
def modulus_args(modulus: int):
    """(p as 8 little-endian u32 words in a ctypes array, -p^-1 mod 2^32)."""
    words = (ctypes.c_uint32 * 8)(*[(modulus >> (32 * i)) & 0xFFFFFFFF
                                    for i in range(8)])
    n0 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
    return words, n0


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
