"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> one .so, ctypes)
and the host C++ library beside them (``build_host``).

The library is compiled at first use from the package's own sources
into ``build/torch_kernels/<hash>/`` at the repository root (one nvcc
per ``.cu``, all started together, then one link), where the hash covers
every ``csrc`` file, so an edited kernel is rebuilt and an unchanged one
is loaded as is.  Each C entry point returns the
``cudaGetLastError()`` of its launch; ``check`` raises on a non-zero
code.  ``csrc/bn254_host.cpp`` (the verifier's G1 MSM and pairing
product: host C++, no device code) is built apart from the kernels, by
the host compiler, into a hash directory of its own beside them.
Nothing here runs at import time.
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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
_U = ctypes.c_uint32
# entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # out, a, b, n, a_rows, b_rows, p[8] (host), n0inv, stream
    "mont_mul_launch": [_P, _P, _P, _I, _I, _I, _P, _U, _P],
    # out, x, tw, mul_in | NULL, mul_out | NULL, mul_out_rows, count, k, lt,
    # log2 of the output stride, p[8] (host), n0inv, stream
    "ntt_fused_launch": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, _P, _U, _P],
    # x3, y3, z3, then per operand x, y, z, rows, inner, outer; n, p[8]
    # (host), n0inv, stream
    "curve_add_launch": [_P] * 3 + ([_P] * 3 + [_I] * 3) * 2 + [_I, _P, _U, _P],
    # level-1 x, y, z, level-2 x, y, z, level-0 x, y, z, groups, m, p[8]
    # (host), n0inv, stream
    "curve_fold2_launch": [_P] * 9 + [_I, _I, _P, _U, _P],
    # x3, y3, z3, x1, y1, z1, rows1, qx, qy, qz, index (int64), mask (u8),
    # one (16 limbs), n, p[8] (host), n0inv, stream
    "curve_add_masked_launch": [_P] * 6 + [_I] + [_P] * 6 + [_I, _P, _U, _P],
    # x3, y3, z3, x, y, z, n, times, p[8] (host), n0inv, stream
    "curve_double_launch": [_P] * 6 + [_I, ctypes.c_int, _P, _U, _P],
    # out, a, b, n, k, mask16, stream
    "mul_probe_launch": [_P, _P, _P, _I, ctypes.c_int, ctypes.c_int, _P],
    # out, a, b, n, p as 16 16-bit limbs (host), -p^-1 mod 2^16, stream
    "mont_mul_planes16_launch": [_P, _P, _P, _I, _P, _U, _P],
    # out, a, b, n, p as 20 13-bit limbs (host), -p^-1 mod 2^13, stream
    "mont_mul_planes13_launch": [_P, _P, _P, _I, _P, _U, _P],
    # out, x, packed B, offsets, masks, addend | NULL, groups, rows, limbs,
    # ksteps, tiles, tile limbs, limbs a column block, limbs, width (0: fold
    # only), addend limbs, stream
    "nibble_mma_launch": [_P] * 6 + [_I, _I] + [ctypes.c_int] * 8 + [_P],
    # out, static stack, dynamic stack, omega powers, code, instructions,
    # table, table rows, static polys, n, first row, rows, slots, threads,
    # p[8] (host), n0inv, stream
    "quotient_terms_launch": [_P] * 5 + [ctypes.c_int, _P, ctypes.c_int]
                             + [_I] * 4 + [ctypes.c_int] * 2 + [_P, _U, _P],
    # kind, out, scratch, four inputs, table, init, blinding, n, usable,
    # blinding rows, segments, chunk columns, their columns (int64, host),
    # their permutation columns (int32, host), p[8] (host), n0inv, R mod p
    # [8] (host), R^3 mod p [8] (host), stream
    "grand_product_launch": [ctypes.c_int] + [_P] * 9 + [_I] * 4
                            + [ctypes.c_int, _P, _P, _P, _U, _P, _P, _P],
    # digits (uint16), scalars, count*n, n, c, windows, stream
    "msm_digits_launch": [_P, _P, _I, _I, ctypes.c_int, ctypes.c_int, _P],
    # rows, starts, list1, scratch, digits, sets, rows a set, c, low bits,
    # pass-1 tiles, rows a tile, pass-2 tiles, places a tile, stream
    "msm_sort_launch": [_P] * 5 + [_I, _I] + [ctypes.c_int] * 3
                       + [_I, ctypes.c_int, _I, _P],
    # buckets x, y, z, first pieces x, y, z, last pieces x, y, z, rows,
    # starts, buckets, points x, points y, row stride, slice, threads, one
    # (16 limbs), p[8] (host), n0inv, stream
    "msm_accumulate_launch": [_P] * 11 + [_I, _P, _P, _I, _I, _I, _P, _P, _U, _P],
    # out: the accumulation threads the current card holds at once
    "msm_accumulate_threads": [_P],
    # out x, y, z, buckets x, y, z, one (16 limbs), sets, c, log2 of the
    # segments on both levels, p[8] (host), n0inv, stream
    "msm_reduce_launch": [_P] * 7 + [_I] + [ctypes.c_int] * 3 + [_P, _U, _P],
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
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
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
    # one nvcc per source, all started together, then one link
    obj_dir = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(obj_dir, os.path.basename(p)[:-3] + ".o") for p in cu]
    procs = [subprocess.Popen([_nvcc(), *COMPILE_FLAGS, "-I", CSRC, "-c", "-o", o, p],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for p, o in zip(cu, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [p for p, proc in zip(cu, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    shutil.rmtree(obj_dir)
    if failed:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
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


HOST_SOURCE = os.path.join(CSRC, "bn254_host.cpp")
HOST_FLAGS = ["-O2", "-shared", "-fPIC"]


def host_compiler() -> list[str] | None:
    """The command that compiles host C++: g++ or c++ where there is one,
    else nvcc driving its own host compiler; None where there is none."""
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return [path, *HOST_FLAGS]
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if os.path.exists(nvcc):
        return [nvcc, "-x", "c++", "-O2", "-shared", "-Xcompiler", "-fPIC"]
    return None


def build_host() -> str:
    """Compile ``HOST_SOURCE`` (host C++, no device code) if its hash
    directory lacks the library; returns the library's path.  A failed
    compile raises with the compiler's output."""
    cmd = host_compiler()
    if cmd is None:
        raise RuntimeError("no host C++ compiler (g++, c++ or nvcc) found")
    # the hash covers the source, the flags and the compiler's version, so a
    # library built by another toolchain is never loaded
    version = subprocess.run([cmd[0], "--version"], capture_output=True,
                             text=True).stdout
    with open(HOST_SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(cmd[1:]).encode()
                             + version.encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, "host_" + tag)
    lib = os.path.join(out_dir, "libbn254_host.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    run = subprocess.run([*cmd, "-o", tmp, HOST_SOURCE], capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed on {HOST_SOURCE}:\n"
                           f"{run.stdout}{run.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


# csrc/field.cuh's product drops the carries out of its accumulators' top
# words, which stay zero only for p below 2^254 (BN254's Fr and Fq are)
MODULUS_LIMIT = 1 << 254


@functools.lru_cache(maxsize=None)
def modulus_args(modulus: int):
    """(p as 8 little-endian u32 words in a ctypes array, -p^-1 mod 2^32);
    refuses a modulus from ``MODULUS_LIMIT`` on."""
    if not 0 < modulus < MODULUS_LIMIT or modulus % 2 == 0:
        raise ValueError(f"the kernels take an odd modulus below 2^254, not {modulus}")
    words = (ctypes.c_uint32 * 8)(*[(modulus >> (32 * i)) & 0xFFFFFFFF
                                    for i in range(8)])
    n0 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
    return words, n0


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
