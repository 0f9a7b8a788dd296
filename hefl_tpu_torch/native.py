"""The exact CRT decode in C++ (`csrc/crt.cpp`), loaded with ctypes.

Counterpart of `hefl_tpu.native`. The owner's final decode (`exact_final_decode`,
`decrypt_average(exact=True)`) and every slot decode of serving
(`encoding.decode_slots`) need the exact centred CRT value of each
coefficient; Python bignum arithmetic over an object array is the plain
version (`encoding.decode_exact_plain`), this library the fast one, equal
to it bit for bit.

Build: at first use `g++` compiles `csrc/crt.cpp` (with OpenMP where the
compiler has it) into `hefl_tpu_torch/_build/`, keyed by a hash of the
source and the flags. There is no fallback: a library that does not build
or load raises, and the caller gets the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "crt.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAX_PRIMES = 8

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """The library's path, keyed by the source's bytes and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libhefl_crt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/crt.cpp` unless the hashed library exists: with
    `-fopenmp` first, without it where the compiler has no OpenMP."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError(f"no C++ compiler (g++, c++) on PATH: cannot build {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        errors = []
        for extra in (("-fopenmp",), ()):
            proc = subprocess.run([gxx, *GXX_FLAGS, *extra, str(SOURCE), "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, so)
                return so
            errors.append(proc.stderr)
        raise RuntimeError(f"{gxx} failed building {SOURCE}:\n" + "\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.crt_decode_exact.restype = ctypes.c_int
            lib.crt_decode_exact.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


_ERRORS = {
    1: f"a shape or a prime count outside 1..{MAX_PRIMES}",
    2: "a prime outside [2, 2**31)",
    3: "a residue that is not canonical (>= its prime)",
}


def crt_decode_exact(residues: np.ndarray, primes, scale: float) -> np.ndarray:
    """Exact centred CRT decode: uint32 residues [..., L, N] -> float64
    [..., N], float(v) / scale of the centred value v in (-q/2, q/2]."""
    res = np.ascontiguousarray(residues, dtype=np.uint32)
    if res.ndim < 2:
        raise ValueError(f"residues must be [..., L, N], got shape {res.shape}")
    num_l, n = res.shape[-2], res.shape[-1]
    p = np.ascontiguousarray(np.asarray(primes).reshape(-1), dtype=np.uint32)
    if len(p) != num_l:
        raise ValueError(f"{len(p)} primes for residues of {num_l} limbs")
    outer = int(np.prod(res.shape[:-2], dtype=np.int64))
    out = np.empty(res.shape[:-2] + (n,), dtype=np.float64)
    rc = load_library().crt_decode_exact(res.ctypes.data, outer, num_l, n, p.ctypes.data,
                                         float(scale), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"crt_decode_exact: {_ERRORS.get(rc, f'status {rc}')}")
    return out
