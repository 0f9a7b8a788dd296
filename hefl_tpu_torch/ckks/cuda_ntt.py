"""Wrappers of the hand-written CUDA kernels K1-K4, and their plain versions.

The kernels live in `hefl_tpu_torch/csrc/ntt.cu` (see its header for the
design and the bounds). They replace the four TPU kernels of the encrypted
round in `hefl_tpu/ckks/pallas_ntt.py`:

    K1 ntt_forward   <- ntt_forward_pallas   (pallas_ntt.py:413)
    K2 ntt_inverse   <- ntt_inverse_pallas   (pallas_ntt.py:418)
    K3 encrypt_fused <- encrypt_fused_pallas (pallas_ntt.py:480)
    K4 decrypt_fused <- decrypt_fused_pallas (pallas_ntt.py:633)

Build: at first use on a CUDA tensor, nvcc compiles the source for sm_90a
into a shared library with a plain C interface under `hefl_tpu_torch/_build/`
(keyed by a hash of the source), loaded with ctypes. A failed build raises;
nothing falls back to the plain version.

Dispatch follows the tensor's device and nothing else: a CPU tensor goes to
the plain PyTorch version beside each wrapper, a CUDA tensor to the kernel
(or an exception). Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, so a run can show that its main path went through the
kernels (`reset_launch_counts` / `launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from hefl_tpu_torch.ckks.modular import add_mod, mont_mul
from hefl_tpu_torch.ckks.ntt import (
    NTTContext,
    _inverse_stages_plain,
    kernel_tables,
    ntt_forward_plain,
    ntt_inverse_plain,
    plain_tables,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SUPPORTED_N = (1024, 2048, 4096, 8192)

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0, "encrypt_fused": 0, "decrypt_fused": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ntt_forward": [_P] * 5 + [_I] * 3 + [_P],
    "ntt_inverse": [_P] * 7 + [_I] * 3 + [_P],
    "encrypt_fused": [_P] * 12 + [_I] * 3 + [_P],
    "decrypt_fused": [_P] * 10 + [_I] * 3 + [_P],
}
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build csrc/ntt.cu")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhefl_ntt_{digest[:16]}.so"


def build() -> Path:
    """Compile `csrc/ntt.cu` for sm_90a unless the hashed library exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(ctx: NTTContext, name: str, t: torch.Tensor, shape=None) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 residues, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dim() < 2 or t.shape[-2:] != (ctx.num_primes, ctx.n):
        raise ValueError(
            f"{name}: expected [..., {ctx.num_primes}, {ctx.n}], got {tuple(t.shape)}"
        )


def _is_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; False when all are on one CUDA
    device; raises on a mix or on another device type."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device type {dev.type!r}")
    return False


def _launch(ctx: NTTContext, name: str, device: torch.device, rows: int, *ptrs) -> None:
    if ctx.n not in SUPPORTED_N:
        raise ValueError(f"{name}: the kernel supports N in {SUPPORTED_N}, not {ctx.n}")
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, name)(*ptrs, rows, ctx.num_primes, ctx.logn, stream)
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {status})")
    LAUNCHES[name] += 1


# --- K1: forward NTT ---------------------------------------------------------


def ntt_forward(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Coefficient -> evaluation domain of int32[..., L, N] (K1 on CUDA)."""
    if _is_cpu(a):
        return ntt_forward_plain(ctx, a)
    _check(ctx, "ntt_forward", a)
    out = torch.empty_like(a)
    rows = a.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, a.device)
        _launch(ctx, "ntt_forward", a.device, rows, a.data_ptr(), out.data_ptr(),
                tabs.psi.data_ptr(), tabs.psi_shoup.data_ptr(), tabs.p.data_ptr())
    return out


# --- K2: inverse NTT ---------------------------------------------------------


def ntt_inverse(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Evaluation -> coefficient domain incl. N^-1 (K2 on CUDA)."""
    if _is_cpu(a):
        return ntt_inverse_plain(ctx, a)
    _check(ctx, "ntt_inverse", a)
    out = torch.empty_like(a)
    rows = a.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, a.device)
        _launch(ctx, "ntt_inverse", a.device, rows, a.data_ptr(), out.data_ptr(),
                tabs.psi_inv.data_ptr(), tabs.psi_inv_shoup.data_ptr(), tabs.p.data_ptr(),
                tabs.n_inv.data_ptr(), tabs.n_inv_shoup.data_ptr())
    return out


# --- K3: fused encrypt -------------------------------------------------------


def encrypt_fused_plain(ctx: NTTContext, m_res, u, e0, e1, b_mont, a_mont):
    """Plain version of K3 (any device): the JAX package's `_encrypt_core_xla`
    (hefl_tpu/ckks/ops.py:79) in int64 — four forward NTTs in one stacked
    call, then c0 = b*u + e0 + m and c1 = a*u + e1."""
    tabs = plain_tables(ctx, m_res.device)
    p, pinv = tabs.p, tabs.pinv_neg
    u_ev, e0_ev, e1_ev, m_ev = ntt_forward_plain(
        ctx, torch.stack([u, e0, e1, m_res])
    ).to(torch.int64)
    b64, a64 = b_mont.to(torch.int64), a_mont.to(torch.int64)
    c0 = add_mod(add_mod(mont_mul(u_ev, b64, p, pinv), e0_ev, p), m_ev, p)
    c1 = add_mod(mont_mul(u_ev, a64, p, pinv), e1_ev, p)
    return c0.to(torch.int32), c1.to(torch.int32)


def encrypt_fused(ctx: NTTContext, m_res, u, e0, e1, b_mont, a_mont):
    """Deterministic encrypt core: coefficient-domain m, u, e0, e1
    int32[..., L, N] and the Montgomery-form public key int32[L, N] ->
    evaluation-domain (c0, c1). One K3 launch over all rows on CUDA."""
    if _is_cpu(m_res, u, e0, e1, b_mont, a_mont):
        return encrypt_fused_plain(ctx, m_res, u, e0, e1, b_mont, a_mont)
    _check(ctx, "encrypt_fused(m)", m_res)
    for name, t in (("u", u), ("e0", e0), ("e1", e1)):
        _check(ctx, f"encrypt_fused({name})", t, m_res.shape)
    for name, t in (("b_mont", b_mont), ("a_mont", a_mont)):
        _check(ctx, f"encrypt_fused({name})", t, (ctx.num_primes, ctx.n))
    c0 = torch.empty_like(m_res)
    c1 = torch.empty_like(m_res)
    rows = m_res.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, m_res.device)
        _launch(ctx, "encrypt_fused", m_res.device, rows,
                m_res.data_ptr(), u.data_ptr(), e0.data_ptr(), e1.data_ptr(),
                b_mont.data_ptr(), a_mont.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                tabs.psi.data_ptr(), tabs.psi_shoup.data_ptr(), tabs.p.data_ptr(),
                tabs.pinv_neg.data_ptr())
    return c0, c1


# --- K4: fused decrypt -------------------------------------------------------


def decrypt_fused_plain(ctx: NTTContext, c0, c1, s_mont):
    """Plain version of K4 (any device): the XLA branch of the JAX package's
    `ops.decrypt` (hefl_tpu/ckks/ops.py:176-182) in int64."""
    tabs = plain_tables(ctx, c0.device)
    d = add_mod(
        c0.to(torch.int64),
        mont_mul(c1.to(torch.int64), s_mont.to(torch.int64), tabs.p, tabs.pinv_neg),
        tabs.p,
    )
    return _inverse_stages_plain(ctx, d).to(torch.int32)


def decrypt_fused(ctx: NTTContext, c0, c1, s_mont):
    """c0 + c1*s then the inverse NTT -> coefficient residues int32[..., L, N]
    (`s_mont`: the Montgomery-form secret key int32[L, N]). K4 on CUDA."""
    if _is_cpu(c0, c1, s_mont):
        return decrypt_fused_plain(ctx, c0, c1, s_mont)
    _check(ctx, "decrypt_fused(c0)", c0)
    _check(ctx, "decrypt_fused(c1)", c1, c0.shape)
    _check(ctx, "decrypt_fused(s_mont)", s_mont, (ctx.num_primes, ctx.n))
    out = torch.empty_like(c0)
    rows = c0.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, c0.device)
        _launch(ctx, "decrypt_fused", c0.device, rows,
                c0.data_ptr(), c1.data_ptr(), s_mont.data_ptr(), out.data_ptr(),
                tabs.psi_inv.data_ptr(), tabs.psi_inv_shoup.data_ptr(), tabs.p.data_ptr(),
                tabs.pinv_neg.data_ptr(), tabs.n_inv.data_ptr(), tabs.n_inv_shoup.data_ptr())
    return out
