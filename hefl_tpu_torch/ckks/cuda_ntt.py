"""Wrappers of the hand-written CUDA kernels K1-K7, and their plain versions.

The kernels live in `hefl_tpu_torch/csrc/ntt.cu` (see its header for the
design and the bounds). They replace the TPU kernels of the encrypted round
and of encrypted-inference serving in `hefl_tpu/ckks/pallas_ntt.py`:

    K1 ntt_forward      <- ntt_forward_pallas       (pallas_ntt.py:413)
    K2 ntt_inverse      <- ntt_inverse_pallas       (pallas_ntt.py:418)
    K3 encrypt_fused    <- encrypt_fused_pallas     (pallas_ntt.py:480)
    K4 decrypt_fused    <- decrypt_fused_pallas     (pallas_ntt.py:633)
    K5 keyswitch_fused  <- keyswitch_fused_pallas   (pallas_ntt.py:527)
    K6 hoisted_products <- hoisted_rotations_pallas (pallas_ntt.py:701)
    K7 transcipher_fused <- transcipher_fused_pallas (pallas_ntt.py:423)

Build: at first use on a CUDA tensor, nvcc compiles the sources for sm_90a
into a shared library with a plain C interface under `hefl_tpu_torch/_build/`
(keyed by a hash of every file under `csrc/`), loaded with ctypes, and keeps
ptxas's report of every kernel's registers and spills beside it
(`ptxas_report_path`). A failed build raises; nothing falls back to the
plain version.

Dispatch follows the tensor's device and nothing else: a CPU tensor goes to
the plain PyTorch version beside each wrapper, a CUDA tensor to the kernel
(or an exception). Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel, so a run can show that its main path went through the
kernels (`reset_launch_counts` / `launch_counts`), and one to
`LAUNCH_ROWS[(name, rows, N)]`, where rows is the number of N-word rows of
the kernel's main input (B*L), so a run can show at which shapes it launched
them (`launch_rows`). K5 counts its evaluation-domain-input mode
(relinearization) under its own name, "keyswitch_fused_eval".

Host-side launch plans, plain functions the CPU tests pin: `ntt_plan` gives
the thread-block cluster size over which K1-K4 and K7 split each row;
`keyswitch_plan` gives K5's (its digit stage is K1's transform on B*R*L
rows, its eval-input inverse K2's on B*L rows) and refuses a gadget the
kernel cannot compute exactly; `hoisted_plan` gives K6's component split
and its lazy-reduction chunk, and refuses primes whose 64-bit lazy sums
the kernel cannot reduce exactly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from hefl_tpu_torch.ckks.encoding import encode_packed
from hefl_tpu_torch.ckks.modular import MASK32, add_mod, mont_mul, neg_mod, sub_mod
from hefl_tpu_torch.ckks.ntt import (
    NTTContext,
    _inverse_stages_plain,
    kernel_tables,
    ntt_forward_plain,
    ntt_inverse_plain,
    plain_tables,
)
from hefl_tpu_torch.ckks.primes import host_to_mont

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Ring sizes the kernels take: every power of two from 256 to 16384. Smaller
# rings (the JAX package's math tests at n = 32..128; no configuration of
# either package) are refused by name.
SUPPORTED_N = (256, 512, 1024, 2048, 4096, 8192, 16384)
# The smallest cluster a row of N words may take, where it is more than 1:
# at N = 16384 one block a row would need 2048 threads, over the card's 1024.
MIN_CLUSTER = {16384: 2}

LAUNCHES = {
    "ntt_forward": 0, "ntt_inverse": 0, "encrypt_fused": 0, "decrypt_fused": 0,
    "keyswitch_fused": 0, "keyswitch_fused_eval": 0, "hoisted_products": 0,
    "transcipher_fused": 0,
}
LAUNCH_ROWS: dict[tuple[str, int, int], int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ntt_forward": [_P] * 5 + [_I] * 4 + [_P],
    "ntt_inverse": [_P] * 7 + [_I] * 4 + [_P],
    "encrypt_fused": [_P] * 12 + [_I] * 4 + [_P],
    "decrypt_fused": [_P] * 10 + [_I] * 4 + [_P],
    "keyswitch_fused": [_P] * 15 + [_I] * 8 + [_P],
    "hoisted_products": [_P] * 8 + [_I] * 7 + [_P],
    "transcipher_fused": [_P] * 12 + [_I] * 4 + [_P],
}
_lib = None
# The H100 SXM's streaming multiprocessors: ntt_plan's default without a card.
DEFAULT_SM_COUNT = 132
_sm_count = None


def reset_launch_counts() -> None:
    """Zero LAUNCHES and empty LAUNCH_ROWS."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_ROWS.clear()


def launch_counts() -> dict:
    return dict(LAUNCHES)


def launch_rows() -> dict:
    """{(name, rows, N): launches} since the last reset: rows of a launch's
    main input ([B*L] residue rows; K6 its S*B*L output rows, so a sweep
    and its one-step twin are told apart)."""
    return dict(LAUNCH_ROWS)


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
    """The library's path, keyed by the bytes of every file under `csrc/`
    (sources and headers) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(f.relative_to(CSRC).as_posix().encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libhefl_ntt_{h.hexdigest()[:16]}.so"


def ptxas_report_path() -> Path:
    """ptxas's `-v` report of the library's build: registers, shared memory
    and spills of every kernel (written beside the library by `build`)."""
    return library_path().with_suffix(".ptxas.txt")


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
        ptxas_report_path().write_text(proc.stderr)
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


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """K2's body (K2, K4, and K5 with evaluation-domain input) loads its
    input rows as 16-byte vectors, K3's epilogue its key rows, K7's epilogue
    its pad rows, K5's inner product its key rows, and K6 all its inputs."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel loads rows as 16-byte vectors; the tensor's "
                         "data is not 16-byte aligned")


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


def _launch(ctx: NTTContext, name: str, device: torch.device, *args, rows: int,
            count: str | None = None) -> None:
    """Call the library's `name` with `args` and the current stream; raise on
    a non-zero status, else add one to LAUNCHES[count or name] and to
    LAUNCH_ROWS[(count or name, rows, N)]."""
    if ctx.n not in SUPPORTED_N:
        raise ValueError(f"{name}: the kernel supports N in {SUPPORTED_N}, not {ctx.n}")
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, name)(*args, stream)
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {status})")
    key = count or name
    LAUNCHES[key] += 1
    LAUNCH_ROWS[(key, rows, ctx.n)] = LAUNCH_ROWS.get((key, rows, ctx.n), 0) + 1


# --- K1 and K2: forward and inverse NTT --------------------------------------


def _sms(sms: int | None) -> int:
    """`sms`, or the SM count of the current CUDA device (read once),
    DEFAULT_SM_COUNT without one."""
    global _sm_count
    if sms is not None:
        return sms
    if _sm_count is None:
        _sm_count = (torch.cuda.get_device_properties(torch.cuda.current_device())
                     .multi_processor_count if torch.cuda.is_available() else DEFAULT_SM_COUNT)
    return _sm_count


def ntt_plan(rows: int, n: int, sms: int | None = None) -> int:
    """Cluster size C of K1-K4 and K7 on `rows` rows of N words: each row is
    split over C thread blocks. Below N = 1024, 1: a row is one block of N/8
    threads (one warp at N = 256) and a cluster would cut it finer than the
    kernel's 32-word padded segments. Otherwise the largest C in (1, 2, 4,
    8) with rows * C <= the card's SM count, so that few rows still spread
    over the SMs; 1 from half the SM count of rows up (66 on an H100), where
    one block per row already fills the card; never below MIN_CLUSTER[N]
    (2 at N = 16384). `sms`: the SM count, by default read once from the
    current CUDA device, DEFAULT_SM_COUNT without one."""
    if n not in SUPPORTED_N:
        raise ValueError(f"the NTT kernels support N in {SUPPORTED_N}, not {n}")
    if n < 1024:
        return 1
    sms = _sms(sms)
    c = 8
    if 2 * rows >= sms:
        c = 1
    while c > 1 and rows * c > sms:
        c //= 2
    return max(c, MIN_CLUSTER.get(n, 1))


def _ntt_launch(ctx: NTTContext, name: str, a: torch.Tensor, *tables: torch.Tensor) -> torch.Tensor:
    """Launch K1 ("ntt_forward") or K2 ("ntt_inverse") on every row of `a`
    with the tables' pointers and ntt_plan's cluster size."""
    _check(ctx, name, a)
    out = torch.empty_like(a)
    rows = a.numel() // ctx.n
    if rows:
        _launch(ctx, name, a.device, a.data_ptr(), out.data_ptr(),
                *(t.data_ptr() for t in tables), rows, ctx.num_primes, ctx.logn,
                ntt_plan(rows, ctx.n), rows=rows)
    return out


def ntt_forward(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Coefficient -> evaluation domain of int32[..., L, N] (K1 on CUDA)."""
    if _is_cpu(a):
        return ntt_forward_plain(ctx, a)
    tabs = kernel_tables(ctx, a.device)
    return _ntt_launch(ctx, "ntt_forward", a, tabs.psi, tabs.psi_shoup, tabs.p)


def ntt_inverse(ctx: NTTContext, a: torch.Tensor) -> torch.Tensor:
    """Evaluation -> coefficient domain incl. N^-1 (K2 on CUDA)."""
    if _is_cpu(a):
        return ntt_inverse_plain(ctx, a)
    _check_aligned("ntt_inverse", a)
    tabs = kernel_tables(ctx, a.device)
    return _ntt_launch(ctx, "ntt_inverse", a, tabs.psi_inv, tabs.psi_inv_shoup, tabs.p,
                       tabs.n_inv, tabs.n_inv_shoup)


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
    evaluation-domain (c0, c1). One K3 launch over all rows on CUDA, at
    `ntt_plan`'s cluster size: three forward transforms a row (u, e0 + m,
    e1), bitwise the plain version's four. The key rows must be 16-byte
    aligned."""
    if _is_cpu(m_res, u, e0, e1, b_mont, a_mont):
        return encrypt_fused_plain(ctx, m_res, u, e0, e1, b_mont, a_mont)
    _check(ctx, "encrypt_fused(m)", m_res)
    for name, t in (("u", u), ("e0", e0), ("e1", e1)):
        _check(ctx, f"encrypt_fused({name})", t, m_res.shape)
    for name, t in (("b_mont", b_mont), ("a_mont", a_mont)):
        _check(ctx, f"encrypt_fused({name})", t, (ctx.num_primes, ctx.n))
        _check_aligned(f"encrypt_fused({name})", t)
    c0 = torch.empty_like(m_res)
    c1 = torch.empty_like(m_res)
    rows = m_res.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, m_res.device)
        _launch(ctx, "encrypt_fused", m_res.device,
                m_res.data_ptr(), u.data_ptr(), e0.data_ptr(), e1.data_ptr(),
                b_mont.data_ptr(), a_mont.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                tabs.psi.data_ptr(), tabs.psi_shoup.data_ptr(), tabs.p.data_ptr(),
                tabs.pinv_neg.data_ptr(), rows, ctx.num_primes, ctx.logn,
                ntt_plan(rows, ctx.n), rows=rows)
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
    (`s_mont`: the Montgomery-form secret key int32[L, N]). One K4 launch on
    CUDA, at `ntt_plan`'s cluster size; c0, c1 and s_mont must be 16-byte
    aligned."""
    if _is_cpu(c0, c1, s_mont):
        return decrypt_fused_plain(ctx, c0, c1, s_mont)
    _check(ctx, "decrypt_fused(c0)", c0)
    _check(ctx, "decrypt_fused(c1)", c1, c0.shape)
    _check(ctx, "decrypt_fused(s_mont)", s_mont, (ctx.num_primes, ctx.n))
    for name, t in (("c0", c0), ("c1", c1), ("s_mont", s_mont)):
        _check_aligned(f"decrypt_fused({name})", t)
    out = torch.empty_like(c0)
    rows = c0.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, c0.device)
        _launch(ctx, "decrypt_fused", c0.device,
                c0.data_ptr(), c1.data_ptr(), s_mont.data_ptr(), out.data_ptr(),
                tabs.psi_inv.data_ptr(), tabs.psi_inv_shoup.data_ptr(), tabs.p.data_ptr(),
                tabs.pinv_neg.data_ptr(), tabs.n_inv.data_ptr(), tabs.n_inv_shoup.data_ptr(),
                rows, ctx.num_primes, ctx.logn, ntt_plan(rows, ctx.n), rows=rows)
    return out


# --- K5: fused gadget key-switch ---------------------------------------------


def gadget_digits(coeff: torch.Tensor, digit_bits: int, num_digits: int) -> torch.Tensor:
    """Base-2**w digits of every limb, lifted to every prime: int64
    [..., L, N] -> [..., L*d, L, N] (component c = limb*d + k)."""
    mask = (1 << digit_bits) - 1
    c64 = coeff.to(torch.int64)
    digits = torch.stack([(c64 >> (digit_bits * k)) & mask for k in range(num_digits)], dim=-2)
    *batch, num_l, _, n = digits.shape
    comp = digits.reshape(*batch, num_l * num_digits, n)
    return comp[..., :, None, :].expand(*batch, num_l * num_digits, num_l, n)


def keyswitch_fused_plain(ctx: NTTContext, x, b_mont, a_mont, digit_bits: int,
                          num_digits: int, eval_input: bool = False):
    """Plain version of K5 (any device): the JAX package's
    `ops._keyswitch_coeff_xla` (hefl_tpu/ckks/ops.py:243), preceded by the
    inverse NTT when `eval_input` (its `_keyswitch_d2`), in int64. Centered
    digits d - 2**(w-1) under every output prime, forward NTT, Montgomery
    inner product with the [C, L, N] key rows, plus the correction row."""
    tabs = plain_tables(ctx, x.device)
    p, pinv = tabs.p, tabs.pinv_neg
    coeff = ntt_inverse_plain(ctx, x) if eval_input else x
    lifted = sub_mod(gadget_digits(coeff, digit_bits, num_digits), 1 << (digit_bits - 1), p)
    d_eval = ntt_forward_plain(ctx, lifted.to(torch.int32)).to(torch.int64)
    num_r = d_eval.shape[-3]
    accs = []
    for key in (b_mont, a_mont):
        k64 = key.to(torch.int64)
        acc = mont_mul(1, k64[num_r], p, pinv).expand(d_eval.shape[:-3] + k64.shape[1:])
        for c in range(num_r):
            acc = add_mod(acc, mont_mul(d_eval[..., c, :, :], k64[c], p, pinv), p)
        accs.append(acc.to(torch.int32))
    return accs[0], accs[1]


@dataclasses.dataclass(frozen=True)
class KeyswitchPlan:
    """K5's launch geometry: the digit stage transforms digit_rows = B*R*L
    rows (R = L*d gadget components) split over digit_cluster blocks each;
    with evaluation-domain input, the inverse first transforms
    inverse_rows = B*L rows over inverse_cluster blocks each."""

    digit_rows: int
    digit_cluster: int
    inverse_rows: int
    inverse_cluster: int


def keyswitch_plan(batch: int, primes, num_digits: int, digit_bits: int, n: int,
                   sms: int | None = None) -> KeyswitchPlan:
    """K5's plan for `batch` ciphertexts over `primes` (the L primes of the
    ring) with a base-2**digit_bits gadget of num_digits digits: both
    cluster sizes from `ntt_plan` (`sms` as there). Refuses, with
    ValueError, a geometry whose words the kernel cannot compute exactly:
    a digit shifted by 32 bits or more; a digit or its centre 2**(w-1) that
    is not a canonical residue of every prime (2**w > p); a prime of 2**31
    or more, where add_mod and the Montgomery product leave 32 bits."""
    primes = [int(p) for p in primes]
    if batch < 1 or not primes:
        raise ValueError(f"K5 needs a batch and primes, got batch {batch}, {len(primes)} primes")
    if num_digits < 1 or not 1 <= digit_bits <= 31 or digit_bits * (num_digits - 1) > 31:
        raise ValueError(f"K5 cannot cut {num_digits} digits of {digit_bits} bits from a 32-bit "
                         "word: the last digit's shift must stay below 32")
    if (1 << digit_bits) > min(primes):
        raise ValueError(f"K5's digits of {digit_bits} bits are not canonical residues of the "
                         f"prime {min(primes)}")
    if max(primes) >= 1 << 31:
        raise ValueError(f"K5's modular arithmetic needs primes below 2**31, got {max(primes)}")
    rows = batch * len(primes)
    digit_rows = rows * len(primes) * num_digits
    return KeyswitchPlan(digit_rows, ntt_plan(digit_rows, n, sms), rows, ntt_plan(rows, n, sms))


def keyswitch_fused(ctx: NTTContext, x, b_mont, a_mont, digit_bits: int, num_digits: int,
                    eval_input: bool = False):
    """Gadget key-switch of x int32[..., L, N] (coefficient domain, or
    evaluation domain with `eval_input`) with the key rows int32[C, L, N],
    C = L*num_digits + 1 -> evaluation-domain (c0, c1) [..., L, N]. One K5
    call on CUDA (counted under "keyswitch_fused_eval" with `eval_input`):
    the inverse NTT when `eval_input` and the digit stage under
    `keyswitch_plan`'s cluster sizes, then the inner product. The key rows
    (and x with `eval_input`) must be 16-byte aligned."""
    if _is_cpu(x, b_mont, a_mont):
        return keyswitch_fused_plain(ctx, x, b_mont, a_mont, digit_bits, num_digits, eval_input)
    num_l = ctx.num_primes
    num_c = num_l * num_digits + 1
    _check(ctx, "keyswitch_fused(x)", x)
    _check(ctx, "keyswitch_fused(b_mont)", b_mont, (num_c, num_l, ctx.n))
    _check(ctx, "keyswitch_fused(a_mont)", a_mont, (num_c, num_l, ctx.n))
    _check_aligned("keyswitch_fused(b_mont)", b_mont)
    _check_aligned("keyswitch_fused(a_mont)", a_mont)
    if eval_input:
        _check_aligned("keyswitch_fused(x)", x)
    c0 = torch.empty_like(x)
    c1 = torch.empty_like(x)
    batch = x.numel() // (num_l * ctx.n)
    if batch:
        plan = keyswitch_plan(batch, ctx.p[:, 0], num_digits, digit_bits, ctx.n)
        tabs = kernel_tables(ctx, x.device)
        coeff = torch.empty_like(x) if eval_input else x
        digits = torch.empty((batch, num_c - 1, num_l, ctx.n), dtype=torch.int32, device=x.device)
        _launch(ctx, "keyswitch_fused", x.device,
                x.data_ptr(), coeff.data_ptr(), digits.data_ptr(), b_mont.data_ptr(),
                a_mont.data_ptr(), c0.data_ptr(), c1.data_ptr(), tabs.psi.data_ptr(),
                tabs.psi_shoup.data_ptr(), tabs.psi_inv.data_ptr(), tabs.psi_inv_shoup.data_ptr(),
                tabs.p.data_ptr(), tabs.pinv_neg.data_ptr(), tabs.n_inv.data_ptr(),
                tabs.n_inv_shoup.data_ptr(), batch, num_l, num_digits, digit_bits,
                int(eval_input), ctx.logn, plan.digit_cluster, plan.inverse_cluster,
                rows=batch * num_l,
                count="keyswitch_fused_eval" if eval_input else "keyswitch_fused")
    return c0, c1


# --- K6: hoisted-rotation products -------------------------------------------


def hoisted_products_plain(ctx: NTTContext, c0, d_eval, b_mont, a_mont):
    """Plain version of K6 (any device): the JAX package's
    `ops._hoisted_products_xla` (hefl_tpu/ckks/ops.py:484) in int64 —
    acc0[s] = c0 + sum_c D_c * B'[s, c], acc1[s] = sum_c D_c * A'[s, c]."""
    tabs = plain_tables(ctx, c0.device)
    p, pinv = tabs.p, tabs.pinv_neg
    num_s, num_r = b_mont.shape[0], b_mont.shape[1]
    batch = tuple(c0.shape[:-2])
    out_shape = (num_s,) + batch + tuple(c0.shape[-2:])
    kshape = (num_s,) + (1,) * len(batch) + tuple(b_mont.shape[2:])
    d64 = d_eval.to(torch.int64)
    accs = []
    for key in (b_mont, a_mont):
        k64 = key.to(torch.int64)
        acc = torch.zeros(out_shape, dtype=torch.int64, device=c0.device)
        for c in range(num_r):
            acc = add_mod(acc, mont_mul(d64[..., c, :, :], k64[:, c].reshape(kshape), p, pinv), p)
        accs.append(acc)
    return add_mod(accs[0], c0.to(torch.int64), p).to(torch.int32), accs[1].to(torch.int32)


HOIST_SPLITS = (1, 2, 4, 8)
# Threads a SM that K6 keeps resident: 4 blocks of ntt.cu's kHoistThreads
# = 256 (the kernel takes at most 64 registers a thread).
HOIST_THREADS_PER_SM = 1024


def lazy_terms(primes) -> int:
    """K: the most raw products d*k of canonical residues (each at most
    (p-1)**2) whose sum stays below p * 2**32 under every prime, so one
    Montgomery REDC reduces it exactly: min over p of
    floor((p * 2**32 - 1) / (p - 1)**2), 32 at 27-bit primes."""
    return min(((int(p) << 32) - 1) // (int(p) - 1) ** 2 for p in primes)


@dataclasses.dataclass(frozen=True)
class HoistedPlan:
    """K6's launch geometry: `split` threads (Q) share one 4-word group's
    components; each 64-bit lazy sum covers at most `chunk` components (a
    multiple of Q, at most `terms` = lazy_terms of the primes) before its
    REDC."""

    split: int
    chunk: int
    terms: int


def hoisted_plan(num_s: int, batch: int, num_r: int, primes, n: int, sms: int | None = None,
                 split: int | None = None) -> HoistedPlan:
    """K6's plan for S = num_s steps, `batch` ciphertexts and R = num_r
    shared digits over `primes` (the L primes of the ring). Q is the largest
    of (1, 2, 4, 8) whose S*B*L*N/4 groups x Q threads still fit the card in
    one wave (HOIST_THREADS_PER_SM on each of `sms` SMs, as in `ntt_plan`),
    at most R and at most K; `split` overrides it (timing sweeps, the card
    tests). Refuses, with ValueError, an empty geometry, an unsupported
    ring, and a prime of 2**31 or more (or below 3), whose sums REDC cannot
    reduce exactly."""
    primes = [int(p) for p in primes]
    if num_s < 1 or batch < 1 or num_r < 1 or not primes:
        raise ValueError(f"K6 needs steps, a batch, digits and primes, got S={num_s}, "
                         f"B={batch}, R={num_r}, {len(primes)} primes")
    if n not in SUPPORTED_N:
        raise ValueError(f"K6 supports N in {SUPPORTED_N}, not {n}")
    if max(primes) >= 1 << 31 or min(primes) < 3:
        raise ValueError(f"K6's lazy Montgomery sums need primes in [3, 2**31), got {primes}")
    terms = lazy_terms(primes)
    if split is None:
        threads = num_s * batch * len(primes) * n // 4
        room = _sms(sms) * HOIST_THREADS_PER_SM
        split = max([q for q in HOIST_SPLITS if threads * q <= room and q <= num_r
                     and q <= terms], default=1)
    elif split not in HOIST_SPLITS or split > terms:
        raise ValueError(f"K6's split must be one of {HOIST_SPLITS} and at most K={terms}, "
                         f"got {split}")
    return HoistedPlan(split, split * (terms // split), terms)


def hoisted_products(ctx: NTTContext, c0, d_eval, b_mont, a_mont,
                     plan: HoistedPlan | None = None):
    """The hoisted sweep's inner products: c0 int32[..., L, N], shared digits
    d_eval int32[..., R, L, N], pre-permuted keys int32[S, R, L, N] ->
    (acc0, acc1) int32[S, ..., L, N] before the per-step permutation. One K6
    launch on CUDA under `plan` (default: `hoisted_plan`'s for the shapes);
    S = 0 gives empty tensors and no launch. c0, d_eval and both keys must
    be 16-byte aligned."""
    if _is_cpu(c0, d_eval, b_mont, a_mont):
        return hoisted_products_plain(ctx, c0, d_eval, b_mont, a_mont)
    num_s, num_r = b_mont.shape[0], b_mont.shape[1]
    batch = tuple(c0.shape[:-2])
    _check(ctx, "hoisted_products(c0)", c0)
    _check(ctx, "hoisted_products(d_eval)", d_eval, batch + (num_r, ctx.num_primes, ctx.n))
    _check(ctx, "hoisted_products(b_mont)", b_mont, (num_s, num_r, ctx.num_primes, ctx.n))
    _check(ctx, "hoisted_products(a_mont)", a_mont, (num_s, num_r, ctx.num_primes, ctx.n))
    for name, t in (("c0", c0), ("d_eval", d_eval), ("b_mont", b_mont), ("a_mont", a_mont)):
        _check_aligned(f"hoisted_products({name})", t)
    shape = (num_s,) + tuple(c0.shape)
    out0 = torch.empty(shape, dtype=torch.int32, device=c0.device)
    out1 = torch.empty(shape, dtype=torch.int32, device=c0.device)
    nb = c0.numel() // (ctx.num_primes * ctx.n)
    if num_s and nb:
        plan = plan or hoisted_plan(num_s, nb, num_r, ctx.p[:, 0], ctx.n)
        tabs = kernel_tables(ctx, c0.device)
        _launch(ctx, "hoisted_products", c0.device,
                c0.data_ptr(), d_eval.data_ptr(), b_mont.data_ptr(), a_mont.data_ptr(),
                out0.data_ptr(), out1.data_ptr(), tabs.p.data_ptr(), tabs.pinv_neg.data_ptr(),
                num_s, nb, num_r, ctx.num_primes, ctx.logn, plan.split, plan.chunk,
                rows=num_s * nb * ctx.num_primes)
    return out0, out1


# --- K7: fused hybrid-HE transcipher -----------------------------------------


def _transcipher_consts(ctx: NTTContext, device):
    """Per-prime int32 (uint32-bit) tensors [L] of K7: the Barrett constant
    mu = floor((2**32 - 1) / p) and sh31 = host_to_mont(2**31 mod p), both
    below p < 2**27."""
    device = torch.device(device)
    key = (str(device), "transcipher")
    hit = ctx._device_cache.get(key)
    if hit is None:
        primes = [int(pi) for pi in ctx.p[:, 0]]
        hit = (
            torch.tensor([MASK32 // pi for pi in primes], dtype=torch.int32, device=device),
            torch.tensor([host_to_mont((1 << 31) % pi, pi) for pi in primes],
                         dtype=torch.int32, device=device),
        )
        ctx._device_cache[key] = hit
    return hit


def transcipher_fused_plain(ctx: NTTContext, w_hi, w_lo, pad_c0, pad_c1):
    """Plain version of K7 (any device): the JAX package's
    `hhe.transcipher._transcipher_core_xla` in int64 — `encode_packed` of
    the word pairs, the forward NTT, then c0 = NTT(m) - pad_c0 and
    c1 = -pad_c1."""
    p = plain_tables(ctx, w_hi.device).p
    m_eval = ntt_forward_plain(ctx, encode_packed(ctx, w_hi, w_lo)).to(torch.int64)
    c0 = sub_mod(m_eval, pad_c0.to(torch.int64), p)
    c1 = neg_mod(pad_c1.to(torch.int64), p)
    return c0.to(torch.int32), c1.to(torch.int32)


def transcipher_fused(ctx: NTTContext, w_hi, w_lo, pad_c0, pad_c1):
    """trivial(w) - Enc(z): symmetric-ciphertext words w_hi/w_lo int32[..., N]
    (each < 2**31) and the provisioned pad residues int32[..., L, N] ->
    evaluation-domain (c0, c1) [..., L, N]. One K7 launch on CUDA over all
    B*L rows, at `ntt_plan`'s cluster size: the forward transform with the
    embedding in its first pass and the pads in its epilogue. The pad rows
    must be 16-byte aligned."""
    if _is_cpu(w_hi, w_lo, pad_c0, pad_c1):
        return transcipher_fused_plain(ctx, w_hi, w_lo, pad_c0, pad_c1)
    _check(ctx, "transcipher_fused(pad_c0)", pad_c0)
    _check(ctx, "transcipher_fused(pad_c1)", pad_c1, pad_c0.shape)
    _check_aligned("transcipher_fused(pad_c0)", pad_c0)
    _check_aligned("transcipher_fused(pad_c1)", pad_c1)
    words = tuple(pad_c0.shape[:-2]) + (ctx.n,)
    for name, t in (("w_hi", w_hi), ("w_lo", w_lo)):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != words:
            raise ValueError(
                f"transcipher_fused({name}): expected contiguous torch.int32 {words}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    c0 = torch.empty_like(pad_c0)
    c1 = torch.empty_like(pad_c0)
    rows = pad_c0.numel() // ctx.n
    if rows:
        tabs = kernel_tables(ctx, pad_c0.device)
        mu, sh31 = _transcipher_consts(ctx, pad_c0.device)
        _launch(ctx, "transcipher_fused", pad_c0.device,
                w_hi.data_ptr(), w_lo.data_ptr(), pad_c0.data_ptr(), pad_c1.data_ptr(),
                c0.data_ptr(), c1.data_ptr(), tabs.psi.data_ptr(), tabs.psi_shoup.data_ptr(),
                tabs.p.data_ptr(), tabs.pinv_neg.data_ptr(), mu.data_ptr(), sh31.data_ptr(),
                rows, ctx.num_primes, ctx.logn, ntt_plan(rows, ctx.n), rows=rows)
    return c0, c1
