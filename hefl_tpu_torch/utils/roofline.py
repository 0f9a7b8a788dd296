"""Roofline / MFU accounting and the kernel timers every measurement driver
shares.

Counterpart of `hefl_tpu.utils.roofline`, on one CUDA card. This module is
the single source of:

  * the card's peaks, keyed by CUDA device name (`torch.cuda.
    get_device_name`): dense bf16 FLOP/s from NVIDIA's data sheet, HBM
    bandwidth, and the 32-bit integer pipe and issue rates that bound the
    port's kernels. An unknown card has no peak (never a guess); the CPU
    keeps the JAX package's placeholder, flagged `peak_is_placeholder`;
  * `model_flops` — one forward's conv and matmul FLOPs, counted by
    `torch.utils.flop_counter.FlopCounterMode` on a meta copy of the model
    (the JAX package asks XLA's `cost_analysis`, which also counts the
    elementwise ops: the port's count is 0.93-0.95 of it);
  * `phase_stats` / `backend_compare` — the {seconds, flops, mfu,
    images_per_s} record every artifact embeds per phase;
  * `he_phase_counts` / `he_roofline` — the JAX package's analytic integer
    cost model of encrypt / aggregate / decrypt, word for word, with the
    rates against the card's 32-bit issue rate (`peak_is_estimate`);
  * `steady_seconds` — the host-clock phase timer (warm, min over
    repetitions, the device synchronized around each), and `time_ms` /
    `device_ms` — the kernel timers (CUDA events around a call; the
    kernels' own device time from torch.profiler) that `bench_ntt.py`,
    `chip_smoke.py` and `time_kernels.py` read;
  * `bound` — the least time a kernel's bytes and instructions take on the
    card.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Mapping

import torch

H100_SXM = "NVIDIA H100 80GB HBM3"

# Dense bf16 peak FLOP/s by CUDA device name (NVIDIA data sheets; the H100
# SXM's 1,979 TFLOP/s is with sparsity, half of it dense).
PEAK_BF16_FLOPS: dict[str, float] = {
    H100_SXM: 989.4e12,
}

# Order-of-magnitude CPU placeholder (the JAX package's). Absolute MFU
# against it is meaningless, so every record derived from it carries
# `peak_is_placeholder`.
CPU_PLACEHOLDER_FLOPS = 1e11

# H100 SXM peaks at the 700 W limit: HBM3 bandwidth (NVIDIA data sheet), and
# the rate of the 32-bit integer instructions that bound the kernels' work
# (NVIDIA Hopper architecture white paper, 1.98 GHz boost clock): each of an
# SM's 4 sub-partitions issues one warp instruction a clock (128 lanes a
# clock an SM) to one of two integer pipes of 16 lanes, the multiply pipe
# (IMAD, IMAD.HI, IMAD.WIDE: umulhi, mul, mad) and the ALU pipe (ISETP, SEL,
# LOP3, SHF: compare, select, logic, shift); an add runs on either (IADD3 on
# the ALU pipe, IMAD.IADD on the multiply pipe: chip_smoke.py's phase 1
# prints K3's SASS, where the compiler puts 759 of its ~980 adds on the
# multiply pipe). So m multiplies, a ALU-only operations and d adds take at
# least max(m / 64, a / 64, (m + a + d) / 128) lane-clocks an SM, at 132
# SMs x 1.98e9 clocks a second. (A model with every instruction on one
# 64-lane pipe stands too high for the NTT kernels: K3 was once timed below
# it. The data sheet's 67 TFLOP/s float32 rate counts an FMA as two
# operations and does not apply to integer code.)
HBM_BYTES_PER_S = 3.35e12
PIPE_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9

# Peak 32-bit integer operations a second by CUDA device name: the issue
# rate above (an estimate: no data sheet states an integer rate).
PEAK_INT32_OPS: dict[str, float] = {
    H100_SXM: ISSUE_OPS_PER_S,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def device_kind(device: Any) -> str:
    """The device's name: a CUDA card's `torch.cuda.get_device_name`, else
    its type ("cpu"); a string is taken as the name."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    if device is None:
        return ""
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return torch.cuda.get_device_name(index)
    return device.type


def peak_flops(device: Any) -> tuple[float | None, bool]:
    """-> (peak dense bf16 FLOP/s, is_placeholder). None for a card not in
    the table (never guess an accelerator's peak)."""
    kind = device_kind(device)
    if kind in PEAK_BF16_FLOPS:
        return PEAK_BF16_FLOPS[kind], False
    if "cpu" in kind.lower() or kind.lower() in ("", "none"):
        return CPU_PLACEHOLDER_FLOPS, True
    return None, False


def model_flops(model: torch.nn.Module, batch_shape) -> float | None:
    """FLOPs of one forward of `model` on a float batch of `batch_shape`
    (NHWC, as the port's models take), counted by
    `torch.utils.flop_counter.FlopCounterMode`: convolutions and matrix
    products only, 2 a multiply-add. The forward runs on a meta copy of
    the model, so nothing is computed or allocated. None when the batch is
    empty."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    if not batch_shape or int(batch_shape[0]) < 1:
        return None
    meta = copy.deepcopy(model).to("meta")
    with FlopCounterMode(display=False) as counter:
        meta(torch.zeros(tuple(batch_shape), device="meta"))
    return float(counter.get_total_flops())


def mfu(flops: float | None, seconds: float | None, device: Any) -> float | None:
    """Model FLOPs utilization: FLOPs / wall seconds / the card's bf16 peak."""
    peak, _ = peak_flops(device)
    if not flops or not seconds or not peak:
        return None
    return flops / seconds / peak


def clamp_utilization(rec: dict[str, Any], field: str) -> dict[str, Any]:
    """A utilization above 1.0 is impossible: the row is clamped to 1.0,
    keeps the raw value under `<field>_raw` and carries
    `timing_floor_suspect: true`. The cause is either a phase the host
    clock could not resolve or an understated peak (`peak_is_placeholder` /
    `peak_is_estimate` on the same row says which)."""
    v = rec.get(field)
    if v is not None and v > 1.0:
        rec[f"{field}_raw"] = v
        rec[field] = 1.0
        rec["timing_floor_suspect"] = True
    return rec


def phase_stats(
    seconds: float | None,
    flops: float | None = None,
    device: Any = None,
    images: int | None = None,
) -> dict[str, Any]:
    """One phase's roofline record. Fields are always present (null when
    not computable)."""
    peak, placeholder = peak_flops(device) if device is not None else (None, False)
    rec: dict[str, Any] = {
        "seconds": round(seconds, 6) if seconds is not None else None,
        "flops": flops,
        "mfu": (
            round(flops / seconds / peak, 5)
            if (flops and seconds and peak)
            else None
        ),
        "images_per_s": (
            round(images / seconds, 2) if (images and seconds) else None
        ),
    }
    if placeholder and rec["mfu"] is not None:
        rec["peak_is_placeholder"] = True
    return clamp_utilization(rec, "mfu")


def train_flops_per_round(
    fwd_flops: float | None,
    steps_per_epoch: int,
    epochs: int,
    num_clients: int,
    bwd_multiplier: float = 3.0,
) -> float | None:
    """Train FLOPs of one FL round from one batch's forward (forward +
    backward ~= 3x forward)."""
    if not fwd_flops:
        return None
    return bwd_multiplier * fwd_flops * steps_per_epoch * epochs * num_clients


def backend_compare(
    seconds_by_backend: Mapping[str, float | None],
    flops: float | None = None,
    device: Any = None,
    images: int | None = None,
) -> dict[str, Any]:
    """{backend: phase_stats(...), "fused_speedup_vs_vmap": ratio}: the
    backends run the same FLOPs, only the wall clock differs."""
    rows: dict[str, Any] = {
        k: phase_stats(v, flops=flops, device=device, images=images)
        for k, v in seconds_by_backend.items()
    }
    vmap_s = seconds_by_backend.get("vmap")
    fused_s = seconds_by_backend.get("fused")
    rows["fused_speedup_vs_vmap"] = (
        round(vmap_s / fused_s, 3) if (vmap_s and fused_s) else None
    )
    return rows


# Below this, one call's wall clock is mostly timer and launch noise: such
# a phase is timed again as a chain of back-to-back calls.
TIMING_FLOOR_S = 2e-3
_TIMING_TARGET_S = 2e-2   # total measured span a repetition chain aims for
_MAX_TIMING_REPS = 1000


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def steady_seconds(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Warm-then-min-over-reps wall clock of `fn(*args)`, the device
    synchronized before and after each repetition. A phase below
    TIMING_FLOOR_S is timed again as chains of back-to-back calls with one
    synchronize at the end (the per-call average of a span the host clock
    resolves)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    if best >= TIMING_FLOOR_S or best <= 0.0:
        return best
    inner = min(max(int(_TIMING_TARGET_S / best), 2), _MAX_TIMING_REPS)
    best_avg = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        _sync()
        best_avg = min(best_avg, (time.perf_counter() - t0) / inner)
    return best_avg


# ---------------------------------------------------------------------------
# HE roofline: the JAX package's analytic integer cost model, word for word,
# so the artifact's int_ops and bytes are the reference's.
#
# Cost model (counted from hefl_tpu.ckks.modular's elementwise uint32 ops):
#   mul32_wide 17, mont_mul 40, shoup_mul 22, barrett_mod 22, add/sub_mod 3.
# NTT: one butterfly (2 elements) = shoup_mul + add_mod + sub_mod = 28
# -> 14 int ops per element per stage, logn stages.
# ---------------------------------------------------------------------------

_OPS_MONT_MUL = 40
_OPS_SHOUP_MUL = 22
_OPS_BARRETT = 22
_OPS_ADD_MOD = 3
_NTT_OPS_PER_ELEM_STAGE = 14

CPU_PLACEHOLDER_INT_OPS = 2e10


def peak_int_ops(device: Any) -> tuple[float | None, bool]:
    """-> (peak 32-bit integer ops/s, is_estimate): the card's issue rate
    (PEAK_INT32_OPS), the CPU placeholder, or None for an unknown card.
    Always an estimate."""
    kind = device_kind(device)
    if kind in PEAK_INT32_OPS:
        return PEAK_INT32_OPS[kind], True
    _, placeholder = peak_flops(device)
    if placeholder:
        return CPU_PLACEHOLDER_INT_OPS, True
    return None, True


def he_phase_counts(
    phase: str, *, n: int, num_limbs: int, n_ct: int, num_clients: int = 1
) -> dict[str, float]:
    """Analytic {int_ops, bytes} of one HE phase at the given geometry.
    `bytes` is the ideal fused traffic (inputs + outputs + key polynomials
    once; twiddle tables once), the denominator of a bandwidth roofline."""
    logn = n.bit_length() - 1
    elems = float(n_ct) * num_limbs * n          # one residue tensor
    ntt = _NTT_OPS_PER_ELEM_STAGE * logn
    table_bytes = 2 * num_limbs * n * 4 * logn   # twiddle + shoup tables
    if phase == "encrypt":
        # 4 forward NTTs + pointwise 2 mont_mul + 3 add_mod, per client.
        int_ops = num_clients * elems * (4 * ntt + 2 * _OPS_MONT_MUL + 3 * _OPS_ADD_MOD)
        byts = num_clients * (elems * 4 * (4 + 2)) + 2 * num_limbs * n * 4 + table_bytes
    elif phase == "aggregate":
        # Lazy sum over 2*C ciphertext components + one Barrett.
        int_ops = 2 * elems * (max(num_clients - 1, 1) + _OPS_BARRETT)
        byts = 2 * (num_clients * elems * 4 + elems * 4)
    elif phase == "decrypt":
        # c0 + c1*s, inverse NTT, final N^-1 multiply.
        int_ops = elems * (_OPS_MONT_MUL + _OPS_ADD_MOD + ntt + _OPS_SHOUP_MUL)
        byts = elems * 4 * 3 + num_limbs * n * 4 + table_bytes
    else:
        raise ValueError(f"unknown HE phase {phase!r}")
    return {"int_ops": float(int_ops), "bytes": float(byts)}


def he_phase_stats(
    seconds: float | None,
    counts: Mapping[str, float],
    device: Any = None,
) -> dict[str, Any]:
    """One HE phase's roofline record, the integer analog of
    `phase_stats`: `util_vs_peak_int_ops` divides by `peak_int_ops`."""
    peak, estimate = peak_int_ops(device) if device is not None else (None, True)
    int_ops = counts["int_ops"]
    byts = counts["bytes"]
    rec: dict[str, Any] = {
        "seconds": round(seconds, 6) if seconds is not None else None,
        "int_ops": int_ops,
        "bytes": byts,
        "int_ops_per_s": round(int_ops / seconds, 1) if seconds else None,
        "bytes_per_s": round(byts / seconds, 1) if seconds else None,
        "util_vs_peak_int_ops": (
            round(int_ops / seconds / peak, 5) if (seconds and peak) else None
        ),
    }
    if estimate and rec["util_vs_peak_int_ops"] is not None:
        rec["peak_is_estimate"] = True
    return clamp_utilization(rec, "util_vs_peak_int_ops")


def he_roofline(
    seconds_by_phase: Mapping[str, float | None],
    *,
    n: int,
    num_limbs: int,
    n_ct: int,
    num_clients: int,
    encrypt_clients: int = 1,
    device: Any = None,
) -> dict[str, Any]:
    """{phase: he_phase_stats} for encrypt / aggregate / decrypt at one
    geometry: `num_clients` sizes the aggregation, `encrypt_clients` the
    encrypt row. None seconds still give the analytic counts."""
    rows: dict[str, Any] = {}
    by_phase = {
        "encrypt": encrypt_clients, "aggregate": num_clients, "decrypt": 1,
    }
    for phase, clients in by_phase.items():
        counts = he_phase_counts(
            phase, n=n, num_limbs=num_limbs, n_ct=n_ct, num_clients=clients
        )
        rows[phase] = he_phase_stats(
            seconds_by_phase.get(phase), counts, device=device
        )
    rows["geometry"] = {
        "n": n, "num_limbs": num_limbs, "n_ct": n_ct,
        "num_clients": num_clients, "encrypt_clients": encrypt_clients,
    }
    return rows


def clamp_attribution(
    raw: Mapping[str, float]
) -> tuple[dict[str, float], bool]:
    """Ablation deltas clamped at 0 -> (clamped rows, unreliable): True
    when any raw delta was negative."""
    clamped = {k: max(0.0, float(v)) for k, v in raw.items()}
    unreliable = any(float(v) < 0.0 for v in raw.values())
    return clamped, unreliable


# ---------------------------------------------------------------------------
# Kernel bounds and timers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ops:
    """A count of 32-bit integer instructions by the pipes that can run
    them: `mul` only the multiply pipe, `alu` only the ALU pipe, `add`
    either. Adds to another count, multiplies by an int."""

    mul: int = 0
    alu: int = 0
    add: int = 0

    def __add__(self, other):
        if isinstance(other, int) and other == 0:
            return self
        return Ops(self.mul + other.mul, self.alu + other.alu, self.add + other.add)

    __radd__ = __add__

    def __mul__(self, k: int):
        return Ops(self.mul * k, self.alu * k, self.add * k)

    __rmul__ = __mul__

    @property
    def total(self) -> int:
        return self.mul + self.alu + self.add

    def __str__(self) -> str:
        return f"{self.total} ({self.mul} mul + {self.alu} alu + {self.add} add)"


def bound(bytes_moved: int, ops: Ops) -> tuple[float, str]:
    """The least time (ms) for `bytes_moved` bytes and `ops` instructions:
    the larger of the bytes over HBM's rate and the instructions over each
    pipe's rate and over the issue rate; and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(max(ops.mul, ops.alu) / PIPE_OPS_PER_S, ops.total / ISSUE_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median time between two CUDA events recorded around one call of `fn`,
    over `reps` calls, L2 flushed before each (after `reps` untimed warm-up
    calls, so the clocks have ramped up). The host runs the call between the
    two events, so this is the cost as a caller pays it: device time plus
    the host work (argument checks, allocation, the ctypes call) the device
    waits for. The plain versions are timed so; a kernel's `call_ms` too."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def is_port_kernel(name: str) -> bool:
    """The port's kernels live in csrc/ntt.cu's anonymous namespace (a
    template's demangled name starts with its return type). PyTorch's own
    kernels start with their return type and at::native; some of them hold
    "(anonymous namespace)::" further in."""
    return name.removeprefix("void ").startswith("(anonymous namespace)::")


# Device idle time (us) that marks the start of a new call in device_ms:
# the 64 MB flush before each call keeps the card busy for about 20 us.
CALL_GAP_US = 10.0
PROFILE_TRIES = 5


def kernel_label(name: str) -> str:
    """A port kernel's event name without its namespace and argument list,
    e.g. "ntt_kernel<12, 2, false, DigitRows>"."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def device_ms(fn, reps: int, flush: torch.Tensor, own=is_port_kernel) -> tuple[float, list]:
    """Median device time of one call of `fn`: the summed durations of the
    port's kernels that the call launched (torch.profiler with CUDA
    activity; K5 launches 2 or 3 kernels a call), over `reps` calls with the
    L2 flushed before each, after 3 untimed warm-up calls; and the split by
    launch, [(kernel label, median ms)] in launch order. One call's kernels
    are told from the next's by the flush between them: its own device
    event, or, where the profiler dropped that event (it happens, at times
    for a third of the calls), the idle gap the flush leaves on the port's
    stream (at least CALL_GAP_US; a call's own launches follow each other
    closely). A group with another kernel count than most (a dropped kernel
    event) is left out; at least half of the calls must remain. The
    profiler has also returned a window with none or few of the port's
    kernel events, between two windows that had all of them; such a window
    is measured again, up to PROFILE_TRIES windows in all, and the run fails
    when none of them holds the calls' kernels (a time from another clock
    never stands in for the device time). `own` picks the
    kernels that count by their event name (the port's, by default)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        calls, current, last_end = [], None, 0.0
        for start, end, name in sorted((e.time_range.start, e.time_range.end, e.name) for e in
                                       prof.events() if str(e.device_type).endswith("CUDA")):
            if not own(name):
                current = None
                continue
            if current is None or start - last_end > CALL_GAP_US:
                current = []
                calls.append(current)
            current.append((kernel_label(name), end - start))
            last_end = end
        width = statistics.mode(len(c) for c in calls) if calls else 0
        whole = [c for c in calls if len(c) == width]
        if len(whole) != reps:
            log(f"    (profiler: {len(calls)} groups of kernel events for {reps} calls, "
                f"{len(whole)} whole with {width} kernels)")
        if len(whole) >= reps // 2:
            break
        time.sleep(0.5)
    else:
        raise AssertionError(f"the profiler saw the port's kernels whole in fewer than {reps // 2} "
                             f"of {reps} calls in each of {PROFILE_TRIES} windows")
    split = [(whole[0][i][0], statistics.median(c[i][1] for c in whole) / 1e3)
             for i in range(width)]
    return statistics.median(sum(us for _, us in c) for c in whole) / 1e3, split
