"""Profiler-trace attribution: per-phase device time from ONE traced run.

Counterpart of `hefl_tpu.obs.trace`, on the traces `torch.profiler` writes
(`tensorboard_trace_handler(dir, use_gzip=True)`:
`<dir>/<host>_<pid>.<ts>.pt.trace.json.gz`, the Chrome trace-viewer format).
It keeps the JAX module's names, its failure policy and its record's keys;
the join is this package's own, since a profiler trace of eager PyTorch
carries no compiled program to read scopes from:

  1. The port's paths open `torch.profiler.record_function(<scope>)`
     ranges (`obs.scopes`) around their phases; each is a
     `user_annotation` event on the thread that opened it.
  2. On a card, the device ops are the `kernel`, `gpu_memcpy` and
     `gpu_memset` events. Each carries `args.correlation`, the id of the
     `cuda_runtime` (or `cuda_driver`) event that launched it, which gives
     the launch's host timestamp and thread. A device op's phase is the
     innermost phase range containing its launch: on the launching thread
     first, and where that thread has none, on any thread of the process
     (the autograd engine's device thread launches the backward kernels
     while the thread that called `autograd.grad` waits inside its range).
     Kernels run after their launch, so a kernel's own timestamp never
     stands in for its launch's.
  3. Its module is found the same way among PhaseTimer's
     `hefl.phase.<name>` ranges (the JAX record's per-program `modules`).
  4. On the CPU there is no device op: the `cpu_op` events stand in for
     them, each attributed by its own start, and the record says so
     (`"device_events": "cpu_op"`); such a number is host time, never a
     device time.

Rows, `unattributed_s`, `device_total_s` and `modules` are interval unions,
as in the JAX module: overlapping ops (two streams, nested aten ops on the
CPU) count each microsecond once. `host_rows` are the `hefl.*` ranges that
are not phases (the straggler and quorum waits, PhaseTimer's brackets).

Failure policy: a truncated gzip, malformed JSON, an empty event list, a
trace with no device-op events, or a CUDA trace whose launches have no
kernel events raises `TraceParseError`; never a silent all-zeros table.
Launches whose kernel event the profiler dropped are counted
(`dropped_launches`) and flag `suspected_truncated`; a device op whose
launch is missing counts as unattributed (`unlinked_device_events`).

`round_profiler` is the profiler window that the port's traced runs use
(`ExperimentConfig.profile_dir`, `profile_round --profile`). It opens with
throwaway launches in a `hefl.profiler_prime` range, and the join leaves
those launches and their kernels out of every count.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
from typing import Any, Mapping

import torch

from hefl_tpu_torch.obs import scopes

DEVICE_OP_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
RANGE_CAT = "user_annotation"
CPU_OP_CAT = "cpu_op"


class TraceParseError(RuntimeError):
    """The trace is unusable for attribution."""


# Throwaway kernels at the start of a traced window (`round_profiler`): at
# least the 13 kernel events a window lost after chip_smoke.py's phases
# 1-12, with room to spare.
PRIME_KERNELS = 256


@contextlib.contextmanager
def round_profiler(profile_dir: str, device):
    """A `torch.profiler.profile` of the host (and, on a card, the CUDA
    activity) around the block, which writes
    `<host>_<pid>.<ts>.pt.trace.json.gz` into `profile_dir` when the block
    ends (`trace_attribution` reads it).

    The block is the schedule's active step, after a warm-up step that runs
    one small kernel on a card. On the H100, once a process had run
    profiled windows, each later window lost the kernel events of its first
    launches: 1-3 after a few windows (3 without the warm-up step, 1 with
    it; a host-to-device copy or a sleep first did not take the loss, a
    kernel did), 13 after the hundreds of chip_smoke.py's phases 1-12. So
    the active step starts with PRIME_KERNELS small kernels inside a
    `hefl.profiler_prime` range, which the join leaves out."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(profile_dir, use_gzip=True)) as prof:
        if cuda:
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
        prof.step()
        if cuda:
            with torch.profiler.record_function(scopes.PROFILER_PRIME):
                one = torch.ones(1, device=device)
                for _ in range(PRIME_KERNELS):
                    one.add_(1)
                torch.cuda.synchronize(device)
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
        prof.step()



def find_trace_file(logdir: str) -> str:
    """The newest trace-viewer JSON under a profiler logdir, recursively."""
    hits = sorted(
        glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    if not hits:
        raise TraceParseError(f"no *.trace.json.gz under {logdir!r} — did the profiler run?")
    return hits[-1]


def load_trace_events(path: str) -> list[dict]:
    """Parse one trace-viewer JSON (.trace.json.gz or plain .json) -> its
    traceEvents list. Truncated or corrupt input fails loudly."""
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = json.loads(f.read().decode("utf-8"))
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        raise TraceParseError(f"unreadable trace {path!r}: {e}") from e
    events = data.get("traceEvents") if isinstance(data, dict) else None
    if not isinstance(events, list) or not events:
        raise TraceParseError(f"trace {path!r} carries no traceEvents")
    return events


def _merged_length_us(intervals: list[tuple[float, float]]) -> float:
    """Total covered length of a set of [start, end) intervals (overlaps
    counted once)."""
    total = 0.0
    end = -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _subtract_covered_us(
    intervals: list[tuple[float, float]], cover: list[tuple[float, float]]
) -> float:
    """Length of `intervals` NOT covered by `cover`: |A ∪ B| − |B|."""
    if not intervals:
        return 0.0
    return max(
        0.0,
        _merged_length_us(intervals + cover) - _merged_length_us(cover),
    )


class _Ranges:
    """Named ranges of each (pid, tid), for the innermost range containing
    a timestamp: a bisect to the last range starting at or before it, then
    up its chain of enclosing ranges (ranges on one thread nest)."""

    def __init__(self, ranges: list[tuple[Any, Any, float, float, str]]):
        by_thread: dict[tuple, list] = {}
        for pid, tid, ts, end, name in ranges:
            by_thread.setdefault((pid, tid), []).append((ts, end, name))
        self._threads: dict[tuple, tuple] = {}
        self._by_pid: dict[Any, list] = {}
        for key, rs in by_thread.items():
            rs.sort(key=lambda r: (r[0], -r[1]))      # the outer first at one start
            parent, stack = [], []
            for s, _, _ in rs:
                while stack and rs[stack[-1]][1] <= s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(len(parent) - 1)
            self._threads[key] = ([r[0] for r in rs], rs, parent)
            self._by_pid.setdefault(key[0], []).append(key)

    def _on_thread(self, key: tuple, ts: float):
        hit = self._threads.get(key)
        if hit is None:
            return None
        starts, rs, parent = hit
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and not rs[i][0] <= ts < rs[i][1]:
            i = parent[i]
        return rs[i] if i >= 0 else None

    def innermost(self, pid, tid, ts: float) -> str | None:
        """The innermost range containing `ts` on thread (pid, tid), else the
        innermost (latest-starting) one on any other thread of `pid`."""
        hit = self._on_thread((pid, tid), ts)
        if hit is None:
            for key in self._by_pid.get(pid, ()):
                if key[1] != tid:
                    other = self._on_thread(key, ts)
                    if other is not None and (hit is None or other[0] > hit[0]):
                        hit = other
        return hit[2] if hit is not None else None


def _seconds(us: float) -> float:
    return round(us / 1e6, 9)


def _load(trace: str | list[dict]) -> tuple[list[dict], str | None]:
    if isinstance(trace, str):
        path = trace if os.path.isfile(trace) else find_trace_file(trace)
        return load_trace_events(path), path
    return trace, None


def _attribute(events: list[dict]) -> dict[str, Any]:
    """The join: every device op (or, on a CPU trace, cpu_op) with its
    phase and module -> {kind, ops [(name, start, end, phase, module)],
    unlinked, dropped [(launch name, tid, launch ts, phase)], host_iv}."""
    phase_ranges, module_ranges, prime_ranges = [], [], []
    host_iv: dict[str, list[tuple[float, float]]] = {}
    device_ops, cpu_ops = [], []
    launches: dict[Any, tuple] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        name = str(ev.get("name") or "")
        if cat in DEVICE_OP_CATS:
            device_ops.append((name, ts, end, cat, (ev.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            launches[corr] = (ev.get("pid"), ev.get("tid"), ts, name)
        elif cat == CPU_OP_CAT:
            cpu_ops.append((name, ev.get("pid"), ev.get("tid"), ts, end))
        elif cat == RANGE_CAT and scopes.is_phase_scope(name):
            if name == scopes.PROFILER_PRIME:
                prime_ranges.append((ev.get("pid"), ev.get("tid"), ts, end, name))
            elif name.startswith(scopes.MODULE_PREFIX) or name in scopes.HOST_SPANS:
                host_iv.setdefault(name, []).append((ts, end))
                if name.startswith(scopes.MODULE_PREFIX):
                    module_ranges.append((ev.get("pid"), ev.get("tid"), ts, end, name))
            else:
                phase_ranges.append((ev.get("pid"), ev.get("tid"), ts, end, name))

    phase_of, module_of = _Ranges(phase_ranges), _Ranges(module_ranges)
    if prime_ranges:
        # The priming launches, on the thread that opened the range, are
        # not the traced work: out of the ops and of the dropped count.
        primed = _Ranges(prime_ranges)
        skip = {corr for corr, launch in launches.items()
                if primed._on_thread(launch[:2], launch[2]) is not None}
        launches = {corr: launch for corr, launch in launches.items() if corr not in skip}
        device_ops = [op for op in device_ops if op[4] not in skip]
    ops: list[tuple[str, float, float, str | None, str | None]] = []
    dropped: list[tuple[str, Any, float, str | None]] = []
    unlinked = 0
    if device_ops:
        kind = "kernel"
        for name, ts, end, _, corr in device_ops:
            launch = launches.get(corr)
            if launch is None:
                unlinked += 1
                ops.append((name, ts, end, None, None))
                continue
            pid, tid, lts, _ = launch
            ops.append((name, ts, end, phase_of.innermost(pid, tid, lts),
                        module_of.innermost(pid, tid, lts)))
        with_kernel = {corr for _, _, _, cat, corr in device_ops if cat == "kernel"}
        dropped = [(name, tid, lts, phase_of.innermost(pid, tid, lts))
                   for corr, (pid, tid, lts, name) in launches.items()
                   if "LaunchKernel" in name and corr not in with_kernel]
    elif launches:
        raise TraceParseError(
            f"trace has {len(launches)} CUDA runtime/driver events but no kernel, memcpy "
            "or memset event — the profiler lost the device activity"
        )
    elif cpu_ops:
        kind = "cpu_op"
        ops = [(name, ts, end, phase_of.innermost(pid, tid, ts),
                module_of.innermost(pid, tid, ts)) for name, pid, tid, ts, end in cpu_ops]
    else:
        raise TraceParseError(
            "trace has no device-op events (kernel, gpu_memcpy, gpu_memset) and no cpu_op "
            "events — wrong trace dir, or the profiler captured no activity"
        )
    return {"kind": kind, "ops": ops, "unlinked": unlinked, "dropped": dropped,
            "host_iv": host_iv}


def attributed_events(trace: str | list[dict]) -> dict[str, list[dict[str, Any]]]:
    """What `trace_attribution` sums, event by event, of a trace (a
    logdir, a file or loaded events) -> {"ops": each device op {name, ts,
    dur, phase, module}, phase and module None where no range holds its
    launch; "dropped": each kernel launch without its kernel event {name,
    tid, ts, phase}, the launch's own}."""
    att = _attribute(_load(trace)[0])
    return {
        "ops": [{"name": name, "ts": ts, "dur": end - ts, "phase": phase, "module": module}
                for name, ts, end, phase, module in att["ops"]],
        "dropped": [{"name": name, "tid": tid, "ts": ts, "phase": phase}
                    for name, tid, ts, phase in att["dropped"]],
    }


def trace_attribution(
    trace: str | list[dict],
    phases: tuple[str, ...] = scopes.PHASES,
) -> dict[str, Any]:
    """Per-phase device time of a traced run: THE trace_attribution record.

    trace: a profiler logdir, a *.trace.json(.gz) path, or a pre-loaded
    traceEvents list.

    -> {
      "rows": {phase: {"device_seconds", "op_events"}},   # union per phase
      "unattributed_s":   device-busy time no phase range covers,
      "device_total_s":   union of ALL device-op events,
      "modules": {"hefl.phase.<name>": device_seconds},   # per PhaseTimer phase
      "host_rows": {range: {"seconds", "spans"}},         # non-phase hefl.* ranges
      "op_events": device-op events considered,
      "device_events": "kernel" (a CUDA trace) or "cpu_op" (a CPU trace),
      "dropped_launches": kernel launches without a kernel event,
      "unlinked_device_events": device ops without a launch event,
      "suspected_truncated": dropped_launches > 0,
      "trace_file": the file read (when given a path),
      "source": "trace",
    }

    Phases do not overlap on one stream, so sum(rows) + unattributed_s is
    device_total_s; `attributed_sum_s` is that sum.
    """
    events, trace_file = _load(trace)
    att = _attribute(events)
    ops = att["ops"]
    # Times relative to the first op: differences of ~1e12-us timestamps
    # lose digits that differences of small numbers keep.
    base = min(op[1] for op in ops)
    per_phase: dict[str, list[tuple[float, float]]] = {}
    per_module: dict[str, list[tuple[float, float]]] = {}
    all_iv, attributed_iv = [], []
    for _, ts, end, phase, module in ops:
        iv = (ts - base, end - base)
        all_iv.append(iv)
        if module is not None:
            per_module.setdefault(module, []).append(iv)
        if phase is not None:
            per_phase.setdefault(phase, []).append(iv)
            attributed_iv.append(iv)

    order = list(phases) + sorted(set(per_phase) - set(phases))
    rows = {
        ph: {"device_seconds": _seconds(_merged_length_us(per_phase[ph])),
             "op_events": len(per_phase[ph])}
        for ph in order
        if ph in per_phase
    }
    return {
        "rows": rows,
        "unattributed_s": _seconds(_subtract_covered_us(all_iv, attributed_iv)),
        "device_total_s": _seconds(_merged_length_us(all_iv)),
        "modules": {m: _seconds(_merged_length_us(iv)) for m, iv in sorted(per_module.items())},
        "host_rows": {
            name: {"seconds": _seconds(_merged_length_us(iv)), "spans": len(iv)}
            for name, iv in sorted(att["host_iv"].items())
        },
        "op_events": len(ops),
        "device_events": att["kind"],
        "dropped_launches": len(att["dropped"]),
        "unlinked_device_events": att["unlinked"],
        "suspected_truncated": bool(att["dropped"]),
        **({"trace_file": trace_file} if trace_file else {}),
        "source": "trace",
    }


def attributed_sum_s(record: Mapping[str, Any]) -> float:
    """sum(per-phase rows) + unattributed — the quantity compared against
    the traced region's wall clock."""
    rows = record.get("rows") or {}
    return round(
        sum(r["device_seconds"] for r in rows.values())
        + float(record.get("unattributed_s") or 0.0),
        9,
    )
