"""One profiled round, read back from the profiler's Chrome trace.

The join is the one the system's own trace reader uses, copied here so
that the yardstick cannot move with the system: the system opens
`torch.profiler.record_function("hefl.<phase>")` ranges around its phases,
each a `user_annotation` event on the thread that opened it; each device
op (`kernel`, `gpu_memcpy`, `gpu_memset`) carries the correlation id of
the runtime call that launched it, and its phase is the innermost `hefl.*`
range containing that launch, on the launching thread first and else on
any thread of the process (the autograd engine launches the backward on a
thread of its own while the caller waits inside its range).

The window opens with throwaway kernels inside a `bench.prime` range: on
the H100 a profiled window has lost the kernel events of its first
launches, and those launches are these. The join leaves them out. The
profiled round itself runs inside a `bench.round` range, whose host
extent is the window that the busy and idle shares are taken over.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os

import torch

DEVICE_OP_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
RANGE_CAT = "user_annotation"
PRIME = "bench.prime"
ROUND = "bench.round"
PRIME_KERNELS = 256


class TraceError(RuntimeError):
    """The trace cannot be read as a round's device activity."""


@contextlib.contextmanager
def profiled(path: str, device):
    """Profile the block (host and CUDA activity) and write the Chrome
    trace to `path` when it ends. The block is the active step, after a
    warm-up step that runs one kernel; it opens with PRIME_KERNELS small
    kernels in a `bench.prime` range."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        prof.step()
        with torch.profiler.record_function(PRIME):
            one = torch.ones(1, device=device)
            for _ in range(PRIME_KERNELS):
                one.add_(1)
            torch.cuda.synchronize(device)
        yield prof
        torch.cuda.synchronize(device)
        prof.step()


def load_events(path: str) -> list[dict]:
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = json.loads(f.read().decode("utf-8"))
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        raise TraceError(f"unreadable trace {path!r}: {e}") from e
    events = data.get("traceEvents") if isinstance(data, dict) else None
    if not isinstance(events, list) or not events:
        raise TraceError(f"trace {path!r} carries no traceEvents")
    return events


def merged(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


class _Ranges:
    """Named ranges of each (pid, tid); the innermost one holding a time."""

    def __init__(self, ranges):
        by_thread: dict[tuple, list] = {}
        for pid, tid, ts, end, name in ranges:
            by_thread.setdefault((pid, tid), []).append((ts, end, name))
        self._threads: dict[tuple, tuple] = {}
        self._by_pid: dict = {}
        for key, rs in by_thread.items():
            rs.sort(key=lambda r: (r[0], -r[1]))
            parent, stack = [], []
            for s, _, _ in rs:
                while stack and rs[stack[-1]][1] <= s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(len(parent) - 1)
            self._threads[key] = ([r[0] for r in rs], rs, parent)
            self._by_pid.setdefault(key[0], []).append(key)

    def on_thread(self, key, ts):
        hit = self._threads.get(key)
        if hit is None:
            return None
        starts, rs, parent = hit
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and not rs[i][0] <= ts < rs[i][1]:
            i = parent[i]
        return rs[i] if i >= 0 else None

    def innermost(self, pid, tid, ts):
        hit = self.on_thread((pid, tid), ts)
        if hit is None:
            for key in self._by_pid.get(pid, ()):
                if key[1] != tid:
                    other = self.on_thread(key, ts)
                    if other is not None and (hit is None or other[0] > hit[0]):
                        hit = other
        return hit[2] if hit is not None else None

    def any_thread(self, ts):
        """The innermost range holding `ts` on any thread (latest start)."""
        best = None
        for key in self._threads:
            r = self.on_thread(key, ts)
            if r is not None and (best is None or r[0] > best[0]):
                best = r
        return best[2] if best is not None else None


class RoundTrace:
    """The profiled round's device ops, each with its phase.

    ops: [(name, cat, start_us, end_us, phase or None)], priming left out;
    window: (start_us, end_us) of the `bench.round` range."""

    def __init__(self, events: list[dict]):
        ranges, prime, rounds = [], [], []
        launches, dev = {}, []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            ts = float(ev.get("ts", 0.0))
            end = ts + float(ev.get("dur", 0.0))
            name = str(ev.get("name") or "")
            corr = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_OP_CATS:
                dev.append((name, cat, ts, end, corr))
            elif cat in LAUNCH_CATS:
                launches[corr] = (ev.get("pid"), ev.get("tid"), ts, name)
            elif cat == RANGE_CAT:
                item = (ev.get("pid"), ev.get("tid"), ts, end, name)
                if name == PRIME:
                    prime.append(item)
                elif name == ROUND:
                    rounds.append(item)
                elif name.startswith("hefl."):
                    ranges.append(item)
        if not rounds:
            raise TraceError(f"trace has no {ROUND!r} range")
        if not dev:
            raise TraceError("trace has no kernel, memcpy or memset event: the profiler "
                             "lost the device activity")
        self.window = (rounds[0][2], rounds[0][3])
        primed = _Ranges(prime)
        skip = {c for c, l in launches.items() if primed.on_thread(l[:2], l[2]) is not None}
        phase_of = _Ranges(ranges)
        self.host_ranges = phase_of
        self.ops = []
        self.unlinked = 0
        for name, cat, ts, end, corr in dev:
            if corr in skip:
                continue
            launch = launches.get(corr)
            if launch is None:
                self.unlinked += 1
                self.ops.append((name, cat, ts, end, None))
                continue
            pid, tid, lts, _ = launch
            self.ops.append((name, cat, ts, end, phase_of.innermost(pid, tid, lts)))
        with_kernel = {corr for _, cat, _, _, corr in dev if cat == "kernel"}
        self.dropped = sum(1 for c, l in launches.items()
                           if c not in skip and "LaunchKernel" in l[3] and c not in with_kernel)

    def in_window(self):
        lo, hi = self.window
        return [op for op in self.ops if op[3] > lo and op[2] < hi]

    def busy_us(self, phases=None) -> float:
        lo, hi = self.window
        return length((max(s, lo), min(e, hi)) for _, _, s, e, ph in self.in_window()
                      if phases is None or ph in phases)

    def kernels(self, phases) -> int:
        return sum(1 for _, cat, _, _, ph in self.in_window() if cat == "kernel" and ph in phases)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps by
        the `hefl.*` range open on the host during each (summed by range)."""
        per_name: dict[str, float] = {}
        for name, _, s, e, _ in self.in_window():
            per_name[name] = per_name.get(name, 0.0) + (e - s)
        ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        busy = merged((max(s, lo), min(e, hi)) for _, _, s, e, _ in self.in_window())
        gaps, cur = {}, lo
        for s, e in busy + [(hi, hi)]:
            if s > cur:
                label = self.host_ranges.any_thread(0.5 * (cur + s)) or "none"
                gaps[label] = gaps.get(label, 0.0) + (s - cur)
            cur = max(cur, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v / 1e6] for n, v in ops],
                "idle_gaps": [[n, v / 1e6] for n, v in idle]}


def read_round_trace(path: str) -> RoundTrace:
    try:
        return RoundTrace(load_events(path))
    finally:
        if os.path.exists(path):
            os.unlink(path)
