"""Structured per-phase wall-clock timing (`hefl_tpu.utils.timers`).

The reference traces by `start=time.time(); ...; print('x time', end-start)`
around every expensive phase. `PhaseTimer` collects that phase schema —
train / encrypt / aggregate / decrypt / evaluate — as a dict that is the
round record's `phases`. On a CUDA device each phase ends in
`torch.cuda.synchronize()`, so it times the work and not its enqueue; each
phase is also a `torch.profiler.record_function` span named
`hefl.phase.<name>`, so a profiler trace carries the phase brackets.
"""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Collects named wall-clock phases; re-entering a phase accumulates.

    >>> t = PhaseTimer()
    >>> with t.phase("train"): ...
    >>> t.summary()            # {'train': 1.23, 'total': 1.23}
    """

    def __init__(self, device=None) -> None:
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._device = device
        self._elapsed: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            with torch.profiler.record_function(f"hefl.phase.{name}"):
                yield
                if self._sync:
                    torch.cuda.synchronize(self._device)
        finally:
            dt = time.perf_counter() - start
            if name not in self._elapsed:
                self._order.append(name)
            self._elapsed[name] = self._elapsed.get(name, 0.0) + dt

    def summary(self) -> dict[str, float]:
        out = {k: round(self._elapsed[k], 4) for k in self._order}
        out["total"] = round(sum(self._elapsed.values()), 4)
        return out

    def __repr__(self) -> str:
        parts = " | ".join(f"{k} {v:.2f}s" for k, v in self.summary().items())
        return f"PhaseTimer({parts})"
