"""Persisted per-device auto-selection winners.

Counterpart of `hefl_tpu.utils.autoselect`. The client-fusion training
backend is chosen by a one-shot micro-timing at first use ("auto" mode,
`fl.fusion`). The timing is cheap but not free, and a short-lived CLI run
would pay it on every invocation; this module persists the winner per
device name so the probe runs once per (device, decision), not once per
process.

Storage is one JSON file, `hefl_autoselect.json`, of
`{decision: {device_name: {"winner": str, "timings_ms": {...}}}}`, the JAX
module's format, written by an atomic replace. Its directory is
`DEFAULT_DIR`, the package's `_build/` beside the kernel libraries: what the port learned about this card lives where the
libraries built for it do (the JAX package keeps it beside its XLA
compilation cache). The device name is `torch.cuda.get_device_name()`, or
"cpu". `HEFL_AUTOSELECT_CACHE=0` disables persistence (the in-process
choice still applies); the test suite sets it so that auto-mode tests
always run the live micro-timing.

A corrupt or unreadable file reads as empty: the cache is an optimization,
a miss runs the probe again, and it never changes what a run computes.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

FILENAME = "hefl_autoselect.json"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"


def device_name(device: torch.device) -> str:
    """The key a winner is kept under: the card's CUDA name, or the device
    type ("cpu")."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def time_backend(fn, device: torch.device) -> float:
    """A probe's reading of one candidate: the best of 3 wall times of `fn`
    after one warm-up call, each ending in a synchronize on a card."""
    def run():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def cache_file() -> str | None:
    """The winners' file, or None when persistence is disabled."""
    if os.environ.get("HEFL_AUTOSELECT_CACHE", "1") == "0":
        return None
    return os.path.join(DEFAULT_DIR, FILENAME)


def _read_all(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def load_winner(decision: str, device_kind: str, allowed=None) -> dict | None:
    """-> {"winner": str, "timings_ms": {...}} or None on any miss.

    `allowed` (a container of valid winner names) rejects a stale entry,
    e.g. a renamed backend, before the hit is published to obs: a
    rejected entry logs no 'cache' outcome that the caller's fresh probe
    would then contradict."""
    path = cache_file()
    if path is None:
        return None
    rec = _read_all(path).get(decision, {})
    rec = rec.get(device_kind) if isinstance(rec, dict) else None
    if (
        isinstance(rec, dict)
        and isinstance(rec.get("winner"), str)
        and (allowed is None or rec["winner"] in allowed)
    ):
        _record_outcome(decision, device_kind, rec["winner"], "cache", rec.get("timings_ms"))
        return rec
    return None


def _record_outcome(
    decision: str, device_kind: str, winner: str, source: str, timings_ms: dict | None,
) -> None:
    """Publish one auto-selection outcome (a probe run or a persisted hit)
    to obs.events and obs.metrics (`autoselect.probe` / `autoselect.cache`
    counters, an `autoselect` event)."""
    from hefl_tpu_torch.obs import events, metrics

    metrics.counter(f"autoselect.{source}").inc()
    events.emit("autoselect", decision=decision, device_kind=device_kind, winner=winner,
                source=source, timings_ms=timings_ms)


def store_winner(
    decision: str, device_kind: str, winner: str, timings_ms: dict | None = None,
) -> None:
    """Best-effort atomic upsert; failures are silent (persistence is an
    optimization: the in-process cache already holds the choice)."""
    # The probe ran whether or not its winner can be persisted.
    _record_outcome(decision, device_kind, winner, "probe", timings_ms)
    path = cache_file()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _read_all(path)
        if not isinstance(data.get(decision), dict):
            data[decision] = {}
        data[decision][device_kind] = {"winner": winner, "timings_ms": timings_ms}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass
