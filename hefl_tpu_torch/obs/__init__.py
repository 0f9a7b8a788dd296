"""Observability: run events, metrics, round-lifecycle spans, scope names,
and the bench trend gate.

Counterpart of `hefl_tpu.obs` without its XLA trace parser (`obs.trace`):
`events` (the JSONL run-event log), `metrics` (the process-wide
counter/gauge/histogram registry), `spans` (per-round span trees on the
streaming engine's virtual clock, exported as Chrome trace-viewer JSON),
`scopes` (phase names for profiler ranges) and `trend` (the trend table
and regression gate over the committed BENCH_TORCH_*.json artifacts,
`python -m hefl_tpu_torch.obs.trend`).
"""

from hefl_tpu_torch.obs import events, metrics, scopes, spans, trend
from hefl_tpu_torch.obs.events import EventLog
from hefl_tpu_torch.obs.spans import SpanTracer

__all__ = ["events", "metrics", "scopes", "spans", "trend", "EventLog", "SpanTracer"]
