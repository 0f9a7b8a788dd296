"""Observability: run events, metrics, round-lifecycle spans, scope names,
profiler-trace attribution, and the bench trend gate.

Counterpart of `hefl_tpu.obs`: `events` (the JSONL run-event log),
`metrics` (the process-wide counter/gauge/histogram registry), `spans`
(per-round span trees on the streaming engine's virtual clock, exported as
Chrome trace-viewer JSON), `scopes` (the phase names the port's paths open
as `torch.profiler` ranges), `trace` (per-phase device time of one
`torch.profiler` trace: `trace_attribution`, failing with `TraceParseError`
on an unusable trace) and `trend` (the trend table and regression gate
over the committed BENCH_TORCH_*.json artifacts,
`python -m hefl_tpu_torch.obs.trend`).
"""

from hefl_tpu_torch.obs import events, metrics, scopes, spans, trace, trend
from hefl_tpu_torch.obs.events import EventLog
from hefl_tpu_torch.obs.spans import SpanTracer
from hefl_tpu_torch.obs.trace import TraceParseError, trace_attribution

__all__ = [
    "events",
    "metrics",
    "scopes",
    "spans",
    "trace",
    "trend",
    "EventLog",
    "SpanTracer",
    "TraceParseError",
    "trace_attribution",
]
