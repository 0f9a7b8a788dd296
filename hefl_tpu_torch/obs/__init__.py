"""Observability: run events, metrics, round-lifecycle spans, scope names.

Counterpart of `hefl_tpu.obs` without its XLA trace parser and bench
trend gate: `events` (the JSONL run-event log), `metrics` (the
process-wide counter/gauge/histogram registry), `spans` (per-round span
trees on the streaming engine's virtual clock, exported as Chrome
trace-viewer JSON) and `scopes` (phase names for profiler ranges).
"""

from hefl_tpu_torch.obs import events, metrics, scopes, spans
from hefl_tpu_torch.obs.events import EventLog
from hefl_tpu_torch.obs.spans import SpanTracer

__all__ = ["events", "metrics", "scopes", "spans", "EventLog", "SpanTracer"]
