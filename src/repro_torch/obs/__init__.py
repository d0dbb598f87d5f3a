"""repro_torch.obs — observability for the port: spans and metrics.

- :mod:`repro_torch.obs.trace` — context-manager **spans** gated by the
  ``SPKADD_OBS`` env switch (a shared no-op when off), JSONL-exportable,
  wrapping ``torch.profiler.record_function`` so spans land on profiler
  timelines.
- :mod:`repro_torch.obs.metrics` — always-on named
  **counters/gauges/histograms** with snapshot/reset semantics and the
  reference package's metric names.
- :mod:`repro_torch.obs.ledger` — the perf-history **ledger** keyed by
  (commit, backend, suite, geometry) and its regression gate, in the
  reference's format.

The re-exports below are the instrumentation API the rest of the port uses:
``obs.span(...)``, ``obs.counter(...)``, etc.
"""
from repro_torch.obs.trace import (OBS_ENV, OBS_JSONL_ENV, enabled, set_enabled,
                                   span, spans, clear, export_jsonl, read_jsonl)
from repro_torch.obs.metrics import (counter, gauge, histogram, snapshot, reset)

__all__ = [
    "OBS_ENV", "OBS_JSONL_ENV", "enabled", "set_enabled", "span", "spans",
    "clear", "export_jsonl", "read_jsonl",
    "counter", "gauge", "histogram", "snapshot", "reset",
]
