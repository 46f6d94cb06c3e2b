"""``repro_torch.obs``: the port's observability (counterpart of ``repro.obs``).

Two halves over one statistics core:

* **online**: the metrics registry of :mod:`repro_torch.core.telemetry`
  (counters, gauges, histograms, spans timed by CUDA events on the card),
  wired into the port's surfaces: the dispatch layer (``kernel.*``), the
  train step (``step.*``), quantize and the KV appends (``quant.*`` /
  ``kv.*``) and the train loop (``loop.*``); exported as JSONL and as
  Perfetto / Chrome trace JSON (:mod:`repro_torch.obs.trace_export`).
* **offline**: the bootstrap CIs and the CI-overlap gate of
  :mod:`repro_torch.obs.stats`.

Every symbol is re-exported here, lazily (PEP 562), so that importing
``repro_torch.obs.stats`` alone stays numpy-only.
"""

from __future__ import annotations

_TELEMETRY = frozenset((
    "annotate_xla", "capture", "counters", "dropped_spans", "emit",
    "emit_gauge", "emit_hist", "enabled", "gauges", "hists", "host_span",
    "probe", "record", "record_gauge", "record_hist", "reset", "snapshot",
    "spans", "trace_span",
))
_STATS = frozenset(("MIN_EFFECT", "bootstrap_ci", "ci_gate", "summarize"))
_TRACE = frozenset((
    "chrome_trace", "export_chrome_trace", "export_jsonl",
    "load_chrome_trace", "load_jsonl", "validate_chrome_trace",
))

__all__ = sorted(_TELEMETRY | _STATS | _TRACE)


def __getattr__(name: str):
    if name in _TELEMETRY:
        from repro_torch.core import telemetry as mod
    elif name in _STATS:
        from . import stats as mod
    elif name in _TRACE:
        from . import trace_export as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(mod, name)


def __dir__():
    return __all__
