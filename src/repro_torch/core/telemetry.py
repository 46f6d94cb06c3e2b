"""Metrics registry of the port (counterpart of ``repro.core.telemetry``):
counters, gauges, histograms and timed spans, keyed by the same dotted tags
(``kernel.calls.matmul.t8``, ``kv.specials.t8``, ``step.grad_norm``, ...),
so that a capture from either package reads the same.

Metric kinds:

* **counter**: a float sum (:func:`record` / :func:`emit`).
* **gauge**: the last value wins (:func:`record_gauge` / :func:`emit_gauge`).
* **histogram**: count, sum, min and max, and a bounded, deterministic
  stride-decimated sample for the quantiles (:func:`record_hist` /
  :func:`emit_hist`).
* **span**: a named interval with a category (``kernel``, ``step``,
  ``host``, ...).  :func:`host_span` times a host region with
  ``time.perf_counter``; :func:`trace_span` times device work: given a
  CUDA ``device`` it records a pair of ``torch.cuda.Event(enable_timing=
  True)`` on that device's current stream, so the pair brackets the
  kernels launched inside it; on the CPU it takes the host clock.

The gate.  Eager PyTorch has no trace time, so the gate is a runtime
check: every emitting site in the port reads ``if telemetry.enabled():``
first, and outside a :func:`capture` it adds no tensor op, no launch and
no host sync.  Inside a capture, a value given as a tensor stays where it
is (a 0-d device tensor such as ``count_specials``' is kept, not read), and
event spans stay unresolved: both are read back when the capture exits or
a reader (:func:`snapshot`, :func:`counters`, ...) is called, which
synchronises once.  Event spans' times are placed on the host clock by one
anchor event per device, recorded at the outermost capture's entry (or at
the first event span on a device that had none), beside the host time of
that record.

``emit*`` and ``record*`` are the same functions here (``repro`` splits
them into the traced callback and its host target); both names are kept.
:func:`annotate_xla` bridges :func:`host_span` into
``torch.profiler.record_function``, so host spans show in a profiler trace.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_LOCK = threading.Lock()
_COUNTERS: collections.Counter = collections.Counter()
_GAUGES: dict = {}
_HISTS: dict = {}
_SPANS: list = []
#: (kind, tag, 0-d tensor) recorded inside a capture and not yet read back,
#: in the order they were recorded
_PENDING: list = []
#: (name, cat, tid, start event, end event, args, device index) awaiting
#: resolution
_EVENT_SPANS: list = []
#: device index -> (anchor event, host perf_counter at its record)
_ANCHORS: dict = {}
_DROPPED_SPANS = 0
_DEPTH = 0  # capture scopes may nest; any active scope enables recording
_ANNOTATE = False


def enabled() -> bool:
    """True while at least one :func:`capture` scope is active."""
    return _DEPTH > 0


def annotate_xla(flag: bool) -> None:
    """Bridge :func:`host_span` into ``torch.profiler.record_function`` (the
    name is ``repro``'s, whose bridge was ``jax.profiler.TraceAnnotation``)."""
    global _ANNOTATE
    _ANNOTATE = bool(flag)


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------


class _Hist:
    """count/sum/min/max + a bounded deterministic sample.

    When the sample buffer fills it is decimated to every other element and
    the keep-stride doubles: no RNG (reproducible runs), bounded memory, and
    the surviving sample stays spread over the whole recording window.
    """

    CAP = 4096
    __slots__ = ("count", "total", "vmin", "vmax", "sample", "_stride", "_skip")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.sample: list = []
        self._stride = 1
        self._skip = 0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self._skip += 1
        if self._skip >= self._stride:
            self._skip = 0
            self.sample.append(v)
            if len(self.sample) >= self.CAP:
                self.sample = self.sample[::2]
                self._stride *= 2

    def summary(self) -> dict:
        s = sorted(self.sample)
        q = lambda p: s[min(len(s) - 1, int(p * len(s)))] if s else float("nan")  # noqa: E731
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else float("nan"),
            "max": self.vmax if self.count else float("nan"),
            "mean": self.total / self.count if self.count else float("nan"),
            "p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
        }


def _apply(kind: str, tag: str, v: float) -> None:
    """Add one host value to the store (the caller holds ``_LOCK``)."""
    if kind == "counter":
        _COUNTERS[tag] += v
    elif kind == "gauge":
        _GAUGES[tag] = v
    else:
        h = _HISTS.get(tag)
        if h is None:
            h = _HISTS[tag] = _Hist()
        h.add(v)


def _record(kind: str, tag: str, value) -> None:
    if _DEPTH == 0:
        return
    with _LOCK:
        if isinstance(value, torch.Tensor):
            _PENDING.append((kind, tag, value.detach()))
        elif kind != "counter" and any(p[1] == tag and p[0] == kind for p in _PENDING):
            # a host value behind a pending device value of the same gauge or
            # histogram keeps its place in the order
            _PENDING.append((kind, tag, float(value)))
        else:
            _apply(kind, tag, float(value))


def record(tag: str, value) -> None:
    """Counter accumulate (a float, or a tensor read back later)."""
    _record("counter", tag, value)


def record_gauge(tag: str, value) -> None:
    """Gauge: last value wins."""
    _record("gauge", tag, value)


def record_hist(tag: str, value) -> None:
    """Histogram sample."""
    _record("hist", tag, value)


#: the emitters of ``repro`` (its traced callbacks) are the recorders here
emit = record
emit_gauge = record_gauge
emit_hist = record_hist


def _record_span(name: str, cat: str, t0: float, t1: float, args=None) -> None:
    if _DEPTH > 0:
        with _LOCK:
            _SPANS.append({
                "name": name, "cat": cat, "t0": t0, "t1": t1,
                "tid": threading.get_ident(), **({"args": args} if args else {}),
            })


def _anchor(device: torch.device) -> int:
    """Record ``device``'s anchor (an event and the host time of its record)
    if it has none; returns the device index."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _ANCHORS:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(idx))
        _ANCHORS[idx] = (ev, time.perf_counter())
    return idx


def _resolve() -> None:
    """Read back every pending device value and event span: one synchronise
    per device with event spans, one copy per device of its pending values."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
        spans, _EVENT_SPANS[:] = list(_EVENT_SPANS), []
        anchors = dict(_ANCHORS)
    if not pending and not spans:
        return
    by_device: dict = {}
    for i, (_, _, v) in enumerate(pending):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
    values = {}
    for dev, idx in by_device.items():
        got = torch.stack([pending[i][2].reshape(()).to(torch.float64) for i in idx]).cpu()
        values.update(zip(idx, got.tolist()))
    for d in {sp[6] for sp in spans}:
        torch.cuda.synchronize(d)
    resolved = []
    for name, cat, tid, ev0, ev1, args, d in spans:
        anchor_ev, anchor_t = anchors[d]
        t0 = anchor_t + anchor_ev.elapsed_time(ev0) / 1e3
        resolved.append({"name": name, "cat": cat, "t0": t0,
                         "t1": t0 + ev0.elapsed_time(ev1) / 1e3, "tid": tid,
                         **({"args": args} if args else {})})
    with _LOCK:
        for i, (kind, tag, v) in enumerate(pending):
            _apply(kind, tag, values[i] if i in values else v)
        _SPANS.extend(resolved)


class _SpanHandle:
    """Yielded by :func:`trace_span`.  ``.dep`` is kept for ``repro``'s API
    (a data dependency of its end callback); an end event recorded on the
    stream after the span's launches needs none."""

    __slots__ = ("dep",)

    def __init__(self):
        self.dep = None


def probe(x: torch.Tensor) -> torch.Tensor:
    """A one-element view of ``x`` (``repro``'s cheap span dependency)."""
    return x.reshape(-1)[:1] if x.numel() else torch.zeros(1, dtype=torch.float32)


@contextlib.contextmanager
def trace_span(name: str, cat: str = "trace", device=None):
    """Timer span around device work.  Given a CUDA ``device``, a pair of
    timing events on its current stream brackets the kernels launched
    inside (read back with the capture); else the host clock times the
    region.  Nothing is recorded, and no event made, outside a capture."""
    global _DROPPED_SPANS
    h = _SpanHandle()
    if _DEPTH == 0:
        yield h
        return
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        t0 = time.perf_counter()
        yield h
        _record_span(name, cat, t0, time.perf_counter())
        return
    idx = _anchor(dev)
    stream = torch.cuda.current_stream(idx)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev0.record(stream)
    yield h
    ev1 = torch.cuda.Event(enable_timing=True)
    ev1.record(stream)
    with _LOCK:
        if _DEPTH > 0:
            _EVENT_SPANS.append((name, cat, threading.get_ident(), ev0, ev1, None, idx))
        else:  # the capture closed inside the span
            _DROPPED_SPANS += 1


@contextlib.contextmanager
def host_span(name: str, cat: str = "host", **args):
    """Wall-clock span over a host region (the train loop's steps, bench
    repetitions, export passes)."""
    if _DEPTH == 0:
        yield
        return
    bridge = (torch.profiler.record_function(name) if _ANNOTATE
              else contextlib.nullcontext())
    t0 = time.perf_counter()
    try:
        with bridge:
            yield
    finally:
        _record_span(name, cat, t0, time.perf_counter(), args or None)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def counters() -> dict:
    _resolve()
    with _LOCK:
        return dict(_COUNTERS)


def gauges() -> dict:
    _resolve()
    with _LOCK:
        return dict(_GAUGES)


def hists() -> dict:
    """tag -> summary dict (count/sum/min/max/mean/p50/p90/p99)."""
    _resolve()
    with _LOCK:
        return {tag: h.summary() for tag, h in _HISTS.items()}


def spans() -> list:
    _resolve()
    with _LOCK:
        return list(_SPANS)


def dropped_spans() -> int:
    return _DROPPED_SPANS


def snapshot() -> dict:
    """Everything the exporters consume, in one consistent view (device
    values and event spans read back first)."""
    _resolve()
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "hists": {tag: h.summary() for tag, h in _HISTS.items()},
            "spans": list(_SPANS),
            "dropped_spans": _DROPPED_SPANS,
        }


def reset() -> None:
    global _DROPPED_SPANS
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _SPANS.clear()
        _PENDING.clear()
        _EVENT_SPANS.clear()
        _ANCHORS.clear()
        _DROPPED_SPANS = 0


@contextlib.contextmanager
def capture(fresh: bool = True, annotate_xla: bool | None = None):
    """Enable recording; yields the live counter store (read it after the
    scope exits, or through :func:`counters` / :func:`snapshot` inside it:
    device values land in it when read back).  ``fresh`` resets the store on
    entry of the outermost scope only: nested scopes share one store and
    never clear it.  ``annotate_xla`` sets the :func:`host_span` profiler
    bridge for the scope's duration.  Exit reads back everything recorded
    inside the scope."""
    global _DEPTH, _ANNOTATE
    if fresh and _DEPTH == 0:
        reset()
    prev = _ANNOTATE
    if annotate_xla is not None:
        _ANNOTATE = bool(annotate_xla)
    if _DEPTH == 0 and torch.cuda.is_available() and torch.cuda.is_initialized():
        _anchor(torch.device("cuda", torch.cuda.current_device()))
    _DEPTH += 1
    try:
        yield _COUNTERS
    finally:
        try:
            _resolve()
        finally:
            _DEPTH -= 1
            _ANNOTATE = prev
