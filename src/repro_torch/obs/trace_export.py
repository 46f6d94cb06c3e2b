"""Structured exports of a telemetry capture: JSONL and Chrome-trace JSON
(counterpart of ``repro.obs.trace_export``: the same formats, so that each
package's loaders and validator read the other's files).

* :func:`export_jsonl`: one JSON object per line, one line per metric (kind
  ``counter`` / ``gauge`` / ``hist`` / ``span``).
* :func:`export_chrome_trace`: the Chrome Trace Event JSON format
  (``{"traceEvents": [...]}``), loadable by Perfetto
  (https://ui.perfetto.dev) and ``chrome://tracing``.  Spans become
  complete ("ph": "X") events with microsecond timestamps relative to the
  earliest span; the span category maps to the event ``cat`` and each host
  thread to a ``tid``.  Counters, gauges and histograms ride along under
  ``otherData``.

Span timing: host spans are the host's wall clock; a span over CUDA work is
the time between its two events on the stream, placed on the host clock
through the capture's anchor event (:mod:`repro_torch.core.telemetry`).

:func:`load_jsonl`, :func:`load_chrome_trace` and
:func:`validate_chrome_trace` read an export back.
"""

from __future__ import annotations

import json

from repro_torch.core import telemetry

#: process id used for all events (single-process capture); Perfetto wants
#: one, any one
_PID = 1


def _snap(snapshot: dict | None) -> dict:
    return telemetry.snapshot() if snapshot is None else snapshot


def export_jsonl(path: str, snapshot: dict | None = None) -> int:
    """Write the capture as JSONL; returns the number of lines written."""
    snap = _snap(snapshot)
    n = 0
    with open(path, "w") as fh:
        for tag, v in sorted(snap["counters"].items()):
            fh.write(json.dumps({"kind": "counter", "tag": tag, "value": v}) + "\n")
            n += 1
        for tag, v in sorted(snap["gauges"].items()):
            fh.write(json.dumps({"kind": "gauge", "tag": tag, "value": v}) + "\n")
            n += 1
        for tag, h in sorted(snap["hists"].items()):
            fh.write(json.dumps({"kind": "hist", "tag": tag, **h}) + "\n")
            n += 1
        for sp in snap["spans"]:
            fh.write(json.dumps({
                "kind": "span", "name": sp["name"], "cat": sp["cat"],
                "t0": sp["t0"], "dur_us": (sp["t1"] - sp["t0"]) * 1e6,
                "tid": sp["tid"], **({"args": sp["args"]} if "args" in sp else {}),
            }) + "\n")
            n += 1
    return n


def load_jsonl(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def chrome_trace(snapshot: dict | None = None) -> dict:
    """Build the Chrome Trace Event dict (see module docstring)."""
    snap = _snap(snapshot)
    spans = snap["spans"]
    t_base = min((sp["t0"] for sp in spans), default=0.0)
    events = [
        {
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "repro_torch.obs capture"},
        }
    ]
    for sp in spans:
        ev = {
            "name": sp["name"],
            "cat": sp["cat"],
            "ph": "X",
            "ts": round((sp["t0"] - t_base) * 1e6, 3),
            "dur": round(max(0.0, sp["t1"] - sp["t0"]) * 1e6, 3),
            "pid": _PID,
            "tid": sp["tid"] % 1_000_000,  # thread idents are huge; fold
        }
        if "args" in sp:
            ev["args"] = sp["args"]
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "hists": snap["hists"],
            "dropped_spans": snap["dropped_spans"],
        },
    }


def export_chrome_trace(path: str, snapshot: dict | None = None) -> int:
    """Write the Perfetto/Chrome trace JSON; returns the span-event count."""
    trace = chrome_trace(snapshot)
    with open(path, "w") as fh:
        json.dump(trace, fh, indent=1)
        fh.write("\n")
    return sum(1 for ev in trace["traceEvents"] if ev["ph"] == "X")


def load_chrome_trace(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def validate_chrome_trace(trace: dict) -> list[dict]:
    """Structural validation (raises AssertionError); returns the span
    events so callers can assert on their categories/names."""
    assert isinstance(trace.get("traceEvents"), list), "traceEvents missing"
    spans = []
    for ev in trace["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= ev.keys(), ev
        if ev["ph"] == "X":
            assert "ts" in ev and "dur" in ev and ev["dur"] >= 0.0, ev
            assert "cat" in ev, ev
            spans.append(ev)
    return spans
