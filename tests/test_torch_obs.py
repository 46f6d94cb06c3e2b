"""The port's observability (``repro_torch.core.telemetry``,
``repro_torch.obs``, the dispatch layer's ``_observed``) against ``repro``'s.

* The registry cases of ``tests/test_obs.py`` (roundtrip, records dropped
  outside a capture, nesting, ``fresh=False``, the histogram's decimation,
  thread safety, ``host_span``), one parametrised test run on both
  registries with the same results; plus the port's own: a tensor value
  stays unread until a reader resolves it, spans on the host clock.
* Nothing runs outside a capture or ``inject``: with every emitter, span,
  census and fault hook patched to raise, an uncaptured prefill, decode
  step, guarded train step and loop step run.
* Export both ways: the port's JSONL and Chrome trace read back and
  accepted by ``repro``'s loaders and validator, and ``repro``'s by the
  port's.
* ``obs.stats``: the port's copy equals ``repro.obs.stats`` on seeded
  samples.
* ``kernel.calls`` / ``kernel.wire_bytes`` per op (``encode``, ``decode``,
  ``matmul``, ``dual_matmul``, ``decode_attention``, fused producers and an
  mx payload among them) equal ``repro``'s exactly on the same inputs.
"""

import json
import pkgutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import telemetry as jtelemetry
from repro.kernels import ops as jops
from repro.obs import stats as jstats
from repro.obs import trace_export as jexport
import repro_torch
from repro_torch import configs, serve
from repro_torch.core import telemetry
from repro_torch.dist import faults
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.obs import stats, trace_export
from repro_torch.quant import qtensor
from repro_torch.quant.policy import POLICIES
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state, make_train_step

# ---------------------------------------------------------------------------
# the registry: each case runs on both packages' registries
# ---------------------------------------------------------------------------


def _roundtrip(tm):
    with tm.capture():
        tm.record("t.c", 2.0)
        tm.record("t.c", 3.0)
        tm.record_gauge("t.g", 1.0)
        tm.record_gauge("t.g", 7.5)  # last write wins
        for v in (1.0, 2.0, 3.0, 4.0):
            tm.record_hist("t.h", v)
        snap = tm.snapshot()
    assert snap["counters"]["t.c"] == 5.0 and snap["gauges"]["t.g"] == 7.5
    h = snap["hists"]["t.h"]
    assert (h["count"], h["sum"], h["min"], h["max"], h["mean"]) == (4, 10.0, 1.0, 4.0, 2.5)
    return snap["counters"], snap["gauges"], snap["hists"]


def _dropped_outside(tm):
    tm.record("t.outside", 1.0)
    tm.record_gauge("t.outside", 1.0)
    tm.record_hist("t.outside", 1.0)
    with tm.capture():
        seen = ("t.outside" in tm.counters(), "t.outside" in tm.gauges(),
                "t.outside" in tm.hists())
    assert seen == (False, False, False)
    return seen


def _nesting(tm):
    with tm.capture() as outer:
        tm.record("t.n", 1.0)
        with tm.capture() as inner:
            assert inner is outer and tm.counters()["t.n"] == 1.0
            tm.record("t.n", 1.0)
        assert tm.enabled()
        tm.record("t.n", 1.0)
        n = tm.counters()["t.n"]
    assert n == 3.0 and not tm.enabled()
    with tm.capture():
        assert "t.n" not in tm.counters()
    return n


def _keep(tm):
    with tm.capture():
        tm.record("t.keep", 1.0)
    with tm.capture(fresh=False):
        kept = tm.counters()["t.keep"]
    assert kept == 1.0
    return kept


def _decimation(tm):
    n = 3 * tm._Hist.CAP
    with tm.capture():
        for i in range(n):
            tm.record_hist("t.big", float(i))
        h = tm.snapshot()["hists"]["t.big"]
    assert h["count"] == n and h["sum"] == sum(range(n))
    assert h["min"] == 0.0 and h["max"] == float(n - 1)
    assert 0.4 * n < h["p50"] < 0.6 * n and h["p99"] > 0.9 * n
    return h


def _threads(tm):
    threads, per = 8, 1000

    def work():
        for k in range(per):
            tm.record("t.mt", 1.0)
            tm.record_hist("t.mt.h", float(k))

    with tm.capture():
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        snap = tm.snapshot()
    assert snap["counters"]["t.mt"] == float(threads * per)
    assert snap["hists"]["t.mt.h"]["count"] == threads * per
    return snap["counters"]["t.mt"], snap["hists"]["t.mt.h"]["sum"]


def _host_span(tm):
    with tm.capture():
        with tm.host_span("t.host", cat="step", step=3):
            pass
        (sp,) = [s for s in tm.spans() if s["name"] == "t.host"]
    assert sp["cat"] == "step" and sp["t1"] >= sp["t0"] and sp["args"] == {"step": 3}
    return sp["cat"], sp["args"]


REGISTRY_CASES = {"roundtrip": _roundtrip, "dropped_outside": _dropped_outside,
                  "nesting": _nesting, "fresh_false": _keep, "hist_decimation": _decimation,
                  "thread_safety": _threads, "host_span": _host_span}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_case_reads_as_repro(case):
    assert REGISTRY_CASES[case](telemetry) == REGISTRY_CASES[case](jtelemetry)


def test_tensor_values_stay_unread_until_resolved():
    with telemetry.capture() as ctrs:
        telemetry.emit("d.c", torch.tensor(3, dtype=torch.int32))
        telemetry.emit("d.c", 2.0)
        telemetry.emit_gauge("d.g", torch.tensor(1.5))
        telemetry.emit_gauge("d.g", 4.0)  # behind a pending value: still the last
        telemetry.emit_hist("d.h", torch.tensor(2.0))
        telemetry.emit_hist("d.h", 6.0)
        assert ctrs["d.c"] == 2.0 and "d.g" not in ctrs  # the live store: not yet read
        assert len(telemetry._PENDING) == 5  # the host values queue behind theirs
        snap = telemetry.snapshot()
    assert snap["counters"]["d.c"] == 5.0 and snap["gauges"]["d.g"] == 4.0
    assert snap["hists"]["d.h"]["count"] == 2 and snap["hists"]["d.h"]["sum"] == 8.0
    assert not telemetry._PENDING
    with telemetry.capture():
        with telemetry.trace_span("d.span", cat="kernel", device="cpu") as h:
            h.dep = telemetry.probe(torch.ones(3, 4))
        (sp,) = telemetry.spans()
    assert sp["cat"] == "kernel" and sp["t1"] >= sp["t0"]
    assert telemetry.probe(torch.ones(3, 4)).numel() == telemetry.probe(torch.zeros(0)).numel() == 1


# ---------------------------------------------------------------------------
# nothing runs outside a capture or inject
# ---------------------------------------------------------------------------


def test_nothing_runs_outside_capture_and_inject(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise AssertionError("ran outside a capture / inject")

    for name in ("record", "record_gauge", "record_hist", "emit", "emit_gauge", "emit_hist",
                 "trace_span", "host_span", "probe", "snapshot"):
        monkeypatch.setattr(telemetry, name, boom)
    for name in ("corrupt_payload", "poison_grads", "flip_bits", "poison", "content_hash"):
        monkeypatch.setattr(faults, name, boom)
    monkeypatch.setattr(T, "count_specials", boom)
    monkeypatch.setattr(qtensor, "count_specials", boom)
    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum_guarded"])
    qp = serve.load_params(serve.quantize_params(cfg, T.init_params(cfg, 0, device="cpu")))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    logits, cache = T.prefill(cfg, qp, tokens, cache_len=9)
    logits, cache = T.decode_step(cfg, qp, logits.argmax(-1), cache)
    assert torch.isfinite(logits).all()
    step = make_train_step(cfg)
    loop = TrainLoop(TrainLoopConfig(total_steps=1, ckpt_every=10, ckpt_dir=str(tmp_path),
                                     ckpt_fmt="f32", resume=False),
                     step, lambda s: {"tokens": tokens}, lambda: init_state(cfg, 0, device="cpu"))
    state = loop.run()
    assert state.opt.step.item() == 1


# ---------------------------------------------------------------------------
# export, both ways
# ---------------------------------------------------------------------------


def _populate(tm):
    tm.record("e.c", 2.0)
    tm.record_gauge("e.g", 1.5)
    tm.record_hist("e.h", 3.0)
    with tm.host_span("e.span", cat="step", step=1):
        pass


@pytest.mark.parametrize("writer", ("port", "repro"))
def test_exports_read_back_in_both_packages(tmp_path, writer):
    tm, ex = (telemetry, trace_export) if writer == "port" else (jtelemetry, jexport)
    jsonl, trace = str(tmp_path / "obs.jsonl"), str(tmp_path / "trace.json")
    with tm.capture():
        _populate(tm)
        if writer == "port":
            with tm.trace_span("kernel.matmul.t8", cat="kernel", device="cpu"):
                pass
        n_lines = ex.export_jsonl(jsonl)
        n_spans = ex.export_chrome_trace(trace)
    for reader in (trace_export, jexport):
        lines = reader.load_jsonl(jsonl)
        assert len(lines) == n_lines == 4 + (writer == "port")
        by_kind = {l["kind"]: l for l in lines}
        assert by_kind["counter"] == {"kind": "counter", "tag": "e.c", "value": 2.0}
        assert by_kind["hist"]["count"] == 1 and by_kind["span"]["dur_us"] >= 0
        evs = reader.validate_chrome_trace(reader.load_chrome_trace(trace))
        assert len(evs) == n_spans == 1 + (writer == "port")
        assert {e["cat"] for e in evs} == ({"step", "kernel"} if writer == "port" else {"step"})
        assert min(e["ts"] for e in evs) == 0.0
        assert reader.load_chrome_trace(trace)["otherData"]["counters"] == {"e.c": 2.0}
    for bad in ({"foo": 1}, {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1}]}):
        with pytest.raises(AssertionError):
            trace_export.validate_chrome_trace(bad)
    with open(trace) as fh:
        assert json.load(fh)["traceEvents"][0]["ph"] == "M"


# ---------------------------------------------------------------------------
# obs.stats: the copy against repro's
# ---------------------------------------------------------------------------


def test_stats_copy_equals_repro():
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 5, 11, 40):
        s = rng.normal(100.0, 5.0, size=n)
        for kw in ({}, {"seed": 3, "conf": 0.9, "n_boot": 500}):
            a, b = stats.bootstrap_ci(s, **kw), jstats.bootstrap_ci(s, **kw)
            assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
            sa, sb = stats.summarize(s, **kw), jstats.summarize(s, **kw)
            assert sa.keys() == sb.keys()
            assert all(np.array_equal(sa[k], sb[k], equal_nan=True) for k in sa)
    base = stats.summarize(rng.normal(100.0, 2.0, 11))
    for m in (70.0, 97.0, 100.0, 130.0):
        cand = stats.summarize(rng.normal(m, 2.0, 11))
        for eff in (0.1, 0.01):
            assert stats.ci_gate(base, cand, min_effect=eff) == \
                jstats.ci_gate(base, cand, min_effect=eff)
    assert stats.MIN_EFFECT == jstats.MIN_EFFECT


# ---------------------------------------------------------------------------
# kernel.* counters per op against repro's
# ---------------------------------------------------------------------------


def _only(store, prefix):
    return {t: c for t, c in store.items() if t.startswith(prefix)}


def test_kernel_counters_match_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 2, 16, 32)).astype(np.float32)
    wm = rng.standard_normal((64, 64)).astype(np.float32)

    def run(m, asarray):
        b = m.encode(asarray(x), "t8")
        m.decode(b, "t8")
        wb = m.encode(asarray(w), "t8")
        m.matmul(asarray(x), wb, "t8")
        m.matmul(asarray(x), wb, "t8", out_fmt="t16")
        m.dual_matmul(b, wb, "t8")
        m.dual_matmul(b, wb, "t8", out_fmt="t8")
        kb = m.encode(asarray(kv), "e4m3")
        m.decode_attention(asarray(q), kb, kb, "e4m3")
        m.decode_attention(asarray(q), kb, kb, "e4m3", out_fmt="mxe4m3")
        mx = m.encode(asarray(wm), "mxe4m3")
        m.decode(mx, "mxe4m3")
        m.matmul(asarray(x), mx, "mxe4m3")
        return b

    with jtelemetry.capture() as want:
        jax.block_until_ready(run(jops, jnp.asarray))
    with telemetry.capture() as got:
        run(ops, torch.from_numpy)
    assert _only(got, "kernel.") == _only(want, "kernel.")
    assert got["kernel.calls.matmul.t8"] == 2.0 and got["kernel.calls.encode.mxe4m3"] == 1.0
    spans = telemetry.spans()
    assert len(spans) == 13 and {s["cat"] for s in spans} == {"kernel"}
    assert {s["name"] for s in spans} >= {"kernel.matmul.t8", "kernel.decode_attention.e4m3"}


def test_port_only_ops_are_observed_under_their_names():
    """``encode_into``, ``decode_rows`` and ``matmul_t`` (no ``repro``
    counterpart) count and charge the bytes they move."""
    rng = np.random.default_rng(1)
    table = ops.encode(torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)), "t16")
    dst = torch.zeros((2, 64), dtype=torch.uint8)
    with telemetry.capture() as got:
        ops.decode_rows(table, torch.tensor([3, 5, 3]), "t16")
        ops.matmul_t(torch.ones(2, 32), table, "t16")
        ops.encode_into((torch.ones(2, 32), torch.ones(2, 32)), (dst[:, :32], dst[:, 32:]), "t8")
    assert _only(got, "kernel.") == {
        "kernel.calls.decode_rows.t16": 1.0, "kernel.wire_bytes.decode_rows": 3 * 64.0,
        "kernel.calls.matmul_t.t16": 1.0, "kernel.wire_bytes.matmul_t": 16 * 64.0,
        "kernel.calls.encode_into.t8": 1.0, "kernel.wire_bytes.encode_into": 128.0}


def test_the_import_walk_reaches_the_new_modules():
    """``test_torch_serve.py::test_port_imports_neither_jax_nor_repro`` walks
    every module of the package; these are among them."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.core.telemetry", "repro_torch.obs", "repro_torch.obs.stats",
            "repro_torch.obs.trace_export", "repro_torch.dist", "repro_torch.dist.faults"} <= names
