"""Rank-side bodies of the dist tests (``tests/test_torch_dist_*.py``).

Each function runs on every rank of a ``repro_torch.dist.spawn.RankPool``
(gloo, on the CPU) and returns host values; the test process holds them
against ``repro``.  This module imports torch and the port only, so a rank
starts without JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, convert, serve, tree
from repro_torch.core import telemetry
from repro_torch.dist import collectives as C
from repro_torch.dist import error_feedback as EF
from repro_torch.dist import faults
from repro_torch.dist import pipeline as PL
from repro_torch.dist import step as dstep
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.quant.policy import GuardPolicy, QuantPolicy
from repro_torch.train.step import init_state

_MESHES: dict = {}


def mesh_of(dims, names):
    """One mesh per shape a process (its groups are made once)."""
    key = (tuple(dims), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(dims, names)
    return _MESHES[key]


def ring_group():
    return mesh_of((dist.get_world_size(),), ("pod",)).group("pod")


def _wire_counters():
    return {k: v for k, v in telemetry.counters().items() if k.startswith(("wire.", "ef."))}


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def ring_cases(x_all, cases, sr_bits, sr_fmts, mx27):
    """``compressed_psum`` / ``_pmean`` on this rank's slice of ``x_all``:
    every (name, fmt, exact_local, mean) of ``cases``, the 27-wide mx
    cases, the SR rings fed ``repro``'s per-rank draws, and a captured t8
    ring's counters."""
    g = ring_group()
    r = dist.get_rank()
    x = torch.from_numpy(x_all[r])
    out = {}
    for name, fmt, el, mean in cases:
        fn = C.compressed_pmean if mean else C.compressed_psum
        out[name] = fn(x, g, fmt, exact_local=el)
    for fmt in mx27:
        out[f"psum27_{fmt}"] = C.compressed_psum(x[..., :27], g, fmt)
    for fmt in sr_fmts:
        out[f"psumsr_{fmt}"] = C.compressed_psum(x, g, fmt, sr_key=torch.from_numpy(
            sr_bits[r].astype(np.int64)))
    with telemetry.capture():
        C.compressed_psum(x, g, "t8")
        out["counters"] = _wire_counters()
    return out


def ring_launches(x, fmt, exact_local, chunk):
    """One ring's K1 / K2 calls per rank, counted at ``ops`` (on the CPU the
    wrappers run their plain versions), with ``chunk`` elements a ring
    pass, and the result."""
    counts = {"encode": 0, "decode": 0}
    saved = ops.encode, ops.decode

    def count(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    ops.encode, ops.decode = count("encode", saved[0]), count("decode", saved[1])
    C.RING_CHUNK, ring_chunk = chunk, C.RING_CHUNK
    try:
        got = C.compressed_psum(torch.from_numpy(x[dist.get_rank()]), ring_group(), fmt,
                                exact_local=exact_local)
    finally:
        ops.encode, ops.decode = saved
        C.RING_CHUNK = ring_chunk
    return {"out": got, **counts}


def ef_gradients(step, P, shape, scales=None):
    """The P ranks' gradients at ``step`` ([P, *shape] f32), rank r's scaled
    by ``scales[r]``."""
    g = np.random.default_rng(10 + step).standard_normal((P, *shape)).astype(np.float32)
    if scales is not None:
        g = g * np.asarray(scales, np.float32).reshape(-1, *[1] * len(shape))
    return g


def ef_steps(fmt, steps, shape, guard=None, poison_rank=None, scales=None, chunk=None):
    """``steps`` error-feedback steps from zero residuals, the gradients drawn
    as the reference draws them (:func:`ef_gradients`), ``chunk`` elements
    a ring pass if given; under ``guard``, ``poison_rank``'s first gradient
    holds NaNs.  Returns each step's reduced sum and residual."""
    g_ = ring_group()
    r = dist.get_rank()
    err = EF.ef_init(torch.zeros(shape))
    out = {}
    ring_chunk = C.RING_CHUNK
    C.RING_CHUNK = chunk or ring_chunk
    try:
        with telemetry.capture():
            for s in range(steps):
                g = torch.from_numpy(ef_gradients(s, dist.get_world_size(), shape, scales)[r])
                if poison_rank == r and s == 0:
                    g[0, :3] = float("nan")
                red, err = EF.ef_compressed_psum(g, err, g_, fmt, guard=guard)
                out[f"red{s}"], out[f"err{s}"] = red, err
            out["counters"] = _wire_counters()
    finally:
        C.RING_CHUNK = ring_chunk
    return out


def degraded(x_all, fmt, guard_kw, nan_rank, exact_local=True):
    """``degraded_psum`` with NaNs planted in ``nan_rank``'s input, beside the
    port's ``compressed_psum`` of the contained input at every rung, and
    the counters."""
    g = ring_group()
    r = dist.get_rank()
    x = torch.from_numpy(x_all[r]).clone()
    if r == nan_rank:
        x[0, :5] = float("nan")
        x[1, 3] = float("inf")
    guard = GuardPolicy(**guard_kw)
    with telemetry.capture():
        got = C.degraded_psum(x, g, fmt, guard, exact_local=exact_local)
        ctr = _wire_counters()
    clean = torch.where(torch.isfinite(x), x, torch.zeros(()))
    rungs = {name: C.compressed_psum(clean, g, name, exact_local=exact_local)
             for name in guard.ladder_from(fmt)}
    return {"out": got, "rungs": rungs, "counters": ctr, "clean": clean}


def hop_faults(x_all, fmt, fault_kw, guard_kw):
    """The guarded ring under hop faults: the output, ``wire.contained``,
    and every arriving message as the ring received it (to count the
    contained elements apart from the ring)."""
    g = ring_group()
    x = torch.from_numpy(x_all[dist.get_rank()])
    seen = []
    real = faults.corrupt_hop

    def record(msg, group=None):
        got = real(msg, group)
        seen.append((msg.clone(), got.clone()))
        return got

    C.faults.corrupt_hop = record
    try:
        with faults.inject(faults.FaultConfig(**fault_kw)), telemetry.capture():
            out = C.degraded_psum(x, g, fmt, GuardPolicy(**guard_kw))
            ctr = _wire_counters()
    finally:
        C.faults.corrupt_hop = real
    return {"out": out, "counters": ctr, "sent": [a for a, _ in seen],
            "got": [b for _, b in seen]}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _stage(w, h):
    return torch.tanh(h @ w)


def _linear(w, h):
    return h @ w


def pipeline(ws, x, wire_fmt=None, guard_kw=None, linear=False):
    """``pipeline_apply`` of ``tanh(h @ w)`` stages (``h @ w`` if ``linear``)
    over every rank, with the per-tick trip decisions of a guarded run and
    the ``pipe.*`` counters."""
    r = dist.get_rank()
    mesh = mesh_of((dist.get_world_size(),), ("pipe",))
    trips = []
    real = PL.trips

    def record(*a, **k):
        t = real(*a, **k)
        trips.append(t)
        return t

    PL.trips = record
    try:
        with telemetry.capture():
            out = PL.pipeline_apply(_linear if linear else _stage, torch.from_numpy(ws[r]),
                                    torch.from_numpy(x),
                                    mesh=mesh, wire_fmt=wire_fmt,
                                    guard=None if guard_kw is None else GuardPolicy(**guard_kw))
            ctr = {k: v for k, v in telemetry.counters().items() if k.startswith("pipe.")}
    finally:
        PL.trips = real
    return {"out": out, "trips": trips, "counters": ctr}


# ---------------------------------------------------------------------------
# the train and serve steps
# ---------------------------------------------------------------------------


def port_state(jstate_np, cfg):
    return convert.train_state_from_numpy(jstate_np, cfg, device="cpu")


def pod_step_vs_repro(jstate_np, tokens, policy):
    """The pod step on (2, 2, 1) from ``repro``'s state, one step."""
    cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**policy))
    mesh = mesh_of((2, 2, 1), ("pod", "data", "model"))
    st, m = dstep.make_train_step(cfg, mesh)(port_state(jstate_np, cfg),
                                             {"tokens": torch.from_numpy(tokens)})
    return {"params": tree.flatten(st.params)[0], "loss": m["loss"], "ce": m["ce"]}


def train_steps(dims, names, policy, tokens, steps, seed=0, poison_rank=None, lr=3e-4):
    """``steps`` steps of ``dist.step.make_train_step`` on one batch from the
    port's own init; ``poison_rank`` poisons its gradients (every step)."""
    cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**policy))
    mesh = mesh_of(dims, names)
    st = init_state(cfg, seed, device="cpu")
    step = dstep.make_train_step(cfg, mesh, lr=lr)
    hist, oks = [], []
    scope = (faults.inject(faults.FaultConfig(seed=3, grad_poison_rate=1.0))
             if poison_rank == dist.get_rank() else contextlib.nullcontext())
    with scope, telemetry.capture():
        for _ in range(steps):
            st, m = step(st, {"tokens": torch.from_numpy(tokens)})
            hist.append(float(m["ce"]))
            oks.append(float(m["grad_ok"]))
        skipped = telemetry.counters().get("step.skipped", 0.0)
    return {"params": tree.flatten(st.params)[0], "ce": hist, "ok": oks, "skipped": skipped,
            "opt_step": int(st.opt.step)}


def serve_rows(dims, names, policy, tokens, steps):
    """The mesh prefill and ``steps`` greedy decode steps on this rank's rows
    (the port's packed path), from the port's seeded init."""
    cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**policy))
    mesh = mesh_of(dims, names)
    qp = serve.load_params(dstep.quantize_params(cfg, T.init_params(cfg, 0, device="cpu")))
    logits, cache = dstep.make_prefill_step(cfg, mesh, cache_len=tokens.shape[1] + steps)(
        qp, {"tokens": torch.from_numpy(tokens)})
    out = [logits]
    decode = dstep.make_serve_step(cfg, mesh)
    tok = torch.from_numpy(tokens[:, -1])
    for s in range(steps):
        logits, cache = decode(qp, {"token": tok}, cache)
        out.append(logits)
        tok = torch.from_numpy((np.arange(tokens.shape[0]) * 7 + s) % cfg.vocab_size)
    return {"logits": torch.stack(out), "rows": dstep.local_rows(mesh, tokens.shape[0])}


def fails(kind):
    """A rank that raises (rank 1) or blocks (every rank waits on a peer that
    never sends), for the spawner's error paths."""
    if kind == "raise" and dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    if kind == "block" and dist.get_rank() == 0:
        t = torch.zeros(1)
        dist.recv(t, 1)
    return dist.get_rank()


def launcher(argv):
    """``repro_torch.launch.train.main(argv)`` on this rank: its CE history,
    or the message of what it raised."""
    from repro_torch.launch import train

    try:
        _, hist = train.main(argv)
    except ValueError as e:
        return {"error": str(e)}
    return {"ce": [m["ce"] for m in hist]}


def pod_batch_refused(B):
    """The pod step on a batch the pod axis does not divide: the message."""
    cfg = configs.get_smoke("llama3_8b")
    mesh = mesh_of((2, 2, 1), ("pod", "data", "model"))
    tokens = torch.zeros((B, 8), dtype=torch.int64)
    try:
        dstep.make_train_step(cfg, mesh)(init_state(cfg, 0, device="cpu"), {"tokens": tokens})
    except ValueError as e:
        return str(e)
    return None
