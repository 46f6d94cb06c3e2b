"""Pipeline parallelism: GPipe-style microbatched stages over a process
group (counterpart of ``repro.dist.pipeline``).

``pipeline_apply`` runs ``x``'s M microbatches through the P stages of a
"pipe" group, one stage a rank, on ``repro``'s M + P - 1 tick wavefront: at
tick t stage p runs ``stage_fn`` on microbatch t - p (stage 0 feeds
microbatch min(t, M - 1), the later stages what they received), then every
stage sends its output to stage p + 1 (stage 0 receives nothing; the last
stage sends nothing).  As in ``repro`` every stage computes every tick,
the bubble ticks' outputs never reaching a result.  With f32 hops the
numbers are the sequential composition's.

``wire_fmt`` compresses the hops (``QuantPolicy.pipe_act``): the sender
encodes its output (K2; an mx format pads the last axis to whole blocks),
the packed bits cross the group (host-staged under gloo), the receiver
decodes (K1) and slices.  A ``guard`` arms ``repro``'s per-tick guards: the
sender's health check of its encoded output (special fraction, relative
rms error), the trip all-reduced over the group *before* the branch so
every stage escalates the same tick, one rung wider (f32 exact), and the
containment rail on every arrival.

Under a telemetry capture each rank counts ``pipe.ticks``, ``pipe.hops``
(guarded), ``pipe.hop_bytes`` (its hop's packed bytes, the base rung's
under a guard), ``pipe.escalated`` and ``pipe.contained``, and each tick's
hop is a ``pipe.hop.<fmt>`` span (category ``collective``).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import telemetry
from repro_torch.core.formats import wire_format
from repro_torch.quant import blockscale

from . import comm, faults
from .collectives import health, trips, wire_codec
from .comm import axis_index, axis_size


def _hop_codec(name: str, last_n: int):
    """(encode, decode) of one hop rung, the mx padding folded in; (None,
    None) for the exact f32 rung."""
    if name == "f32":
        return None, None
    wf = wire_format(name)
    encode, decode = wire_codec(wf.name)
    if wf.is_block_scaled:
        enc0, dec0 = encode, decode
        encode = lambda v: enc0(blockscale.pad_block(v))  # noqa: E731
        decode = lambda m: dec0(m)[..., :last_n]  # noqa: E731
    return encode, decode


def _encoded_like(x: torch.Tensor, name: str) -> torch.Tensor:
    """An empty payload of the shape and dtype a hop of ``x`` carries."""
    wf = wire_format(name)
    if wf.is_block_scaled:
        shape = (*x.shape[:-1], blockscale.payload_len(x.shape[-1]))
    else:
        shape = x.shape
    return torch.empty(shape, dtype=wf.storage, device=x.device)


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, mesh=None, axis: str = "pipe",
                   wire_fmt=None, guard=None) -> torch.Tensor:
    """Run microbatches through the stages of a process group.

    Args:
      stage_fn: ``(stage_params, h) -> h`` for one stage (shape kept).
      stage_params: this rank's stage (each process holds its own; ``repro``
        takes the stack and shards its leading dim over the axis).
      x: ``[M, microbatch, ...]`` input microbatches, the same on every rank.
      mesh, axis: the mesh and its axis the stages are laid out over (no
        mesh: one stage, this process).
      wire_fmt: None / "f32" for exact hops, or a <=16-bit wire format.
      guard: an optional :class:`~repro_torch.quant.policy.GuardPolicy`.

    Returns the final stage's output for every microbatch, ``[M,
    microbatch, ...]``, on every rank of the group (an all-reduce of the
    last stage's buffer with the others' zeros, ``repro``'s ``psum``).
    """
    group = None if mesh is None else mesh.group(axis)
    name = "f32" if wire_fmt is None else wire_format(wire_fmt).name
    hop_encode, hop_decode = _hop_codec(name, x.shape[-1])
    esc_encode = esc_decode = None
    if guard is not None and hop_encode is not None:
        rungs = guard.ladder_from(name)
        if len(rungs) > 1:  # one step wider a tick
            esc_encode, esc_decode = _hop_codec(rungs[1], x.shape[-1])

    N, p = axis_size(group), axis_index(group)
    dst = p + 1 if p < N - 1 else None
    src = p - 1 if p > 0 else None
    M = x.shape[0]
    dev = x.device

    def contain(recv):
        if guard is None or not guard.contain_hops:
            return recv
        bad = ~torch.isfinite(recv) | (torch.abs(recv) > guard.contain_abs)
        if telemetry.enabled():
            telemetry.emit("pipe.contained", bad.sum(dtype=torch.float32))
        return torch.where(bad, torch.zeros((), dtype=recv.dtype, device=recv.device), recv)

    def move(payload):
        """One hop of ``payload``: the message from stage p - 1 (faults
        applied on arrival), or None at stage 0."""
        got = comm.shift(payload, group, dst, src)
        return None if got is None else faults.corrupt_hop(got, group)

    def nbytes(t) -> float:
        return float(t.numel() * t.element_size())

    def plain_hop(out):
        if telemetry.enabled():
            telemetry.emit("pipe.hop_bytes", nbytes(out))
        got = move(out)
        return None if got is None else contain(got)

    def coded_hop(out):
        wire = hop_encode(out) if dst is not None else _encoded_like(out, name)
        if telemetry.enabled():
            telemetry.emit("pipe.hop_bytes", nbytes(wire))
        got = move(wire)
        return None if got is None else contain(hop_decode(got).to(x.dtype))

    def guarded_hop(out):
        outf = out.to(torch.float32)
        wire = hop_encode(outf)
        trip = trips(*health([(wire, outf)], hop_decode, name), guard, group)
        if telemetry.enabled():
            telemetry.emit("pipe.hops", 1.0)
            telemetry.emit("pipe.escalated", float(trip))
            telemetry.emit("pipe.hop_bytes", nbytes(wire))
        if not trip:
            got = move(wire)
            got = None if got is None else hop_decode(got)
        elif esc_encode is None:  # the next rung is f32: an exact hop
            got = move(outf)
        else:
            got = move(esc_encode(outf))
            got = None if got is None else esc_decode(got)
        return None if got is None else contain(got).to(x.dtype)

    recv = torch.zeros(x.shape[1:], dtype=x.dtype, device=dev)
    out_buf = torch.zeros_like(x)
    for t in range(M + N - 1):
        inp = x[min(t, M - 1)] if p == 0 else recv
        out = stage_fn(stage_params, inp)
        m = t - (N - 1)
        if 0 <= m < M and p == N - 1:
            out_buf[m] = out
        if N > 1:
            if telemetry.enabled():
                telemetry.emit("pipe.ticks", 1.0)
            span = (telemetry.trace_span(f"pipe.hop.{name}", cat="collective", device=dev)
                    if telemetry.enabled() else contextlib.nullcontext())
            with span:
                if hop_encode is None:
                    got = plain_hop(out)
                elif guard is None:
                    got = coded_hop(out)
                else:
                    got = guarded_hop(out)
            if got is not None:
                recv = got
    return comm.all_reduce(out_buf, group)
