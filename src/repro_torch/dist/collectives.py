"""Wire-format-compressed collectives (counterpart of
``repro.dist.collectives``).

A reduction payload crosses the group as packed wire-format bits (t8 / t16,
OFP8 e4m3 / e5m2, bf16, or an mx container) while every sum stays in f32.
``compressed_psum`` is a P-hop ring: each rank encodes its payload once
(K2, ``ops.encode``; the takum and OFP8 stochastic-rounding encodes are
plain PyTorch, as ``repro``'s are jnp), the packed bits travel P - 1 hops
to rank + 1 (``comm``: host-staged under gloo), and each arrival is kept
packed until the ring is done.  Then the ranks decode (K1, ``ops.decode``)
and add the terms in f32 in *source* order (sources 0, 1, ..., P - 1, each
added to a running sum that starts at zero, as XLA reduces ``repro``'s
stacked terms), so every rank's sum is the same bits.  ``repro`` stacks P
f32 terms; keeping the arrivals packed holds 1/4 to 1/2 of that.  A payload
longer than ``RING_CHUNK`` elements rides the ring chunk by chunk (each
chunk a multiple of 32 elements of the flat, mx-padded payload, so every
mx block is ``repro``'s block); each chunk is encoded, sent and summed
before the next, so the packed copies never exceed one chunk.  The guarded
ring and error feedback encode every chunk before the first is sent (the
health check and the residual need them all), so they hold the whole
packed payload.

With ``exact_local=True`` a rank's own term is its f32 input (P - 1 terms
carry one quantisation error each); ``exact_local=False`` (the pmean's and
the train step's default) decodes its own payload too, one more K1, so all
ranks add identical terms.  "f32" is no compressed wire: it is the group's
native all-reduce, as ``repro`` falls through to ``lax.psum``.

``degraded_psum`` adds the guards of a
:class:`~repro_torch.quant.policy.GuardPolicy` (DESIGN.md §8): non-finite
inputs are zeroed and counted, arriving terms pass the ``contain_abs``
rail, and each rung's local health check (the payload's special fraction,
the relative rms error of its finite lanes) is all-reduced into one trip
flag *before* any rank branches, so every rank takes the same rung and no
collective runs in one rank's branch alone.  Reading the flag is one host
sync a rung.

Under a telemetry capture: ``wire.calls``, ``wire.rung.<fmt>``, a
``wire.ring.<fmt>`` span per call and a ``wire.hop.<fmt>`` span per hop
(category ``collective``), ``wire.hops`` (P - 1 a call) and
``wire.hop_bytes`` (the packed bytes this rank sent); the guarded ring
adds ``wire.rung``, ``wire.escalated``, ``wire.contained`` and
``wire.specials_in``.  Each rank counts its own, as each of ``repro``'s
devices does.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import telemetry
from repro_torch.core.formats import count_specials, wire_format
from repro_torch.kernels import ops
from repro_torch.quant import blockscale
from repro_torch.quant.qtensor import _encode_sr

from . import comm, faults
from .comm import axis_index, axis_size

#: elements of the flat payload per ring pass (a multiple of 32)
RING_CHUNK = 1 << 26


def _span(name: str, device):
    return (telemetry.trace_span(name, cat="collective", device=device)
            if telemetry.enabled() else contextlib.nullcontext())


def sr_draws(sr_key):
    """The SR draws ``(start, count) -> int64 tensor of uint32 values`` of a
    key: an int seeds a generator per call (``faults.mix(key, start)``, on
    the device of the values), a tensor gives its own flat elements (the
    tests pass ``repro``'s draws so)."""
    if isinstance(sr_key, torch.Tensor):
        flat = sr_key.reshape(-1).to(torch.int64)
        return lambda start, count, device=None: flat[start:start + count]

    def draw(start, count, device=None):
        g = torch.Generator(device=device)
        g.manual_seed(faults.mix(sr_key, start))
        return torch.randint(0, 1 << 32, (count,), generator=g, device=device,
                             dtype=torch.int64)

    return draw


def wire_codec(fmt, *, sr_key=None):
    """(encode, decode) moving f32 payloads through wire format ``fmt``.

    ``encode(v, start=0)`` maps f32 to the packed payload (the bf16 wire as
    its uint16 bits; an mx format as the interleaved payload, last dim n ->
    n/32*33, n a multiple of 32): K2 on the card.  ``decode`` maps a payload
    back to f32: K1.  ``sr_key`` (see :func:`sr_draws`) switches the takum
    and OFP8 encodes to stochastic rounding, plain PyTorch, with the draws
    of flat elements [start, start + numel); bf16 and the mx containers
    ignore it.  "f32" and formats without a table decode raise."""
    wf = wire_format(fmt)
    if wf.name == "f32":
        raise ValueError("f32 is the accumulate format, not a compressed wire")
    if not (wf.name == "bf16" or wf.is_block_scaled or wf.supports_lut_decode):
        raise ValueError(f"compressed wire format {wf.name!r} unsupported: the LUT decode "
                         "tabulates 2**n entries (use a <=16-bit format, or f32/bf16)")
    if sr_key is not None and wf.supports_sr and not wf.is_block_scaled:
        draws = sr_draws(sr_key)

        def encode(v, start=0):
            rnd = lambda s, c: draws(start + s, c, v.device)  # noqa: E731
            return _encode_sr(v.to(torch.float32), wf, rnd)
    else:
        def encode(v, start=0):
            return ops.encode(v, wf)
    return _arm_encode(encode, wf.name), (lambda m: ops.decode(m, wf))


def _arm_encode(encode, fmt_name: str):
    """Inside a ``faults.inject`` scope that corrupts wires, encoded payloads
    take the payload faults on their way out; else ``encode`` itself."""
    cfg = faults.active()
    if cfg is None or not cfg.corrupts_wire:
        return encode
    return lambda v, start=0: faults.corrupt_payload(encode(v, start), fmt_name)


def _hops(wire: torch.Tensor, group, fmt_name: str) -> dict:
    """P - 1 hops of ``wire`` to rank + 1: returns {source: message} for
    every other source, each on ``wire``'s device.  Staged under gloo, the
    host copy received is what goes out on the next hop."""
    N, p = axis_size(group), axis_index(group)
    staged = comm.staged(wire, group)
    msg = comm.to_transport(wire, group, "ring0")
    out = {}
    for i in range(1, N):
        with _span(f"wire.hop.{fmt_name}", wire.device):
            recv = (comm.pinned(f"ring{i % 2}", msg).view(msg.shape) if staged
                    else torch.empty_like(msg))
            comm.exchange(msg, (p + 1) % N, recv, (p - 1) % N, group)
            msg = faults.corrupt_hop(recv, group)
            out[(p - i) % N] = msg.to(wire.device, copy=True) if msg.device != wire.device \
                else msg
    return out


def _sum_terms(own, arrivals: dict, decode, group, canonical_order: bool, contain_abs):
    """The f32 sum of the own term and the decoded arrivals, in source order
    (or arrival order), each term through the containment rail; returns
    (sum, contained count as a 0-d f32 tensor)."""
    N, p = axis_size(group), axis_index(group)
    order = range(N) if canonical_order else [(p - i) % N for i in range(N)]
    acc = torch.zeros_like(own, dtype=torch.float32)
    contained = torch.zeros((), dtype=torch.float32, device=own.device)
    for s in order:
        term = own if s == p else decode(arrivals[s])
        if contain_abs is not None:
            bad = ~torch.isfinite(term) | (torch.abs(term) > contain_abs)
            contained = contained + bad.sum(dtype=torch.float32)
            term = torch.where(bad, torch.zeros((), dtype=term.dtype, device=term.device), term)
        acc += term
    return acc, contained


def _ring_reduce(wire, own_f32, group, decode, canonical_order: bool = True,
                 contain_abs=None, fmt_name: str = "wire"):
    """P - 1 hops of one packed payload; the f32 sum of the decodes (see the
    module docstring).  Returns ``(sum, contained)``, ``contained`` this
    rank's count of zeroed elements (0 with ``contain_abs`` None).  Counts
    ``wire.hops`` and ``wire.hop_bytes`` under a capture."""
    if telemetry.enabled():
        N = axis_size(group)
        telemetry.emit("wire.hops", float(N - 1))
        telemetry.emit("wire.hop_bytes", float((N - 1) * wire.numel() * wire.element_size()))
    arrivals = _hops(wire, group, fmt_name)
    return _sum_terms(own_f32, arrivals, decode, group, canonical_order, contain_abs)


def _chunks(n: int):
    """(start, count) of each ring pass over ``n`` flat elements."""
    if RING_CHUNK % 32:
        raise ValueError(f"ring chunk {RING_CHUNK} is not a multiple of 32")
    return [(s, min(RING_CHUNK, n - s)) for s in range(0, n, RING_CHUNK)] or [(0, 0)]


def encode_chunks(xp: torch.Tensor, encode) -> list:
    """The flat payload ``xp`` encoded pass by pass: [(wire, f32 part)]."""
    flat = xp.reshape(-1)
    return [(encode(flat[s:s + c], s), flat[s:s + c]) for s, c in _chunks(flat.numel())]


def decode_chunks(pairs, decode, like: torch.Tensor) -> torch.Tensor:
    """The f32 decode of :func:`encode_chunks`'s wires, in ``like``'s shape."""
    out = torch.empty(like.numel(), dtype=torch.float32, device=like.device)
    for (wire, _), (s, c) in zip(pairs, _chunks(like.numel())):
        out[s:s + c] = decode(wire).reshape(-1)
    return out.view(like.shape)


def _padded(xf: torch.Tensor, wf) -> torch.Tensor:
    """The payload the ring moves: ``xf``, its last axis zero-padded to whole
    32-blocks for an mx format (a 0-d payload as one element)."""
    if not wf.is_block_scaled:
        return xf
    return blockscale.pad_block(xf.reshape(1) if xf.dim() == 0 else xf)


def _unpadded(out: torch.Tensor, x: torch.Tensor, wf) -> torch.Tensor:
    if not wf.is_block_scaled:
        return out
    n = x.shape[-1] if x.dim() else 1
    return out[..., :n].reshape(x.shape)


def _ring_payload(xp, encode, decode, group, exact_local, canonical_order, contain_abs,
                  fmt_name, wires=None):
    """The ring over the flat payload ``xp``, chunk by chunk (``wires``: the
    chunks already encoded, as the guarded path keeps them).  Returns (sum
    in ``xp``'s shape, contained)."""
    flat = xp.reshape(-1)
    out = torch.empty_like(flat)
    contained = torch.zeros((), dtype=torch.float32, device=xp.device)
    for k, (s, c) in enumerate(_chunks(flat.numel())):
        part = flat[s:s + c]
        wire = encode(part, s) if wires is None else wires[k]
        own = part if exact_local else decode(wire)
        out[s:s + c], cc = _ring_reduce(wire, own, group, decode, canonical_order, contain_abs,
                                        fmt_name)
        contained = contained + cc
    return out.view(xp.shape), contained


def compressed_psum(x: torch.Tensor, group, fmt="t8", *, exact_local: bool = True,
                    canonical_order: bool = True, sr_key=None) -> torch.Tensor:
    """All-reduce-sum of ``x`` over ``group`` with wire-compressed payloads
    (``repro``'s ``compressed_psum``; ``group`` where it takes the axis
    name).  "f32" is the group's native all-reduce.  ``sr_key`` switches
    the takum / OFP8 encode to stochastic rounding; fold the ring member's
    index into it so the members' noise decorrelates, but give replicas of
    one source the same key.  Returns f32 of ``x``'s shape."""
    xf = x.to(torch.float32)
    wf = wire_format(fmt)
    if wf.name == "f32":
        return comm.all_reduce(xf, group)
    if axis_size(group) == 1:
        return xf
    encode, decode = wire_codec(wf.name, sr_key=sr_key)
    with _span(f"wire.ring.{wf.name}", x.device):
        out, _ = _ring_payload(_padded(xf, wf), encode, decode, group, exact_local,
                               canonical_order, None, wf.name)
        out = _unpadded(out, x, wf)
    if telemetry.enabled():
        telemetry.emit("wire.calls", 1.0)
        telemetry.emit(f"wire.rung.{wf.name}", 1.0)
    return out


def compressed_pmean(x: torch.Tensor, group, fmt="t8", *, exact_local: bool = False,
                     canonical_order: bool = True, sr_key=None) -> torch.Tensor:
    """Mean-reduction variant (the gradient sync): the local term quantised
    by default, so the ranks add identical terms."""
    n = axis_size(group)
    out = compressed_psum(x, group, fmt, exact_local=exact_local,
                          canonical_order=canonical_order, sr_key=sr_key)
    return out if n == 1 else out.div_(n)  # a new tensor over a group: divided in place


def health(pairs, decode, fmt_name: str):
    """``repro``'s local health check of an encoded payload given as
    [(wire, f32 part)]: (special fraction of the payload, relative rms
    error of its finite lanes), as 0-d f32 tensors, accumulated over the
    parts."""
    dev = pairs[0][1].device
    n_spec = torch.zeros((), dtype=torch.float64, device=dev)
    n_el = 0
    err2 = torch.zeros((), dtype=torch.float64, device=dev)
    x2 = torch.zeros((), dtype=torch.float64, device=dev)
    for wire, part in pairs:
        part = part.reshape(-1)
        n_spec = n_spec + count_specials(wire, fmt_name)
        n_el += part.numel()
        q = decode(wire).reshape(-1)
        err = torch.where(torch.isfinite(q), q - part, torch.zeros((), device=q.device))
        err2 = err2 + torch.sum(torch.square(err), dtype=torch.float64)
        x2 = x2 + torch.sum(torch.square(part), dtype=torch.float64)
    n = max(n_el, 1)
    spec = (n_spec / n).to(torch.float32)
    rel = (torch.sqrt(err2 / n) / (torch.sqrt(x2 / n) + 1e-12)).to(torch.float32)
    return spec, rel


def trips(spec, rel, guard, group) -> bool:
    """The ring-uniform trip decision: each rank's check, all-reduced
    before anyone branches, read on the host (one sync)."""
    local = ((spec > guard.max_special_frac) | (rel > guard.max_rel_err)).to(torch.float32)
    return comm.all_reduce(local.reshape(1), group).item() > 0


def degraded_psum(x: torch.Tensor, group, fmt, guard, *, exact_local: bool = True,
                  canonical_order: bool = True, sr_key=None) -> torch.Tensor:
    """Guarded all-reduce-sum: ``compressed_psum`` with the guards of
    ``guard`` (see the module docstring): input containment, hop
    containment, and the degradation ladder ``guard.ladder_from(fmt)``,
    whose last rung always sends (f32: the native all-reduce)."""
    xf = x.to(torch.float32)
    bad_in = ~torch.isfinite(xf)
    n_bad = bad_in.sum(dtype=torch.float32)
    xf = torch.where(bad_in, torch.zeros((), device=xf.device), xf)
    rungs = guard.ladder_from(wire_format(fmt).name)
    N = axis_size(group)
    contain = guard.contain_abs if guard.contain_hops else None
    zero = torch.zeros((), dtype=torch.float32, device=xf.device)
    rung, contained = 0, zero
    if N == 1 or rungs == ("f32",):
        out = xf if N == 1 else comm.all_reduce(xf, group)
    else:
        for i, name in enumerate(rungs):
            rung = i
            wf = wire_format(name)
            if wf.name == "f32":
                if telemetry.enabled():
                    telemetry.emit("wire.rung.f32", 1.0)
                out = comm.all_reduce(xf, group)
                break
            xp = _padded(xf, wf)
            key = sr_key if wf.family in ("takum", "ofp8") else None
            encode, decode = wire_codec(wf.name, sr_key=key)
            pairs = encode_chunks(xp, encode)
            if i < len(rungs) - 1 and trips(*health(pairs, decode, wf.name), guard, group):
                continue
            with _span(f"wire.ring.{wf.name}", x.device):
                out, contained = _ring_payload(xp, encode, decode, group, exact_local,
                                               canonical_order, contain, wf.name,
                                               [w for w, _ in pairs])
            out = _unpadded(out, x, wf)
            if telemetry.enabled():
                telemetry.emit(f"wire.rung.{wf.name}", 1.0)
            break
    if telemetry.enabled():
        telemetry.emit("wire.calls", 1.0)
        telemetry.emit("wire.rung", float(rung))
        telemetry.emit("wire.escalated", float(rung > 0))
        telemetry.emit("wire.contained", contained)
        telemetry.emit("wire.specials_in", n_bad)
    return out


def degraded_pmean(x: torch.Tensor, group, fmt, guard, *, exact_local: bool = False,
                   canonical_order: bool = True, sr_key=None) -> torch.Tensor:
    """Guarded mean-reduction (the gradient sync under a GuardPolicy)."""
    n = axis_size(group)
    out = degraded_psum(x, group, fmt, guard, exact_local=exact_local,
                        canonical_order=canonical_order, sr_key=sr_key)
    return out if n == 1 else out.div_(n)


def wire_bytes_per_element(fmt, pods: int) -> float:
    """Bytes per payload element crossing the wire on a ``pods``-wide ring:
    P - 1 messages of the full payload, each element at its format's wire
    bits (8.25 for an mx container: the scale byte is charged to its 32
    elements)."""
    return (pods - 1) * wire_format(fmt).wire_bits_per_el / 8
