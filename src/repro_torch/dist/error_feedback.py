"""Error-feedback compressed reduction (counterpart of
``repro.dist.error_feedback``).

Each rank carries its quantisation residual into its next contribution::

    c_t   = g_t + e_{t-1}          (gradient + carried residual)
    q_t   = decode(encode(c_t))    (K2 then K1: the value transmitted)
    e_t   = c_t - q_t              (new residual, stays local)
    out_t = ring_sum_j q_t^(j)     (the compressed ring over the q's)

so that ``sum_t out_t = exact total - sum_j e_T^(j)``: the accumulated
error is bounded by the final residuals.  The local term entering the ring
is ``q_t``, what the rest of the ring received.  Every lossy wire format
works (takum, OFP8, bf16, the mx containers; f32 raises).
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import telemetry
from repro_torch.core.formats import wire_format

from . import comm
from .collectives import (_padded, _ring_payload, _unpadded, decode_chunks, encode_chunks,
                          health, trips, wire_codec)
from .comm import axis_size


def ef_init(params):
    """A zero f32 residual for each leaf of ``params``."""
    return tree.map_leaves(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                           params)


def _emit(name: str, v) -> None:
    if telemetry.enabled():
        telemetry.emit(name, v)


def ef_compressed_psum(g, err, group, fmt="t8", guard=None):
    """Compressed psum with error feedback; returns ``(reduced, new_err)``.

    ``g`` and ``err`` are matching trees (or single tensors), ``group`` the
    ring's process group.  With a :class:`~repro_torch.quant.policy.GuardPolicy`
    the reduction takes ``degraded_psum``'s guards (input containment, the
    hop rail, the ladder with its trip all-reduced before the branch), and
    the residual is always taken against the format actually transmitted:
    at the f32 rung it is zero."""
    wf = wire_format(fmt)
    encode, decode = wire_codec(wf.name)  # also rejects fmt="f32"
    N = axis_size(group)
    rungs = (wf.name,) if guard is None else guard.ladder_from(wf.name)
    contain = guard.contain_abs if guard is not None and guard.contain_hops else None

    def send(cp, enc, dec, name, pairs=None, contain_abs=None):
        """The ring of the transmitted values q = dec(enc(cp)), chunk by
        chunk as ``compressed_psum`` runs it: (sum, residual cp - q,
        contained)."""
        pairs = encode_chunks(cp, enc) if pairs is None else pairs
        q = decode_chunks(pairs, dec, cp)
        if N == 1:
            return q, cp - q, torch.zeros((), dtype=torch.float32, device=cp.device)
        # q is every chunk's own decode: the ring's local term, no K1 again
        reduced, contained = _ring_payload(q, None, dec, group, True, True, contain_abs, name,
                                           [w for w, _ in pairs])
        return reduced, cp - q, contained

    def one(gl, el):
        c = gl.to(torch.float32) + el
        if guard is None:
            reduced, new_err, _ = send(_padded(c, wf), encode, decode, wf.name)
            _emit("ef.calls", 1.0)
            return _unpadded(reduced, gl, wf), _unpadded(new_err, gl, wf)

        bad = ~torch.isfinite(c)
        n_bad = bad.sum(dtype=torch.float32)
        c = torch.where(bad, torch.zeros((), device=c.device), c)
        contained = torch.zeros((), dtype=torch.float32, device=c.device)
        for i, name in enumerate(rungs):
            rwf = wire_format(name)
            if rwf.name == "f32":  # exact: the residual telescopes to nothing
                reduced, new_err = comm.all_reduce(c, group), torch.zeros_like(c)
                _emit("ef.rung.f32", 1.0)
                break
            cp = _padded(c, rwf)
            enc, dec = wire_codec(rwf.name)
            pairs = encode_chunks(cp, enc)
            if i < len(rungs) - 1 and trips(*health(pairs, dec, rwf.name), guard, group):
                continue
            # the residual against what was sent
            reduced, new_err, contained = send(cp, enc, dec, rwf.name, pairs, contain)
            reduced, new_err = _unpadded(reduced, gl, rwf), _unpadded(new_err, gl, rwf)
            _emit(f"ef.rung.{rwf.name}", 1.0)
            break
        _emit("ef.calls", 1.0)
        _emit("ef.rung", float(i))
        _emit("ef.escalated", float(i > 0))
        _emit("ef.contained", contained)
        _emit("ef.specials_in", n_bad)
        return reduced, new_err

    flat_g, spec = tree.flatten(g)
    flat_e = tree.flatten(err)[0]
    pairs = [one(gl, el) for gl, el in zip(flat_g, flat_e)]
    return (tree.unflatten(spec, [r for r, _ in pairs]),
            tree.unflatten(spec, [e for _, e in pairs]))
