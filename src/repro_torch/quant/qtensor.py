"""QTensor: a quantised tensor (format + bits + scale), the counterpart of
``repro.quant.qtensor``.

Takum and OFP8 tensors hold packed bit patterns in the format's storage
dtype and an optional power-of-two f32 scale (exact to reapply); bf16 holds
the bf16 tensor itself and f32 the f32 tensor, as in ``repro``.  The mx
containers hold the interleaved wire payload ``[..., ceil(n/32)*33]`` in
``bits`` (what K1-mx and K3-mx read), the logical last-axis length in ``n``
and the per-32-block E8M0 scale bytes in ``scale`` (a view into the
payload); ``repro`` keeps the element bytes and the scales apart instead, and
:func:`repro_torch.convert.params_from_numpy` interleaves them.  Encode and
decode go through :mod:`repro_torch.kernels.ops`, i.e. K2 and K1 on the
card, each with the format's default codec.  Given ``rnd_bits``, takum and
OFP8 encode with stochastic rounding instead (``takum.takum_encode_sr``,
``ofp8.encode_sr``: plain PyTorch, as ``repro``'s SR encode is jnp), in
chunks of at most ``SR_CHUNK`` elements; bf16 and the mx containers stay
RNE, as in ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import ofp8, takum
from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops
from . import blockscale

#: elements per slice of the SR encode: its int64 temporaries take about
#: 100 bytes per element, so a 525M-element embedding stays in bounded memory
SR_CHUNK = 1 << 24


@dataclass
class QTensor:
    bits: torch.Tensor  # packed patterns, the bf16/f32 tensor itself, or an mx payload
    fmt: str
    scale: Optional[torch.Tensor] = None  # 0-d f32 power of two | mx E8M0 bytes | None
    n: Optional[int] = None  # mx: logical length of the last axis

    @classmethod
    def from_payload(cls, payload: torch.Tensor, fmt: str, n: int) -> "QTensor":
        """An mx QTensor over ``payload`` [..., ceil(n/32)*33] of ``n`` logical
        elements per row; ``scale`` views the payload's scale bytes."""
        if payload.shape[-1] != blockscale.payload_len(n):
            raise ValueError(f"payload width {payload.shape[-1]} does not carry n={n}")
        groups = payload.reshape(*payload.shape[:-1], -1, blockscale.GROUP)
        return cls(payload, wire_format(fmt).name, groups[..., 0], n)

    @property
    def block_scaled(self) -> bool:
        return self.n is not None

    @property
    def shape(self):
        """The logical shape (an mx payload's last axis counts elements)."""
        if self.block_scaled:
            return torch.Size((*self.bits.shape[:-1], self.n))
        return self.bits.shape

    def __getitem__(self, idx) -> "QTensor":
        """Slice or gather the leading axes (16-bit bits through their signed
        view, see ``WireFormat.signed_storage``).  A per-tensor scale is
        shared by every slice; mx scale bytes go with their payload rows."""
        signed = wire_format(self.fmt).signed_storage
        bits = self.bits.view(signed)[idx].view(self.bits.dtype)
        if self.block_scaled:
            return QTensor.from_payload(bits, self.fmt, self.n)
        return QTensor(bits, self.fmt, self.scale)

    def apply_scale(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` times the per-tensor scale, if any (an mx decode has already
        applied its block scales)."""
        return y if self.block_scaled or self.scale is None else y * self.scale

    def wire_payload(self) -> torch.Tensor:
        """The interleaved uint8 wire payload (block-scaled formats only)."""
        if not self.block_scaled:
            raise ValueError(f"{self.fmt} is not a block-scaled format")
        return self.bits

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def pow2_scale(x: torch.Tensor) -> torch.Tensor:
    """Nearest power of two to RMS(x): exactly invertible scaling.  The power
    is assembled from its exponent's bits, so it is exact on every device
    (``repro``'s ``jnp.exp2`` is not off small integers on XLA's CPU backend:
    ROADMAP R5); a non-finite RMS gives ``exp2`` of its log, NaN or Inf,
    as there."""
    ms = torch.mean(torch.square(x.to(torch.float32)))
    rms = torch.sqrt(torch.clamp(ms, min=1e-30))
    e = torch.round(torch.log2(rms))
    exact = takum.pow2_f32(torch.nan_to_num(e, nan=0.0, posinf=0.0).to(torch.int64))
    return torch.where(torch.isfinite(e), exact, torch.exp2(e))


def _encode_sr(xs: torch.Tensor, wf, rnd_bits) -> torch.Tensor:
    """The SR encode of f32 ``xs`` into ``wf``'s storage, slice by slice of
    the flattened tensor.  ``rnd_bits``: uint32 values of xs's shape in an
    integer tensor, or a callable ``(start, count) -> tensor`` giving those
    of flat elements [start, start + count)."""
    flat = xs.reshape(-1)
    out = torch.empty(flat.shape, dtype=wf.signed_storage, device=xs.device)
    if not callable(rnd_bits):
        bits = rnd_bits.reshape(-1)
        rnd_bits = lambda start, count: bits[start:start + count]  # noqa: E731
    for start in range(0, flat.numel(), SR_CHUNK):
        x = flat[start:start + SR_CHUNK]
        r = rnd_bits(start, x.numel())
        codes = (takum.takum_encode_sr(x, wf.nbits, r) if wf.family == "takum"
                 else ofp8.encode_sr(x, r, wf.name))
        out[start:start + x.numel()] = wf.pack(codes).view(wf.signed_storage)
    return out.view(wf.storage).reshape(xs.shape)


def quantize(x: torch.Tensor, fmt: str, *, scaled: bool = False, rnd_bits=None) -> QTensor:
    """Quantise x into ``fmt`` with round-to-nearest-even (K2), or, given
    ``rnd_bits`` and a takum or OFP8 format, with stochastic rounding (see
    :func:`_encode_sr` for what ``rnd_bits`` may be; the other formats
    ignore it, as ``repro``'s ``sr_key``).  The mx formats ignore
    ``scaled``: the per-block E8M0 scale is the scaling."""
    wf = wire_format(fmt)
    if wf.name == "f32":
        return QTensor(x.to(torch.float32), wf.name)
    if wf.name == "bf16":
        return QTensor(x.to(torch.bfloat16), wf.name)
    if wf.is_block_scaled:
        payload = ops.encode(blockscale.pad_block(x.to(torch.float32)), wf)
        return QTensor.from_payload(payload, wf.name, x.shape[-1])
    scale = pow2_scale(x) if scaled else None
    xs = x.to(torch.float32) if scale is None else x.to(torch.float32) / scale
    if rnd_bits is not None and wf.supports_sr:
        return QTensor(_encode_sr(xs, wf, rnd_bits), wf.name, scale)
    return QTensor(ops.encode(xs, wf), wf.name, scale)


def requantize(q: QTensor, x: torch.Tensor, rnd_bits=None) -> QTensor:
    """Re-encode fresh values into ``q``'s format (the optimizer-state
    refresh): same format, a per-tensor scale recomputed iff ``q`` carries
    one."""
    return quantize(x, q.fmt, scaled=q.scale is not None, rnd_bits=rnd_bits)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if q.fmt in ("f32", "bf16"):
        return q.bits.to(dtype)
    x = ops.decode(q.bits, q.fmt)
    if q.block_scaled:
        x = x[..., :q.n]
    return q.apply_scale(x).to(dtype)
