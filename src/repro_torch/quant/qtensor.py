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
card, each with the format's default codec.  Stochastic rounding comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops
from . import blockscale


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
    """Nearest power of two to RMS(x): exactly invertible scaling."""
    ms = torch.mean(torch.square(x.to(torch.float32)))
    rms = torch.sqrt(torch.clamp(ms, min=1e-30))
    return torch.exp2(torch.round(torch.log2(rms))).to(torch.float32)


def quantize(x: torch.Tensor, fmt: str, *, scaled: bool = False) -> QTensor:
    """Quantise x into ``fmt`` with round-to-nearest-even.  The mx formats
    ignore ``scaled``: the per-block E8M0 scale is the scaling."""
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
    return QTensor(ops.encode(xs, wf), wf.name, scale)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if q.fmt in ("f32", "bf16"):
        return q.bits.to(dtype)
    x = ops.decode(q.bits, q.fmt)
    if q.block_scaled:
        x = x[..., :q.n]
    return q.apply_scale(x).to(dtype)
