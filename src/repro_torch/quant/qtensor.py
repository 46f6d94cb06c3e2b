"""QTensor: a quantised tensor (format + bits + per-tensor scale), the
counterpart of ``repro.quant.qtensor`` for the flat formats.

Takum and OFP8 tensors hold packed bit patterns in the format's storage
dtype and an optional power-of-two f32 scale (exact to reapply); bf16 holds
the bf16 tensor itself and f32 the f32 tensor, as in ``repro``.  Encode and
decode go through :mod:`repro_torch.kernels.ops`, i.e. K2 and K1 on the
card.  Stochastic rounding comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops


@dataclass
class QTensor:
    bits: torch.Tensor  # packed patterns, or the bf16/f32 tensor itself
    fmt: str
    scale: Optional[torch.Tensor] = None  # 0-d f32 power of two, or None

    @property
    def shape(self):
        return self.bits.shape

    def __getitem__(self, idx) -> "QTensor":
        """Slice the bits; the per-tensor scale is shared by every slice."""
        return QTensor(self.bits[idx], self.fmt, self.scale)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def pow2_scale(x: torch.Tensor) -> torch.Tensor:
    """Nearest power of two to RMS(x): exactly invertible scaling."""
    ms = torch.mean(torch.square(x.to(torch.float32)))
    rms = torch.sqrt(torch.clamp(ms, min=1e-30))
    return torch.exp2(torch.round(torch.log2(rms))).to(torch.float32)


def quantize(x: torch.Tensor, fmt: str, *, scaled: bool = False) -> QTensor:
    """Quantise x into ``fmt`` with round-to-nearest-even."""
    wf = wire_format(fmt)
    if wf.name == "f32":
        return QTensor(x.to(torch.float32), wf.name)
    if wf.name == "bf16":
        return QTensor(x.to(torch.bfloat16), wf.name)
    scale = pow2_scale(x) if scaled else None
    xs = x.to(torch.float32) if scale is None else x.to(torch.float32) / scale
    return QTensor(ops.encode(xs, wf), wf.name, scale)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if q.fmt in ("f32", "bf16"):
        return q.bits.to(dtype)
    x = ops.decode(q.bits, q.fmt)
    if q.scale is not None:
        x = x * q.scale
    return x.to(dtype)
