"""Plain twins of the device codecs (counterpart of ``repro.kernels.common``).

``decode_takum_f32`` and ``encode_takum_from_f32`` name the plain PyTorch
versions of the K0 ``__device__`` takum codecs in ``csrc/codec.cuh``: the
linear takum codec of ``core.takum``, whose clamp semantics are the kernels'
(c > 127 saturates to f32 max-finite, c < -126 flushes to zero, NaR <->
NaN/Inf, RNE with guard and sticky bits, DAZ).  The module also holds the
small helpers every kernel wrapper shares.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import WireFormat, wire_format
from repro_torch.core.takum import takum_decode as decode_takum_f32  # noqa: F401
from repro_torch.core.takum import takum_encode as encode_takum_from_f32  # noqa: F401


def kernel_format(fmt) -> WireFormat:
    """Resolve ``fmt`` and check that a CUDA kernel can move it."""
    wf = wire_format(fmt)
    if wf.code is None:
        raise ValueError(f"no kernel moves wire format {wf.name!r}")
    return wf


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
