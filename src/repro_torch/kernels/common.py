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
from .lut import tables_on


def kernel_format(fmt) -> WireFormat:
    """Resolve ``fmt`` and check that a CUDA kernel can move it."""
    wf = wire_format(fmt)
    if wf.code is None:
        raise ValueError(f"no kernel moves wire format {wf.name!r}")
    return wf


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


#: the C entries' codec ids (``repro::Impl`` in ``csrc/codec.cuh``)
IMPL_CODE = {"bits": 0, "lut": 1}


def table_ptrs(wf: WireFormat, impl: str, op: str, device) -> tuple[int, ...]:
    """Device pointers of the tables a kernel reads under ``impl``: (decode
    table,) or (meta, thr | sub) for op "encode"; null pointers for "bits".
    Raises on a table of the wrong size or type, or on another device: the
    kernels read fixed table lengths."""
    n = 1 if op == "decode" else 2
    if impl == "bits":
        return (0,) * n
    name = wf.elem_name if wf.is_block_scaled else wf.name
    nbits = wire_format(name).nbits
    want = [1 << nbits] if op == "decode" else [256, 128 if name == "t16" else 256]
    tabs = tables_on(wf, op, device)
    for t, size in zip(tabs, want, strict=True):
        if t.dtype != torch.int32 or t.numel() != size or t.device != device or not t.is_contiguous():
            raise ValueError(f"{op} table for {name}: want {size} contiguous int32 on {device}, "
                             f"got {t.numel()} {t.dtype} on {t.device}")
    return tuple(t.data_ptr() for t in tabs)
