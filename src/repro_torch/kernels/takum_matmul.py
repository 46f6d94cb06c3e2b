"""K3: dequantising matmul ``x[M, K] @ decode(w_bits[K, N])`` with f32
accumulation (counterpart of ``repro.kernels.takum_matmul.takum_matmul``
without the ``out_fmt`` epilogue).  An mx weight is the payload
[K, ceil(N/32)*33], blocked along N; ``n`` names its logical N, and the
padded output columns are dropped.

``decode_impl`` picks the weight decode ("bits" or "lut", see :mod:`.lut`;
None is the format's default).  ``takum_matmul`` launches
``csrc/takum_matmul.cu`` for CUDA tensors and takes ``takum_matmul_plain``
for CPU tensors; ``.launches`` counts the kernel launches per codec.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import wire_format
from repro_torch.quant import blockscale
from . import _build, lut
from .common import IMPL_CODE, kernel_format, stream_of, table_ptrs
from .takum_codec import decode_2d_plain


def _logical_n(w_bits: torch.Tensor, wf, n) -> int:
    """The weight's logical N: its column count, or for an mx payload the
    ``n`` it was packed from (default: every payload column)."""
    if not wf.is_block_scaled:
        if n is not None and n != w_bits.shape[-1]:
            raise ValueError(f"n={n} does not match w_bits {tuple(w_bits.shape)}")
        return w_bits.shape[-1]
    n_pad = blockscale.elems_len(w_bits.shape[-1])
    if n is None:
        return n_pad
    if blockscale.payload_len(n) != w_bits.shape[-1] or n <= 0:
        raise ValueError(f"n={n} does not match the mx payload width {w_bits.shape[-1]}")
    return n


def takum_matmul_plain(x: torch.Tensor, w_bits: torch.Tensor, fmt, n=None,
                       acc: torch.dtype = torch.float32, decode_impl=None) -> torch.Tensor:
    """Plain PyTorch K3: decode the whole weight (through ``decode_impl``),
    then one matmul in ``acc`` (float32; float64 is the order control of
    ``ops.plain_path``), returned as float32."""
    w = decode_2d_plain(w_bits, fmt, decode_impl)[:, :_logical_n(w_bits, wire_format(fmt), n)]
    return torch.matmul(x.to(acc), w.to(acc)).to(torch.float32)


def takum_matmul(x: torch.Tensor, w_bits: torch.Tensor, fmt, n=None,
                 decode_impl=None) -> torch.Tensor:
    """K3: x [M, K] f32/bf16 @ decode(w_bits [K, N]) -> [M, N] float32; an mx
    ``w_bits`` is the payload [K, ceil(N/32)*33] and ``n`` its logical N."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    if x.dim() != 2 or w_bits.dim() != 2 or x.shape[1] != w_bits.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(x.shape)} @ {tuple(w_bits.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_bits.dtype != wf.storage:
        raise TypeError(f"w_bits must be {wf.storage} for {wf.name}, got {w_bits.dtype}")
    N = _logical_n(w_bits, wf, n)
    if x.device.type == "cpu" and w_bits.device.type == "cpu":
        return takum_matmul_plain(x, w_bits, wf, N, decode_impl=impl)
    if x.device.type != "cuda" or w_bits.device != x.device:
        raise ValueError(f"x and w_bits must share one CUDA device, got {x.device}, {w_bits.device}")
    if not (x.is_contiguous() and w_bits.is_contiguous()):
        raise ValueError("x and w_bits must be contiguous")
    M, K = x.shape
    if max(M, N, K) >= 2**31:
        raise ValueError("matmul dims must fit in int32")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel():
        fn = _build.entry("repro_matmul")
        _build.check(
            fn(x.data_ptr(), w_bits.data_ptr(), out.data_ptr(), M, N, K,
               int(x.dtype == torch.bfloat16), wf.code, IMPL_CODE[impl],
               *table_ptrs(wf, impl, "decode", x.device), stream_of(x)),
            "takum_matmul",
        )
        takum_matmul.launches[impl] += 1
    return out


takum_matmul.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
