"""K1 / K2: wire-format decode and encode over [R, C] (counterpart of
``repro.kernels.takum_codec``).  Flat formats map [R, C] bits <-> [R, C]
f32 element by element; the mx containers map an interleaved payload
[R, C/32*33] <-> [R, C] f32 (encode needs C % 32 == 0).

``takum_decode_2d`` / ``takum_encode_2d`` launch the CUDA kernels in
``csrc/takum_codec.cu`` for a CUDA tensor and take the plain versions
``decode_2d_plain`` / ``encode_2d_plain`` for a CPU tensor.  ``decode_impl``
/ ``encode_impl`` pick the codec ("bits" or "lut", see :mod:`.lut`; None is
the format's default), in the kernel and in the plain version alike.  Each
wrapper counts its kernel launches per codec in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import wire_format
from repro_torch.quant import blockscale
from . import _build, lut
from .common import IMPL_CODE, kernel_format, stream_of, table_ptrs


def _check_2d(t: torch.Tensor, dtype, what: str) -> None:
    if t.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


#: elements per slice of the plain codecs: their int64 temporaries take about
#: 100 bytes per element, so a [4096, 128256] head stays in bounded memory
_PLAIN_CHUNK = 1 << 24


def _by_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply the element-wise ``fn`` to ``x`` in slices along dim 0."""
    if x.numel() <= _PLAIN_CHUNK:
        return fn(x)
    rows = max(1, _PLAIN_CHUNK // (x.numel() // x.shape[0]))
    return torch.cat([fn(x[r:r + rows]) for r in range(0, x.shape[0], rows)])


def decode_2d_plain(bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """Plain PyTorch K1: [R, C] packed bits (an mx payload [R, C/32*33]) ->
    [R, C] float32, through the table gather or the bits decode."""
    return _by_rows(lut.decode_fn(fmt, decode_impl), bits)


def encode_2d_plain(x: torch.Tensor, fmt, encode_impl=None) -> torch.Tensor:
    """Plain PyTorch K2: [R, C] float32 -> [R, C] packed bits (storage dtype),
    or the mx payload [R, C/32*33], through the table or the bits encode."""
    wf = wire_format(fmt)
    enc = lut.encode_fn(wf, encode_impl)
    packed = _by_rows(lambda c: wf.pack(enc(c)).view(wf.signed_storage), x.to(torch.float32))
    return packed.view(wf.storage)


def takum_decode_2d(bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """K1: [R, C] packed wire bits (an mx payload [R, C/32*33]) -> [R, C]
    float32 (kernel clamp semantics)."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    _check_2d(bits, wf.storage, "bits")
    R, L = bits.shape
    C = blockscale.elems_len(L) if wf.is_block_scaled else L
    if bits.device.type == "cpu":
        return decode_2d_plain(bits, wf, impl)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    out = torch.empty((R, C), dtype=torch.float32, device=bits.device)
    if out.numel():
        fn = _build.entry("repro_decode")
        _build.check(fn(bits.data_ptr(), out.data_ptr(), out.numel(), wf.code, IMPL_CODE[impl],
                        *table_ptrs(wf, impl, "decode", bits.device), stream_of(bits)),
                     "takum_decode_2d")
        takum_decode_2d.launches[impl] += 1
    return out


def takum_encode_2d(x: torch.Tensor, fmt, encode_impl=None) -> torch.Tensor:
    """K2: [R, C] float32 -> [R, C] packed wire bits; RNE, DAZ, saturation
    (takum) or overflow to NaN/Inf (OFP8, bf16).  An mx format gives the
    payload [R, C/32*33] and needs C % 32 == 0."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(encode_impl, wf, "encode")
    _check_2d(x, torch.float32, "x")
    R, C = x.shape
    if wf.is_block_scaled and C % blockscale.BLOCK:
        raise ValueError(f"block-scaled encode needs a 32-multiple column count, got {C}")
    if x.device.type == "cpu":
        return encode_2d_plain(x, wf, impl)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    cols = blockscale.payload_len(C) if wf.is_block_scaled else C
    out = torch.empty((R, cols), dtype=wf.storage, device=x.device)
    if x.numel():
        fn = _build.entry("repro_encode")
        _build.check(fn(x.data_ptr(), out.data_ptr(), x.numel(), wf.code, IMPL_CODE[impl],
                        *table_ptrs(wf, impl, "encode", x.device), stream_of(x)),
                     "takum_encode_2d")
        takum_encode_2d.launches[impl] += 1
    return out


takum_decode_2d.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
takum_encode_2d.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
