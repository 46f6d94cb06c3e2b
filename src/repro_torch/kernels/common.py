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
from repro_torch.quant import blockscale
from .lut import resolve_out_fmt, tables_on


def kernel_format(fmt, *, f32: bool = True) -> WireFormat:
    """Resolve ``fmt`` and check that a CUDA kernel can move it; ``f32``:
    whether the kernel takes f32 bits (K1, K2 and K6 do; K3 / K4 weights
    and the producers' out formats do not)."""
    wf = wire_format(fmt)
    if wf.code is None or (wf.name == "f32" and not f32):
        raise ValueError(f"no kernel moves wire format {wf.name!r} here")
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


#: the C entries' out-format id of an unfused launch (``repro::kOutF32``)
OUT_F32 = -1


def out_format(out_fmt, encode_impl, n: int, dim: str = "N"):
    """A producer's ``out_fmt=`` / ``encode_impl=`` resolved, on every route:
    ``(out WireFormat, encode impl)``, or ``(None, None)`` for f32 output.
    Raises as ``lut.resolve_out_fmt`` does, for f32 (the unfused output
    already is), and for an mx out whose last dim ``n`` (the matmul's N, the
    attention's head dim) is not whole 32-element blocks, as ``repro``
    does."""
    name, impl = resolve_out_fmt(out_fmt, encode_impl)
    if name is None:
        return None, None
    out_wf = kernel_format(name, f32=False)
    if out_wf.is_block_scaled and n % blockscale.BLOCK:
        raise ValueError(f"block-scaled out_fmt needs a 32-multiple {dim}, got {n}")
    return out_wf, impl


def empty_out(lead: tuple, n: int, out_wf, device) -> torch.Tensor:
    """A producer's output: f32 [*lead, n], or ``out_wf``'s packed bits
    [*lead, n] (an mx payload [*lead, n/32*33])."""
    if out_wf is None:
        return torch.empty((*lead, n), dtype=torch.float32, device=device)
    cols = blockscale.payload_len(n) if out_wf.is_block_scaled else n
    return torch.empty((*lead, cols), dtype=out_wf.storage, device=device)


def epilogue_args(out_wf, out_impl, device) -> tuple:
    """The four trailing epilogue arguments of a producer's C entry: out
    format id, encode codec id and encode table pointers; ``(OUT_F32, 0, 0,
    0)`` for f32 output (``out_wf`` None)."""
    if out_wf is None:
        return (OUT_F32, 0, 0, 0)
    return (out_wf.code, IMPL_CODE[out_impl], *table_ptrs(out_wf, out_impl, "encode", device))


def launch_key(impl: str, out_name=None, out_impl=None, transposed=False) -> str:
    """Key of a launch in a wrapper's ``.launches``: the decode codec, and
    for a fused launch the out format and its encode codec
    (``"lut>t8:lut"``); a transposed-weight launch (K5's backward) is
    ``"lut^T"``."""
    if transposed:
        return f"{impl}^T"
    return impl if out_name is None else f"{impl}>{out_name}:{out_impl}"


#: blocks a split plan aims for (K3 at small M, K6): two per SM of the
#: H100's 132, so that every SM has a second block to run while one waits
TARGET_BLOCKS = 2 * 132


def count_launch(fn, key: str) -> None:
    fn.launches[key] = fn.launches.get(key, 0) + 1
