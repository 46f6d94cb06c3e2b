"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``): ``encode``, ``decode``, ``matmul``,
``decode_attention``.

Each op takes a wire-format handle (a registered name such as 't8', 'e4m3',
'bf16', a :class:`~repro_torch.core.formats.WireFormat`, or a bare takum
width).  ``encode``/``decode`` take any rank >= 1 and flatten to 2-D for the
element-wise K1/K2 kernels.

On CUDA tensors the ops launch the kernels; on CPU tensors the kernel
wrappers take their plain versions.  ``use_kernels(False)`` routes every op
through the plain versions on any device: it is the explicit reference mode
``chip_smoke.py`` holds the kernel path against, never a fallback taken on
an error.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import wire_format
from .takum_attention import decode_attention_plain, takum_decode_attention
from .takum_codec import decode_2d_plain, encode_2d_plain, takum_decode_2d, takum_encode_2d
from .takum_matmul import takum_matmul, takum_matmul_plain

_USE_KERNELS = True

#: every kernel wrapper of this slice; each carries a ``.launches`` count
KERNELS = {
    "takum_decode_2d": takum_decode_2d,
    "takum_encode_2d": takum_encode_2d,
    "takum_matmul": takum_matmul,
    "takum_decode_attention": takum_decode_attention,
}


def use_kernels(flag: bool) -> None:
    """Route the ops through the kernels (True, default) or the plain versions."""
    global _USE_KERNELS
    _USE_KERNELS = bool(flag)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _as_2d(x: torch.Tensor):
    """ND -> 2-D view for the element-wise codec kernels.  Returns
    ``(x2d, orig_shape_or_None)``; 1-D becomes one row, >= 3-D folds the
    leading dims onto the rows."""
    if x.dim() == 2:
        return x, None
    if x.dim() == 1:
        return x.reshape(1, -1), x.shape
    return x.reshape(-1, x.shape[-1]), x.shape


def encode(x: torch.Tensor, fmt) -> torch.Tensor:
    """float32 [...] -> packed wire bits of the same shape (K2)."""
    wf = wire_format(fmt)
    if x.dim() == 0:
        raise ValueError("encode takes rank >= 1")
    x2, shape = _as_2d(x.to(torch.float32).contiguous())
    out = takum_encode_2d(x2, wf) if _USE_KERNELS else encode_2d_plain(x2, wf)
    return out if shape is None else out.reshape(shape)


def decode(bits: torch.Tensor, fmt) -> torch.Tensor:
    """Packed wire bits [...] -> float32 of the same shape (K1)."""
    wf = wire_format(fmt)
    if bits.dim() == 0:
        raise ValueError("decode takes rank >= 1")
    b2, shape = _as_2d(bits.contiguous())
    out = takum_decode_2d(b2, wf) if _USE_KERNELS else decode_2d_plain(b2, wf)
    return out if shape is None else out.reshape(shape)


def matmul(x: torch.Tensor, w_bits: torch.Tensor, fmt) -> torch.Tensor:
    """x [M, K] @ decode(w_bits [K, N]) -> [M, N] float32 (K3)."""
    wf = wire_format(fmt)
    if _USE_KERNELS:
        return takum_matmul(x.contiguous(), w_bits.contiguous(), wf)
    return takum_matmul_plain(x, w_bits, wf)


def decode_attention(q, k_bits, v_bits, fmt, *, length=None, window=0, softcap=0.0,
                     scale=None) -> torch.Tensor:
    """One-token GQA decode attention over a packed KV cache (K6); see
    :func:`~repro_torch.kernels.takum_attention.takum_decode_attention`."""
    wf = wire_format(fmt)
    fn = takum_decode_attention if _USE_KERNELS else decode_attention_plain
    return fn(q.contiguous(), k_bits, v_bits, wf, length, window, softcap, scale)
