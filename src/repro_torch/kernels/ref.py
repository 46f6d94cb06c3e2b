"""Eager oracles for the port's kernels (counterpart of ``repro.kernels.ref``).

Each name is the plain PyTorch version that sits beside its kernel: codecs
are held to them bit for bit, matmul and attention at a stated tolerance
(accumulation order differs between implementations).
"""

from __future__ import annotations

from .takum_attention import decode_attention_plain as decode_attention_ref  # noqa: F401
from .takum_codec import decode_2d_plain as codec_decode_ref  # noqa: F401
from .takum_codec import encode_2d_plain as codec_encode_ref  # noqa: F401
from .takum_matmul import takum_dual_matmul_plain as takum_dual_matmul_ref  # noqa: F401
from .takum_matmul import takum_matmul_plain as takum_matmul_ref  # noqa: F401


# The fused out_fmt epilogue's contract (``repro.kernels.ref`` :54-78): the
# plain encode of the plain output; the epilogue adds no rounding of its own.

def fused_matmul_ref(x, w_bits, fmt, out_fmt, n=None, decode_impl=None, encode_impl=None):
    """``encode(takum_matmul_ref(...), out_fmt)``."""
    return takum_matmul_ref(x, w_bits, fmt, n, decode_impl=decode_impl, out_fmt=out_fmt,
                            encode_impl=encode_impl)


def fused_dual_matmul_ref(x_bits, w_bits, fmt, out_fmt, n=None, decode_impl=None,
                          encode_impl=None):
    """``encode(takum_dual_matmul_ref(...), out_fmt)``: bits in, bits out."""
    return takum_dual_matmul_ref(x_bits, w_bits, fmt, n, decode_impl=decode_impl,
                                 out_fmt=out_fmt, encode_impl=encode_impl)


def fused_decode_attention_ref(q, k_bits, v_bits, fmt, out_fmt, decode_impl=None,
                               encode_impl=None, **kw):
    """``encode(decode_attention_ref(...), out_fmt)``; ``kw``: length,
    window, softcap, scale."""
    return decode_attention_ref(q, k_bits, v_bits, fmt, decode_impl=decode_impl,
                                out_fmt=out_fmt, encode_impl=encode_impl, **kw)
