"""Eager oracles for the port's kernels (counterpart of ``repro.kernels.ref``).

Each name is the plain PyTorch version that sits beside its kernel: codecs
are held to them bit for bit, matmul and attention at a stated tolerance
(accumulation order differs between implementations).
"""

from __future__ import annotations

from .takum_attention import decode_attention_plain as decode_attention_ref  # noqa: F401
from .takum_codec import decode_2d_plain as codec_decode_ref  # noqa: F401
from .takum_codec import encode_2d_plain as codec_encode_ref  # noqa: F401
from .takum_matmul import takum_matmul_plain as takum_matmul_ref  # noqa: F401
