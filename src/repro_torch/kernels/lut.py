"""Per-format codec selection (counterpart of the "bits" half of
``repro.kernels.lut``).

``repro`` offers a table-gather ("lut") and a branch-free ("bits") codec for
each format and proves them bit-identical (``tests/test_tables.py``).  The
port has the bits codecs only; the tables come with a later slice.  For the
mx containers the registry's codec already is the container
(``quant.blockscale``) around the element format's bits codec, so the same
lookup serves them.  The ``*_fast`` names are the plain K1/K2 versions in
``takum_codec``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.formats import wire_format
from .takum_codec import decode_2d_plain as decode_fast  # noqa: F401
from .takum_codec import encode_2d_plain as encode_fast  # noqa: F401


def decode_bits_fn(fmt) -> Callable[[torch.Tensor], torch.Tensor]:
    """The format's branch-free decode: bit patterns (an mx payload) -> float32."""
    return wire_format(fmt).decode


def encode_bits_fn(fmt) -> Callable[[torch.Tensor], torch.Tensor]:
    """The format's branch-free encode: float32 -> int64 bit patterns (an mx
    format: the uint8 payload)."""
    return wire_format(fmt).encode
