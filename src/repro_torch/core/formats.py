"""Wire-format registry of the port (counterpart of
``repro.core.formats.WIRE_FORMATS`` and ``wire_format``): the flat formats
t8, t16, e4m3, e5m2, bf16 and f32, and the OCP-MX block-scaled containers
mxe4m3, mxe5m2 and mxt8 (:class:`BlockScaledFormat`).

``encode``/``decode`` are the plain PyTorch codecs with kernel clamp
semantics, mapping float32 <-> bit patterns.  A flat ``encode`` returns int64
codes (:meth:`WireFormat.pack` turns them into :attr:`WireFormat.storage`);
``decode`` takes codes in any integer dtype.  An mx ``encode`` maps f32
``[..., n]`` (n a multiple of 32) to the interleaved uint8 payload
``[..., n/32*33]`` and ``decode`` maps it back (``quant.blockscale``).
``code`` is the format's id in the CUDA kernels (``kernels/csrc/codec.cuh``);
f32's moves through K1, K2 and K6 only (an f32 KV cache: its encode is the
raw bits, subnormals, signed zeros and NaN payloads kept, and its decode a
bitcast), never as K3 / K4 weights.  ``encode_np``/``decode_np`` are the
float64 numpy oracles (:mod:`.codecs_np`) the checkpoint manager packs
float leaves with.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import codecs_np, ofp8, takum


@dataclasses.dataclass(frozen=True, eq=False)
class WireFormat:
    """A machine number format the stack moves bits in.

    ``special`` names the out-of-range semantics: ``nar`` (one NaR pattern,
    finite overflow saturates), ``nan`` (no Inf, overflow becomes NaN, E4M3)
    or ``inf`` (IEEE Inf/NaN: E5M2, bf16, f32).
    """

    name: str
    nbits: int
    family: str  # takum | ofp8 | ieee
    special: str  # nar | nan | inf
    code: Optional[int] = None
    encode: Callable = dataclasses.field(repr=False, default=None)
    decode: Callable = dataclasses.field(repr=False, default=None)
    encode_np: Callable = dataclasses.field(repr=False, default=None)
    decode_np: Callable = dataclasses.field(repr=False, default=None)

    @property
    def storage(self) -> torch.dtype:
        """Narrowest unsigned container for the packed bit patterns."""
        return {8: torch.uint8, 16: torch.uint16, 32: torch.uint32}[self.nbits]

    @property
    def np_storage(self):
        """:attr:`storage` as a numpy dtype."""
        return {8: np.uint8, 16: np.uint16, 32: np.uint32}[self.nbits]

    @property
    def supports_sr(self) -> bool:
        """A stochastic-rounding encode exists: takum's and OFP8's
        (``takum.takum_encode_sr``, ``ofp8.encode_sr``)."""
        return self.family in ("takum", "ofp8")

    @property
    def signed_storage(self) -> torch.dtype:
        """Signed dtype of the same width.  CUDA builds of torch implement few
        operators for uint16/uint32, so gathers and copies of packed bits run
        on this view."""
        return {8: torch.uint8, 16: torch.int16, 32: torch.int32}[self.nbits]

    @property
    def supports_lut_decode(self) -> bool:
        """Decode can be one gather: a table of 2**nbits f32 patterns."""
        return self.nbits <= 16

    @property
    def supports_lut_encode(self) -> bool:
        """A table-driven encode exists: the 8-bit formats use the 256-entry
        exponent-byte pair, takum16 the two-level scheme.  bf16 has none:
        its encode is already a 2-op shift-round."""
        return self.nbits == 8 or (self.family == "takum" and self.nbits == 16)

    @property
    def is_block_scaled(self) -> bool:
        """True for the MX block-scaled containers (see the subclass)."""
        return False

    @property
    def wire_bits_per_el(self) -> float:
        """Wire bits per element, container overhead included."""
        return float(self.nbits)

    def pack(self, codes: torch.Tensor) -> torch.Tensor:
        """int64 codes in [0, 2**nbits) -> a :attr:`storage` tensor (built
        through the signed view, see :attr:`signed_storage`)."""
        if self.nbits == 8:
            return codes.to(torch.uint8)
        wrapped = torch.where(codes >= 1 << (self.nbits - 1), codes - (1 << self.nbits), codes)
        return wrapped.to(self.signed_storage).view(self.storage)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockScaledFormat(WireFormat):
    """OCP-MX container around an 8-bit element format: one E8M0 scale byte
    per block of 32 elements, stored interleaved as 33-byte groups
    ``[scale, e0..e31]``.  ``elem_emax`` is the exponent of the element
    format's top binade, into which the scale drops each block's absmax
    (e4m3 8, e5m2 15, t8 0).  ``nbits``/``storage`` describe the payload
    bytes; the wire cost is :attr:`wire_bits_per_el` (8.25)."""

    elem_name: str = ""
    block: int = 32
    elem_emax: int = 0

    @property
    def elem(self) -> WireFormat:
        return WIRE_FORMATS[self.elem_name]

    @property
    def is_block_scaled(self) -> bool:
        return True

    @property
    def wire_bits_per_el(self) -> float:
        return self.nbits + 8.0 / self.block

    @property
    def supports_lut_decode(self) -> bool:
        """The payload is not one code space, but the element decode inside
        the container follows the element format's tabulability."""
        return self.elem.supports_lut_decode

    @property
    def supports_lut_encode(self) -> bool:
        return self.elem.supports_lut_encode


def _mx_wire(elem_name: str, elem_emax: int, code: int) -> BlockScaledFormat:
    """The codec bodies live in ``repro_torch.quant.blockscale``, imported
    when first called: quant sits above core."""
    name = f"mx{elem_name}"

    def _bs():
        from repro_torch.quant import blockscale

        return blockscale

    return BlockScaledFormat(
        name=name, nbits=8, family="mx", special="nan_block", code=code,
        encode=lambda x: _bs().encode_payload(x, name),
        decode=lambda p: _bs().decode_payload(p, name),
        encode_np=lambda x: codecs_np.mx_encode(x, name),
        decode_np=lambda p: codecs_np.mx_decode(p, name),
        elem_name=elem_name, elem_emax=elem_emax,
    )


def _takum_wire(n: int, code: int) -> WireFormat:
    return WireFormat(
        name=f"t{n}", nbits=n, family="takum", special="nar", code=code,
        encode=lambda x: takum.takum_encode(x, n),
        decode=lambda b: takum.takum_decode(b, n),
        encode_np=lambda x: codecs_np.takum_encode(x, n),
        decode_np=lambda b: codecs_np.takum_decode(b, n),
    )


def _ofp8_wire(fmt: str, code: int) -> WireFormat:
    return WireFormat(
        name=fmt, nbits=8, family="ofp8", special="nan" if fmt == "e4m3" else "inf",
        code=code,
        encode=lambda x: ofp8.encode(x, fmt),
        decode=lambda b: ofp8.decode(b, fmt),
        encode_np=lambda x: codecs_np.ofp8_encode(x, fmt),
        decode_np=lambda b: codecs_np.ofp8_decode(b, fmt),
    )


def bf16_encode(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 bit patterns (int64): RNE on the bits, subnormals kept,
    NaN -> sign | 0x7FC0 (what XLA's convert gives)."""
    u = takum.f32_bits(x)
    is_nan = (u & 0x7FFFFFFF) > 0x7F800000
    rne = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return torch.where(is_nan, ((u >> 16) & 0x8000) | 0x7FC0, rne)


def bf16_decode(bits: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns -> float32 (a shift)."""
    return takum.f32_from_bits((takum.codes_of(bits) & 0xFFFF) << 16)


WIRE_FORMATS: dict[str, WireFormat] = {
    wf.name: wf
    for wf in [
        WireFormat(
            name="f32", nbits=32, family="ieee", special="inf", code=8,
            encode=takum.f32_bits,
            decode=lambda b: takum.f32_from_bits(takum.codes_of(b) & 0xFFFFFFFF),
            encode_np=codecs_np.f32_encode, decode_np=codecs_np.f32_decode,
        ),
        WireFormat(
            name="bf16", nbits=16, family="ieee", special="inf", code=4,
            encode=bf16_encode, decode=bf16_decode,
            encode_np=codecs_np.bf16_encode, decode_np=codecs_np.bf16_decode,
        ),
        _takum_wire(8, 0),
        _takum_wire(16, 1),
        _ofp8_wire("e4m3", 2),
        _ofp8_wire("e5m2", 3),
        _mx_wire("e4m3", 8, 5),
        _mx_wire("e5m2", 15, 6),
        _mx_wire("t8", 0, 7),
    ]
}

#: accepted spellings -> canonical registry names (bare ints are takum widths)
WIRE_ALIASES = {
    8: "t8",
    16: "t16",
    "takum8": "t8",
    "takum16": "t16",
    "float32": "f32",
    "bfloat16": "bf16",
    "ofp8_e4m3": "e4m3",
    "ofp8_e5m2": "e5m2",
    "mxfp8": "mxe4m3",  # the OCP MXFP8 default element format
    "mxfp8_e4m3": "mxe4m3",
    "mxfp8_e5m2": "mxe5m2",
    "mxtakum8": "mxt8",
}


def wire_format(spec) -> WireFormat:
    """Resolve a WireFormat | canonical name | alias | takum width -> entry."""
    if isinstance(spec, WireFormat):
        return spec
    key = WIRE_ALIASES.get(spec, spec)
    try:
        return WIRE_FORMATS[key]
    except (KeyError, TypeError):
        raise KeyError(
            f"unknown wire format {spec!r}; registered: {sorted(WIRE_FORMATS)}"
        ) from None


def kernel_wire_names() -> tuple[str, ...]:
    """The packed wire formats every kernel moves (``repro``'s
    ``kernel_wire_names``: every registered format of at most 16 bits, the
    mx containers included).  f32, the compute dtype, is left out, though
    K1, K2 and K6 take it (an f32 KV cache)."""
    return tuple(name for name, wf in WIRE_FORMATS.items()
                 if wf.code is not None and wf.nbits <= 16)
