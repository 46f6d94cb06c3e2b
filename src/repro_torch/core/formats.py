"""Format registries of the port (counterpart of ``repro.core.formats``).

The wire registry (``WIRE_FORMATS``, ``wire_format``): the flat formats
t8, t16, t32, e4m3, e5m2, bf16 and f32, and the OCP-MX block-scaled
containers mxe4m3, mxe5m2 and mxt8 (:class:`BlockScaledFormat`).  t32 has
no kernel code (``code`` None): no kernel moves it, as no Pallas codec of
``repro`` does, and ``kernels.ops`` routes it to the plain codec.

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

The figure registry (``FORMATS``, :class:`Format`,
:func:`dynamic_range_decades`): the paper's Figure 1/2 formats as float64
round trips with their dynamic-range endpoints, built on numpy and the
port's own oracles (no ``ml_dtypes``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import codecs_np, ofp8, posit_np, takum, takum_np


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


def _takum_wire(n: int, code: Optional[int]) -> WireFormat:
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
        _takum_wire(32, None),
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
    32: "t32",
    "takum8": "t8",
    "takum16": "t16",
    "takum32": "t32",
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
    K1, K2 and K6 take it (an f32 KV cache), and t32, which no kernel
    moves."""
    return tuple(name for name, wf in WIRE_FORMATS.items()
                 if wf.code is not None and wf.nbits <= 16)


# ---------------------------------------------------------------------------
# the special-code census (``repro``'s special-value telemetry)
# ---------------------------------------------------------------------------
#
# One predicate per family over raw payload bits, no decode: takum has one
# special code, NaR (the sign bit alone); e4m3 has NaN (S.1111.111); e5m2,
# bf16 and f32 an all-ones exponent (Inf or NaN); an mx container's element
# is special when its block's E8M0 scale byte is 255 (the NaN scale) or its
# element byte is special in the element format.  The mask is per logical
# element (mx: 32 lanes per 33-byte group), so ``count_specials`` over an
# element count compares across families.  The compares run in int32 /
# int64: CPU builds of torch have no compare on uint16 / uint32.


def _as_codes(wf: WireFormat, bits: torch.Tensor) -> torch.Tensor:
    """Payload bits (the storage dtype, its signed view, or the bf16 / f32
    tensor itself) as non-negative int32 / int64 codes."""
    if bits.dtype.is_floating_point:
        bits = bits.view(wf.signed_storage)
    if wf.nbits == 32:
        return bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if wf.nbits == 16:
        return bits.view(torch.int16).to(torch.int32) & 0xFFFF
    return bits.view(torch.uint8).to(torch.int32)


def _flat_special_mask(wf: WireFormat, u, xp):
    """The special-code predicate of a flat format over codes ``u`` (numpy
    unsigned, or non-negative torch ints); ``xp`` is numpy or torch."""
    if wf.family == "takum":
        return (u & ((1 << wf.nbits) - 1)) == 1 << (wf.nbits - 1)
    if wf.name == "e4m3":
        return (u & 0x7F) == 0x7F
    if wf.name == "e5m2":
        return (u & 0x7C) == 0x7C
    if wf.name == "bf16":
        return (u & 0x7FFF) >= 0x7F80
    if wf.name == "f32":
        return (u & 0x7FFFFFFF) >= 0x7F800000
    raise KeyError(f"no special predicate for wire format {wf.name!r}")


def _special_mask(payload, fmt, xp):
    wf = wire_format(fmt)
    if not wf.is_block_scaled:
        if xp is np:
            u = np.asarray(payload)
            if not np.issubdtype(u.dtype, np.unsignedinteger):
                u = u.view(wf.np_storage)
            return _flat_special_mask(wf, u, np)
        return _flat_special_mask(wf, _as_codes(wf, payload), torch)
    L = payload.shape[-1]
    if L % 33:
        raise ValueError(f"{wf.name} payload last dim {L} is not a multiple of 33 "
                         "(33-byte groups: [scale | 32 elems])")
    nb = L // 33
    lead = tuple(payload.shape[:-1])
    if xp is np:
        grp = np.asarray(payload).reshape(lead + (nb, 33))
        elem = _flat_special_mask(wf.elem, grp[..., 1:], np)
    else:
        grp = payload.view(torch.uint8).reshape(lead + (nb, 33)).to(torch.int32)
        elem = _flat_special_mask(wf.elem, grp[..., 1:], torch)
    return (elem | (grp[..., :1] == 255)).reshape(lead + (nb * 32,))


def special_mask(payload: torch.Tensor, fmt) -> torch.Tensor:
    """Per-element bool mask: which logical elements of a wire payload decode
    to a non-finite value (an mx payload [..., nb*33] gives [..., nb*32])."""
    return _special_mask(payload, fmt, torch)


def special_mask_np(payload, fmt) -> np.ndarray:
    """The numpy twin of :func:`special_mask` (the same predicates)."""
    return _special_mask(payload, fmt, np)


def count_specials(payload: torch.Tensor, fmt) -> torch.Tensor:
    """The number of special (non-finite-decoding) elements of a wire payload,
    as a 0-d int32 tensor on the payload's device (never read back here):
    NaR codes for takum, NaN / Inf codes for OFP8, bf16 and f32, NaN-scale
    blocks (32 elements each) plus corrupted element bytes for the mx
    containers."""
    return torch.sum(special_mask(payload, fmt), dtype=torch.int32)


def special_fraction(payload: torch.Tensor, fmt) -> torch.Tensor:
    """``count_specials`` over the logical element count, a 0-d float32
    tensor: the health quantity the degradation ladder thresholds on."""
    n = payload.numel()
    if wire_format(fmt).is_block_scaled:
        n = n // 33 * 32
    return count_specials(payload, fmt).to(torch.float32) / max(n, 1)


# ---------------------------------------------------------------------------
# the figure registry (float64 round trips, Figures 1-2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Format:
    """A format of the paper's figures: ``roundtrip`` takes float64 values
    through the format and back; ``minpos`` / ``maxpos`` are its smallest
    positive (subnormal, where it has them) and largest finite values."""

    name: str
    nbits: int
    family: str  # ieee | ofp8 | posit | takum | takum_log
    roundtrip: Callable[[np.ndarray], np.ndarray]
    minpos: float
    maxpos: float


def _ieee_roundtrip(dtype):
    def rt(x):
        with np.errstate(over="ignore"):
            return np.asarray(x, dtype=np.float64).astype(dtype).astype(np.float64)

    return rt


def _bf16_roundtrip(x):
    return codecs_np.bf16_decode(codecs_np.bf16_encode(x))


def _ofp8_roundtrip(fmt: str):
    """Through f32 first, then to the format: ``ml_dtypes``' float64 -> OFP8
    cast (``repro``'s oracle) rounds twice so, and a value just past a tie
    by less than an f32 ulp lands on the tie's even side."""

    def rt(x):
        with np.errstate(over="ignore"):
            x32 = np.asarray(x, dtype=np.float64).astype(np.float32).astype(np.float64)
        return codecs_np.ofp8_decode(codecs_np.ofp8_encode(x32, fmt), fmt)

    return rt


def _posit_roundtrip(n: int):
    def rt(x):
        return posit_np.decode(posit_np.encode(x, n), n)

    return rt


def _takum_roundtrip(n: int, mode: str):
    def rt(x):
        return takum_np.decode(takum_np.encode(x, n, mode), n, mode)

    return rt


def _finfo_range(dt: torch.dtype) -> tuple[float, float]:
    """(smallest subnormal, max finite) of an IEEE-derived dtype: torch's
    finfo has no ``smallest_subnormal``, so it is the smallest normal times
    eps (a product of powers of two, exact)."""
    fi = torch.finfo(dt)
    return float(fi.tiny * fi.eps), float(fi.max)


def _figure_registry() -> dict[str, Format]:
    fmts = []
    for name, dt, roundtrip in [
        ("float16", torch.float16, _ieee_roundtrip(np.float16)),
        ("bfloat16", torch.bfloat16, _bf16_roundtrip),
        ("float32", torch.float32, _ieee_roundtrip(np.float32)),
        ("float64", torch.float64, _ieee_roundtrip(np.float64)),
    ]:
        fmts.append(Format(name, torch.finfo(dt).bits, "ieee", roundtrip, *_finfo_range(dt)))
    for fmt, dt in (("e4m3", torch.float8_e4m3fn), ("e5m2", torch.float8_e5m2)):
        fmts.append(Format(f"ofp8_{fmt}", 8, "ofp8", _ofp8_roundtrip(fmt), *_finfo_range(dt)))
    for n in (8, 16, 32):
        fmts.append(Format(f"posit{n}", n, "posit", _posit_roundtrip(n), posit_np.minpos(n),
                           posit_np.maxpos(n)))
    for n in (8, 16, 32):
        for mode, name, family in (("linear", f"takum{n}", "takum"),
                                   ("log", f"takum_log{n}", "takum_log")):
            fmts.append(Format(name, n, family, _takum_roundtrip(n, mode),
                               takum_np.minpos(n, mode), takum_np.maxpos(n, mode)))
    return {f.name: f for f in fmts}


FORMATS = _figure_registry()


def dynamic_range_decades(fmt: Format) -> float:
    """log10(maxpos / minpos): the Figure 1 quantity."""
    return float(np.log10(fmt.maxpos) - np.log10(fmt.minpos))
