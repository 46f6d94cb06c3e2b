"""Per-format codec selection and the table ("lut") codecs (counterpart of
``repro.kernels.lut``).

Every tabulable format has two codecs that agree bit for bit.  "bits" is the
format family's branch-free codec (takum bit assembly, OFP8 field
pack/unpack, bf16 shift; the registry's ``WireFormat.encode``/``decode``).
"lut" gathers from the tables of :mod:`repro_torch.core.tables`: decode is
one gather of the code's f32 bit pattern, encode two gathers indexed by the
f32 exponent byte and a short integer tail.  The ``decode_impl`` /
``encode_impl`` knob of every kernel op picks one; ``None`` takes the
per-format default (:func:`resolve_impl`, the same tables as ``repro``).  An
mx container resolves against its element format: the knob selects the
element codec inside the container, whose scale path is the same either way.

The functions here are the plain PyTorch versions (integer work in int64:
torch has no unsigned 32-bit shifts) that run on the CPU and that the CUDA
twins in ``csrc/codec.cuh`` are held against.  :func:`tables_on` keeps one
copy of each table per device, uploaded at first use.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.formats import wire_format
from repro_torch.core.tables import (ENC8_THR_FLAG, decode_table_bits, encode_tables,
                                     ofp8_overflow_code)
from repro_torch.core.takum import codes_of, f32_bits
from repro_torch.quant import blockscale

#: per-format default decode implementation (the A/B knob's resting position)
DEFAULT_DECODE_IMPL = {
    "t8": "lut",
    "t16": "bits",
    "e4m3": "lut",
    "e5m2": "lut",
    "bf16": "bits",
}
#: per-format default *encode* implementation; repro chose these from its
#: own measurements (takum's bits encode is the heaviest codec body, OFP8's
#: field packers are short, bf16 encode is a 2-op shift-round)
DEFAULT_ENCODE_IMPL = {
    "t8": "lut",
    "t16": "lut",
    "e4m3": "bits",
    "e5m2": "bits",
    "bf16": "bits",
}
#: supported values for the decode_impl/encode_impl knobs
DECODE_IMPLS = ("bits", "lut")

#: takums wider than 16 bits: the kernel codecs cannot move them (the port
#: registers none; repro sends t32 down its jnp reference path)
_WIDE_TAKUMS = ("t32", "takum32", 32)

#: |x| bits of 1.0, read from the tables in place of Inf/NaN, whose codes
#: the encoders set apart (keeps every table index and shift in range)
_ONE_BITS = 0x3F800000


def resolve_impl(impl: str | None, fmt, op: str = "decode") -> str:
    """``None`` -> the per-format default; else validate the explicit choice.

    ``op`` ("decode" or "encode") picks the default table and the
    tabulability check: decode tables exist for every <= 16-bit format,
    encode tables for the 8-bit formats and takum16.  A block-scaled format
    resolves against its element format.  Raises ValueError for a wide takum,
    an unknown impl, or "lut" where no table exists."""
    if op not in ("decode", "encode"):
        raise ValueError(f"op must be 'decode' or 'encode', got {op!r}")
    if isinstance(fmt, (str, int)) and fmt in _WIDE_TAKUMS:
        raise ValueError(f"kernel codecs support <=16-bit takums, got {fmt!r}")
    wf = wire_format(fmt)
    if wf.is_block_scaled:
        return resolve_impl(impl, wf.elem_name, op)
    defaults = DEFAULT_DECODE_IMPL if op == "decode" else DEFAULT_ENCODE_IMPL
    if impl is None:
        return defaults.get(wf.name, "bits")
    if impl not in DECODE_IMPLS:
        raise ValueError(f"{op}_impl must be one of {DECODE_IMPLS}, got {impl!r}")
    tabulable = wf.supports_lut_decode if op == "decode" else wf.supports_lut_encode
    if impl == "lut" and not tabulable:
        raise ValueError(f"{op}_impl='lut': no tables for {wf.name} ({wf.nbits}b)")
    return impl


def resolve_out_fmt(out_fmt, encode_impl) -> tuple[str | None, str | None]:
    """Normalise a producer's fused-encode knobs (``out_fmt=``,
    ``encode_impl=`` of ``matmul``, ``dual_matmul`` and
    ``decode_attention``): ``(canonical name, encode impl)``, or ``(None,
    None)`` for a plain f32 output.  An unknown format (t32 among them: the
    port registers none) raises the registry's KeyError; "lut" where the
    format has no encode tables (bf16) raises ValueError."""
    if out_fmt is None:
        return None, None
    name = wire_format(out_fmt).name
    return name, resolve_impl(encode_impl, name, "encode")


@functools.lru_cache(maxsize=None)
def _tables_on(name: str, op: str, device: torch.device) -> tuple[torch.Tensor, ...]:
    tabs = (decode_table_bits(name),) if op == "decode" else encode_tables(name)
    return tuple(t.to(device) for t in tabs)


def tables_on(fmt, op: str, device) -> tuple[torch.Tensor, ...]:
    """The tables of ``fmt`` (an mx format: of its element format) on
    ``device``: ``(decode table,)`` for op "decode", the encode pair for
    "encode".  Each is uploaded once per (format, device) and shared."""
    wf = wire_format(fmt)
    return _tables_on(wf.elem_name if wf.is_block_scaled else wf.name, op, torch.device(device))


def decode_bits_fn(fmt) -> Callable[[torch.Tensor], torch.Tensor]:
    """The format's branch-free decode: bit patterns (an mx payload) -> float32."""
    return wire_format(fmt).decode


def encode_bits_fn(fmt) -> Callable[[torch.Tensor], torch.Tensor]:
    """The format's branch-free encode: float32 -> int64 bit patterns (an mx
    format: the uint8 payload)."""
    return wire_format(fmt).encode


def decode_wire_lut(tab: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Gather decode: bit patterns -> float32.  ``tab`` is the int32 decode
    table (f32 bit patterns) of the same format; zero, NaR/NaN/Inf and
    negative codes are all just rows."""
    return tab[codes_of(bits)].view(torch.float32)


def _shift_round_rne(base, s, m23):
    """``base + RNE(m23 >> s)`` with ties to the even *code*: the carry across
    binades is exact because takum codes and OFP8 magnitude codes are
    consecutive integers in value order.  ``s`` >= 1."""
    kept = m23 >> s
    guard = (m23 >> (s - 1)) & 1
    below = m23 & ((torch.ones_like(s) << (s - 1)) - 1)
    rnd = (guard == 1) & ((below != 0) | (((base + kept) & 1) == 1))
    return base + kept + rnd.to(torch.int64)


def _mag8(a, meta, thr):
    """The 8-bit tail: finite |x| bits ``a`` -> magnitude code through the
    exponent-byte entry (threshold path or shift path)."""
    e = a >> 23
    m23 = a & 0x7FFFFF
    mt = meta[e].to(torch.int64)
    base = mt >> 8
    mag_t = base + (m23 > thr[e].to(torch.int64)).to(torch.int64)
    mag_s = _shift_round_rne(base, mt & 0x7F, m23)
    return torch.where((mt & ENC8_THR_FLAG) != 0, mag_t, mag_s)


def encode_takum8_lut(x, meta, thr) -> torch.Tensor:
    """Table encode f32 -> takum8 codes (int64): RNE on the bit string with
    ties to even, two's-complement negatives, NaR for Inf/NaN, DAZ.
    Bit-identical to the bits encode."""
    u = f32_bits(x)
    a = u & 0x7FFFFFFF
    is_nar = a >= 0x7F800000
    mag = _mag8(torch.where(is_nar, _ONE_BITS, a), meta, thr)
    enc = torch.where((u >> 31) == 1, (-mag) & 0xFF, mag)
    return torch.where(is_nar, 0x80, enc)


def encode_ofp8_lut(x, meta, thr, fmt: str) -> torch.Tensor:
    """Table encode f32 -> OFP8 codes (int64): the shared tail, the sign bit,
    and rounding past the top finite code capped at the overflow pattern
    (E4M3 NaN, E5M2 Inf); Inf -> that pattern, NaN -> 0x7F."""
    ovf = ofp8_overflow_code(fmt)
    u = f32_bits(x)
    a = u & 0x7FFFFFFF
    is_inf = a == 0x7F800000
    is_nan = a > 0x7F800000
    mag = _mag8(torch.where(is_inf | is_nan, _ONE_BITS, a), meta, thr).clamp(max=ovf)
    mag = torch.where(is_inf, ovf, mag)
    mag = torch.where(is_nan, 0x7F, mag)
    return ((u >> 31) << 7) | mag


def encode_takum16_lut(x, meta, sub) -> torch.Tensor:
    """Two-level table encode f32 -> takum16 codes (int64): the exponent
    byte gives (base, regime), the regime its mantissa shift, then the RNE
    tail; DAZ and NaR explicit.  Bit-identical to the bits encode."""
    u = f32_bits(x)
    a = u & 0x7FFFFFFF
    is_nar = a >= 0x7F800000
    is_zero = a < 0x00800000  # zero and f32 subnormals (DAZ)
    a = torch.where(is_nar, _ONE_BITS, a)
    mt = meta[a >> 23].to(torch.int64)
    mag = _shift_round_rne(mt >> 8, sub[mt & 0xFF].to(torch.int64), a & 0x7FFFFF)
    enc = torch.where((u >> 31) == 1, (-mag) & 0xFFFF, mag)
    enc = torch.where(is_zero, 0, enc)
    return torch.where(is_nar, 0x8000, enc)


def encode_wire_lut(x, tabs, fmt) -> torch.Tensor:
    """Table encode dispatched on the format's scheme; ``tabs`` is its pair
    from :func:`repro_torch.core.tables.encode_tables`."""
    wf = wire_format(fmt)
    if wf.name == "t8":
        return encode_takum8_lut(x, *tabs)
    if wf.family == "ofp8":
        return encode_ofp8_lut(x, *tabs, wf.name)
    if wf.name == "t16":
        return encode_takum16_lut(x, *tabs)
    raise ValueError(f"no LUT encode for {wf.name!r}")


def decode_fn(fmt, impl=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The plain decode of ``fmt`` under ``impl`` (None: the default): bit
    patterns, or an mx payload, -> float32.  The tables are those of the
    input's device."""
    wf = wire_format(fmt)
    if resolve_impl(impl, wf) == "bits":
        return wf.decode

    def gather(bits):
        return decode_wire_lut(tables_on(wf, "decode", bits.device)[0], bits)

    if wf.is_block_scaled:
        return lambda p: blockscale.decode_payload(p, wf, elem_decode=gather)
    return gather


def encode_fn(fmt, impl=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The plain encode of ``fmt`` under ``impl`` (None: the default):
    float32 -> int64 codes, or an mx format's uint8 payload."""
    wf = wire_format(fmt)
    if resolve_impl(impl, wf, "encode") == "bits":
        return wf.encode
    name = wf.elem_name if wf.is_block_scaled else wf.name

    def table_encode(x):
        return encode_wire_lut(x, tables_on(name, "encode", x.device), name)

    if wf.is_block_scaled:
        # the container clamps to the element cap before the element encode,
        # so the non-saturating OFP8 table encode is exact here
        return lambda x: blockscale.encode_payload(x, wf, elem_encode=table_encode)
    return table_encode


def decode_fast(bits: torch.Tensor, fmt) -> torch.Tensor:
    """Bit patterns -> float32 through the format's default decode (the
    counterpart of ``repro``'s ``decode_jnp_fast``)."""
    return decode_fn(fmt)(bits)


def encode_fast(x: torch.Tensor, fmt) -> torch.Tensor:
    """float32 -> packed bits in the format's storage dtype through its
    default encode (the counterpart of ``repro``'s ``encode_jnp_fast``)."""
    wf = wire_format(fmt)
    return wf.pack(encode_fn(wf)(x.to(torch.float32)))
