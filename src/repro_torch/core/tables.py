"""Wire-codec lookup tables (counterpart of ``repro.core.tables``): what the
``lut`` codecs of :mod:`repro_torch.kernels.lut` and the CUDA kernels gather
from.  Every table is an int32 tensor on the CPU holding uint32 bit
patterns, never floats: a float round trip may canonicalise a NaN (torch's
own f32 -> bf16 cast drops its sign), and the tables must equal ``repro``'s
bit for bit (``tests/test_torch_tables.py``).  The tables are cached; do not
write to them.

* **Decode tables**: the f32 bit pattern of every code of an n <= 16-bit
  format, with the kernel clamp semantics of the format's plain decode
  (takum: c > 127 saturates to max-finite, c < -126 flushes to zero, NaR ->
  canonical NaN; OFP8/bf16: the format's own NaN/Inf patterns).  Built from
  the port's own bits decoders, so the gather and the bits codec agree by
  construction.  1 KiB for an 8-bit format, 256 KiB for t16/bf16.

* **Encode tables, 8-bit formats**: a 256-entry pair indexed by the f32
  exponent byte.  ``meta[e]`` holds the code of the binade bottom 2^(e-127)
  in bits 15:8 and either a mantissa shift ``23 - p`` (binades whose codes
  keep p mantissa bits: ``mag = base + RNE(m23 >> (23 - p))``, ties to the
  even code) or the threshold flag (binades whose codes carry no mantissa:
  ``mag = base + (m23 > thr[e])``).  Takum8's thresholds are its exact
  rounding boundaries, the 9-bit takum values ``2m + 1`` (append-a-one
  midpoints) from the float64 oracle :mod:`.takum_np`; OFP8's are the value
  midpoints of neighbouring codes, and overflow rounds through the top finite
  code into the format's overflow pattern (NaN for E4M3, Inf for E5M2).

* **Encode tables, takum16**: two levels.  ``meta[e]`` holds
  ``(base << 8) | r`` (binade-bottom code and takum regime), ``sub[r]`` the
  mantissa shift ``23 - (11 - r)`` of the regime; every f32-reachable binade
  keeps p >= 4 mantissa bits, so there is no threshold path.  Construction
  checks every binade against the oracle (uniform spacing, boundaries at the
  17-bit takum values, carry onto the code of the next binade's bottom).

Exponent byte 0 (zero and f32 subnormals) encodes to 0 (DAZ); 255
(Inf/NaN) is special-cased by the encoders.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import takum_np

__all__ = [
    "decode_table_bits",
    "decode_table_f32",
    "encode8_tables",
    "encode16_tables",
    "encode_tables",
    "ofp8_overflow_code",
    "table_nbytes",
    "ENC8_THR_FLAG",
    "ENC8_THR_NEVER",
]

# meta-table layout: bits[15:8] = base code, bit 7 = threshold-path flag,
# bits[6:0] = mantissa shift (23 - p) for shift-path binades.
ENC8_THR_FLAG = 1 << 7
# threshold sentinel: m23 can never exceed it, so the binade never rounds up
ENC8_THR_NEVER = 1 << 23


def _wire(fmt):
    from .formats import wire_format

    return wire_format(fmt)


def _as_i32(a: np.ndarray) -> torch.Tensor:
    """uint32 patterns (a numpy integer array) -> an int32 tensor of the same bits."""
    a = torch.as_tensor(np.asarray(a, dtype=np.int64))
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


def table_nbytes(fmt) -> int:
    """Bytes one decode table of ``fmt`` occupies (4 per code)."""
    return (1 << _wire(fmt).nbits) * 4


@functools.lru_cache(maxsize=None)
def _decode_table_bits_by_name(name: str) -> torch.Tensor:
    from .formats import wire_format
    from .takum import takum_decode_f32bits

    wf = wire_format(name)
    if wf.is_block_scaled:
        raise ValueError(
            f"decode table for {name!r}: block-scaled payloads are not one "
            f"code space; tabulate the element format {wf.elem_name!r}")
    if not wf.supports_lut_decode:
        raise ValueError(f"decode table for {name!r}: 2**{wf.nbits} entries untabulable")
    codes = torch.arange(1 << wf.nbits, dtype=torch.int64)
    if wf.family == "takum":
        return _as_i32(takum_decode_f32bits(codes, wf.nbits).numpy())
    return wf.decode(codes).contiguous().view(torch.int32)


def decode_table_bits(fmt) -> torch.Tensor:
    """int32[2**n]: the f32 bit patterns of every code of ``fmt`` (kernel
    semantics).  ``fmt`` is a WireFormat, a registered name or a bare takum
    width (8 -> t8, 16 -> t16)."""
    return _decode_table_bits_by_name(_wire(fmt).name)


def decode_table_f32(fmt) -> torch.Tensor:
    """float32[2**n]: the decoded value of every code of ``fmt``, a view of
    :func:`decode_table_bits` (a reinterpretation: NaN payloads survive)."""
    return decode_table_bits(fmt).view(torch.float32)


def _code_of(x: float, boundaries: np.ndarray, lo: int = 1) -> int:
    """Positive f64 value -> magnitude code under RNE with ties to even.

    ``boundaries[m]`` is the exact rounding boundary between codes m and
    m+1; ties go to the even code.  ``lo`` is the smallest candidate code
    (1 for takum: nonzero never rounds to 0; 0 for the sign-magnitude
    formats, which do round small values to zero)."""
    m = lo
    for j in range(lo, len(boundaries)):
        if x > boundaries[j] or (x == boundaries[j] and j % 2 == 1):
            m = j + 1
    return m


def _encode8_tables_takum() -> tuple[np.ndarray, np.ndarray]:
    values = takum_np.decode(np.arange(128, dtype=np.uint64), 8)
    bounds = takum_np.decode(2 * np.arange(127, dtype=np.uint64) + 1, 9)

    meta = np.zeros(256, dtype=np.uint32)
    thr = np.full(256, ENC8_THR_NEVER, dtype=np.int32)
    # e = 0: zero and f32 subnormals encode to 0 (base 0, never rounds up)
    meta[0] = ENC8_THR_FLAG | 1
    for e in range(1, 255):
        c = e - 127
        scale = 2.0**c  # exact in f64
        base = _code_of(scale, bounds)
        g = (c + 1) if c >= 0 else -c
        r = g.bit_length() - 1  # takum regime of characteristic c
        p = 3 - r  # mantissa bits a takum8 code keeps at this c
        if p >= 1:
            # shift path: 2**c is exactly representable, code is base + RNE
            assert values[base] == scale, (e, base)
            meta[e] = np.uint32((base << 8) | (23 - p))
        else:
            meta[e] = np.uint32((base << 8) | ENC8_THR_FLAG | 1)
            if base <= 126:
                # exact boundary position on the 23-bit mantissa scale
                mb = (bounds[base] / scale - 1.0) * (1 << 23)
                if 0.0 <= mb < (1 << 23):
                    imb = int(np.floor(mb))
                    # tie (mb integral): round to the even code
                    thr[e] = imb - 1 if (mb == imb and base % 2 == 1) else imb
    # e = 255 entries are never used (NaR special-cased); left as "never".
    return meta, thr


def ofp8_overflow_code(name: str) -> int:
    """First non-finite magnitude code: NaN (E4M3) or Inf (E5M2), the code
    the carry-through-overflow rounding lands on, and the encode-side cap."""
    return {"e4m3": 0x7F, "e5m2": 0x7C}[name]


def _encode8_tables_signmag(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Exponent-byte encode tables for a sign-magnitude 8-bit format, from
    the format's own decode table: magnitude codes 0..K with strictly
    increasing finite values, rounding boundaries at the exact value
    midpoints (dyadic, so exact in float64), ties to the even code.  Binades
    wholly above the overflow threshold map straight to the overflow code;
    the top in-range binade reaches it by mantissa carry."""
    vals = decode_table_f32(name)[:128].double().numpy()
    finite = np.isfinite(vals)
    K = int(np.max(np.nonzero(finite)[0]))
    assert np.all(finite[: K + 1]) and np.all(np.diff(vals[: K + 1]) > 0), name
    ovf_code = ofp8_overflow_code(name)
    assert ovf_code == K + 1, (name, K, ovf_code)
    bounds = (vals[:K] + vals[1 : K + 1]) / 2.0  # boundary between m, m+1
    ovf_thr = vals[K] + (vals[K] - bounds[K - 1])  # v_K + ulp/2

    meta = np.zeros(256, dtype=np.uint32)
    thr = np.full(256, ENC8_THR_NEVER, dtype=np.int32)
    meta[0] = ENC8_THR_FLAG | 1  # f32 zero/subnormals: far below minpos -> 0
    for e in range(1, 255):
        scale = 2.0 ** (e - 127)
        if scale >= ovf_thr:
            # whole binade overflows: NaN (E4M3) / Inf (E5M2), never rounds
            meta[e] = np.uint32((ovf_code << 8) | ENC8_THR_FLAG | 1)
            continue
        base = _code_of(scale, bounds, lo=0)
        # shift path: codes in [scale, 2*scale) uniformly spaced at
        # scale / 2**p with the binade bottom exactly representable
        in_binade = [m for m in range(base, K + 1) if scale <= vals[m] < 2 * scale]
        p = None
        if in_binade and vals[base] == scale:
            if len(in_binade) >= 2:
                pf = np.log2(scale / (vals[base + 1] - vals[base]))
                if pf == round(pf) and 0 <= round(pf) <= 22:
                    p = int(round(pf))
            elif base + 1 <= K and vals[base + 1] == 2 * scale:
                p = 0
        if p is not None:
            step = scale / (1 << p)
            uniform = all(
                vals[base + j] == scale + j * step for j in range(min(len(in_binade), 1 << p)))
            # the carry target (base + 2**p) must be the code of 2*scale,
            # or lie beyond K (overflow -> the cap in the LUT encode tail)
            carry_ok = (base + (1 << p) > K) or (vals[base + (1 << p)] == 2 * scale)
            if not (uniform and carry_ok):
                p = None
        if p is not None:
            meta[e] = np.uint32((base << 8) | (23 - p))
            continue
        # threshold path: at most one rounding boundary in [scale, 2*scale)
        bs_in = [m for m in range(K) if scale <= bounds[m] < 2 * scale]
        assert len(bs_in) <= 1, (name, e, bs_in)
        meta[e] = np.uint32((base << 8) | ENC8_THR_FLAG | 1)
        if bs_in:
            m = bs_in[0]
            if base == m:  # boundary above base: threshold decides m vs m+1
                mb = (bounds[m] / scale - 1.0) * (1 << 23)
                if 0.0 <= mb < (1 << 23):
                    imb = int(np.floor(mb))
                    thr[e] = imb - 1 if (mb == imb and base % 2 == 1) else imb
            else:
                # tie at the binade bottom resolved *up* to base = m+1:
                # every mantissa in the binade already rounds to base
                assert base == m + 1, (name, e, base, m)
    return meta, thr


@functools.lru_cache(maxsize=None)
def _encode16_tables_takum() -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level takum16 encode tables: ``meta`` int32[256] indexed by the
    f32 exponent byte, ``(base << 8) | r``; ``sub`` int32[128] (entries 0..7
    live, the rest 23, shift-out-everything), the regime's mantissa shift.
    Every binade is verified against the float64 oracle."""
    values = takum_np.decode(np.arange(1 << 15, dtype=np.uint64), 16)
    bounds = takum_np.decode(2 * np.arange((1 << 15) - 1, dtype=np.uint64) + 1, 17)

    meta = np.zeros(256, dtype=np.uint32)
    sub = np.full(128, 23, dtype=np.int32)
    for e in range(1, 255):
        c = e - 127
        scale = 2.0**c  # exact in f64
        base = int(np.searchsorted(values, scale))
        assert values[base] == scale, (e, base)
        g = (c + 1) if c >= 0 else -c
        r = g.bit_length() - 1  # takum regime of characteristic c
        p = 11 - r  # mantissa bits a takum16 code keeps at this c
        assert p >= 4, (e, r)
        # codes base..base+2**p are consecutive and uniformly spaced, the
        # boundaries sit at the value midpoints (the 17-bit append-a-one
        # takums), and the carry target base + 2**p is the code of 2**(c+1)
        step = scale / (1 << p)
        j = np.arange(1 << p)
        assert np.array_equal(values[base : base + (1 << p)], scale + j * step), e
        assert values[base + (1 << p)] == 2.0 * scale, e
        assert np.array_equal(bounds[base : base + (1 << p)], scale + (2 * j + 1) * (step / 2.0)), e
        if sub[r] != 23:
            assert sub[r] == 23 - p, (e, r)
        sub[r] = 23 - p
        meta[e] = np.uint32((base << 8) | r)
    # e = 0 (zero + f32 subnormals) -> DAZ; e = 255 (inf/NaN) -> NaR: both
    # handled by the encoder, entries left at 0.
    return _as_i32(meta), _as_i32(sub)


def encode16_tables(fmt="t16") -> tuple[torch.Tensor, torch.Tensor]:
    """(meta int32[256], sub int32[128]): the two-level f32 -> takum16
    encode tables (see the module docstring)."""
    wf = _wire(fmt)
    if wf.name != "t16":
        raise ValueError(f"two-level encode tables exist for t16 only, got {wf.name!r}")
    return _encode16_tables_takum()


@functools.lru_cache(maxsize=None)
def _encode8_tables_by_name(name: str) -> tuple[torch.Tensor, torch.Tensor]:
    from .formats import wire_format

    wf = wire_format(name)
    if wf.nbits != 8:
        raise ValueError(
            f"exponent-byte table pairs are 8-bit only, got {name!r} "
            f"({wf.nbits}b; takum16 uses encode16_tables)")
    if wf.family == "takum":
        meta, thr = _encode8_tables_takum()
    elif wf.family == "ofp8":
        meta, thr = _encode8_tables_signmag(name)
    else:
        raise ValueError(f"no encode tables for family {wf.family!r}")
    return _as_i32(meta), _as_i32(thr)


def encode8_tables(fmt="t8") -> tuple[torch.Tensor, torch.Tensor]:
    """(meta int32[256], thr int32[256]): the exact f32 -> 8-bit encode
    tables, indexed by the f32 exponent byte ``(bits >> 23) & 0xFF``."""
    return _encode8_tables_by_name(_wire(fmt).name)


def encode_tables(fmt) -> tuple[torch.Tensor, torch.Tensor]:
    """The format's encode-table pair: (meta, thr) for an 8-bit format,
    (meta, sub) for takum16, as :func:`repro_torch.kernels.lut.encode_wire_lut`
    takes them."""
    wf = _wire(fmt)
    if wf.is_block_scaled:
        raise ValueError(
            f"no encode tables for {wf.name!r}: the container tabulates its "
            f"element format {wf.elem_name!r}")
    if not wf.supports_lut_encode:
        raise ValueError(f"no encode tables for {wf.name!r} ({wf.nbits}b)")
    return encode8_tables(wf) if wf.nbits == 8 else encode16_tables(wf)
