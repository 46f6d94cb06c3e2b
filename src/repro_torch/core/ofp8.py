"""OCP 8-bit floating point E4M3 / E5M2 codecs in plain PyTorch
(counterpart of ``repro.core.ofp8.encode_jnp`` / ``decode_jnp``).

E4M3: bias 7, no infinities, S.1111.111 is NaN, max finite 448.  E5M2:
IEEE-like, bias 15, with infinities, max finite 57344.  Encode is
round-to-nearest-even and non-saturating: finite overflow becomes NaN for
E4M3 and Inf for E5M2.  f32 subnormal inputs flush to (signed) zero.
Integer work is int64 (torch has no unsigned shifts).

:func:`encode_sr` is ``repro``'s stochastic-rounding encode
(``encode_sr_jnp``): truncate plus a uniform dither below the kept bits,
the dither given by the caller.
"""

from __future__ import annotations

import torch

from .takum import codes_of, f32_bits, pow2_f32

SPECS = {
    "e4m3": dict(ebits=4, mbits=3, bias=7, max_finite=448.0, has_inf=False),
    "e5m2": dict(ebits=5, mbits=2, bias=15, max_finite=57344.0, has_inf=True),
}

#: largest finite magnitude code, the NaN code and the Inf code (E4M3 has no
#: Inf: overflow lands on NaN)
_MAX_MAG = {"e4m3": 0x7E, "e5m2": 0x7B}
_NAN_MAG = 0x7F
_INF_MAG = {"e4m3": 0x7F, "e5m2": 0x7C}


def encode(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """float32 -> OFP8 bit patterns (int64 in [0, 255]), RNE."""
    spec = SPECS[fmt]
    mb, bias = spec["mbits"], spec["bias"]
    u = f32_bits(x)
    sign = u >> 31
    a = u & 0x7FFFFFFF
    is_nan = a > 0x7F800000
    is_inf = a == 0x7F800000

    e = (a >> 23) - 127
    e_t = e + bias
    m23 = a & 0x7FFFFF
    extra = (1 - e_t).clamp(0, 24)  # how far below the normal range
    t = (23 - mb) + extra
    src = torch.where(extra > 0, m23 | (1 << 23), m23)
    tc = t.clamp(1, 31)
    kept = src >> tc
    guard = (src >> (tc - 1)) & 1
    sticky = (src & ((torch.ones_like(tc) << (tc - 1)) - 1)) != 0
    kept = kept + ((guard == 1) & (sticky | ((kept & 1) == 1))).to(torch.int64)

    e_sub = torch.where(extra > 0, torch.zeros_like(e_t), e_t)
    mag = (e_sub.clamp(min=0) << mb) + kept  # a carry may walk into the exponent
    zero = torch.zeros_like(mag)
    mag = torch.where(a == 0, zero, mag)
    mag = torch.where(e < -126, zero, mag)  # f32 subnormals: below every OFP8

    mag = torch.where(mag > _MAX_MAG[fmt], torch.full_like(mag, _INF_MAG[fmt]), mag)
    mag = torch.where(is_inf, torch.full_like(mag, _INF_MAG[fmt]), mag)
    mag = torch.where(is_nan, torch.full_like(mag, _NAN_MAG), mag)
    return (sign << 7) | mag


def encode_sr(x: torch.Tensor, rnd_bits: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """float32 -> OFP8 bit patterns (int64 in [0, 255]) with stochastic
    rounding (counterpart of ``repro.core.ofp8.encode_sr_jnp``): add
    ``rnd_bits & (2**t - 1)`` below the t discarded bits of the magnitude
    (a source deeper than the 31-bit dither field is pre-shifted by
    t - 31), then truncate; inputs below the 24-bit subnormal alignment
    window and f32 subnormals give zero; finite overflow becomes NaN (E4M3)
    or Inf (E5M2).  ``rnd_bits``: x's shape, uint32 values in an integer
    tensor (int64, or their int32 view)."""
    if rnd_bits.shape != x.shape:
        raise ValueError(f"rnd_bits {tuple(rnd_bits.shape)} must match x {tuple(x.shape)}")
    mb, bias = SPECS[fmt]["mbits"], SPECS[fmt]["bias"]
    u = f32_bits(x)
    sign = u >> 31
    a = u & 0x7FFFFFFF
    is_nan = a > 0x7F800000
    is_inf = a == 0x7F800000

    e = (a >> 23) - 127
    e_t = e + bias
    m23 = a & 0x7FFFFF
    extra = (1 - e_t).clamp(0, 24)
    t = (23 - mb) + extra
    src = torch.where(extra > 0, m23 | (1 << 23), m23) >> (t - 31).clamp(0, 31)
    tc = t.clamp(1, 31)
    dither = rnd_bits.to(torch.int64) & ((torch.ones_like(tc) << tc) - 1)
    kept = (src + dither) >> tc
    zero = torch.zeros_like(kept)
    kept = torch.where(1 - e_t > 24, zero, kept)

    e_sub = torch.where(extra > 0, torch.zeros_like(e_t), e_t)
    mag = (e_sub.clamp(min=0) << mb) + kept
    mag = torch.where(a == 0, zero, mag)
    mag = torch.where(e < -126, zero, mag)  # DAZ: f32 subnormal inputs
    mag = torch.where(mag > _MAX_MAG[fmt], torch.full_like(mag, _INF_MAG[fmt]), mag)
    mag = torch.where(is_inf, torch.full_like(mag, _INF_MAG[fmt]), mag)
    mag = torch.where(is_nan, torch.full_like(mag, _NAN_MAG), mag)
    return (sign << 7) | mag


def decode(bits: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """OFP8 bit patterns -> float32."""
    spec = SPECS[fmt]
    eb, mb, bias = spec["ebits"], spec["mbits"], spec["bias"]
    b = codes_of(bits)
    sign = (b >> 7) & 1
    e_f = (b >> mb) & ((1 << eb) - 1)
    m_f = (b & ((1 << mb) - 1)).to(torch.float32)

    normal = (1.0 + m_f * 2.0**-mb) * pow2_f32(e_f - bias)
    subn = m_f * 2.0**-mb * pow2_f32(torch.full_like(e_f, 1 - bias))
    val = torch.where(e_f == 0, subn, normal)
    if spec["has_inf"]:
        top = e_f == (1 << eb) - 1
        val = torch.where(top & (m_f == 0), torch.full_like(val, float("inf")), val)
        is_nan = top & (m_f != 0)
    else:
        is_nan = (b & 0x7F) == 0x7F
    val = torch.where(is_nan, torch.full_like(val, float("nan")), val)
    return torch.where(sign == 1, -val, val)
