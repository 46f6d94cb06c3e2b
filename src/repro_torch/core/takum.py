"""Linear takum codec in plain PyTorch (counterpart of ``repro.core.takum``).

Bit layout (MSB -> LSB) of an n-bit takum::

    S | D | R(3 bits) | C(r bits) | M(p bits),      n = 5 + r + p

    r = R            if D == 1 else 7 - R
    c = 2**r - 1 + C if D == 1 else -2**(r+1) + 1 + C          (characteristic)
    value = (-1)**S * 2**c * (1 + M / 2**p)                    (linear takum)

Zero is all-zero bits and NaR is ``1 0...0``.  Negation is the two's
complement of the whole bit string.  Bit strings shorter than 12 bits behave
as if zero-extended to 12 bits.

The encoder rounds to nearest, ties to even, on the bit string, saturates
(a nonzero value never becomes 0, a finite value never becomes NaR) and
flushes f32 subnormal inputs to zero (DAZ).  The stochastic-rounding
encoder (:func:`takum_encode_sr`, for optimizer state) shares everything
but the rounding: it adds given uniform bits below the kept bits and
truncates.  The decoder assembles the f32
directly: characteristics above 127 saturate to f32 max-finite, below -126
flush to zero, NaR becomes NaN.  On XLA's CPU backend ``repro``'s value
decoder flushes the same subnormal results, so both agree on every t8/t16
code (checked exhaustively in ``tests/test_torch_codecs.py``).

torch has no shifts on uint16/uint32, so everything computes in int64 and the
unsigned dtypes are used for storage only.
"""

from __future__ import annotations

import torch

__all__ = ["NAR", "codes_of", "f32_bits", "f32_from_bits", "pow2_f32", "takum_encode",
           "takum_encode_sr", "takum_decode"]

_I64 = torch.int64


def NAR(n: int) -> int:
    """The Not-a-Real bit pattern for width n (1 followed by zeros)."""
    return 1 << (n - 1)


def codes_of(bits: torch.Tensor) -> torch.Tensor:
    """Packed bits of any integer storage -> their unsigned codes as int64.
    uint16/uint32 go through the signed view: CUDA builds of torch convert
    few unsigned 16/32-bit tensors."""
    if bits.dtype == torch.uint16:
        return bits.view(torch.int16).to(_I64) & 0xFFFF
    if bits.dtype == torch.uint32:
        return bits.view(torch.int32).to(_I64) & 0xFFFFFFFF
    return bits.to(_I64)


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> its IEEE bit patterns as int64 in [0, 2**32)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(_I64) & 0xFFFFFFFF


def f32_from_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns in [0, 2**32) -> float32 tensor."""
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def pow2_f32(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**k`` for integer k in [-126, 127] (bit assembly)."""
    return f32_from_bits((k.clamp(-126, 127) + 127) << 23)


def _floor_log2_small(g: torch.Tensor) -> torch.Tensor:
    """floor(log2(g)) for int64 g in [1, 255] (takum regimes are 0..7)."""
    r = torch.zeros_like(g)
    for k in range(1, 8):
        r += (g >= (1 << k)).to(_I64)
    return r


def _round_body(body, nbits, keep: int):
    """Round a left-aligned body of ``nbits`` significant bits to ``keep``
    bits: RNE with guard and sticky bits, saturated to ``[1, 2**keep - 1]``."""
    t = nbits - keep
    no_round = body << (-t).clamp(min=0)
    tc = t.clamp(min=1)
    kept = body >> tc
    guard = (body >> (tc - 1)) & 1
    sticky = (body & ((torch.ones_like(tc) << (tc - 1)) - 1)) != 0
    round_up = (guard == 1) & (sticky | ((kept & 1) == 1))
    kept = kept + round_up.to(_I64)
    out = torch.where(t <= 0, no_round, kept)
    return out.clamp(1, (1 << keep) - 1)


def _encode_body(x: torch.Tensor):
    """float32 -> (neg, is_zero, is_nar, body, nbits): the left-aligned
    header + 23-bit fraction of |x| and its bit count (int64), DAZ'd
    subnormals and zeros flagged zero, NaN and Inf flagged NaR."""
    u = f32_bits(x)
    a = u & 0x7FFFFFFF
    is_zero = a < 0x00800000  # |x| < 2**-126: zero and DAZ'd subnormals
    is_nar = a >= 0x7F800000  # Inf or NaN
    neg = (u >> 31) == 1
    a = torch.where(is_zero | is_nar, torch.full_like(a, 0x3F800000), a)
    c = (a >> 23) - 127  # f32 characteristics never reach takum's saturation
    mf = a & 0x7FFFFF

    cneg = c < 0
    g = torch.where(cneg, -c, c + 1)
    r = _floor_log2_small(g)
    one = torch.ones_like(r)
    C = torch.where(cneg, c + (one << (r + 1)) - 1, c - ((one << r) - 1))
    R = torch.where(cneg, 7 - r, r)
    D = (~cneg).to(_I64)
    H = (D << (r + 3)) | (R << r) | C  # 4 + r header bits
    return neg, is_zero, is_nar, (H << 23) | mf, r + 4 + 23


def _finish(neg, is_zero, is_nar, mag, n: int) -> torch.Tensor:
    """Sign, zero and NaR onto the rounded magnitude."""
    mask = (1 << n) - 1
    enc = torch.where(neg, (-mag) & mask, mag)
    enc = torch.where(is_zero, torch.zeros_like(enc), enc)
    return torch.where(is_nar, torch.full_like(enc, NAR(n)), enc)


def takum_encode(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 -> n-bit linear takum bit patterns (int64), RNE, DAZ,
    saturating; NaN and Inf encode to NaR.  ``n`` in [2, 28]."""
    if not 2 <= n <= 28:
        raise ValueError(f"takum_encode supports 2 <= n <= 28, got {n}")
    neg, is_zero, is_nar, body, nbits = _encode_body(x)
    return _finish(neg, is_zero, is_nar, _round_body(body, nbits, n - 1), n)


def takum_encode_sr(x: torch.Tensor, n: int, rnd_bits: torch.Tensor) -> torch.Tensor:
    """float32 -> n-bit linear takum bit patterns (int64) with stochastic
    rounding: the tail of ``repro``'s ``_encode_from_cm(..., rnd_bits)``.
    ``rnd_bits & (2**t - 1)`` is added below the t discarded bits of the
    body (the carry walks into the kept bits), the sum truncated, and the
    magnitude clamped to [1, 2**(n-1) - 1]; zero, DAZ and NaR as
    :func:`takum_encode`.  ``rnd_bits``: x's shape, uint32 values in an
    integer tensor (int64, or their int32 view), given by the caller and
    never drawn here.  ``n`` in [2, 27] (a body has at least 27 bits, so
    t >= 1)."""
    if not 2 <= n <= 27:
        raise ValueError(f"takum_encode_sr supports 2 <= n <= 27, got {n}")
    if rnd_bits.shape != x.shape:
        raise ValueError(f"rnd_bits {tuple(rnd_bits.shape)} must match x {tuple(x.shape)}")
    neg, is_zero, is_nar, body, nbits = _encode_body(x)
    t = (nbits - (n - 1)).clamp(0, 31)
    add = rnd_bits.to(_I64) & ((torch.ones_like(t) << t) - 1)
    mag = ((body + add) >> t).clamp(1, (1 << (n - 1)) - 1)
    return _finish(neg, is_zero, is_nar, mag, n)


def _decode_fields(bits: torch.Tensor, n: int):
    """n-bit patterns -> (neg, c, M, p), two's-complement magnitude parse."""
    mask = (1 << n) - 1
    b = codes_of(bits) & mask
    neg = ((b >> (n - 1)) & 1) == 1
    mag = torch.where(neg, (-b) & mask, b)
    D = (mag >> (n - 2)) & 1
    R = (mag >> (n - 5)) & 7
    r = torch.where(D == 1, R, 7 - R)
    rem = n - 5
    rem_v = mag & ((1 << rem) - 1)
    have = r <= rem
    C = torch.where(have, rem_v >> (rem - r).clamp(min=0), rem_v << (r - rem).clamp(min=0))
    p = (rem - r).clamp(min=0)
    one = torch.ones_like(p)
    M = torch.where(have, rem_v & ((one << p) - 1), torch.zeros_like(rem_v))
    c = torch.where(D == 1, (one << r) - 1 + C, 1 - (one << (r + 1)) + C)
    return neg, c, M, p


def takum_decode_f32bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """n-bit takum patterns -> IEEE f32 bit patterns (int64), assembled
    directly: c > 127 saturates to max-finite, c < -126 flushes to +0,
    NaR -> canonical NaN, zero -> +0.  ``n`` in [5, 28] (p <= 23)."""
    if not 5 <= n <= 28:
        raise ValueError(f"takum decode supports 5 <= n <= 28, got {n}")
    b = codes_of(bits) & ((1 << n) - 1)
    is_zero = b == 0
    is_nar = b == NAR(n)
    neg, c, M, p = _decode_fields(b, n)
    out = ((c.clamp(-126, 127) + 127) << 23) | (M << (23 - p))
    out = torch.where(c > 127, torch.full_like(out, 0x7F7FFFFF), out)
    out = torch.where((c < -126) | is_zero, torch.zeros_like(out), out)
    out = torch.where(is_nar, torch.full_like(out, 0x7FC00000), out)
    return torch.where(is_zero | is_nar | ~neg, out, out | (1 << 31))


def takum_decode(bits: torch.Tensor, n: int) -> torch.Tensor:
    """n-bit takum patterns -> float32 (see :func:`takum_decode_f32bits`)."""
    return f32_from_bits(takum_decode_f32bits(bits, n))
