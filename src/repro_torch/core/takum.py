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

Widths run to 32 bits.  Above 28 the fraction field of a code has more
bits (up to 27) than f32's 23, and the decoder rounds it as ``repro``'s
value decoder does on XLA's CPU backend: twice, to nearest even, first to
24 significant bits (``M.astype(float32)``), then to 23 fraction bits
(``1.0 + f``), a carry walking into the exponent.  It does so in integer
arithmetic, so that the CPU and the card (which keeps f32 subnormals) give
the same bits.

``mode="log"`` selects the logarithmic takum, value ``(-1)**S *
sqrt(e)**l``: the encoder and decoder take ``repro``'s f32 steps (``log2``
scaled by ``1/log2(sqrt(e))``, floored, a 23-bit fraction with carry; the
decoder ``exp2`` of the fraction scaled by a power of two), so they agree
with it to an ulp of ``log2`` / ``exp2``, not bit for bit.  Results below
2**-126 flush to zero there, as XLA's CPU backend flushes them.

:func:`storage_dtype`, :func:`pack` and :func:`sortable_int` give the packed
containers and the two's-complement keys the ISA layer (``core/isa.py``)
compares with.

torch has no shifts on uint16/uint32, so everything computes in int64 and the
unsigned dtypes are used for storage only.
"""

from __future__ import annotations

import torch

__all__ = ["NAR", "codes_of", "f32_bits", "f32_from_bits", "pack", "pow2_f32", "sortable_int",
           "storage_dtype", "takum_encode", "takum_encode_sr", "takum_decode",
           "takum_decode_f32bits"]

_I64 = torch.int64
#: log2(sqrt(e)) and its inverse: the linear <-> logarithmic conversion
#: constants (``repro``'s, taken to f32 where used)
_LOG2_SQRT_E = 0.7213475204444817
_INV_LOG2_SQRT_E = 1.0 / _LOG2_SQRT_E
_MODES = ("linear", "log")


def NAR(n: int) -> int:
    """The Not-a-Real bit pattern for width n (1 followed by zeros)."""
    return 1 << (n - 1)


def storage_dtype(n: int) -> torch.dtype:
    """Narrowest unsigned container for an n-bit takum."""
    return torch.uint8 if n <= 8 else torch.uint16 if n <= 16 else torch.uint32


def pack(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Integer codes (their low n bits) -> a :func:`storage_dtype` tensor,
    built through the signed view of the same width (CUDA builds of torch
    convert few unsigned 16/32-bit tensors)."""
    dt = storage_dtype(n)
    if dt == torch.uint8:
        return (codes.to(_I64) & 0xFF).to(torch.uint8)
    w = 16 if dt == torch.uint16 else 32
    c = codes.to(_I64) & ((1 << w) - 1)
    c = torch.where(c >= 1 << (w - 1), c - (1 << w), c)
    return c.to(torch.int16 if w == 16 else torch.int32).view(dt)


def sortable_int(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Takum patterns -> int32 keys that order like the real values: the
    n-bit pattern sign-extended (takums compare as two's-complement
    integers, the paper's section IV-A)."""
    b = codes_of(bits) & ((1 << n) - 1)
    return torch.where(b >= 1 << (n - 1), b - (1 << n), b).to(torch.int32)


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


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown takum mode: {mode!r} (one of {_MODES})")


def _f32_const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A python float taken to f32 (as ``jnp.float32(v)``), on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _encode_body(x: torch.Tensor, mode: str = "linear"):
    """float32 -> (neg, is_zero, is_nar, body, nbits): the left-aligned
    header + 23-bit fraction of |x| and its bit count (int64), DAZ'd
    subnormals and zeros flagged zero, NaN and Inf flagged NaR.  In log mode
    the characteristic and fraction are those of l = log2|x| / log2(sqrt e)
    in f32, as ``repro`` computes them (|l| < 178 for every normal f32, so
    neither saturation rail of the characteristic is reached)."""
    _check_mode(mode)
    u = f32_bits(x)
    a = u & 0x7FFFFFFF
    is_zero = a < 0x00800000  # |x| < 2**-126: zero and DAZ'd subnormals
    is_nar = a >= 0x7F800000  # Inf or NaN
    neg = (u >> 31) == 1
    a = torch.where(is_zero | is_nar, torch.full_like(a, 0x3F800000), a)
    if mode == "linear":
        c = (a >> 23) - 127  # f32 characteristics never reach takum's saturation
        mf = a & 0x7FFFFF
    else:
        af = f32_from_bits(a)
        lv = torch.log2(af) * _f32_const(_INV_LOG2_SQRT_E, af)
        cf = torch.floor(lv)
        mf = torch.floor((lv - cf) * 8388608.0).to(_I64)  # exact: a power of two
        carry = mf >= 1 << 23
        c = cf.to(_I64) + carry.to(_I64)
        mf = torch.where(carry, torch.zeros_like(mf), mf)

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


def takum_encode(x: torch.Tensor, n: int, mode: str = "linear") -> torch.Tensor:
    """float32 -> n-bit takum bit patterns (int64), RNE, DAZ, saturating;
    NaN and Inf encode to NaR.  ``n`` in [2, 32]; ``mode`` "linear" or
    "log" (see the module docstring)."""
    if not 2 <= n <= 32:
        raise ValueError(f"takum_encode supports 2 <= n <= 32, got {n}")
    neg, is_zero, is_nar, body, nbits = _encode_body(x, mode)
    return _finish(neg, is_zero, is_nar, _round_body(body, nbits, n - 1), n)


def takum_encode_sr(x: torch.Tensor, n: int, rnd_bits: torch.Tensor) -> torch.Tensor:
    """float32 -> n-bit linear takum bit patterns (int64) with stochastic
    rounding: the tail of ``repro``'s ``_encode_from_cm(..., rnd_bits)``.
    ``rnd_bits & (2**t - 1)`` is added below the t discarded bits of the
    body (the carry walks into the kept bits), the sum truncated, and the
    magnitude clamped to [1, 2**(n-1) - 1]; zero, DAZ and NaR as
    :func:`takum_encode`.  ``rnd_bits``: x's shape, uint32 values in an
    integer tensor (int64, or their int32 view), given by the caller and
    never drawn here.  ``n`` in [2, 32].  A body has 27 to 34 bits; where it
    is shorter than the n - 1 kept bits (n > 28 only) nothing is discarded
    and the body is left-aligned, the exact code :func:`takum_encode` gives
    (``repro`` keeps it unshifted there: ROADMAP R10)."""
    if not 2 <= n <= 32:
        raise ValueError(f"takum_encode_sr supports 2 <= n <= 32, got {n}")
    if rnd_bits.shape != x.shape:
        raise ValueError(f"rnd_bits {tuple(rnd_bits.shape)} must match x {tuple(x.shape)}")
    neg, is_zero, is_nar, body, nbits = _encode_body(x)
    t = nbits - (n - 1)
    tc = t.clamp(0, 31)
    add = rnd_bits.to(_I64) & ((torch.ones_like(tc) << tc) - 1)
    mag = (body + add) >> tc
    if n > 28:
        mag = torch.where(t < 0, body << (-t).clamp(min=0), mag)
    mag = mag.clamp(1, (1 << (n - 1)) - 1)
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


def _rne_shr(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``v >> s`` rounded to nearest, ties to even (int64, s >= 0)."""
    sc = s.clamp(min=1)
    kept = v >> sc
    guard = (v >> (sc - 1)) & 1
    sticky = (v & ((torch.ones_like(sc) << (sc - 1)) - 1)) != 0
    up = (guard == 1) & (sticky | ((kept & 1) == 1))
    return torch.where(s > 0, kept + up.to(_I64), v)


def _round_m24(M: torch.Tensor) -> torch.Tensor:
    """An integer fraction field M < 2**27 rounded to 24 significant bits,
    to nearest even (the value of ``M.astype(float32)``)."""
    s = (M >= 1 << 24).to(_I64) + (M >= 1 << 25).to(_I64) + (M >= 1 << 26).to(_I64)
    return _rne_shr(M, s) << s


def _f32bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """The linear decode as IEEE f32 patterns (int64), any n in [5, 32]; see
    :func:`takum_decode_f32bits`.  Above n = 28 the fraction is rounded
    twice (the module docstring), which may carry into the exponent."""
    b = codes_of(bits) & ((1 << n) - 1)
    is_zero = b == 0
    is_nar = b == NAR(n)
    neg, c, M, p = _decode_fields(b, n)
    if n > 28:
        q = _rne_shr(_round_m24(M), (p - 23).clamp(min=0))
        q = torch.where(p > 23, q, M << (23 - p).clamp(min=0))
        c = c + (q >> 23)  # 1 + f rounded up to 2
        frac = q & 0x7FFFFF
    else:
        frac = M << (23 - p)
    out = ((c.clamp(-126, 127) + 127) << 23) | frac
    out = torch.where(c > 127, torch.full_like(out, 0x7F7FFFFF), out)
    out = torch.where((c < -126) | is_zero, torch.zeros_like(out), out)
    out = torch.where(is_nar, torch.full_like(out, 0x7FC00000), out)
    return torch.where(is_zero | is_nar | ~neg, out, out | (1 << 31))


def takum_decode_f32bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """n-bit takum patterns -> IEEE f32 bit patterns (int64), assembled
    directly: c > 127 saturates to max-finite, c < -126 flushes to zero
    (signed: a negative code gives -0), NaR -> canonical NaN, zero -> +0.
    ``n`` in [5, 28] (p <= 23), as ``repro``'s."""
    if not 5 <= n <= 28:
        raise ValueError(f"takum decode supports 5 <= n <= 28, got {n}")
    return _f32bits(bits, n)


def _scale_pow2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x * 2**k in float32 as two exact power-of-two factors, k in
    [-253, 254] (``repro``'s ``_scale_pow2``); overflow gives inf."""
    a = k.clamp(-126, 127)
    return x * pow2_f32(a) * pow2_f32((k - a).clamp(-126, 127))


def _log_decode(bits: torch.Tensor, n: int) -> torch.Tensor:
    """The logarithmic decode (``repro``'s f32 steps): l = (c + f) *
    log2(sqrt e), value 2**floor(l) * exp2(frac(l)); magnitudes below
    2**-126 flush to zero (XLA's FTZ), above f32's range saturate."""
    b = codes_of(bits) & ((1 << n) - 1)
    neg, c, M, p = _decode_fields(b, n)
    if n > 28:
        M = _round_m24(M)
    f = M.to(torch.float32) * pow2_f32(-p)  # exact: M holds at most 24 significant bits
    lv = (c.to(torch.float32) + f) * _f32_const(_LOG2_SQRT_E, f)
    lf = torch.floor(lv)
    x = torch.exp2(lv - lf)
    k = lf.to(_I64)
    val = _scale_pow2(x, k.clamp(-253, 254))
    tiny = (k < -127) | ((k == -127) & (x < 2.0))  # x * 2**k < 2**-126 exactly
    val = torch.where(tiny, torch.zeros_like(val), val)
    val = torch.clamp_max(val, 3.4028234663852886e38)
    val = torch.where(neg, -val, val)
    val = torch.where(b == 0, torch.zeros_like(val), val)
    return torch.where(b == NAR(n), torch.full_like(val, float("nan")), val)


def takum_decode(bits: torch.Tensor, n: int, mode: str = "linear") -> torch.Tensor:
    """n-bit takum patterns -> float32.  Linear: see
    :func:`takum_decode_f32bits`, for ``n`` in [5, 32] (above 28 the
    fraction rounds twice, as ``repro``'s decoder rounds it).  Log: see the
    module docstring."""
    _check_mode(mode)
    if not 5 <= n <= 32:
        raise ValueError(f"takum decode supports 5 <= n <= 32, got {n}")
    if mode == "log":
        return _log_decode(bits, n)
    return f32_from_bits(_f32bits(bits, n))
