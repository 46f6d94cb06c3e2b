"""Takum codec in numpy float64/uint64 (counterpart of ``repro.core.takum_np``;
the port's own copy, since ``repro``'s imports JAX through ``bitround``).

Same format semantics as :mod:`repro_torch.core.takum`, but with a 52-bit
fraction path and an exact float64 decode: the oracle whose 9-bit and
17-bit takum values give the encode tables of :mod:`repro_torch.core.tables`
their exact rounding boundaries.  Saturation for
out-of-range characteristics (|c| > 255 is reachable from float64 inputs,
unlike float32) is handled explicitly.
"""

from __future__ import annotations

import numpy as np

from .bitround import floor_log2_u64_np, round_body_np

_LOG2_SQRT_E = 0.7213475204444817
_INV_LOG2_SQRT_E = 1.0 / _LOG2_SQRT_E

_WF = 52  # fraction working width


def nar(n: int) -> int:
    return 1 << (n - 1)


def _split_f64(a):
    """|a| -> (e, m52) with a = 2**e * (1 + m52/2**52), subnormal-aware."""
    bits = a.view(np.uint64) if a.dtype == np.float64 else np.float64(a).view(np.uint64)
    raw_e = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    raw_m = bits & np.uint64((1 << 52) - 1)
    # subnormals
    k = np.where(raw_m > 0, floor_log2_u64_np(np.maximum(raw_m, 1)), 0).astype(np.int64)
    sub_sh = (52 - k).astype(np.uint64)
    sub_m = (raw_m << sub_sh) & np.uint64((1 << 52) - 1)
    sub_e = k - 1074
    e = np.where(raw_e == 0, sub_e, raw_e - 1023)
    m = np.where(raw_e == 0, sub_m, raw_m)
    return e, m


def _header(c):
    c = c.astype(np.int64)
    neg = c < 0
    g = np.where(neg, -c, c + 1).astype(np.uint64)  # [1, 255]
    r = floor_log2_u64_np(g)
    C = np.where(neg, c + (np.int64(1) << (r + 1)) - 1, c - ((np.int64(1) << r) - 1)).astype(np.uint64)
    R = np.where(neg, 7 - r, r).astype(np.uint64)
    D = np.where(neg, np.uint64(0), np.uint64(1))
    ru = r.astype(np.uint64)
    H = (D << (ru + np.uint64(3))) | (R << ru) | C
    return H, 4 + r


def _encode_from_cm(c, mf, n: int):
    sat_hi = c > 254
    sat_lo = c < -255
    c = np.clip(c, -255, 254)
    H, hlen = _header(c)
    body = (H << np.uint64(_WF)) | mf  # <= 11 + 52 = 63 bits
    mag = round_body_np(body, hlen + _WF, n - 1)
    mag = np.where(sat_hi, np.uint64((1 << (n - 1)) - 1), mag)
    mag = np.where(sat_lo, np.uint64(1), mag)
    return mag


def encode(x, n: int, mode: str = "linear"):
    """float64 array -> n-bit takum patterns (uint64)."""
    x = np.asarray(x, dtype=np.float64)
    a = np.abs(x)
    is_zero = a == 0
    is_nar = np.isnan(x) | np.isinf(x)
    neg = np.signbit(x) & ~is_zero & ~is_nar
    safe = np.where(is_zero | is_nar, 1.0, a)

    if mode == "linear":
        c, mf = _split_f64(safe)
    elif mode == "log":
        l = 2.0 * np.log(safe)  # log_sqrt(e)
        cf = np.floor(l)
        f = l - cf
        mf = np.floor(f * float(1 << _WF)).astype(np.uint64)
        carry = mf >= np.uint64(1 << _WF)
        c = cf.astype(np.int64) + carry
        mf = np.where(carry, np.uint64(0), mf)
    else:
        raise ValueError(mode)

    mag = _encode_from_cm(c, mf, n)
    mask = np.uint64((1 << n) - 1)
    enc = np.where(neg, (np.uint64(0) - mag) & mask, mag)
    enc = np.where(is_zero, np.uint64(0), enc)
    enc = np.where(is_nar, np.uint64(nar(n)), enc)
    return enc


def _decode_fields(bits, n: int):
    mask = np.uint64((1 << n) - 1)
    bits = bits.astype(np.uint64) & mask
    neg = ((bits >> np.uint64(n - 1)) & np.uint64(1)) == 1
    mag = np.where(neg, (np.uint64(0) - bits) & mask, bits)

    D = (mag >> np.uint64(n - 2)) & np.uint64(1)
    R = ((mag >> np.uint64(n - 5)) & np.uint64(7)).astype(np.int64)
    r = np.where(D == 1, R, 7 - R)
    rem = n - 5
    rem_v = mag & np.uint64((1 << rem) - 1)

    have = rem >= r
    C_full = rem_v >> np.maximum(rem - r, 0).astype(np.uint64)
    C_pad = rem_v << np.clip(r - rem, 0, 63).astype(np.uint64)
    C = np.where(have, C_full, C_pad)
    p = np.maximum(rem - r, 0)
    M = np.where(have, rem_v & ((np.uint64(1) << p.astype(np.uint64)) - np.uint64(1)), np.uint64(0))

    c = np.where(
        D == 1,
        ((np.int64(1) << r) - 1) + C.astype(np.int64),
        1 - (np.int64(1) << (r + 1)) + C.astype(np.int64),
    )
    return neg, c, M, p


def decode(bits, n: int, mode: str = "linear"):
    """n-bit takum patterns -> float64 (exact for n <= 57 in linear mode)."""
    bits = np.asarray(bits, dtype=np.uint64)
    mask = np.uint64((1 << n) - 1)
    masked = bits & mask
    is_zero = masked == 0
    is_nar = masked == np.uint64(nar(n))
    neg, c, M, p = _decode_fields(bits, n)

    f = M.astype(np.float64) * np.exp2(-p.astype(np.float64))
    if mode == "linear":
        val = (1.0 + f) * np.exp2(c.astype(np.float64))
    else:
        val = np.exp2((c.astype(np.float64) + f) * _LOG2_SQRT_E)
    val = np.where(neg, -val, val)
    val = np.where(is_zero, 0.0, val)
    val = np.where(is_nar, np.nan, val)
    return val


def minpos(n: int, mode: str = "linear") -> float:
    return float(decode(np.array([1], dtype=np.uint64), n, mode)[0])


def maxpos(n: int, mode: str = "linear") -> float:
    return float(decode(np.array([(1 << (n - 1)) - 1], dtype=np.uint64), n, mode)[0])
