"""Posit (2022 standard, es=2) codec in numpy float64 — benchmark baseline (the
port's own copy of ``repro.core.posit_np``, on the port's ``bitround``).

The paper compares takum against posit8/16/32 (Figures 1-2); posits are a
benchmark-only format here (the framework's hot paths use takum), so a
vectorised numpy implementation suffices.  Layout of an n-bit posit:

    S | regime (run-length) | E (es=2 bits) | F (fraction)

    k >= 0: (k+1) ones then a zero encode regime k; k < 0: -k zeros then a one.
    value = (-1)**S * 2**(4k + e) * (1 + f),  useed = 2**(2**es) = 16.

Negative values are two's complement.  0 = all zeros, NaR = 1 0...0.
Rounding: nearest, ties-to-even on the bit string; saturation to
[minpos, maxpos] (never rounds to 0 or NaR).
"""

from __future__ import annotations

import numpy as np

from .bitround import floor_log2_u64_np, round_body_np128

ES = 2
_WF = 52


def nar(n: int) -> int:
    return 1 << (n - 1)


def _split_f64(a):
    bits = a.view(np.uint64)
    raw_e = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    raw_m = bits & np.uint64((1 << 52) - 1)
    k = np.where(raw_m > 0, floor_log2_u64_np(np.maximum(raw_m, 1)), 0).astype(np.int64)
    sub_m = (raw_m << (52 - k).astype(np.uint64)) & np.uint64((1 << 52) - 1)
    e = np.where(raw_e == 0, k - 1074, raw_e - 1023)
    m = np.where(raw_e == 0, sub_m, raw_m)
    return e, m


def encode(x, n: int):
    """float64 -> n-bit posit (es=2) patterns, uint64."""
    x = np.asarray(x, dtype=np.float64)
    a = np.abs(x)
    is_zero = a == 0
    is_nar = np.isnan(x) | np.isinf(x)
    neg = np.signbit(x) & ~is_zero & ~is_nar
    safe = np.where(is_zero | is_nar, 1.0, a)

    e, mf = _split_f64(safe)
    # saturation: |exponent| beyond the regime's reach
    emax = 4 * (n - 2)
    sat_hi = e >= emax
    sat_lo = e < -emax
    e = np.clip(e, -emax, emax - 1)

    k = np.floor_divide(e, 4)
    ee = (e - 4 * k).astype(np.uint64)  # in [0, 3]

    # regime bit block
    reg_len = np.where(k >= 0, k + 2, -k + 1).astype(np.int64)  # <= n+1 after clamp
    reg_val = np.where(k >= 0, (np.uint64(1) << (k + 2).astype(np.uint64)) - np.uint64(2), np.uint64(1))

    # body = regime | E(2) | F(52): up to (n+1) + 2 + 52 <= 87 bits -> 2 words
    H = (reg_val << np.uint64(ES)) | ee  # header = regime + exponent bits
    hlen = reg_len + ES
    hi = H >> np.uint64(64 - _WF)  # bits of H above (64 - 52) = 12
    lo = ((H & np.uint64((1 << (64 - _WF)) - 1)) << np.uint64(_WF)) | mf
    mag = round_body_np128(hi, lo, hlen + _WF, n - 1)

    mag = np.where(sat_hi, np.uint64((1 << (n - 1)) - 1), mag)
    mag = np.where(sat_lo, np.uint64(1), mag)

    mask = np.uint64((1 << n) - 1)
    enc = np.where(neg, (np.uint64(0) - mag) & mask, mag)
    enc = np.where(is_zero, np.uint64(0), enc)
    enc = np.where(is_nar, np.uint64(nar(n)), enc)
    return enc


def decode(bits, n: int):
    """n-bit posit patterns -> float64 (exact)."""
    bits = np.asarray(bits, dtype=np.uint64)
    mask = np.uint64((1 << n) - 1)
    masked = bits & mask
    is_zero = masked == 0
    is_nar = masked == np.uint64(nar(n))
    neg = ((masked >> np.uint64(n - 1)) & np.uint64(1)) == 1
    mag = np.where(neg, (np.uint64(0) - masked) & mask, masked)

    body = mag << np.uint64(64 - (n - 1))  # left-align the n-1 body bits
    first = (body >> np.uint64(63)) & np.uint64(1)
    # run length of the leading bit
    inv = np.where(first == 1, ~body, body)
    # count leading zeros of inv (== run length of `first` in body)
    nz = inv != 0
    fl = floor_log2_u64_np(np.maximum(inv, 1))
    run = np.where(nz, 63 - fl, 64)
    run = np.minimum(run, n - 1)  # regime may fill the whole body
    k = np.where(first == 1, run - 1, -run)

    # remaining bits after regime (+ its terminating bit)
    used = np.minimum(run + 1, n - 1).astype(np.uint64)
    rest = body << used  # exponent bits then fraction, left-aligned
    ee = rest >> np.uint64(64 - ES)
    frac_bits = rest << np.uint64(ES)
    f = frac_bits.astype(np.float64) * 2.0**-64

    val = (1.0 + f) * np.exp2((4 * k).astype(np.float64) + ee.astype(np.float64))
    val = np.where(neg, -val, val)
    val = np.where(is_zero, 0.0, val)
    val = np.where(is_nar, np.nan, val)
    return val


def minpos(n: int) -> float:
    return float(decode(np.array([1], dtype=np.uint64), n)[0])


def maxpos(n: int) -> float:
    return float(decode(np.array([(1 << (n - 1)) - 1], dtype=np.uint64), n)[0])
