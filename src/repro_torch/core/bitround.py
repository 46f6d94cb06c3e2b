"""Bit-string rounding for the float64 takum oracle (counterpart of the numpy
half of ``repro.core.bitround``; the port's own copy, since that module
imports ``jax.numpy``).

A takum encoder reduces to one final step: a *left-aligned* full-precision
bit string (header + fraction) is rounded to the target width with
round-to-nearest, ties-to-even **in bit space**, then saturated so that a
nonzero value never rounds to zero and a finite value never rounds to NaR.
"""

from __future__ import annotations

import numpy as np

__all__ = ["floor_log2_u64_np", "round_body_np", "round_body_np128"]


def floor_log2_u64_np(v):
    """Exact floor(log2(v)) for numpy uint64 v >= 1 (float-free: smear+popcount).

    ``np.log2`` on >52-bit integers can round up across power-of-two boundaries
    (e.g. log2(2**57 - 1) -> 57.0), so codecs must never use it on mantissas.
    """
    v = np.asarray(v, dtype=np.uint64)
    for s in (1, 2, 4, 8, 16, 32):
        v = v | (v >> np.uint64(s))
    return np.bitwise_count(v).astype(np.int64) - 1


def round_body_np(body, nbits, keep):
    """uint64 left-aligned body of ``nbits`` bits -> rounded ``keep``-bit value.

    Vectorised; ``nbits`` per element, ``keep`` a scalar < 64.  Requires
    nbits <= 63 so the guard/sticky arithmetic stays in range.
    """
    body = body.astype(np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    t = nbits - keep

    sl = np.where(t < 0, -t, 0).astype(np.uint64)
    no_round = body << sl

    tc = np.maximum(t, 1).astype(np.uint64)
    kept = body >> tc
    guard = (body >> (tc - np.uint64(1))) & np.uint64(1)
    sticky = (body & ((np.uint64(1) << (tc - np.uint64(1))) - np.uint64(1))) != 0
    round_up = (guard == 1) & (sticky | ((kept & np.uint64(1)) == 1))
    kept = kept + round_up.astype(np.uint64)

    out = np.where(t <= 0, no_round, kept)
    out = np.minimum(out, np.uint64((1 << keep) - 1))
    out = np.maximum(out, np.uint64(1))
    return out


def round_body_np128(hi, lo, nbits, keep):
    """128-bit body in two uint64 words -> rounded ``keep``-bit value (posit).

    body = hi * 2**64 + lo, ``nbits`` significant bits (<= 127), keep < 64.
    """
    hi = hi.astype(np.uint64)
    lo = lo.astype(np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    t = nbits - keep  # discarded bits; may exceed 64

    sl = np.where(t < 0, -t, 0).astype(np.uint64)
    no_round = lo << sl  # hi == 0 whenever t < 0

    tc = np.maximum(t, 1).astype(np.int64)

    def shr128(amount):
        a = np.clip(amount, 0, 127).astype(np.uint64)
        lo_part = np.where(a >= 64, np.uint64(0), lo >> (a & np.uint64(63)))
        carry = np.where(
            (a > 0) & (a < 64), hi << ((np.uint64(64) - a) & np.uint64(63)), np.uint64(0)
        )
        hi_part = np.where(a >= 64, hi >> ((a - np.uint64(64)) & np.uint64(63)), np.uint64(0))
        return np.where(a >= 64, hi_part, lo_part | carry)

    kept = shr128(tc)
    guard = shr128(tc - 1) & np.uint64(1)

    # sticky: any bit strictly below position tc-1
    tm1 = tc - 1
    lo_mask = np.where(
        tm1 >= 64,
        np.uint64(0xFFFFFFFFFFFFFFFF),
        (np.uint64(1) << (np.clip(tm1, 0, 63).astype(np.uint64))) - np.uint64(1),
    )
    hi_mask = np.where(
        tm1 > 64,
        (np.uint64(1) << (np.clip(tm1 - 64, 0, 63).astype(np.uint64))) - np.uint64(1),
        np.uint64(0),
    )
    sticky = ((lo & lo_mask) != 0) | ((hi & hi_mask) != 0)

    round_up = (guard == 1) & (sticky | ((kept & np.uint64(1)) == 1))
    kept = kept + round_up.astype(np.uint64)

    out = np.where(t <= 0, no_round, kept)
    out = np.minimum(out, np.uint64((1 << keep) - 1))
    out = np.maximum(out, np.uint64(1))
    return out
