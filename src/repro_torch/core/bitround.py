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

__all__ = ["floor_log2_u64_np", "round_body_np"]


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
