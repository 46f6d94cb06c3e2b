"""The three-way bf16 split of an f32 operand, on the CPU: what the f32-x
wgmma tile of K3 and K5's backward (``csrc/matmul_wgmma.cuh``, loop
``"mma_f32"``) rests on.

``takum_matmul.split3_bf16`` is the plain twin of the tile's ``split3_8``:
hi = x with its low 16 bits cleared, mid the same of r = x - hi, lo = r -
mid.  These tests hold, over an f32 sweep (every exponent with random
mantissas, +-0, subnormals, values around the edge 2^-110, f32's largest
value, +-inf and NaN), that each part is a bf16 value, that hi + mid + lo
== x bit for bit wherever the vote passes, and that the vote flags exactly
the rest: the non-finite values and the nonzero ones below 2^-110 whose
lowest bits lie under bf16's smallest subnormal 2^-133.  Then that the
products of the parts with every decoded weight's bf16 parts (t16: hi and
lo; the 8-bit formats, bf16 and the mx containers: the value itself) are
exact in f32 and sum to x * w, held against numpy float64; and that K3's
and the transposed K3's wrappers hand their C entries the loop and the
block edge (``mma_plan``) of the wgmma tile above M = 16.  The decoded
values are ``repro``'s (JAX on the CPU) as well as the port's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import formats as jformats
from repro.quant import blockscale as jbs
from repro_torch.core.formats import wire_format
from repro_torch.kernels import takum_matmul as tm
from repro_torch.kernels.mx_cases import mx_all_codes
from repro_torch.kernels.takum_codec import decode_2d_plain
from repro_torch.kernels.takum_matmul import (LOOPS, SPLIT3_EDGE, mma_plan, split3_bf16,
                                              tile_for)

F32_MAX = float(np.finfo(np.float32).max)
#: bf16's smallest subnormal, the finest step of its grid
BF16_TINY = 2.0 ** -133


def _sweep() -> np.ndarray:
    """f32 values: random mantissas at every exponent (normal and
    subnormal), both signs; +-0; values just around 2^-110 and at
    multiples of 2^-133 below it; f32's largest; +-inf and NaN."""
    rng = np.random.default_rng(19)
    exps = np.repeat(np.arange(-149, 128), 24)
    mant = rng.random(exps.size) + 1.0
    v = np.ldexp(mant, exps) * rng.choice([-1.0, 1.0], exps.size)
    subnormal_bits = rng.integers(1, 1 << 23, 4000, dtype=np.uint32)
    edge = np.float32(SPLIT3_EDGE)
    around = np.concatenate([
        np.nextafter(edge, np.float32(0), dtype=np.float32) * np.ones(1, np.float32),
        np.float32([edge, -edge]),
        np.nextafter(edge, np.float32(1), dtype=np.float32) * np.ones(1, np.float32),
        # multiples of 2^-133 below the edge: carried exactly
        np.float32(rng.integers(1, 1 << 23, 2000) * BF16_TINY),
        np.float32(-rng.integers(1, 1 << 16, 2000) * BF16_TINY),
    ])
    specials = np.float32([0.0, -0.0, F32_MAX, -F32_MAX, np.inf, -np.inf, np.nan, 1.0, -1.0])
    return np.concatenate([v.astype(np.float32), subnormal_bits.view(np.float32),
                           -subnormal_bits.view(np.float32), around, specials]).astype(np.float32)


def _is_bf16(v: np.ndarray) -> np.ndarray:
    """Whether each f32 value is a bf16 value (its low 16 bits zero), NaN
    counted as one."""
    return np.isnan(v) | ((v.view(np.uint32) & 0xFFFF) == 0)


def _parts(x: np.ndarray):
    hi, mid, lo, vote = split3_bf16(torch.from_numpy(x))
    return hi.numpy(), mid.numpy(), lo.numpy(), vote.numpy()


def test_split3_parts_are_bf16_and_sum_to_x_where_the_vote_passes():
    x = _sweep()
    hi, mid, lo, vote = _parts(x)
    finite = np.isfinite(x)
    # hi and mid are bf16 by construction, for every value
    assert _is_bf16(hi).all() and _is_bf16(mid).all()
    # hi of a finite x is finite: truncation never rounds up to inf
    assert np.isfinite(hi[finite]).all()
    ok = ~vote
    assert _is_bf16(lo[ok]).all()
    # the three parts sum to x exactly (in f64, and in f32 from the
    # smallest part up); bit for bit but for -0, whose parts are -0, +0, +0
    exact = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(exact[ok], x[ok].astype(np.float64))
    s32 = hi + (mid + lo)
    nz = ok & (x != 0)
    assert np.array_equal(s32[nz].view(np.uint32), x[nz].view(np.uint32))
    assert (s32[ok & (x == 0)] == 0).all()
    # the vote flags exactly the rest: non-finite x, and a lo off bf16's grid
    assert np.array_equal(vote, ~finite | ~_is_bf16(lo))


def test_split3_vote_edge_is_2_to_the_minus_110():
    """Every finite |x| >= 2^-110 passes; below it exactly the multiples of
    2^-133 (0 among them) pass."""
    x = _sweep()
    _, _, _, vote = _parts(x)
    finite = np.isfinite(x)
    big = finite & (np.abs(x.astype(np.float64)) >= SPLIT3_EDGE)
    assert not vote[big].any()
    small = finite & ~big
    on_grid = np.mod(x[small].astype(np.float64), BF16_TINY) == 0
    assert np.array_equal(vote[small], ~on_grid)
    assert vote[~finite].all()
    # the sweep reaches both sides of the edge
    assert vote[small].any() and (~vote[small]).any() and big.sum() > 1000


def _decoded(fmt) -> np.ndarray:
    """Every decoded value of ``fmt`` (mx: every element code under every
    scale byte), from the port's plain decode, equal to ``repro``'s."""
    wf = wire_format(fmt)
    if wf.is_block_scaled:
        p = mx_all_codes()
        got = decode_2d_plain(p, fmt).numpy().reshape(-1)
        want = np.asarray(jbs.decode_payload(jnp.asarray(p.numpy()), fmt)).reshape(-1)
    else:
        c = np.arange(1 << wf.nbits, dtype=np.int64).astype({8: np.uint8, 16: np.uint16}[wf.nbits])
        got = decode_2d_plain(torch.from_numpy(c.reshape(1, -1)), fmt).numpy().reshape(-1)
        want = np.asarray(jformats.wire_format(fmt).decode_jnp(jnp.asarray(c))).reshape(-1)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    return got.astype(np.float32)


def _weight_parts(w: np.ndarray, fmt: str) -> list:
    """The bf16 parts the tiles multiply: hi and lo = w - hi for t16, the
    value itself for every other format (exact in bf16)."""
    if fmt != "t16":
        return [w]
    hi = (w.view(np.uint32) & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return [hi, (w - hi).astype(np.float32)]


@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8"))
def test_split3_products_with_every_decoded_weight_are_exact(fmt):
    """For x with random mantissas over exponents -60 .. 60 and every
    finite decoded weight w the tiles carry (their vote passes): each
    product of an x part and a w part, taken in f32 (numpy float32, rounded
    to nearest), equals its float64 product wherever that is 0 or in f32's
    range from 2^-133 (16 significant bits then fit f32's grid), and the
    float64 products sum to x * w exactly."""
    rng = np.random.default_rng(7)
    x = (np.ldexp(rng.random(48) + 1.0, rng.integers(-60, 61, 48))
         * rng.choice([-1.0, 1.0], 48)).astype(np.float32)
    hi, mid, lo, vote = _parts(x)
    assert not vote.any()
    w = _decoded(fmt)
    # the values the tiles carry; the rest (f32's largest value from
    # saturating codes, and mxt8's saturated elements under scales below 1)
    # take their FMA fallback (tests/test_torch_tiles.py)
    carried = np.abs(w) != np.float32(F32_MAX) if fmt == "t16" else _is_bf16(w)
    w = w[np.isfinite(w) & carried]
    wp = _weight_parts(w, fmt)
    assert all(_is_bf16(p).all() for p in wp)
    total = np.zeros((x.size, w.size))
    checked = 0
    for xp in (hi, mid, lo):
        for p in wp:
            p64 = np.multiply.outer(xp.astype(np.float64), p.astype(np.float64))
            with np.errstate(over="ignore"):
                p32 = np.multiply.outer(xp, p).astype(np.float64)
            fits = (p64 == 0) | ((np.abs(p64) >= BF16_TINY) & (np.abs(p64) <= F32_MAX))
            assert np.array_equal(p32[fits], p64[fits])
            checked += int(fits.sum())
            total += p64
    assert np.array_equal(total, np.multiply.outer(x.astype(np.float64), w.astype(np.float64)))
    assert checked > 0.9 * total.size * 3 * len(wp)


def _fake_entry(calls):
    def entry(name):
        def run(*args):
            calls.append((name, args))
            return 0
        return run
    return entry


@pytest.mark.parametrize("fmt", ("t8", "t16", "e5m2", "bf16", "mxt8"))
def test_f32_launches_pass_the_wgmma_loop_and_mma_plan(monkeypatch, fmt):
    """Above M = 16, K3 with f32 x and the transposed K3 hand their C entry
    the loop code of ``"mma_f32"`` and ``mma_plan``'s block rows (128 or
    64), at M = 17, 37, 1000 and 1024 over N = 100, 1024 and 4096; at
    M <= 16 the matvec and no block edge."""
    calls = []
    monkeypatch.setattr(tm, "_check_device", lambda *a: False)
    monkeypatch.setattr(tm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tm._build, "entry", _fake_entry(calls))
    wf = wire_format(fmt)
    K = 96
    for M in (4, 16, 17, 37, 1000, 1024):
        for N in (100, 1024, 4096):
            loop = tile_for(M, "f32", fmt)
            assert loop == ("matvec" if M <= 16 else "mma_f32")
            edge = mma_plan(M, N).rows if M > 16 else 0
            x = torch.zeros((M, K))
            w = (torch.zeros((K, -(-N // 32) * 33), dtype=torch.uint8) if wf.is_block_scaled
                 else torch.zeros((K, N), dtype=wf.storage))
            tm.takum_matmul(x, w, fmt, n=N)
            name, args = calls[-1]
            assert name == "repro_matmul" and tm.takum_matmul.last_loop == loop
            assert args[4:11] == (M, N, K, args[7], LOOPS.index(loop), edge, 0)
            if wf.is_block_scaled:
                continue
            # the transposed launch: g [M, N] @ decode(w [K, N]).T -> [M, K]
            tm.takum_matmul_t(torch.zeros((M, N)), torch.zeros((K, N), dtype=wf.storage), fmt)
            name, args = calls[-1]
            assert name == "repro_matmul_wt" and tm.takum_matmul_t.last_loop == loop
            tedge = mma_plan(M, K).rows if M > 16 else 0
            assert args[4:7] == (M, K, N) and args[8:11] == (LOOPS.index(loop), tedge, wf.code)
