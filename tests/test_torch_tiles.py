"""The tensor-core tile of K3 and K4 on the CPU: the property its exactness
rests on, and the loop table and tile plan the wrapper hands the C entries.

``csrc/matmul_mma.cuh`` multiplies bf16 x by decoded weights on bf16 tensor
cores, where a product of two bf16 values is exact in f32.  That gives K3's
function only where each decoded weight (and K4's decoded x) is the exact
sum of its bf16 parts: the value itself truncated to bf16 for the 8-bit
formats, bf16 and the mx containers; for t16, hi (its low 16 bits cleared)
plus lo = w - hi.  These tests hold, over every code (every mx element code
under every scale byte), that this is so for every value but f32's largest
finite magnitude, to which the saturating t8 / t16 codes decode, and that
the tile's per-element vote (``split8``: a finite value whose parts leave a
remainder) flags exactly those, which the tile then recomputes on its FMA
loop.  The decoded values are ``repro``'s (JAX on the CPU) as well as the
port's, and the two agree.

Then ``takum_matmul.tile_for`` (which loop a launch runs, from M, the kind
of x and the format), ``mma_plan`` (the tensor-core tile's block edge from
(M, N), at least one block per SM at llama3-8b's prefill shapes, every
output covered once), the arguments K3's and K4's wrappers pass a
monkeypatched C entry, and that every variant of ``tools/tile_variants.py``
still applies to the header.
"""

import importlib.util
import math
from pathlib import Path

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
from repro_torch.kernels.takum_matmul import LOOPS, SM_COUNT, mma_plan, tile_for

FLAT = ("t8", "e4m3", "e5m2", "bf16")
MX = ("mxe4m3", "mxe5m2", "mxt8")
F32_MAX_BITS = 0x7F7FFFFF
#: llama3-8b's prefill linears at B = 4, S = 256: M = 1024 and N of wk / wv,
#: wq / wo / down, wi / wg
PREFILL_N = (1024, 4096, 14336)
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("tile_variants", ROOT / "tools" / "tile_variants.py")
tile_variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_variants)


def _codes(fmt) -> np.ndarray:
    wf = wire_format(fmt)
    return np.arange(1 << wf.nbits, dtype=np.int64).astype({8: np.uint8, 16: np.uint16}[wf.nbits])


def _decoded(fmt) -> np.ndarray:
    """Every decoded value of ``fmt`` (mx: every element code under every
    scale byte), f32, from the port's plain decode, held equal (NaN matching
    NaN) to ``repro``'s."""
    if wire_format(fmt).is_block_scaled:
        p = mx_all_codes()
        got = decode_2d_plain(p, fmt).numpy().reshape(-1)
        want = np.asarray(jbs.decode_payload(jnp.asarray(p.numpy()), fmt)).reshape(-1)
    else:
        c = _codes(fmt)
        got = decode_2d_plain(torch.from_numpy(c.reshape(1, -1)), fmt).numpy().reshape(-1)
        want = np.asarray(jformats.wire_format(fmt).decode_jnp(jnp.asarray(c))).reshape(-1)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    return got.astype(np.float32)


def _bf16_round_trip(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _split8_vote(u: np.ndarray, split: bool) -> np.ndarray:
    """The tile's per-element vote (csrc/matmul_mma.cuh split8) on f32 bit
    patterns: a finite value whose bf16 parts leave a remainder."""
    finite = (u & 0x7F800000) != 0x7F800000
    if not split:
        return finite & ((u & 0xFFFF) != 0)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (u.view(np.float32) - hi).view(np.uint32)
    return finite & ((lo & 0xFFFF) != 0)


@pytest.mark.parametrize("fmt", FLAT + MX)
def test_decoded_values_are_exact_in_bf16_but_f32_max(fmt):
    """Every decoded value of the 8-bit formats, bf16 and the mx containers
    equals its own bf16 round trip (after the port's explicit mx FTZ, which
    leaves no subnormal product), except f32's largest finite magnitude,
    which the saturating t8 codes give (and mxt8 elements among them under
    a scale below 1); the tile's vote flags exactly those."""
    v = _decoded(fmt)
    u = v.view(np.uint32)
    finite = np.isfinite(v)
    rt = _bf16_round_trip(v)
    same = np.isnan(v) | (rt == v)
    inexact = ~same
    subnormal = finite & (v != 0) & (np.abs(v) < 2.0 ** -126)
    # bf16 weights hold bf16's subnormals (exact in bf16; the card test
    # test_mma_tile_carries_every_code_exactly sends them through the tensor
    # cores); no other format decodes to one
    assert subnormal.sum() == (2 * 127 if fmt == "bf16" else 0)
    vote = _split8_vote(u, split=False)
    assert np.array_equal(vote, inexact)
    if fmt == "t8":
        assert np.array_equal(np.abs(v[inexact]).view(np.uint32), np.full(14, F32_MAX_BITS))
    elif fmt == "mxt8":
        # a saturated element (t8's 14 codes, 32 copies a group) under each of
        # the 128 scale bytes 0..127 that keep the product finite
        t8 = _decoded("t8")
        sat = np.nonzero(np.abs(t8) == np.float32(np.finfo(np.float32).max))[0]
        assert inexact.sum() == len(sat) * 32 * 128
        elem = np.tile(np.repeat(np.arange(256), 32), 256)
        assert set(np.unique(elem[inexact])) == set(sat.tolist())
    else:
        assert not inexact.any()


def test_t16_split_is_exact_for_every_code_but_f32_max():
    """For all 65536 t16 codes: hi = w with its low 16 bits cleared and lo =
    w - hi are both exact in bf16, hi + lo == w, hi is finite for every
    finite w and lo is never subnormal, except for the 4064 codes that
    saturate to f32's largest finite magnitude (their remainder has 16
    significant bits); the tile's vote flags exactly those."""
    v = _decoded("t16")
    u = v.view(np.uint32)
    finite = np.isfinite(v)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        lo = v - hi
    sat = finite & (np.abs(v) == np.finfo(np.float32).max)
    assert sat.sum() == 4064
    ok = finite & ~sat
    assert np.array_equal((hi + lo)[ok], v[ok])
    assert np.array_equal(_bf16_round_trip(hi[ok]), hi[ok])
    assert np.array_equal(_bf16_round_trip(lo[ok]), lo[ok])
    assert np.all(np.isfinite(hi[finite]))
    assert not np.any((lo[ok] != 0) & (np.abs(lo[ok]) < 2.0 ** -126))
    # the parts carry at most 8 + 4 significant bits: lo's lowest set bit is
    # at most 11 binades below w's leading one
    nz = ok & (lo != 0)
    assert np.all(np.frexp(np.abs(v[nz]))[1] - np.frexp(np.abs(lo[nz]))[1] <= 11)
    assert not np.array_equal(_bf16_round_trip(lo[sat]), lo[sat])
    assert np.array_equal(_split8_vote(u, split=True), sat)
    # NaR: a NaN hi and, in the kernel, lo = 0, so the product is NaN
    assert np.isnan(hi[~finite]).all()


@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "e5m2", "bf16") + MX)
def test_tile_for_loop_table(fmt):
    """M <= 16: the matvec for K3 (either x) and K4; above: bf16-x K3 on the
    tensor cores (t16 through the split), f32-x K3 and every transposed
    launch (f32) on the wgmma tile (x split three ways), K4 on the tensor
    cores but over t16, which keeps the FMA tile."""
    t16 = fmt == "t16"
    for M in (1, 4, 5, 16):
        for kind in ("f32", "bf16", "wire"):
            assert tile_for(M, kind, fmt) == "matvec"
    for M in (17, 37, 256, 1024, 100_000):
        assert tile_for(M, "bf16", fmt) == ("mma_split" if t16 else "mma")
        assert tile_for(M, "f32", fmt) == "mma_f32"
        assert tile_for(M, "wire", fmt) == ("fma" if t16 else "mma")
    assert tile_for(17, "bf16", wire_format(fmt)) == tile_for(17, "bf16", fmt)


def test_tile_for_refuses_an_unknown_x_kind():
    with pytest.raises(ValueError, match="x_kind"):
        tile_for(64, "f16", "t8")
    assert LOOPS == ("matvec", "fma", "mma", "mma_split", "mma_f32")


@pytest.mark.parametrize("M", (17, 37, 64, 100, 256, 1000, 1024, 4096))
@pytest.mark.parametrize("N", (1, 100, 777, 1024, 4096, 14336, 128256))
def test_mma_plan_covers_every_output_once(M, N):
    plan = mma_plan(M, N)
    assert (plan.rows, plan.cols) in tm.MMA_TILES
    rows = [range(i * plan.rows, min((i + 1) * plan.rows, M)) for i in range(plan.m_tiles)]
    cols = [range(j * plan.cols, min((j + 1) * plan.cols, N)) for j in range(plan.n_tiles)]
    assert [m for r in rows for m in r] == list(range(M)) and all(len(r) for r in rows)
    assert [n for c in cols for n in c] == list(range(N)) and all(len(c) for c in cols)
    # the larger tile where it still gives one block per SM
    big = math.ceil(M / 128) * math.ceil(N / 128)
    assert (plan.rows, plan.cols) == ((128, 128) if big >= SM_COUNT else (64, 64))


@pytest.mark.parametrize("N", PREFILL_N)
def test_mma_plan_fills_the_card_at_the_prefill(N):
    plan = mma_plan(1024, N)
    assert plan.blocks >= SM_COUNT == 132
    assert (plan.rows, plan.cols) == ((64, 64) if N == 1024 else (128, 128))


def _fake_entry(calls):
    def entry(name):
        def run(*args):
            calls.append((name, args))
            return 0
        return run
    return entry


@pytest.mark.parametrize("fmt", ("t8", "t16", "bf16", "mxe4m3", "mxt8"))
def test_k4_wrapper_passes_a_matvec_plan_only_at_small_m(monkeypatch, fmt):
    """K4's wrapper hands the C entry the matvec plan's chunk and a workspace
    of its size at M <= 16, the same for bits and lut, and above M = 16
    neither, with the loop of tile_for and (tensor-core tile) mma_plan's
    edge: the twin of test_k3_wrapper_passes_one_plan_for_both_codecs."""
    calls = []
    monkeypatch.setattr(tm, "_check_device", lambda *a: False)
    monkeypatch.setattr(tm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tm._build, "entry", _fake_entry(calls))
    wf = wire_format(fmt)
    K, N = 992, 100
    if wf.is_block_scaled:
        w = torch.zeros((K, 4 * 33), dtype=torch.uint8)
        xk = K // 32 * 33
    else:
        w = torch.zeros((K, N), dtype=wf.storage)
        xk = K
    for M in (3, 16, 17, 37):
        xb = torch.zeros((M, xk), dtype=wf.storage)
        for impl in ("bits", "lut"):
            tm.takum_dual_matmul(xb, w, fmt, n=N, decode_impl=impl)
            assert tm.takum_dual_matmul.last_loop == tile_for(M, "wire", fmt)
    assert {name for name, _ in calls} == {"repro_dual_matmul"}
    ws = [args[3] for _, args in calls]
    chunk, loop, tile = ([args[i] for _, args in calls] for i in (7, 8, 9))
    small = [tm.matvec_plan(M, N, K, fmt).chunk for M in (3, 3, 16, 16)]
    assert chunk == small + [0, 0, 0, 0]
    assert all(ws[:4]) and ws[4:] == [0, 0, 0, 0]
    big = LOOPS.index("fma" if fmt == "t16" else "mma")
    assert loop == [0, 0, 0, 0, big, big, big, big]
    assert tile == [0] * 4 + ([0] * 4 if fmt == "t16" else [64] * 4)
    assert [args[4:7] for _, args in calls] == [(M, N, K) for M in (3, 3, 16, 16, 17, 17, 37, 37)]


@pytest.mark.parametrize("x_dtype,fmt", [(torch.bfloat16, "t8"), (torch.bfloat16, "t16"),
                                         (torch.float32, "t8"), (torch.bfloat16, "mxt8")])
def test_k3_wrapper_passes_tile_for_and_mma_plan(monkeypatch, x_dtype, fmt):
    """K3's wrapper hands its C entry tile_for's loop code and mma_plan's
    edge (0 off the tensor-core tiles), and the transposed launch the wgmma
    tile and its edge above M = 16."""
    calls = []
    monkeypatch.setattr(tm, "_check_device", lambda *a: False)
    monkeypatch.setattr(tm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tm._build, "entry", _fake_entry(calls))
    wf = wire_format(fmt)
    K = 256
    for M, N in ((4, 4096), (1024, 1024), (1024, 4096)):
        x = torch.zeros((M, K), dtype=x_dtype)
        w = (torch.zeros((K, N // 32 * 33), dtype=torch.uint8) if wf.is_block_scaled
             else torch.zeros((K, N), dtype=wf.storage))
        tm.takum_matmul(x, w, fmt, n=N)
        kind = "bf16" if x_dtype == torch.bfloat16 else "f32"
        loop = tile_for(M, kind, fmt)
        assert tm.takum_matmul.last_loop == loop
        _, args = calls[-1]
        assert args[8] == LOOPS.index(loop) and args[10] == int(kind == "bf16")
        assert args[9] == (mma_plan(M, N).rows if loop.startswith("mma") else 0)
    if not wf.is_block_scaled:
        tm.takum_matmul_t(torch.zeros((37, 64)), torch.zeros((K, 64), dtype=wf.storage), fmt)
        name, args = calls[-1]
        assert name == "repro_matmul_wt" and tm.takum_matmul_t.last_loop == "mma_f32"
        assert args[7:11] == (0, LOOPS.index("mma_f32"), mma_plan(37, K).rows, wf.code)


@pytest.mark.parametrize("name", sorted(tile_variants.VARIANTS))
def test_tile_variant_applies_to_the_header(name):
    """Each substitution of a ``tools/tile_variants.py`` variant finds its
    text exactly once in its header (``csrc/matmul_mma.cuh`` or
    ``csrc/matmul_wgmma.cuh``) and changes it (but ``base``), so an edit of
    a header that a variant no longer matches fails here rather than on the
    card."""
    text = (ROOT / tile_variants.header_of(name)).read_text()
    out = tile_variants.apply(name, text)
    assert (out == text) == (name == "base")
