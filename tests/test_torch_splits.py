"""The split plans of K3 at small M and of K6, on the CPU.

``matvec_plan`` (``kernels/takum_matmul.py``) cuts K for K3's split-K
matvec at M <= 16 and its transposed launch; ``attention_plan``
(``kernels/takum_attention.py``) cuts the keys for K6's split S.  Both are
plain Python computed on the host: these tests hold that every k (every
key) is covered exactly once in ascending contiguous chunks of whole stages
(tiles), that the plans never see the codec (so bits and lut add in one
order), that the grid holds at least two blocks per SM of the H100 at every
decode shape of llama3-8b, and that the workspaces have the sizes the
kernels write.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import wire_format
from repro_torch.kernels import takum_matmul as tm
from repro_torch.kernels.common import TARGET_BLOCKS
from repro_torch.kernels.takum_attention import KV_TILE, attention_plan
from repro_torch.kernels.takum_matmul import MATVEC_BN, matvec_plan

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8")
#: llama3-8b's linears at the decode step, (K, N): wq and the attention
#: output, wk and wv, wi and wg, the down projection, the head
DECODE_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))
#: K6 at serving: B = 4, Hkv = 8, the lengths of a 256-token prompt's decode
SERVING_LENGTHS = (257, 270, 288)


def _elem_bytes(fmt) -> int:
    wf = wire_format(fmt)
    return 1 if wf.is_block_scaled else wf.nbits // 8


def _chunks(start: int, stop: int, chunk: int, splits: int) -> list[range]:
    return [range(start + s * chunk, min(start + (s + 1) * chunk, stop)) for s in range(splits)]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("K", (1, 63, 64, 1000, 4096, 14336, 100_000))
def test_matvec_plan_covers_each_k_once_in_stage_multiples(fmt, K):
    for M in (1, 4, 5, 16):
        for N in (1, 100, 1024, 128256):
            plan = matvec_plan(M, N, K, fmt)
            ks = plan.rows_per_stage
            assert ks * _elem_bytes(fmt) == 64  # a stored row's stage span: four 16-byte chunks
            assert plan.chunk % ks == 0 and plan.chunk >= ks
            assert plan.chunk * (4 if M <= 4 else 16) <= tm.MATVEC_X_FLOATS
            parts = _chunks(0, K, plan.chunk, plan.splits)
            assert all(len(p) > 0 for p in parts)
            assert [k for p in parts for k in p] == list(range(K))
            assert plan.n_tiles == math.ceil(N / MATVEC_BN)


@pytest.mark.parametrize("K,N", DECODE_SHAPES)
def test_matvec_plan_fills_the_card_at_the_decode_shapes(K, N):
    for fmt in FMTS:
        for M in (1, 4, 16):
            plan = matvec_plan(M, N, K, fmt)
            assert plan.n_tiles * plan.splits >= TARGET_BLOCKS >= 2 * 132, (fmt, M, plan)


def test_matvec_plan_depends_on_the_width_alone():
    """No codec argument, and formats of one element width share a plan,
    so every codec of a format adds in one order."""
    for K, N in DECODE_SHAPES + ((1000, 777), (130, 100)):
        for M in (1, 4, 5, 16):
            eight = {matvec_plan(M, N, K, f) for f in ("t8", "e4m3", "e5m2", "mxe4m3", "mxt8")}
            sixteen = {matvec_plan(M, N, K, f) for f in ("t16", "bf16")}
            assert len(eight) == 1 and len(sixteen) == 1


@pytest.mark.parametrize("M", (0, 17, 1024))
def test_matvec_plan_refuses_m_outside_the_matvec(M):
    with pytest.raises(ValueError, match="matvec"):
        matvec_plan(M, 128, 128, "t8")


def test_matvec_workspace_shape():
    plan = matvec_plan(4, 14336, 4096, "t8")
    assert plan.workspace_shape(4, 14336) == (plan.splits, 4, 14336)
    assert plan.splits == 4 and plan.chunk == 1024


@pytest.mark.parametrize("fmt,transposed", [("t8", False), ("t16", False), ("mxt8", False),
                                            ("t8", True), ("bf16", True)])
def test_k3_wrapper_passes_one_plan_for_both_codecs(monkeypatch, fmt, transposed):
    """K3's wrapper (and the transposed launch) hands the C entry the plan's
    chunk and a workspace of the plan's size, the same for bits and lut; at
    M > 16 neither (the tiled loop)."""
    calls = []

    def fake_entry(name):
        def run(*args):
            calls.append((name, args))
            return 0
        return run

    monkeypatch.setattr(tm, "_check_device", lambda *a: False)
    monkeypatch.setattr(tm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tm._build, "entry", fake_entry)
    wf = wire_format(fmt)
    K, N = 1000, 100
    w = torch.zeros((N, K) if transposed else (K, N), dtype=wf.storage)
    if wf.is_block_scaled:
        w = torch.zeros((K, 4 * 33), dtype=torch.uint8)
    for M in (3, 37):
        x = torch.zeros((M, K), dtype=torch.float32)
        for impl in ("bits", "lut"):
            if transposed:
                tm.takum_matmul_t(x, w, fmt, decode_impl=impl)
            else:
                tm.takum_matmul(x, w, fmt, n=N, decode_impl=impl)
    chunks = [args[7] for _, args in calls]
    ws = [args[3] for _, args in calls]
    plan = matvec_plan(3, N, K, fmt)
    assert chunks == [plan.chunk, plan.chunk, 0, 0]
    assert ws[2:] == [0, 0] and all(ws[:2])
    assert {name for name, _ in calls} == {"repro_matmul_wt" if transposed else "repro_matmul"}


@pytest.mark.parametrize("length", (1, 31, 32, 33, 200, 257, 288, 4096, 70_000))
@pytest.mark.parametrize("window", (0, 1, 16, 64, 4096))
def test_attention_plan_covers_each_key_once_in_tiles(length, window):
    for B, Hkv in ((4, 8), (1, 1), (2, 2), (4, 1)):
        plan = attention_plan(B, Hkv, length, window)
        lo = max(0, length - window) if window else 0
        assert plan.begin % KV_TILE == 0 and lo - KV_TILE < plan.begin <= lo
        assert plan.chunk % KV_TILE == 0 and plan.chunk >= KV_TILE
        parts = _chunks(plan.begin, length, plan.chunk, plan.splits)
        assert [k for p in parts for k in p] == list(range(plan.begin, length))
        # every chunk holds a valid key: only the first reaches below lo
        assert all(p.stop > lo and len(p) > 0 for p in parts)
        assert plan.splits <= 65535


@pytest.mark.parametrize("length", SERVING_LENGTHS)
def test_attention_plan_fills_the_card_at_serving(length):
    B, Hkv = 4, 8
    plan = attention_plan(B, Hkv, length)
    assert B * Hkv * plan.splits >= TARGET_BLOCKS
    assert plan.chunk == KV_TILE and plan.splits == 9


def test_attention_workspace_numel():
    """[B, Hkv, splits, g, d + 2]: each query row's acc[d], max and denominator."""
    plan = attention_plan(4, 8, 288)
    assert plan.workspace_numel(4, 32, 8, 128) == 4 * 8 * 9 * 4 * 130
    plan = attention_plan(2, 1, 100, window=16)  # keys 64..99: lo = 84 lies in the first tile
    assert (plan.begin, plan.splits) == (64, 2)
    assert plan.workspace_numel(2, 48, 1, 80) == 2 * 1 * 2 * 48 * 82
