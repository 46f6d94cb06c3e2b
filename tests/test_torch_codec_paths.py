"""K1 and K2 as the model launches them, on the CPU.

* ``takum_codec.codec_plan`` (the vectorised, persistent launch of K1 and
  K2) covers every element exactly once, for odd counts and every 16-byte
  misalignment of either pointer, with every vector access aligned on both
  sides and inside one row; the kernels' loops are emulated index by index.
* Through a monkeypatched C entry, each wrapper hands the kernel the plan,
  and ``takum_encode_into`` its pair and pitch, ``takum_decode_rows`` its row
  index (int32 or int64, with its width), scale and output dtype.
* The plain ``takum_encode_into`` (the model's KV append), from bf16 and f32
  sources, equals ``repro.models.transformer._encode_cache`` of the same
  numpy-seeded input placed at the slot, bit for bit (NaN as NaN), at a
  prefill slot range and a mid-cache decode slot, leaving the bytes around
  the slots untouched.
* The plain ``takum_decode_rows`` (the model's embedding rows), over
  repeated and out-of-order ids, equals ``repro.kernels.ops.decode`` (its
  Pallas kernel in interpret mode) of the same rows, scaled and cast.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops
from repro_torch.kernels import takum_codec as tc
from repro_torch.kernels.takum_codec import THREADS, codec_plan
from repro_torch.quant import blockscale

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8")
#: (source, destination) element sizes of K1 (codes -> f32 / bf16) and K2
SIZES = ((1, 4), (1, 2), (2, 4), (2, 2), (4, 1), (4, 2), (2, 1))


def _emulate(plan, n, run=None):
    """Elements each kernel thread writes (the loops of decode_kernel and
    encode_kernel), counted per element."""
    hits = np.zeros(n, np.int64)
    starts = []
    stride = plan.grid * THREADS
    for tid in range(min(stride, n + THREADS)):
        for j in range(tid, plan.head + plan.tail, stride):
            hits[j if j < plan.head else n - plan.tail + (j - plan.head)] += 1
        if plan.vec > 1:
            units = (n - plan.head - plan.tail) // plan.vec
            for u in range(tid, units, stride):
                i = plan.head + u * plan.vec
                hits[i:i + plan.vec] += 1
                starts.append(i)
    return hits, starts


@pytest.mark.parametrize("si,so", SIZES)
def test_codec_plan_covers_each_element_once(si, so):
    """Every misalignment of either pointer, odd n: each element once, each
    vector access aligned on both sides, the vector path taken wherever
    the two pointers can be aligned together."""
    vec = 16 // min(si, so)
    for n in (1, 3, vec - 1, vec, vec + 1, 2 * vec + 3, 4095, 100_003):
        for a in range(0, 16, si):
            for b in range(0, 16, so):
                src, dst = 1 << 20 | a, 1 << 21 | b
                plan = codec_plan(n, src, dst, si, so, sms=4, blocks_per_sm=2)
                assert 1 <= plan.grid <= 8
                heads = [h for h in range(vec)
                         if (src + h * si) % 16 == 0 and (dst + h * so) % 16 == 0]
                if plan.vec == 1:
                    assert (plan.head, plan.tail) == (n, 0)
                    assert not heads or heads[0] >= n
                else:
                    assert plan.vec == vec and plan.head < vec and plan.tail < vec
                    assert (n - plan.head - plan.tail) % vec == 0
                    assert (src + plan.head * si) % 16 == 0 and (dst + plan.head * so) % 16 == 0
                if n <= 4095:
                    hits, starts = _emulate(plan, n)
                    assert (hits == 1).all(), (n, a, b, plan)
                    assert all((src + i * si) % 16 == 0 and (dst + i * so) % 16 == 0
                               for i in starts)


@pytest.mark.parametrize("si,so", SIZES)
def test_codec_plan_keeps_vectors_inside_rows(si, so):
    """Rows at a pitch (the KV slots, the embedding rows): vectors only from
    aligned row starts with whole vectors per row and whole-chunk pitches,
    else the scalar loop; every element once either way; a pair launch
    takes the vector path only where all its pointers align together."""
    vec = 16 // min(si, so)
    for run, rows in ((vec * 4, 3), (vec * 4 + 1, 3), (1024, 4), (vec, 1)):
        n = run * rows
        for pitch in (run, run + 16, run + 1, 2 * run):
            for a, b in ((0, 0), (0, 16 - so), (si, 0)):
                plan = codec_plan(n, 4096 + a, 8192 + b, si, so, run=run, dst_pitch=pitch)
                ok = (a == 0 and b == 0 and run % vec == 0 and pitch * so % 16 == 0)
                assert (plan.vec > 1) == ok, (run, pitch, a, b, plan)
                if ok:
                    assert plan.head == plan.tail == 0
                hits, starts = _emulate(plan, n)
                assert (hits == 1).all()
                assert all(i % run + plan.vec <= run for i in starts)
    pair = codec_plan(4096, [4096 + si, 4160 + si], [8192 + so, 8256 + so], si, so)
    assert pair == codec_plan(4096, 4096 + si, 8192 + so, si, so) and pair.vec > 1
    assert codec_plan(4096, [4096, 4096 + 64], [8192, 8192 + 4], si, so).vec == 1


def test_codec_plan_mx_warp_runs_and_grid():
    """mx: one warp per run of 32 groups, cut per row, shorter runs (16, 8,
    4 groups) where 32 leave fewer runs than the warps the card holds at
    once (sms * blocks_per_sm blocks of 8 warps); the persistent grid is
    capped at sms * blocks_per_sm."""
    CP = tc.CodecPlan
    assert codec_plan(8192 * 128, 0, 0, 4, 1, mx=True) == CP(1024, 4, 0, 0)  # 8192 runs
    assert codec_plan(8192 * 128, 0, 0, 4, 1, mx=True, blocks_per_sm=4) == CP(528, 4, 0, 0)
    assert codec_plan(8192 * 128, 0, 0, 4, 1, mx=True, sms=16, blocks_per_sm=4) == \
        CP(64, 32, 0, 0)  # 1024 runs of 32 fill 512 warps
    assert codec_plan(32 * 128, 0, 0, 2, 1, mx=True) == CP(4, 4, 0, 0)  # the decode step's K
    assert codec_plan(4 * 4096, 0, 0, 1, 2, run=4096, mx=True) == CP(16, 4, 0, 0)
    assert codec_plan(4 * 96, 0, 0, 1, 4, run=96, mx=True) == CP(1, 4, 0, 0)  # 4 short runs
    assert codec_plan(1024 * 4096, 0, 0, 1, 4, run=4096, mx=True, blocks_per_sm=5) == \
        CP(660, 16, 0, 0)
    big = codec_plan(4096 * 14336, 0, 0, 4, 1, mx=True, sms=132, blocks_per_sm=8)
    assert big == CP(132 * 8, 32, 0, 0)
    flat = codec_plan(4096 * 14336, 0, 0, 4, 1, sms=132, blocks_per_sm=6)
    assert flat.grid == 132 * 6 and flat.vec == 16


@pytest.fixture
def fake_entry(monkeypatch):
    """The C entries replaced by a recorder; CPU tensors take the launch path."""
    calls = []

    def entry(name):
        def run(*args):
            calls.append((name, args))
            return 0
        return run

    monkeypatch.setattr(tc, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(tc, "stream_of", lambda t: 0)
    monkeypatch.setattr(tc, "_occupancy", lambda *a: (132, 6))
    monkeypatch.setattr(tc, "table_ptrs", lambda wf, impl, op, dev: (0,) if op == "decode"
                        else (0, 0))
    monkeypatch.setattr(tc._build, "entry", entry)
    return calls


def test_wrappers_pass_the_plan_pairs_and_pitch(fake_entry):
    B, S, Kv, hd, pos = 4, 20, 8, 128, 9
    k = torch.zeros((B * Kv, hd))
    v = torch.zeros((B * Kv, hd))
    cache = torch.zeros((2, B, S * Kv * hd), dtype=torch.uint8)
    slots = [cache[i][:, pos * Kv * hd:(pos + 1) * Kv * hd] for i in range(2)]
    tc.takum_encode_into((k, v), slots, "t8", "lut")
    name, args = fake_entry[-1]
    plan = codec_plan(B * Kv * hd, [k.data_ptr(), v.data_ptr()],
                      [s.data_ptr() for s in slots], 4, 1, run=Kv * hd, dst_pitch=S * Kv * hd,
                      sms=132, blocks_per_sm=6)
    assert name == "repro_encode"
    assert args[:4] == (k.data_ptr(), v.data_ptr(), slots[0].data_ptr(), slots[1].data_ptr())
    assert args[4:9] == (2, B * Kv * hd, Kv * hd, S * Kv * hd, 0)
    assert args[9:11] == (wire_format("t8").code, 1)
    assert args[13:17] == (plan.grid, plan.vec, plan.head, plan.tail) and plan.vec == 16
    assert tc.takum_encode_into.launches["lut"] >= 1

    # a bf16 source into an mx cache: pitch in payload bytes, dtype 1
    feat = blockscale.payload_len(hd)
    mcache = torch.zeros((B, S * Kv * feat), dtype=torch.uint8)
    mslot = mcache[:, pos * Kv * feat:(pos + 2) * Kv * feat]
    kb = torch.zeros((B * 2 * Kv, hd), dtype=torch.bfloat16)
    tc.takum_encode_into(kb, mslot, "mxe4m3")
    name, args = fake_entry[-1]
    assert args[4:9] == (1, B * 2 * Kv * hd, 2 * Kv * feat, S * Kv * feat, 1)
    assert args[13:17] == tuple(codec_plan(kb.numel(), 0, 0, 2, 1, mx=True, sms=132,
                                           blocks_per_sm=6).__dict__.values())

    # the embedding rows: row index, rows, columns, pitch, table rows, scale, bf16 out
    V, d = 300, 256
    table = torch.zeros((V, d), dtype=torch.uint16)
    rows = torch.tensor([[5, 2, 5, 299]])
    scale = torch.tensor(0.25)
    out = tc.takum_decode_rows(table, rows, "t16", scale=scale, out_dtype=torch.bfloat16)
    name, args = fake_entry[-1]
    assert name == "repro_decode" and out.shape == (1, 4, d) and out.dtype == torch.bfloat16
    assert args[1] == rows.data_ptr() and args[2] == out.data_ptr()
    assert args[3:10] == (4, d, d, V, scale.data_ptr(), 1, wire_format("t16").code)
    plan = codec_plan(4 * d, table.data_ptr(), out.data_ptr(), 2, 2, run=d, src_pitch=d,
                      sms=132, blocks_per_sm=6)
    assert args[12:16] == (plan.grid, plan.vec, plan.head, plan.tail) and plan.vec == 8
    assert args[16] == 8  # the width of one row id
    tc.takum_decode_rows(table, rows.to(torch.int32), "t16")
    assert fake_entry[-1][1][16] == 4  # int32 ids are read at their own width, no cast

    # K1 / K2 over one contiguous range
    x = torch.zeros((8, 50))
    bits = tc.takum_encode_2d(x, "e4m3")
    name, args = fake_entry[-1]
    plan = codec_plan(400, x.data_ptr(), bits.data_ptr(), 4, 1, sms=132, blocks_per_sm=6)
    assert name == "repro_encode" and args[4:9] == (1, 400, 400, 400, 0)
    assert args[13:17] == (plan.grid, plan.vec, plan.head, plan.tail)
    y = tc.takum_decode_2d(bits, "e4m3")
    name, args = fake_entry[-1]
    plan = codec_plan(400, bits.data_ptr(), y.data_ptr(), 1, 4, sms=132, blocks_per_sm=6)
    assert name == "repro_decode" and args[1] == 0 and args[3:9] == (1, 400, 400, 1, 0, 0)
    assert args[12:17] == (plan.grid, plan.vec, plan.head, plan.tail, 0)


def test_wrappers_refuse_what_the_launch_cannot_take():
    cache = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):  # 3 pairs
        tc.takum_encode_into([torch.zeros(4, 8)] * 3, [cache[:, :8]] * 3, "t8")
    with pytest.raises(ValueError):  # f16 source
        tc.takum_encode_into(torch.zeros(4, 8, dtype=torch.float16), cache[:, :8], "t8")
    with pytest.raises(ValueError):  # wrong element count
        tc.takum_encode_into(torch.zeros(4, 8), cache[:, :9], "t8")
    with pytest.raises(ValueError):  # wrong storage dtype
        tc.takum_encode_into(torch.zeros(4, 8), cache[:, :8].view(torch.int8), "t8")
    with pytest.raises(ValueError):  # mx source not whole blocks
        tc.takum_encode_into(torch.zeros(4, 40), torch.zeros(4, 66, dtype=torch.uint8), "mxt8")
    with pytest.raises(TypeError):  # ids are int32 or int64
        tc.takum_decode_rows(cache, torch.tensor([1], dtype=torch.int16), "t8")
    with pytest.raises(ValueError):
        tc.takum_decode_rows(cache, torch.tensor([1]), "t8", out_dtype=torch.float16)


def _rng_input(shape, seed):
    """numpy f32 with the specials an append meets: NaN, Inf, a subnormal,
    zeros of both signs, values past every format's range."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 ** rng.integers(-20, 20, shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[:7] = [np.nan, np.inf, -np.inf, 1e-40, -0.0, 0.0, 3e38]
    return x


def _bits_np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8)


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_into_matches_repro_encode_cache(fmt):
    wf = wire_format(fmt)
    B, L, Kv, hd = 2, 12, 2, 64
    feat = blockscale.payload_len(hd) if wf.is_block_scaled else hd
    jcfg = types.SimpleNamespace(quant=types.SimpleNamespace(kv_cache=fmt))
    for start, S in ((0, 5), (7, 1)):  # a prefill range, a decode slot mid-cache
        for src_dtype in (torch.float32, torch.bfloat16):
            x = _rng_input((B, S, Kv, hd), 100 * start + S)
            src = torch.from_numpy(x).to(src_dtype)
            jx = jnp.asarray(src.float().numpy()).astype(jnp.bfloat16 if src_dtype ==
                                                         torch.bfloat16 else jnp.float32)
            enc = _bits_np(JT._encode_cache(jcfg, jx)).reshape(B, S, Kv * feat)
            canary = np.full((B, L, Kv * feat), 0x5A, enc.dtype)
            want = canary.copy()
            want[:, start:start + S] = enc
            cache = torch.from_numpy(canary.view(np.uint8).copy()).view(wf.storage)
            cache = cache.view(B, L * Kv * feat)
            slots = cache[:, start * Kv * feat:(start + S) * Kv * feat]
            ops.encode_into(src.reshape(B * S * Kv, hd), slots, fmt)
            got = cache.view(torch.uint8).numpy().view(enc.dtype).reshape(B, L, Kv * feat)
            if fmt == "bf16":  # NaN as NaN: the two frameworks' NaN payloads may differ
                gf = (got.astype(np.uint32) << 16).view(np.float32)
                wf32 = (want.astype(np.uint32) << 16).view(np.float32)
                np.testing.assert_array_equal(gf, wf32)
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_rows_matches_repro_decode(fmt):
    wf = wire_format(fmt)
    V, C = 40, 96
    rng = np.random.default_rng(7)
    if wf.is_block_scaled:
        bits = rng.integers(0, 256, (V, blockscale.payload_len(C))).astype(np.uint8)
    else:
        bits = rng.integers(0, 1 << wf.nbits, (V, C)).astype(
            np.uint8 if wf.nbits == 8 else np.uint16)
    ids = np.array([[3, 39, 3, 0], [17, 17, 2, 38]], np.int64)
    scale = None if wf.is_block_scaled else np.float32(2.0 ** -5)
    ref = np.asarray(jops.decode(jnp.asarray(bits[ids.reshape(-1)]), fmt)).reshape(2, 4, C)
    if scale is not None:
        with np.errstate(invalid="ignore"):  # NaN codes times the scale
            ref = ref * scale
    tbits = torch.from_numpy(bits.view(np.int16) if wf.nbits == 16 and not wf.is_block_scaled
                             else bits).view(wf.storage)
    tscale = None if scale is None else torch.tensor(float(scale))
    for out_dtype, jdt in ((torch.float32, np.float32), (torch.bfloat16, jnp.bfloat16)):
        want = ref.astype(jdt).astype(np.float32)  # numpy's RNE cast (ml_dtypes for bf16)
        for impl in (("bits", "lut") if wf.supports_lut_decode else ("bits",)):
            got = ops.decode_rows(tbits, torch.from_numpy(ids), fmt, impl, tscale, out_dtype)
            assert got.shape == (2, 4, C) and got.dtype == out_dtype
            np.testing.assert_array_equal(got.float().numpy(), want)
