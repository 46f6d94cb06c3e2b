"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is present
(this file imports neither JAX nor ``repro``, so it runs on a machine that
has only PyTorch):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Codecs must match bit for bit (NaN matches NaN), the mx containers
included.  K3 is held to 4e-6 * (|x| @ |w|), the limit of chip_smoke.py
(which reads a t16 kernel with bf16- or TF32-rounded operands above it), K6
to 1e-5 * max|v|.  Each kernel has a "bits" and a "lut" instantiation (the
codec inside it): the lut codecs must also equal the bits kernels bit for
bit, and K3/K6 under lut must equal K3/K6 under bits bit for bit (the same
decoded values summed in the same order).  K4 (the dual matmul) is held to
K3's limit of |decode(x)| @ |w|, and every fused ``out_fmt`` output of K3,
K4 and K6 must equal K2's encode of the same kernel's unfused output bit
for bit.  K5's backward, the transposed K3, is held to K3's limit of
|g| @ |decode(w)|.T and must equal K3 over a transposed copy of the bits bit
for bit; one autograd step launches one K3 and one transposed K3.  K3 at
M <= 16 (the split-K matvec) and K6 (split S with an ordered combine) must
also give the same bits on a second launch.  The tensor-core tile (K3 with
bf16 x above M = 16, K4 above M = 16) is held to the same limit at M = 17,
37 and 1024, with specials, NaN bits past the operands' ends, and every
code of every format carried exactly; K4 at M <= 16 runs the matvec.  The
wgmma tile (K3 with f32 x above M = 16, and the transposed K3) likewise, at
ragged shapes, fused, all-positive at the prefill's depths against the f64
sum, and with the blocks its vote sends to the FMA tile equal to that loop.
K1 and K2 (the vectorised, persistent codec loops) also run at odd element
counts up to 2^20 + 3, on views offset by 1-15 bytes, into strided
destinations between canary bytes, as one launch for a pair equal to two
single ones, from bf16 sources equal to their f32 widening, and as the
gathered, scaled and cast embedding rows, all bit for bit; the rows of
int32 ids equal those of int64 ids, and ids off the table read what the
plain version reads (wrapped, then clamped).  The training slice's SR
encoders give the same codes on the card as on the host.  Every linear
t8 / t16 family of the executable ISA (``core/isa.py``: decode and encode
through K1 / K2) equals its plain path bit for bit, and the t32 decode (the
plain codec on either device) gives the host's bits on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops, ref
from repro_torch.kernels import takum_matmul as takum_matmul_mod
from repro_torch.kernels.mx_cases import mx_all_codes, mx_sweep
from repro_torch.kernels.takum_attention import (attention_plan, decode_attention_plain,
                                                 takum_decode_attention)
from repro_torch.kernels.takum_codec import (decode_2d_plain, decode_rows_plain,
                                             encode_2d_plain, encode_into_plain, takum_decode_2d,
                                             takum_decode_rows, takum_encode_2d,
                                             takum_encode_into)
from repro_torch.kernels.takum_matmul import (takum_dual_matmul, takum_dual_matmul_plain,
                                              takum_matmul, takum_matmul_ad, takum_matmul_plain,
                                              takum_matmul_t, takum_matmul_t_plain, matvec_plan)
from repro_torch.quant import blockscale

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")
MX_FMTS = ("mxe4m3", "mxe5m2", "mxt8")
IMPLS = ("bits", "lut")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _all_codes(wf):
    c = torch.arange(1 << wf.nbits, dtype=torch.int64)
    if wf.nbits == 16:
        c = torch.where(c >= 1 << 15, c - (1 << 16), c)
    return c.to(wf.signed_storage).view(wf.storage).reshape(-1, 64)


def _same_f32(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_codec_kernels_bit_exact(cuda, fmt):
    wf = wire_format(fmt)
    codes = _all_codes(wf)
    assert _same_f32(takum_decode_2d(codes.to(cuda), fmt).cpu(), takum_decode_2d(codes, fmt))
    x = _rand((300, 70), 12, 4.0)
    x[0, :4] = torch.tensor([float("inf"), float("nan"), 1e-40, -0.0])
    got = takum_encode_2d(x.to(cuda), fmt).cpu()
    assert torch.equal(got.view(wf.signed_storage), takum_encode_2d(x, fmt).view(wf.signed_storage))
    # 2 M elements: more than the kernels' capped grid covers in one pass
    x = _rand((2048, 1024), 18, 0.05)
    bits = takum_encode_2d(x, fmt)
    got = takum_encode_2d(x.to(cuda), fmt).cpu()
    assert torch.equal(got.view(wf.signed_storage), bits.view(wf.signed_storage))
    assert _same_f32(takum_decode_2d(bits.to(cuda), fmt).cpu(), takum_decode_2d(bits, fmt))


#: element counts of the codec checks: below, at and past one vector, and a
#: range that needs many trips of the persistent grid (mx: groups)
CODEC_NS = (1, 15, 17, 4095, 2 ** 20 + 3)


def _impls(fmt, op):
    wf = wire_format(fmt)
    ok = wf.supports_lut_decode if op == "decode" else wf.supports_lut_encode
    return IMPLS if ok else ("bits",)


def _f32_inputs(n, seed, device=None):
    """n f32 values: normals over 80 binades, and a quarter raw bit patterns
    (NaN, Inf, subnormals)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * torch.exp2(torch.randint(-40, 40, (n,), generator=g).float())
    raw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g).to(torch.int32)
    x = torch.where(torch.rand(n, generator=g) < 0.25, raw.view(torch.float32), x)
    return x.to(device)


def _codes(wf, n, seed, device=None):
    g = torch.Generator().manual_seed(seed)
    return wf.pack(torch.randint(0, 1 << wf.nbits, (n,), generator=g)).to(device)


def _same_bits(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_codec_kernels_bit_exact_at_odd_counts(cuda, fmt):
    """K1 and K2 of every codec at n in CODEC_NS (mx: n groups) equal their
    plain versions on the same card bit for bit."""
    wf = wire_format(fmt)
    for n in CODEC_NS:
        if wf.is_block_scaled:
            bits = torch.randint(0, 256, (1, 33 * n), generator=torch.Generator().manual_seed(n),
                                 dtype=torch.uint8).to(cuda)
            x = _f32_inputs(32 * n, n + 1, cuda).reshape(1, -1)
        else:
            bits, x = _codes(wf, n, n, cuda).reshape(1, n), _f32_inputs(n, n + 1, cuda).reshape(1, n)
        for impl in _impls(fmt, "decode"):
            assert _same_f32(takum_decode_2d(bits, fmt, impl), decode_2d_plain(bits, fmt, impl)), \
                (n, impl)
        for impl in _impls(fmt, "encode"):
            assert _same_bits(takum_encode_2d(x, fmt, impl), encode_2d_plain(x, fmt, impl)), (n, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_codec_kernels_on_views_offset_by_bytes(cuda, fmt):
    """Operands that start 1-15 bytes past a 16-byte boundary (as far as
    the element size allows): K1's input and table rows, K2's source and a
    takum_encode_into destination, each against its plain version."""
    wf = wire_format(fmt)
    esz = wf.nbits // 8
    R, C = 3, 96  # mx: three groups per row
    L = blockscale.payload_len(C) if wf.is_block_scaled else C
    for off in range(1, 16):
        x = _f32_inputs(R * C + 4, off, cuda)[off % 4:][:R * C].reshape(R, C)  # f32: 4-byte steps
        for impl in _impls(fmt, "encode"):
            assert _same_bits(takum_encode_2d(x, fmt, impl), encode_2d_plain(x, fmt, impl)), (off, impl)
        if off % esz:
            continue
        buf = _codes(wf, R * L + 16, off, cuda) if not wf.is_block_scaled else \
            torch.randint(0, 256, (R * L + 16,), dtype=torch.uint8).to(cuda)
        bits = buf[off // esz:][:R * L].view(R, L)
        rows = torch.tensor([2, 0, 2, 1], device=cuda)
        for impl in _impls(fmt, "decode"):
            assert _same_f32(takum_decode_2d(bits, fmt, impl), decode_2d_plain(bits, fmt, impl))
            assert _same_f32(takum_decode_rows(bits, rows, fmt, impl),
                             decode_rows_plain(bits, rows, fmt, impl)), (off, impl)
        for impl in _impls(fmt, "encode"):
            got = torch.zeros_like(buf)
            want = torch.zeros_like(buf)
            takum_encode_into(x, got[off // esz:][:R * L].view(R, L), fmt, impl)
            encode_into_plain(x, want[off // esz:][:R * L].view(R, L), fmt, impl)
            assert _same_bits(got, want), (off, impl)


def _cache_slots(wf, B, S, Kv, hd, start, n, device):
    """A [B, S * Kv * feat] cache of canary bytes 0xA5 and the view of its
    positions start .. start + n, as the model's KV append writes them."""
    feat = blockscale.payload_len(hd) if wf.is_block_scaled else hd
    cache = torch.full((B, S * Kv * feat * wf.nbits // 8), 0xA5, dtype=torch.uint8, device=device)
    cache = cache.view(wf.storage)
    return cache, cache[:, start * Kv * feat:(start + n) * Kv * feat]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_encode_into_strided_slots_pairs_and_bf16(cuda, fmt):
    """takum_encode_into at a prefill slot range (n = 5 of S = 13) and a
    decode slot (n = 1 at position 7): the slots equal the plain version's,
    every byte around them keeps its canary; the pair launch equals two
    single launches; a bf16 source equals its f32 widening."""
    wf = wire_format(fmt)
    B, S, Kv, hd = 3, 13, 2, 64
    for start, n in ((0, 5), (7, 1)):
        k = _f32_inputs(B * n * Kv * hd, start + 30, cuda).reshape(B * n * Kv, hd)
        v = (_rand((B * n * Kv, hd), start + 31) * 3).to(cuda)
        for impl in _impls(fmt, "encode"):
            ck, dk = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            cv, dv = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            takum_encode_into((k, v), (dk, dv), fmt, impl)
            for c, src in ((ck, k), (cv, v)):
                want, slots = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
                encode_into_plain(src, slots, fmt, impl)
                assert _same_bits(c, want), (start, impl)
            single_k, sk = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            single_v, sv = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            takum_encode_into(k, sk, fmt, impl)
            takum_encode_into(v, sv, fmt, impl)
            assert _same_bits(ck, single_k) and _same_bits(cv, single_v), (start, impl)
            kb = k.to(torch.bfloat16)
            ob, db = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            of, df = _cache_slots(wf, B, S, Kv, hd, start, n, cuda)
            takum_encode_into(kb, db, fmt, impl)
            takum_encode_into(kb.float(), df, fmt, impl)
            assert _same_bits(ob, of), (start, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_decode_rows_equals_gather_decode_scale_cast(cuda, fmt):
    """K1 over gathered rows (repeated, out of order, a [2, 5] id tensor),
    scaled by a pow2 and cast, equals the gather, K1, the multiply and the
    cast on the card, bit for bit (NaN as NaN)."""
    wf = wire_format(fmt)
    V, C = 50, 256
    L = blockscale.payload_len(C) if wf.is_block_scaled else C
    table = (torch.randint(0, 256, (V, L), dtype=torch.uint8) if wf.is_block_scaled
             else _codes(wf, V * L, 60).reshape(V, L)).to(cuda)
    rows = torch.tensor([[7, 3, 7, 49, 0], [1, 1, 2, 48, 7]], device=cuda)
    scale = None if wf.is_block_scaled else torch.tensor(2.0 ** -3, device=cuda)
    for impl in _impls(fmt, "decode"):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = takum_decode_rows(table, rows, fmt, impl, scale, out_dtype)
            g = table.view(wf.signed_storage)[rows.reshape(-1)].view(table.dtype)
            want = takum_decode_2d(g, fmt, impl).reshape(2, 5, C)
            want = (want if scale is None else want * scale).to(out_dtype)
            assert got.dtype == out_dtype and got.shape == (2, 5, C)
            assert _same_f32(got.float(), want.float()), (impl, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_decode_rows_int32_and_off_table_ids(cuda, fmt):
    """int32 ids give K1 the rows int64 ids give, and ids off the table
    ([-V, -1, V, V + 3, -V - 7, 2V]) read what the plain version reads, bit
    for bit; a launch after them still runs (the context survived)."""
    wf = wire_format(fmt)
    V, C = 50, 256
    L = blockscale.payload_len(C) if wf.is_block_scaled else C
    table = (torch.randint(0, 256, (V, L), dtype=torch.uint8) if wf.is_block_scaled
             else _codes(wf, V * L, 61).reshape(V, L)).to(cuda)
    rows = torch.tensor([[-V, -1, 5, V, V + 3], [-V - 7, 0, V - 1, -2, 2 * V]], device=cuda)
    for impl in _impls(fmt, "decode"):
        want = decode_rows_plain(table, rows, fmt, impl)
        for dt in (torch.int32, torch.int64):
            got = takum_decode_rows(table, rows.to(dt), fmt, impl)
            assert _same_f32(got, want), (impl, dt)
    torch.cuda.synchronize()
    inside = rows[:, 2:3].contiguous()
    assert _same_f32(takum_decode_rows(table, inside, fmt), decode_rows_plain(table, inside, fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["t8", "t16", "e4m3", "e5m2"])
def test_sr_encode_on_card_equals_host(cuda, fmt):
    """The SR quantize of the training slice (plain PyTorch in int64) gives
    the same scale and codes on the card as on the host, fed one set of
    draws."""
    from repro_torch.quant.qtensor import quantize

    x = _rand((300, 257), 62, 1e-3)
    x[0, :3] = torch.tensor([1e-40, -0.0, 0.0])  # a DAZ'd subnormal, both zeros
    r = torch.randint(0, 1 << 32, x.shape, generator=torch.Generator().manual_seed(63))
    host = quantize(x, fmt, scaled=True, rnd_bits=r)
    card = quantize(x.to(cuda), fmt, scaled=True, rnd_bits=r.to(cuda))
    assert torch.equal(card.scale.cpu(), host.scale)
    signed = wire_format(fmt).signed_storage
    assert torch.equal(card.bits.view(signed).cpu(), host.bits.view(signed))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_matmul_kernel_within_limit(cuda, fmt):
    w = takum_encode_2d(_rand((130, 70), 13, 0.3), fmt)
    wd = ref.codec_decode_ref(w, fmt)
    for M, dt in ((4, torch.bfloat16), (37, torch.float32), (4, torch.float32),
                  (37, torch.bfloat16)):
        x = _rand((M, 130), 14).to(dt)
        got = takum_matmul(x.to(cuda), w.to(cuda), fmt).cpu()
        want = takum_matmul_plain(x, w, fmt)
        bound = 4e-6 * (x.float().abs() @ wd.abs())
        assert ((got - want).abs() <= bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_decode_attention_kernel_masks_like_plain(cuda, fmt):
    kv = takum_encode_2d(_rand((2 * 45 * 2, 16), 15), fmt).reshape(2, 45, 2, 16)
    q = _rand((2, 4, 16), 16)
    k = kv.permute(0, 2, 1, 3)
    vmax = ref.codec_decode_ref(kv, fmt).abs().max()
    for length, window, cap in ((40, 0, 0.0), (45, 30, 0.0), (7, 0, 3.0)):
        got = takum_decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), fmt,
                                     length=length, window=window, softcap=cap).cpu()
        want = decode_attention_plain(q, k, k, fmt, length, window, cap)
        assert (got - want).abs().max() <= 1e-5 * vmax


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_codec_kernels_bit_exact(cuda, fmt):
    codes = mx_all_codes()
    assert _same_f32(takum_decode_2d(codes.to(cuda), fmt).cpu(), takum_decode_2d(codes, fmt))
    x = mx_sweep(torch.Generator().manual_seed(19), 400).reshape(-1, 64)
    assert torch.equal(takum_encode_2d(x.to(cuda), fmt).cpu(), takum_encode_2d(x, fmt))
    x = _rand((2048, 1024), 20, 0.05)  # past the capped grid
    bits = takum_encode_2d(x, fmt)
    assert torch.equal(takum_encode_2d(x.to(cuda), fmt).cpu(), bits)
    assert _same_f32(takum_decode_2d(bits.to(cuda), fmt).cpu(), takum_decode_2d(bits, fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_matmul_kernel_within_limit(cuda, fmt):
    for N in (100, 64):
        w = takum_encode_2d(blockscale.pad_block(_rand((130, N), 13, 0.3)), fmt)
        wd = ref.codec_decode_ref(w, fmt)[:, :N]
        for M, dt in ((4, torch.bfloat16), (37, torch.float32)):
            x = _rand((M, 130), 14).to(dt)
            got = takum_matmul(x.to(cuda), w.to(cuda), fmt, n=N).cpu()
            assert got.shape == (M, N)
            want = takum_matmul_plain(x, w, fmt, n=N)
            assert ((got - want).abs() <= 4e-6 * (x.float().abs() @ wd.abs())).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_decode_attention_kernel_masks_like_plain(cuda, fmt):
    for d in (16, 80, 128):
        x = blockscale.pad_block(_rand((2 * 45 * 2, d), 15))
        kv = takum_encode_2d(x, fmt).reshape(2, 45, 2, -1)
        q = _rand((2, 4, d), 16)
        k = kv.permute(0, 2, 1, 3)
        vmax = ref.codec_decode_ref(kv, fmt).abs().max()
        for length, window, cap in ((40, 0, 0.0), (45, 30, 0.0), (7, 0, 3.0)):
            got = takum_decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), fmt,
                                         length=length, window=window, softcap=cap).cpu()
            want = decode_attention_plain(q, k, k, fmt, length, window, cap)
            assert (got - want).abs().max() <= 1e-5 * vmax


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches(cuda):
    """One launch of each op under each impl counts one on each kernel."""
    ops.reset_launch_counts()
    x = _rand((4, 32), 17).to(cuda)
    for impl in IMPLS:
        bits = ops.encode(x, "t8", encode_impl=impl)
        ops.decode(bits, "t8", decode_impl=impl)
        ops.encode_into((x, x), (torch.empty_like(bits), torch.empty_like(bits)), "t8",
                        encode_impl=impl)
        ops.decode_rows(bits, torch.tensor([3, 0, 3], device=cuda), "t8", decode_impl=impl)
        ops.matmul(x, bits.t().contiguous(), "t8", decode_impl=impl)
        ops.dual_matmul(bits, bits.t().contiguous(), "t8", decode_impl=impl)
        kv = bits.reshape(1, 1, 4, 32)
        ops.decode_attention(torch.zeros(1, 2, 32, device=cuda), kv, kv, "t8", decode_impl=impl)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 1)
    ops.reset_launch_counts()


@pytest.mark.gpu
def test_launch_counters_count_mx_kernel_launches(cuda):
    ops.reset_launch_counts()
    x = _rand((4, 64), 21).to(cuda)
    payload = ops.encode(x, "mxt8")
    assert payload.shape == (4, 66)
    assert ops.decode(payload, "mxt8").shape == (4, 64)
    ops.matmul(x, ops.encode(_rand((64, 64), 22).to(cuda), "mxt8"), "mxt8")
    kv = payload.reshape(1, 1, 4, 66)
    ops.decode_attention(torch.zeros(1, 2, 64, device=cuda), kv, kv, "mxt8")
    # mxt8 takes the t8 tables by default, encode and decode
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), "takum_decode_2d[lut]": 1,
                                   "takum_encode_2d[lut]": 2, "takum_matmul[lut]": 1,
                                   "takum_decode_attention[lut]": 1}
    ops.reset_launch_counts()


def _lut_encode_ok(fmt):
    return wire_format(fmt).supports_lut_encode


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_lut_codec_kernels_bit_exact(cuda, fmt):
    """K1-lut over every code (an mx format: every element code under every
    scale byte) and K2-lut over a sweep, also past the capped grid: equal to
    the plain lut codecs and to the bits kernels.  bf16 has no encode tables."""
    wf = wire_format(fmt)
    codes = mx_all_codes() if wf.is_block_scaled else _all_codes(wf)
    got = takum_decode_2d(codes.to(cuda), fmt, "lut").cpu()
    assert _same_f32(got, takum_decode_2d(codes, fmt, "lut"))
    assert _same_f32(got, takum_decode_2d(codes.to(cuda), fmt, "bits").cpu())
    if wf.is_block_scaled:
        sweep = mx_sweep(torch.Generator().manual_seed(23), 400).reshape(-1, 64)
    else:
        sweep = _rand((300, 70), 24, 4.0)
        sweep[0, :4] = torch.tensor([float("inf"), float("nan"), 1e-40, -0.0])
    big = _rand((2048, 1024), 25, 0.05)  # past the capped grid
    sig = wf.signed_storage
    for x in (sweep, big):
        if not _lut_encode_ok(fmt):
            with pytest.raises(ValueError):
                takum_encode_2d(x.to(cuda), fmt, "lut")
            continue
        got = takum_encode_2d(x.to(cuda), fmt, "lut").cpu()
        assert torch.equal(got.view(sig), takum_encode_2d(x, fmt, "lut").view(sig))
        assert torch.equal(got.view(sig), takum_encode_2d(x.to(cuda), fmt, "bits").cpu().view(sig))
        assert _same_f32(takum_decode_2d(got.to(cuda), fmt, "lut").cpu(),
                         takum_decode_2d(got, fmt, "lut"))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_lut_matmul_kernel_equals_bits_kernel(cuda, fmt):
    mx = wire_format(fmt).is_block_scaled
    N = 100 if mx else 70
    w = _rand((130, N), 26, 0.3)
    w = takum_encode_2d(blockscale.pad_block(w) if mx else w, fmt)
    wd = ref.codec_decode_ref(w, fmt)[:, :N]
    n = N if mx else None
    for M, dt in ((4, torch.bfloat16), (37, torch.float32), (4, torch.float32),
                  (37, torch.bfloat16)):
        x = _rand((M, 130), 27).to(dt)
        got = takum_matmul(x.to(cuda), w.to(cuda), fmt, n, "lut")
        assert torch.equal(got, takum_matmul(x.to(cuda), w.to(cuda), fmt, n, "bits"))
        want = takum_matmul_plain(x, w, fmt, n, decode_impl="lut")
        assert ((got.cpu() - want).abs() <= 4e-6 * (x.float().abs() @ wd.abs())).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_lut_decode_attention_kernel_equals_bits_kernel(cuda, fmt):
    mx = wire_format(fmt).is_block_scaled
    for d in ((16, 80, 128) if mx else (16, 128)):
        x = _rand((2 * 45 * 2, d), 28)
        kv = takum_encode_2d(blockscale.pad_block(x) if mx else x, fmt).reshape(2, 45, 2, -1)
        q = _rand((2, 4, d), 29)
        k = kv.permute(0, 2, 1, 3)
        vmax = ref.codec_decode_ref(kv, fmt).abs().max()
        for length, window, cap in ((40, 0, 0.0), (45, 30, 0.0), (7, 0, 3.0)):
            args = dict(length=length, window=window, softcap=cap)
            got = takum_decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), fmt,
                                         decode_impl="lut", **args)
            bits = takum_decode_attention(q.to(cuda), k.to(cuda), k.to(cuda), fmt,
                                          decode_impl="bits", **args)
            assert torch.equal(got, bits)
            want = decode_attention_plain(q, k, k, fmt, length, window, cap, decode_impl="lut")
            assert (got.cpu() - want).abs().max() <= 1e-5 * vmax


# ---------------------------------------------------------------------------
# the producers: fused out_fmt epilogues and K4
# ---------------------------------------------------------------------------

#: (out format, encode codec): every out format with each codec it has
OUT_CASES = [(o, i) for o in FMTS + MX_FMTS for i in IMPLS
             if i == "bits" or wire_format(o).supports_lut_encode]


def _fused_cases(cuda, producer, fmt):
    """(unfused output, fused(out, impl)) of one producer at an odd shape:
    M = 37 (K3 with f32 x: the FMA tile; K4: the tensor-core tile; M = 3,
    the matvec, runs beside it), K
    not a multiple of the K tile, N = 96; K6 at S = 45, d = 64, g = 2."""
    mx = wire_format(fmt).is_block_scaled
    if producer == "K6":
        x = _rand((2 * 45 * 2, 64), 41)
        kv = takum_encode_2d(x, fmt).reshape(2, 45, 2, -1).permute(0, 2, 1, 3).to(cuda)
        q = _rand((2, 4, 64), 42).to(cuda)
        args = dict(length=40, window=30, softcap=5.0)
        return [(takum_decode_attention(q, kv, kv, fmt, **args),
                 lambda o, i: takum_decode_attention(q, kv, kv, fmt, out_fmt=o, encode_impl=i,
                                                     **args))]
    K = 96 if mx and producer == "K4" else 100
    w = takum_encode_2d(_rand((K, 96), 43, 0.1), fmt).to(cuda)
    out = []
    for M in (3, 37):
        if producer == "K3":
            x = _rand((M, K), 44).to(cuda)
            out.append((takum_matmul(x, w, fmt),
                        lambda o, i, x=x: takum_matmul(x, w, fmt, out_fmt=o, encode_impl=i)))
        else:
            xb = takum_encode_2d(_rand((M, K), 45), fmt).to(cuda)
            out.append((takum_dual_matmul(xb, w, fmt),
                        lambda o, i, xb=xb: takum_dual_matmul(xb, w, fmt, out_fmt=o,
                                                              encode_impl=i)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("producer,fmt", [("K3", "t16"), ("K3", "mxt8"), ("K4", "t8"),
                                          ("K4", "mxe4m3"), ("K6", "e5m2"), ("K6", "mxt8")])
def test_fused_output_equals_encode_of_unfused(cuda, producer, fmt):
    """The out_fmt epilogue adds no rounding of its own: for every out format
    and encode codec, the fused output is K2's encode of the unfused output,
    bit for bit, at both loops."""
    for unfused, fused in _fused_cases(cuda, producer, fmt):
        flat = unfused.reshape(-1, unfused.shape[-1])
        for out, impl in OUT_CASES:
            want = takum_encode_2d(flat, out, impl).reshape(*unfused.shape[:-1], -1)
            got = fused(out, impl)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (out, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_dual_matmul_kernel_within_limit(cuda, fmt):
    """K4 against its plain version within 4e-6 * (|decode(x)| @ |w|), each
    codec, at M = 4 (the matvec) and 37 (the tensor-core tile; t16: the FMA
    tile); lut equals bits bit for bit."""
    mx = wire_format(fmt).is_block_scaled
    K, N = (96, 100) if mx else (130, 70)
    w = _rand((K, N), 46, 0.3)
    w = takum_encode_2d(blockscale.pad_block(w) if mx else w, fmt)
    n = N if mx else None
    wd = ref.codec_decode_ref(w, fmt)[:, :N]
    for M in (4, 37):
        xb = takum_encode_2d(_rand((M, K), 47), fmt)
        scale = ref.codec_decode_ref(xb, fmt).abs() @ wd.abs()
        bits = takum_dual_matmul(xb.to(cuda), w.to(cuda), fmt, n, "bits")
        for impl in IMPLS:
            got = takum_dual_matmul(xb.to(cuda), w.to(cuda), fmt, n, impl)
            assert torch.equal(got, bits)
            want = takum_dual_matmul_plain(xb, w, fmt, n, decode_impl=impl)
            assert ((got.cpu() - want).abs() <= 4e-6 * scale).all()


@pytest.mark.gpu
def test_fused_launches_count_under_their_own_keys(cuda):
    """A fused launch counts under wrapper[impl>out:encode_impl], never under
    the unfused key, so a serving run's counts show no fused producer."""
    ops.reset_launch_counts()
    x = _rand((4, 32), 48).to(cuda)
    w = ops.encode(_rand((32, 64), 49).to(cuda), "t8")
    ops.matmul(x, w, "t8", decode_impl="lut", out_fmt="t8", encode_impl="lut")
    ops.dual_matmul(ops.encode(x, "t8"), w, "t8", decode_impl="bits", out_fmt="mxt8")
    kv = w.reshape(1, 2, 16, 64)
    ops.decode_attention(torch.zeros(1, 4, 64, device=cuda), kv, kv, "t8", out_fmt="bf16")
    got = {k: v for k, v in ops.launch_counts().items() if v}
    assert got == {"takum_encode_2d[lut]": 2, "takum_matmul[lut>t8:lut]": 1,
                   "takum_dual_matmul[bits>mxt8:lut]": 1,
                   "takum_decode_attention[lut>bf16:bits]": 1}
    ops.reset_launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "bf16"))
def test_codec_ops_0d_and_empty_nd_launch_like_2d(cuda, fmt):
    """``ops.encode`` / ``decode`` of a 0-d tensor run the kernels (one
    launch each, never the plain version) and give a 0-d result; an empty
    [2, 3, 0] keeps its shape and launches nothing."""
    wf = wire_format(fmt)
    for shape, launches in (((), 1), ((2, 3, 0), 0)):
        x = _rand(shape, 50) if shape else torch.tensor(-1.375)
        ops.reset_launch_counts()
        bits = ops.encode(x.to(cuda), fmt)
        out = ops.decode(bits, fmt)
        assert tuple(bits.shape) == shape and tuple(out.shape) == shape
        assert sum(ops.launch_counts().values()) == 2 * launches
        want = ops.encode(x, fmt)
        assert torch.equal(bits.cpu().view(wf.signed_storage), want.view(wf.signed_storage))
        assert _same_f32(out.cpu(), ops.decode(want, fmt))
    ops.reset_launch_counts()


def _transposed_copy(w):
    """w.T as a contiguous copy; 16-bit bits move through their int16 view."""
    wf = wire_format({torch.uint8: "t8", torch.uint16: "t16"}[w.dtype])
    return w.view(wf.signed_storage).T.contiguous().view(w.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS)
def test_transposed_matmul_kernel_within_limit(cuda, fmt, impl):
    """K5's backward at both loops (M = 3: the matvec; 37: the wgmma tile)
    over a stored weight [96, 1000]: the reduction (1000) is a multiple of
    neither K stage, the output (96) of neither N tile."""
    w = takum_encode_2d(_rand((96, 1000), 51, 1000 ** -0.5), fmt)
    wd = ref.codec_decode_ref(w, fmt)
    for M in (3, 37):
        g = _rand((M, 1000), 52 + M)
        got = takum_matmul_t(g.to(cuda), w.to(cuda), fmt, impl)
        want = takum_matmul_t_plain(g, w, fmt, decode_impl=impl)
        assert ((got.cpu() - want).abs() <= 4e-6 * (g.abs() @ wd.abs().T)).all()
        copy = takum_matmul(g.to(cuda), _transposed_copy(w.to(cuda)), fmt, decode_impl=impl)
        assert _same_f32(got, copy)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16"))
def test_matmul_ad_launches_one_forward_and_one_transposed(cuda, fmt):
    w = takum_encode_2d(_rand((64, 96), 53, 0.1), fmt).to(cuda)
    x = _rand((4, 64), 54).to(cuda).requires_grad_()
    ops.reset_launch_counts()
    y = takum_matmul_ad(x, w, fmt)
    (y ** 2).sum().backward()
    impl = "lut" if fmt == "t8" else "bits"
    got = {k: v for k, v in ops.launch_counts().items() if v}
    assert got == {f"takum_matmul[{impl}]": 1, f"takum_matmul[{impl}^T]": 1}
    assert torch.equal(y.detach(), takum_matmul(x.detach(), w, fmt))
    want = takum_matmul_t_plain(2 * y.detach().cpu(), w.cpu(), fmt)
    wd = ref.codec_decode_ref(w.cpu(), fmt)
    assert ((x.grad.cpu() - want).abs() <= 4e-6 * ((2 * y.detach().cpu()).abs() @ wd.abs().T)).all()
    with pytest.raises(ValueError, match="block-scaled"):
        takum_matmul_ad(x, torch.zeros(64, 99, dtype=torch.uint8, device=cuda), "mxt8")
    ops.reset_launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_matvec_small_m_within_limit_and_deterministic(cuda, fmt):
    """K3 at M in {1, 3, 4, 5, 16} (the split-K matvec, both of its row
    blocks) over K = 1000, a multiple of no plan's chunk, and N = 100, 777
    (ragged) and 1024, f32 and bf16 x: within 4e-6 * (|x| @ |w|) of the plain
    version under each codec, lut equal to bits, and a second launch equal
    to the first, bit for bit."""
    mx = wire_format(fmt).is_block_scaled
    K = 1000
    for N in (100, 777, 1024):
        w = _rand((K, N), 60 + N, K ** -0.5)
        w = takum_encode_2d(blockscale.pad_block(w) if mx else w, fmt)
        n = N if mx else None
        wd = ref.codec_decode_ref(w, fmt)[:, :N]
        wc = w.to(cuda)
        for M in (1, 3, 4, 5, 16):
            assert K % matvec_plan(M, N, K, fmt).chunk
            for dt in (torch.float32, torch.bfloat16):
                x = _rand((M, K), 70 + M).to(dt)
                bound = 4e-6 * (x.float().abs() @ wd.abs())
                bits = takum_matmul(x.to(cuda), wc, fmt, n, "bits")
                for impl in IMPLS:
                    got = takum_matmul(x.to(cuda), wc, fmt, n, impl)
                    assert _same_f32(got, bits), (N, M, dt, impl)
                    assert _same_f32(got, takum_matmul(x.to(cuda), wc, fmt, n, impl))
                    want = takum_matmul_plain(x, w, fmt, n, decode_impl=impl)
                    assert ((got.cpu() - want).abs() <= bound).all(), (N, M, dt, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_transposed_matvec_equals_matvec_over_a_copy(cuda, fmt):
    """The transposed launch at M in {1, 3, 16} runs the matvec's plan and
    order over the stored rows: equal to K3 over a transposed copy bit for
    bit, stored [N, K] with N = 100, 777 and K = 1000."""
    K = 1000
    for N in (100, 777):
        w = takum_encode_2d(_rand((N, K), 80 + N, K ** -0.5), fmt)
        wd = ref.codec_decode_ref(w, fmt)
        wc = w.to(cuda)
        copy = _transposed_copy(wc)
        for M in (1, 3, 16):
            g = _rand((M, K), 90 + M)
            for impl in IMPLS:
                got = takum_matmul_t(g.to(cuda), wc, fmt, impl)
                assert _same_f32(got, takum_matmul(g.to(cuda), copy, fmt, decode_impl=impl))
                want = takum_matmul_t_plain(g, w, fmt, decode_impl=impl)
                assert ((got.cpu() - want).abs() <= 4e-6 * (g.abs() @ wd.abs().T)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "bf16", "mxe4m3", "mxt8"))
def test_split_attention_edges(cuda, fmt):
    """K6's split S at the serving shape (B 4, H 32, Hkv 8, S 288, hd 128):
    one key in all (length 1), a last chunk of one key (length 33), a window
    of 16 whose first tile holds masked keys, a softcap, and the full cache;
    within 1e-5 max|v| of the plain version, lut equal to bits, a second
    launch equal to the first, and every fused output K2's encode of the
    unfused one."""
    B, H, Kv, S, hd = 4, 32, 8, 288, 128
    kv = takum_encode_2d(_rand((B * S * Kv, hd), 100), fmt).reshape(B, S, Kv, -1)
    vv = takum_encode_2d(_rand((B * S * Kv, hd), 101), fmt).reshape(B, S, Kv, -1)
    k, v = kv.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3)
    kc, vc = k.to(cuda), v.to(cuda)
    q = _rand((B, H, hd), 102)
    vmax = ref.codec_decode_ref(vv.reshape(-1, vv.shape[-1]), fmt)[:, :hd].abs().max()
    for length, window, cap in ((1, 0, 0.0), (33, 0, 0.0), (288, 16, 0.0), (288, 0, 30.0),
                                (270, 64, 5.0)):
        assert attention_plan(B, Kv, length, window).splits >= 1
        args = dict(length=length, window=window, softcap=cap)
        bits = takum_decode_attention(q.to(cuda), kc, vc, fmt, decode_impl="bits", **args)
        for impl in IMPLS:
            got = takum_decode_attention(q.to(cuda), kc, vc, fmt, decode_impl=impl, **args)
            assert _same_f32(got, bits)
            assert _same_f32(got, takum_decode_attention(q.to(cuda), kc, vc, fmt, decode_impl=impl,
                                                         **args))
            want = decode_attention_plain(q, k, v, fmt, length, window, cap, decode_impl=impl)
            assert (got.cpu() - want).abs().max() <= 1e-5 * vmax, (length, window, cap, impl)
        flat = bits.reshape(B * H, hd)
        for out, oimpl in (("t8", "lut"), ("mxe4m3", "bits"), ("bf16", "bits")):
            fused = takum_decode_attention(q.to(cuda), kc, vc, fmt, decode_impl="bits",
                                           out_fmt=out, encode_impl=oimpl, **args)
            want = takum_encode_2d(flat, out, oimpl).reshape(B, H, -1)
            assert torch.equal(fused.view(torch.uint8), want.view(torch.uint8)), (length, out)


@pytest.mark.gpu
def test_matvec_t16_bits_decodes_every_code_like_the_lut(cuda):
    """The split-K matvec decodes t16 under bits through its regime table
    (``codec.cuh`` ``t16_decode_regime``): x = [[1]] over a weight [1, 65536]
    holding every t16 code gives each decoded value, which must equal the
    lut codec's (the decode table of ``core/tables.py``) bit for bit, and so
    must the transposed launch over the stored [65536, 1]."""
    codes = _all_codes(wire_format("t16")).reshape(1, -1).to(cuda)
    x = torch.ones((1, 1), device=cuda)
    bits = takum_matmul(x, codes, "t16", decode_impl="bits")
    assert _same_f32(bits, takum_matmul(x, codes, "t16", decode_impl="lut"))
    t = takum_matmul_t(x, codes.reshape(-1, 1), "t16", decode_impl="bits")
    assert _same_f32(t, bits)


# ---------------------------------------------------------------------------
# the tensor-core tile (K3 with bf16 x above M = 16, K4 above M = 16) and K4
# on the split-K matvec
# ---------------------------------------------------------------------------


def _finite_within(got, want, bound):
    """NaN where ``want`` is NaN, the same infinities, and the finite outputs
    within ``bound``."""
    got = got.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    fin = ~(nan | inf)
    return bool(((got[fin] - want[fin]).abs() <= bound[fin]).all())


def _weight(fmt, K, N, seed, positive=False):
    """(bits, n, decoded [K, N]) of a random weight; an mx N pads its last group."""
    mx = wire_format(fmt).is_block_scaled
    w = _rand((K, N), seed, K ** -0.5)
    if positive:
        w = w.abs()
    w = takum_encode_2d(blockscale.pad_block(w) if mx else w, fmt)
    return w, (N if mx else None), ref.codec_decode_ref(w, fmt)[:, :N]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_mma_tile_within_limit_and_deterministic(cuda, fmt):
    """K3 with bf16 x at M in {17, 37, 1024} runs the tensor-core tile
    (t16: its hi/lo split) over K = 1000 and N = 777 (mx: a padded last
    group): within 4e-6 * (|x| @ |w|) of the plain version under each
    codec, lut equal to bits and a second launch equal to the first, bit for
    bit; all-positive inputs (the partial sum is then the whole |x| @ |w|)
    at M = 1024 too.  f32 x at M = 37 runs the wgmma tile."""
    K, N = 1000, 777
    loop = "mma_split" if fmt == "t16" else "mma"
    for positive in (False, True):
        w, n, wd = _weight(fmt, K, N, 200, positive)
        wc = w.to(cuda)
        for M in ((1024,) if positive else (17, 37, 1024)):
            x = _rand((M, K), 201 + M).to(torch.bfloat16)
            if positive:
                x = x.abs()
            bound = 4e-6 * (x.float().abs() @ wd.abs())
            bits = takum_matmul(x.to(cuda), wc, fmt, n, "bits")
            assert takum_matmul.last_loop == loop
            for impl in IMPLS:
                got = takum_matmul(x.to(cuda), wc, fmt, n, impl)
                assert _same_f32(got, bits), (M, impl)
                assert _same_f32(got, takum_matmul(x.to(cuda), wc, fmt, n, impl))
                want = takum_matmul_plain(x, w, fmt, n, decode_impl=impl)
                assert ((got.cpu() - want).abs() <= bound).all(), (M, impl, positive)
    x = _rand((37, K), 209)
    got = takum_matmul(x.to(cuda), wc, fmt, n, "bits")
    assert takum_matmul.last_loop == "mma_f32"
    assert ((got.cpu() - takum_matmul_plain(x, w, fmt, n)).abs()
            <= 4e-6 * (x.abs() @ wd.abs())).all()


#: per format, codes of NaN / NaR and of infinity (None: the format has none)
_SPECIAL_CODES = {"t8": (0x80, None), "t16": (0x8000, None), "e4m3": (0x7F, None),
                  "e5m2": (0x7F, 0x7C), "bf16": (0x7FC0, 0x7F80)}


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + ("mxe4m3", "mxt8"))
def test_mma_tile_specials(cuda, fmt):
    """The tensor-core tile (M = 37, 1024) against the plain version with
    NaN and +-inf in rows of x; NaR / NaN and inf codes in w (an mx NaN
    scale byte); and NaN bits right after the operands' ends, in the row of
    x past M and in weight rows past K (K = 1000, not a multiple of the
    32-row stage), which must not reach the output: NaN and inf exactly
    where the plain version has them, every other output within 4e-6 *
    (|x| @ |w|), lut equal to bits."""
    K, N = 1000, 160
    mx = wire_format(fmt).is_block_scaled
    wf = wire_format(fmt)
    w = _rand((K + 24, N), 210, K ** -0.5)
    w = takum_encode_2d(blockscale.pad_block(w) if mx else w, fmt)
    if mx:
        w[K:, ::33] = 255  # NaN scale bytes past K
        w[5, 33] = 255     # a NaN group inside: row 5, columns 32..63
    else:
        nan_code, inf_code = _SPECIAL_CODES[fmt]
        wv = w.view(torch.int16) if wf.nbits == 16 else w
        signed = (lambda c: c - (1 << 16) if c >= 1 << 15 else c) if wf.nbits == 16 else int
        wv[K:] = signed(nan_code)
        wv[7, 3] = signed(nan_code)
        if inf_code is not None:
            wv[9, 11] = signed(inf_code)
    wk = w[:K]  # contiguous rows; the NaN rows lie right after it
    wd = ref.codec_decode_ref(wk, fmt)[:, :N]
    n = N if mx else None
    wc = w.to(cuda)[:K]
    for M in (37, 1024):
        xf = _rand((M + 1, K), 211 + M).to(torch.bfloat16)
        xf[M] = float("nan")  # the row past M
        xf[1, 3], xf[2, 4], xf[3, 5] = float("nan"), float("inf"), -float("inf")
        x = xf[:M]
        xc = xf.to(cuda)[:M]
        bound = 4e-6 * (torch.nan_to_num(x.float(), 0, 0, 0).abs() @ torch.nan_to_num(wd, 0, 0, 0).abs())
        bits = takum_matmul(xc, wc, fmt, n, "bits")
        assert takum_matmul.last_loop in ("mma", "mma_split")
        for impl in IMPLS:
            got = takum_matmul(xc, wc, fmt, n, impl)
            assert _same_f32(got, bits)
            want = takum_matmul_plain(x, wk, fmt, n, decode_impl=impl)
            assert _finite_within(got, want, bound), (M, impl)


def _every_code_row(fmt):
    """[1, n] bits holding every code of ``fmt`` (mx: every element code
    under every scale byte, one 33-byte group per pair)."""
    wf = wire_format(fmt)
    if wf.is_block_scaled:
        return mx_all_codes().reshape(1, -1)
    return _all_codes(wf).reshape(1, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_mma_tile_carries_every_code_exactly(cuda, fmt):
    """x = 1 (bf16, M = 17) over a weight row holding every code: the
    tensor-core tile must return each decoded value exactly (NaN as NaN),
    under each codec.  This holds the bf16 parts (t16: hi + lo) to the
    decode over all 65536 codes, bf16 weights' subnormals included, and the
    FMA fallback to the codes no bf16 parts carry (f32's largest finite
    magnitude, from saturating t8 / t16 codes and mxt8 elements)."""
    w = _every_code_row(fmt).to(cuda)
    want = ref.codec_decode_ref(w.cpu(), fmt).reshape(-1)
    x = torch.ones((17, 1), dtype=torch.bfloat16, device=cuda)
    for impl in IMPLS:
        got = takum_matmul(x, w, fmt, decode_impl=impl)
        assert takum_matmul.last_loop in ("mma", "mma_split")
        for row in (0, 16):
            g = got[row].cpu()
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(g), nan), impl
            assert torch.equal(g[~nan], want[~nan]), impl


@pytest.mark.gpu
def test_mma_tile_keeps_subnormal_products(cuda):
    """Products below 2^-126 through the tensor cores: x = 2^-64 (bf16)
    times decoded t16 weights 2^-62 .. 2^-70 and 1.5 * 2^-66; the tile's f32
    output must equal the plain version's (f32 products, no flush to zero).
    Subnormal weights themselves (bf16's) are carried by
    test_mma_tile_carries_every_code_exactly."""
    x = torch.full((17, 1), 2.0 ** -64, dtype=torch.bfloat16)
    w = takum_encode_2d(torch.tensor([[2.0 ** -e for e in range(62, 71)] + [1.5 * 2.0 ** -66]]),
                        "t16")
    got = takum_matmul(x.to(cuda), w.to(cuda), "t16").cpu()
    assert takum_matmul.last_loop == "mma_split"
    want = takum_matmul_plain(x, w, "t16")
    assert bool((want[0, 1:] != 0).all())
    assert torch.equal(got, want), (got[0].tolist(), want[0].tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_dual_matmul_loops_by_m(cuda, fmt):
    """K4 at M in {3, 4, 16} runs the split-K matvec and at M in {17, 37}
    the tensor-core tile (t16: the FMA tile): within 4e-6 * (|decode(x)| @
    |w|) of the plain version, lut equal to bits, a second launch equal to
    the first, and a fused t8 / mxe4m3 output K2's encode of the unfused
    one, bit for bit, at each loop."""
    mx = wire_format(fmt).is_block_scaled
    K, N = (992, 160) if mx else (1000, 160)
    w, n, wd = _weight(fmt, K, N, 220)
    wc = w.to(cuda)
    for M in (3, 4, 16, 17, 37):
        xb = takum_encode_2d(_rand((M, K), 221 + M), fmt)
        xd = ref.codec_decode_ref(xb, fmt)
        bound = 4e-6 * (xd.abs() @ wd.abs())
        bits = takum_dual_matmul(xb.to(cuda), wc, fmt, n, "bits")
        assert (takum_dual_matmul.last_loop == "matvec") == (M <= 16)
        for impl in IMPLS:
            got = takum_dual_matmul(xb.to(cuda), wc, fmt, n, impl)
            assert _same_f32(got, bits), (M, impl)
            assert _same_f32(got, takum_dual_matmul(xb.to(cuda), wc, fmt, n, impl))
            want = takum_dual_matmul_plain(xb, w, fmt, n, decode_impl=impl)
            assert ((got.cpu() - want).abs() <= bound).all(), (M, impl)
        for out, oimpl in (("t8", "lut"), ("mxe4m3", "bits")):
            fused = takum_dual_matmul(xb.to(cuda), wc, fmt, n, "bits", out, oimpl)
            assert torch.equal(fused.view(torch.uint8),
                               takum_encode_2d(bits, out, oimpl).view(torch.uint8)), (M, out)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "mxt8"))
def test_mma_tile_fused_equals_encode_of_unfused(cuda, fmt):
    """K3's tensor-core tile, both block edges (M = 37, N = 160: 64; M =
    1024, N = 4096: 128), fused into every out format and encode codec:
    K2's encode of the unfused output, bit for bit."""
    for M, K, N in ((37, 1000, 160), (1024, 512, 4096)):
        w, n, _ = _weight(fmt, K, N, 230)
        wc = w.to(cuda)
        x = _rand((M, K), 231).to(torch.bfloat16).to(cuda)
        unfused = takum_matmul(x, wc, fmt, n)
        for out, impl in OUT_CASES:
            got = takum_matmul(x, wc, fmt, n, out_fmt=out, encode_impl=impl)
            assert takum_matmul.last_loop in ("mma", "mma_split")
            want = takum_encode_2d(unfused, out, impl)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (M, out, impl)


# ---------------------------------------------------------------------------
# the wgmma tile (K3 with f32 x above M = 16, and the transposed K3): x split
# into three bf16 parts
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_mma_f32_tile_within_limit_and_deterministic(cuda, fmt):
    """K3 with f32 x at (M, K) in {(37, 1000), (1000, 1000), (37, 999)} over
    N = 777 (mx: a padded last group; K = 1000 and 999 a multiple of no
    32-k stage, K = 999 rows of x not 16-byte aligned), both block edges
    (mma_plan: 64 x 64 at these N): within 4e-6 * (|x| @ |w|) of the plain
    version under each codec, lut equal to bits, a second launch equal to
    the first, and fused into t8 K2's encode of the unfused output, bit for
    bit."""
    N = 777
    for M, K in ((37, 1000), (1000, 1000), (37, 999)):
        w, n, wd = _weight(fmt, K, N, 240 + K)
        wc = w.to(cuda)
        x = _rand((M, K), 241 + M)
        xc = x.to(cuda)
        bound = 4e-6 * (x.abs() @ wd.abs())
        bits = takum_matmul(xc, wc, fmt, n, "bits")
        assert takum_matmul.last_loop == "mma_f32"
        for impl in IMPLS:
            got = takum_matmul(xc, wc, fmt, n, impl)
            assert _same_f32(got, bits), (M, K, impl)
            assert _same_f32(got, takum_matmul(xc, wc, fmt, n, impl))
            want = takum_matmul_plain(x, w, fmt, n, decode_impl=impl)
            assert ((got.cpu() - want).abs() <= bound).all(), (M, K, impl)
        # fused into t8 (mx out needs whole 32-column groups: the next test)
        fused = takum_matmul(xc, wc, fmt, n, "bits", "t8", "lut")
        assert torch.equal(fused, takum_encode_2d(bits, "t8", "lut")), (M, K)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "mxt8"))
def test_mma_f32_tile_fused_equals_encode_of_unfused(cuda, fmt):
    """The wgmma tile at both block edges (M = 37, N = 160: 64; M = 1024,
    N = 4096: 128), fused into every out format and encode codec: K2's
    encode of the unfused output, bit for bit."""
    for M, K, N in ((37, 1000, 160), (1024, 512, 4096)):
        w, n, _ = _weight(fmt, K, N, 250)
        wc = w.to(cuda)
        x = _rand((M, K), 251).to(cuda)
        unfused = takum_matmul(x, wc, fmt, n)
        for out, impl in OUT_CASES:
            got = takum_matmul(x, wc, fmt, n, out_fmt=out, encode_impl=impl)
            assert takum_matmul.last_loop == "mma_f32"
            want = takum_encode_2d(unfused, out, impl)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (M, out, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_mma_f32_transposed_equals_k3_over_a_copy(cuda, fmt):
    """The transposed launch on the wgmma tile at M = 37 and 1024 over
    stored [N, K] = [777, 1000] and [4096, 1024] (both block edges), each
    codec: equal to K3 over a transposed copy bit for bit, within 4e-6 of
    |g| @ |w|.T of its plain version."""
    for M, N, K in ((37, 777, 1000), (1024, 4096, 1024)):
        w = takum_encode_2d(_rand((N, K), 260 + N, K ** -0.5), fmt)
        wd = ref.codec_decode_ref(w, fmt)
        wc = w.to(cuda)
        copy = _transposed_copy(wc)
        g = _rand((M, K), 261 + M)
        for impl in IMPLS:
            got = takum_matmul_t(g.to(cuda), wc, fmt, impl)
            assert takum_matmul_t.last_loop == "mma_f32"
            assert _same_f32(got, takum_matmul(g.to(cuda), copy, fmt, decode_impl=impl)), (M, impl)
            want = takum_matmul_t_plain(g, w, fmt, decode_impl=impl)
            assert ((got.cpu() - want).abs() <= 4e-6 * (g.abs() @ wd.abs().T)).all(), (M, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("M", (37, 1024))
@pytest.mark.parametrize("fmt", ("t8", "t16"))
def test_matmul_ad_step_on_the_wgmma_tile(cuda, fmt, M):
    """One autograd step of K5 above M = 16 launches exactly one K3 and one
    transposed K3, both on the wgmma tile, and x.grad is the plain backward
    of its cotangent within 4e-6 of |g| @ |w|.T."""
    w = takum_encode_2d(_rand((512, 640), 270, 512 ** -0.5), fmt).to(cuda)
    x = _rand((M, 512), 271).to(cuda).requires_grad_()
    ops.reset_launch_counts()
    y = takum_matmul_ad(x, w, fmt)
    assert takum_matmul.last_loop == "mma_f32"
    (y ** 2).sum().backward()
    assert takum_matmul_t.last_loop == "mma_f32"
    impl = "lut" if fmt == "t8" else "bits"
    got = {k: v for k, v in ops.launch_counts().items() if v}
    assert got == {f"takum_matmul[{impl}]": 1, f"takum_matmul[{impl}^T]": 1}
    g = 2 * y.detach().cpu()
    wd = ref.codec_decode_ref(w.cpu(), fmt)
    want = takum_matmul_t_plain(g, w.cpu(), fmt)
    assert ((x.grad.cpu() - want).abs() <= 4e-6 * (g.abs() @ wd.abs().T)).all()
    ops.reset_launch_counts()


def _fma_loop(monkeypatch, fn, *args, **kw):
    """``fn`` with the wrappers' loop forced to the FMA tile (which the C
    entries keep for f32 x as the wgmma tile's fallback)."""
    with monkeypatch.context() as m:
        m.setattr(takum_matmul_mod, "tile_for", lambda M, kind, fmt: "fma")
        return fn(*args, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((300, 300, 300), (1024, 512, 4096)))
@pytest.mark.parametrize("fmt", ("t8", "t16", "e5m2", "bf16", "mxt8"))
def test_mma_f32_fallback_blocks_equal_the_fma_loop(cuda, monkeypatch, fmt, shape):
    """Blocks the wgmma tile's vote sends to its FMA fallback: x rows with
    +inf, NaN and a sub-edge value (1.2345 * 2^-120, not a multiple of
    2^-133), each in a block of its own, and a weight column with a
    saturating code (t8 0x7F, t16 0x7FFF: f32's largest value; mxt8 the same
    element under scale byte 120) or inf (e5m2, bf16).  At M = K = N = 300
    the blocks are 64 x 64 (mma_plan: one consumer warpgroup), at M = 1024,
    N = 4096 128 x 128 (two, setmaxnreg, TN = 4 in the fallback).  Every
    output of a flagged block equals the FMA loop's bit for bit, NaN
    matching NaN; the rest are within 4e-6 * (|x| @ |w|) of the plain
    version.  Fused into t8 (and mxe4m3 where N is whole 32-column groups),
    the output is K2's encode of the unfused one bit for bit; the transposed
    launch over a transposed copy of the same bits (flat formats) gives the
    unfused output."""
    M, K, N = shape
    tile = takum_matmul_mod.mma_plan(M, N).rows
    assert tile == (64 if M == 300 else 128)
    w, n, _ = _weight(fmt, K, N, 280)
    wf = wire_format(fmt)
    sat = {"t8": 0x7F, "t16": 0x7FFF, "e5m2": 0x7C, "bf16": 0x7F80}.get(fmt)
    k_sat, n_sat = K * 2 // 5, N * 2 // 3 + 1
    if wf.is_block_scaled:
        g = w[k_sat].view(torch.uint8)
        grp = n_sat // 32 * 33
        g[grp] = 120                      # the group's scale byte: 2^-7
        g[grp + 1 + n_sat % 32] = 0x7F    # a saturating t8 element under it
    else:
        wv = w.view(wf.signed_storage)
        wv[k_sat, n_sat] = sat - (1 << 16) if sat >= 1 << 15 else sat
    wd = ref.codec_decode_ref(w, fmt)[:, :N]
    x = _rand((M, K), 281)
    rows = (5, M // 4 + 6, M - 3)
    x[rows[0], 7] = float("inf")
    x[rows[1], 9] = float("nan")
    x[rows[2], 11] = 1.2345 * 2.0 ** -120
    assert len({r // tile for r in rows}) == 3
    xc, wc = x.to(cuda), w.to(cuda)
    got = takum_matmul(xc, wc, fmt, n)
    assert takum_matmul.last_loop == "mma_f32"
    fma = _fma_loop(monkeypatch, takum_matmul, xc, wc, fmt, n).cpu()
    flagged = torch.zeros((M, N), dtype=torch.bool)
    for r in rows:
        flagged[r // tile * tile:(r // tile + 1) * tile] = True
    flagged[:, n_sat // tile * tile:(n_sat // tile + 1) * tile] = True
    assert _same_f32(got.cpu()[flagged], fma[flagged])
    want = takum_matmul_plain(x, w, fmt, n)
    bound = 4e-6 * (x.abs() @ wd.abs())
    keep = ~flagged
    assert ((got.cpu()[keep] - want[keep]).abs() <= bound[keep]).all()
    for out, impl in (("t8", "lut"), ("mxe4m3", "bits")):
        if wire_format(out).is_block_scaled and N % 32:
            continue
        fused = takum_matmul(xc, wc, fmt, n, out_fmt=out, encode_impl=impl)
        assert takum_matmul.last_loop == "mma_f32"
        want_bits = takum_encode_2d(got, out, impl)
        assert torch.equal(fused.view(torch.uint8), want_bits.view(torch.uint8)), (out, impl)
    if not wf.is_block_scaled:
        got_t = takum_matmul_t(xc, _transposed_copy(wc), fmt)
        assert takum_matmul_t.last_loop == "mma_f32"
        assert _same_f32(got_t.cpu(), got.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("K", (4096, 14336))
@pytest.mark.parametrize("fmt", ("t8", "t16"))
def test_mma_f32_all_positive_rows_within_limit(cuda, fmt, K):
    """All-positive f32 x [1024, K] over all-positive weights [K, 4096]
    (K = 4096: every prefill linear but w2; 14336: w2): every partial sum
    is then the whole |x| @ |w|, so a truncating accumulation shows.  The
    wgmma tile within 4e-6 of the f64 sum of the decoded operands, under
    each codec."""
    M, N = 1024, 4096
    gen = torch.Generator(device=cuda).manual_seed(290 + K)
    x = torch.randn((M, K), generator=gen, device=cuda).abs()
    w = takum_encode_2d(torch.randn((K, N), generator=gen, device=cuda).abs() * 0.5, fmt)
    exact = x.double() @ ref.codec_decode_ref(w, fmt).double()
    for impl in IMPLS:
        got = takum_matmul(x, w, fmt, decode_impl=impl)
        assert takum_matmul.last_loop == "mma_f32"
        assert float(((got.double() - exact).abs() / exact).max()) <= 4e-6, impl


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "e5m2"))
def test_tied_head_transposed_matmul_within_limit(cuda, fmt):
    """A tied head, ``layers.linear_t`` over a packed table [V, d] (V = 1000,
    d = 96): the transposed K3 on the stored bits at M = 4 (the matvec) and
    37 (the wgmma tile), bf16 and f32 x, within K3's limit of |x| @ |e|.T
    times the table's pow2 scale, one transposed launch a call and no K1."""
    from repro_torch.models.layers import linear_t
    from repro_torch.quant.qtensor import quantize

    table = _rand((1000, 96), 61, 96 ** -0.5)
    e = quantize(table, fmt, scaled=True)
    ec = quantize(table.to(cuda), fmt, scaled=True)
    assert torch.equal(ec.bits.cpu().view(torch.uint8), e.bits.view(torch.uint8))
    wd = ref.codec_decode_ref(e.bits, fmt) * e.scale
    impl = "bits" if fmt == "t16" else "lut"
    for M, dt in ((4, torch.bfloat16), (4, torch.float32), (37, torch.float32)):
        x = _rand((M, 96), 62 + M).to(dt)
        ops.reset_launch_counts()
        got = linear_t(x.to(cuda), ec)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {f"takum_matmul[{impl}^T]": 1}, counts
        assert got.dtype == dt and got.shape == (M, 1000)
        want = linear_t(x, e)
        lim = 4e-6 * (x.float().abs() @ wd.abs().T)
        if dt == torch.bfloat16:  # both cast the f32 product to bf16: one bf16 step apart
            lim = lim + want.float().abs() * 2.0 ** -7
        assert ((got.cpu().float() - want.float()).abs() <= lim).all(), (M, dt)
    ops.reset_launch_counts()


@pytest.mark.gpu
def test_mx_tied_head_is_one_k1_mx_and_a_matmul(cuda):
    """An mx table's tied head decodes the table through one K1-mx launch and
    multiplies it by ``torch.matmul``: no transposed K3; equal to the plain
    version (the decode is exact, the matmul the same call)."""
    from repro_torch.models.layers import linear_t
    from repro_torch.quant.qtensor import quantize

    table = _rand((1000, 80), 63, 80 ** -0.5)  # d = 80: a padded last block
    e = quantize(table.to(cuda), "mxt8")
    x = _rand((4, 80), 64).to(cuda)
    ops.reset_launch_counts()
    got = linear_t(x, e)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"takum_decode_2d[lut]": 1}, counts
    with ops.plain_path():
        want = linear_t(x, e)
    assert _same_f32(got, want)
    ops.reset_launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ("t8", "t16", "bf16", "mxt8"))
@pytest.mark.parametrize("shape", ["gemma2", "granite"])
def test_attention_past_48k_shared_memory(cuda, fmt, shape):
    """K6 where its shared memory takes the > 48 KiB opt-in: gemma2's head dim
    256 (H 8, Kv 4) and granite's MQA, g = 48 (H 48, Kv 1), with a window
    shorter than the length and a softcap of 50: within 1e-5 max|v| of the
    plain version, lut equal to bits."""
    H, Kv, hd = (8, 4, 256) if shape == "gemma2" else (48, 1, 128)
    B, S = 2, 300
    kv = takum_encode_2d(_rand((B * S * Kv, hd), 110), fmt).reshape(B, S, Kv, -1)
    vv = takum_encode_2d(_rand((B * S * Kv, hd), 111), fmt).reshape(B, S, Kv, -1)
    k, v = kv.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3)
    q = _rand((B, H, hd), 112)
    vmax = ref.codec_decode_ref(vv.reshape(-1, vv.shape[-1]), fmt)[:, :hd].abs().max()
    for length, window, cap in ((290, 100, 50.0), (300, 0, 50.0), (37, 16, 0.0)):
        args = dict(length=length, window=window, softcap=cap)
        bits = takum_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), fmt,
                                      decode_impl="bits", **args)
        for impl in IMPLS:
            got = takum_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), fmt,
                                         decode_impl=impl, **args)
            assert _same_f32(got, bits)
            want = decode_attention_plain(q, k, v, fmt, length, window, cap, decode_impl=impl)
            assert (got.cpu() - want).abs().max() <= 1e-5 * vmax, (length, window, impl)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("fmt", ("t8", "t16", "mxt8"))
@pytest.mark.parametrize("N", (4, 8, 16, 384))
def test_k3_at_the_routers_narrow_n(cuda, N, fmt, xdt):
    """K3 over a router's width, N = 4, 8, 16 (4 to 32 bytes a weight row:
    the wgmma tile stages rows under 16 bytes by cp.async) and 384, at the
    matvec (M = 4) and both tiles (M = 24, 1024), within K3's limit of its
    plain version (mxt8: N padded to a 32-block in the payload)."""
    K = 768
    w32 = _rand((K, N), 120 + N, K ** -0.5)
    mx = fmt.startswith("mx")
    w = takum_encode_2d(blockscale.pad_block(w32) if mx else w32, fmt)
    wd = ref.codec_decode_ref(w, fmt)[:, :N]
    for M in (4, 24, 1024):
        x = _rand((M, K), 121 + M).to(xdt)
        got = takum_matmul(x.to(cuda), w.to(cuda), fmt, n=N if mx else None).cpu()
        want = takum_matmul_plain(x, w, fmt, n=N if mx else None)
        assert got.shape == (M, N) and torch.isfinite(got).all()
        lim = 4e-6 * (x.float().abs() @ wd.abs())
        assert ((got - want).abs() <= lim).all(), (M, takum_matmul.last_loop)


def _moe_cfg(policy, act):
    import dataclasses

    from repro_torch import configs
    from repro_torch.quant.policy import POLICIES

    return configs.get_smoke("kimi_k2_1t_a32b").with_(
        d_model=256, d_ff=384, num_heads=4, num_kv_heads=2, head_dim=64, num_experts=8,
        quant=dataclasses.replace(POLICIES[policy], activations=act))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ("f32", "bf16"))
@pytest.mark.parametrize("policy", ("takum", "takum8"))
def test_moe_block_kernel_path_against_plain(cuda, policy, act):
    """``moe.moe_block`` at d = 256, f = 384, 8 experts, top 2, a shared
    expert, packed t16 / t8 weights: the kernel path (K3 for the router,
    every expert and the shared expert) against ``ops.plain_path()`` on the
    same inputs, the gate indices equal wherever the top-k margin is at
    least 1e-5, the output within 1e-5 of max|y| (f32 results: the experts'
    products stay f32 under bf16 x), aux within 1e-6; one router, 3 per
    expert and 3 shared K3 launches."""
    from repro_torch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = _moe_cfg(policy, act)
    qp = serve.quantize_params(cfg, T.init_params(cfg, 5, device=cuda))
    mp = {k: v[0] for k, v in qp["layers"]["moe"].items()}
    dt = torch.bfloat16 if act == "bf16" else torch.float32
    x = _rand((3, 40, 256), 130).to(dt).to(cuda)
    args = (mp["router"], mp["wi"], mp["wg"], mp["wo"], (mp["wi_s"], mp["wg_s"], mp["wo_s"]))
    kw = dict(top_k=2, capacity_factor=1.25)
    ops.reset_launch_counts()
    kt, pt = {}, {}
    got, aux = moe.moe_block(x, *args, trace=kt, **kw)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    impl = "bits" if policy == "takum" else "lut"
    assert counts == {f"takum_matmul[{impl}]": 1 + 3 * 8 + 3}, counts
    with ops.plain_path():
        want, paux = moe.moe_block(x, *args, trace=pt, **kw)
    top = pt["probs"].topk(3, dim=-1).values
    ok = (top[..., 1] - top[..., 2]) >= 1e-5
    assert ok.float().mean() > 0.99
    assert torch.equal(kt["gate_idx"][ok], pt["gate_idx"][ok])
    assert got.dtype == torch.float32 and want.dtype == torch.float32
    assert (got - want)[ok].abs().max() <= 1e-5 * want[ok].abs().max()
    assert abs(float(aux) - float(paux)) <= 1e-6
    ops.reset_launch_counts()


@pytest.mark.gpu
def test_moe_serve_step_launches_per_layer(cuda):
    """A decode step of a 2-layer MoE config (8 experts, a shared expert)
    under takum8 on the card: per layer 4 + 1 + 3 * 8 + 3 = 32 K3 launches
    (every expert, the empty ones too), one K2 append and one K6, plus the
    head's K3 and the embedding rows' K1; finite logits."""
    from repro_torch import serve
    from repro_torch.models import transformer as T

    cfg = _moe_cfg("takum8", "bf16")
    qp = serve.load_params(serve.quantize_params(cfg, T.init_params(cfg, 6, device=cuda)))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), device=cuda)
    logits, cache = serve.make_prefill_step(cfg, 20)(qp, {"tokens": tokens})
    ops.reset_launch_counts()
    logits, cache = serve.make_serve_step(cfg)(qp, {"token": logits.argmax(-1)}, cache)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    L = cfg.num_layers
    assert counts == {"takum_matmul[lut]": L * 32 + 1, "takum_encode_into[lut]": L,
                      "takum_decode_attention[lut]": L, "takum_decode_rows[lut]": 1}, counts
    assert torch.isfinite(logits).all() and cache.pos == 17
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# the f32 KV cache: K1 / K2 / K6 over raw f32 bits
# ---------------------------------------------------------------------------


def _f32_words(n, seed):
    """n uint32 words: random patterns (subnormals, NaN payloads and +-Inf
    among them), then the named classes."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g, dtype=torch.int64)
    named = torch.tensor([0, -(1 << 31), 1, 0x007FFFFF, 0x7F800000, -0x00800000, 0x7FC00000,
                          0x7F800001, 0x7FBFFFFF, 0x7FF00F0F, -0x003EDCBB], dtype=torch.int64)
    k = min(n, named.numel())
    w[:k] = named[:k]
    return w.to(torch.int32).view(torch.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (1, 7, 4096, (1 << 20) + 3))
def test_f32_codecs_move_raw_bits(cuda, n):
    """K2 of f32 is the raw bits (no DAZ: subnormals, -0 and NaN payloads
    kept) and K1 the bitcast back, bit for bit against the plain versions,
    on views offset by 4 to 12 bytes too; K1 into bf16 rounds as the plain
    version does."""
    words = _f32_words(n + 3, n)
    for off in (0, 1, 3):
        w = words[off:off + n].reshape(1, n)
        x = w.view(torch.float32)
        got = takum_encode_2d(x.to(cuda), "f32")
        assert got.dtype == torch.uint32
        assert torch.equal(got.cpu().view(torch.int32), w.view(torch.int32))
        assert torch.equal(got.cpu().view(torch.int32),
                           encode_2d_plain(x, "f32").view(torch.int32))
        dec = takum_decode_2d(got, "f32")
        assert torch.equal(dec.cpu().view(torch.int32), w.view(torch.int32))
    rows = torch.randint(0, 64, (5, 3), device=cuda)
    table = _f32_words(64 * 40, 3).reshape(64, 40)
    for dt in (torch.float32, torch.bfloat16):
        got = takum_decode_rows(table.to(cuda), rows, "f32", out_dtype=dt)
        want = decode_rows_plain(table, rows.cpu(), "f32", out_dtype=dt)
        assert _same_f32(got.float().cpu(), want.float())


@pytest.mark.gpu
@pytest.mark.parametrize("src_dt", (torch.float32, torch.bfloat16))
def test_f32_append_into_cache_slots(cuda, src_dt):
    """One K2 launch appends a pair (K and V) into an f32 cache's slots,
    the raw bits of the (widened) source, the bytes around them untouched,
    equal to the plain version."""
    B, S, Kv, hd, cap = 4, 5, 8, 128, 16
    k, v = (_rand((B * S * Kv, hd), s).to(src_dt) for s in (140, 141))
    cache = torch.full((2, B, cap * Kv * hd), 0x5A5A5A5A, dtype=torch.int32).view(torch.uint32)
    want = cache.clone()

    def slots(c):
        return [c[i][:, 3 * Kv * hd:(3 + S) * Kv * hd] for i in range(2)]

    on = cache.to(cuda)
    ops.reset_launch_counts()
    takum_encode_into((k.to(cuda), v.to(cuda)), slots(on), "f32")
    assert ops.launch_counts()["takum_encode_into[bits]"] == 1
    encode_into_plain((k, v), slots(want), "f32")
    assert torch.equal(on.cpu().view(torch.int32), want.view(torch.int32))
    ops.reset_launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["llama3_8b", "vlm", "gemma2", "granite"])
def test_attention_over_an_f32_cache(cuda, shape):
    """K6 over raw f32 K/V (512 B a row at hd 128, 1 KiB at gemma2's 256):
    within 1e-5 max|v| of the plain version, at llama3-8b's decode shape
    (g 4), the vlm's (g 8), gemma2's (hd 256, softcap, window) and
    granite's (g 48), the same bits on a second launch."""
    B, H, Kv, hd = {"llama3_8b": (4, 32, 8, 128), "vlm": (4, 64, 8, 128),
                    "gemma2": (2, 8, 4, 256), "granite": (2, 48, 1, 128)}[shape]
    S = 300
    kv = takum_encode_2d(_rand((B * S * Kv, hd), 150), "f32").reshape(B, S, Kv, hd)
    vv = takum_encode_2d(_rand((B * S * Kv, hd), 151), "f32").reshape(B, S, Kv, hd)
    k, v = kv.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3)
    q = _rand((B, H, hd), 152)
    vmax = vv.view(torch.float32).abs().max()
    for length, window, cap in ((288, 0, 0.0), (300, 100, 50.0), (37, 16, 0.0)):
        args = dict(length=length, window=window, softcap=cap)
        got = takum_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), "f32", **args)
        again = takum_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), "f32", **args)
        assert _same_f32(got, again)
        want = decode_attention_plain(q, k, v, "f32", length, window, cap)
        assert (got.cpu() - want).abs().max() <= 1e-5 * vmax, (length, window)
    with pytest.raises(ValueError):
        takum_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), "f32", decode_impl="lut")


# ---------------------------------------------------------------------------
# the vlm, and the f32 cache in every arch
# ---------------------------------------------------------------------------


def _gate_on(qp, seed):
    """Draw the cross layers' gates nonzero (N(0, 1)): at their init of zero
    tanh(0) = 0 takes the whole cross path out of the logits."""
    gate = qp["cross_layers"]["gate"]
    gate.copy_(_rand(tuple(gate.shape), seed).to(gate.device, gate.dtype))
    return qp


@pytest.mark.gpu
@pytest.mark.parametrize("act", ("f32", "bf16"))
@pytest.mark.parametrize("policy", ("takum", "takum8"))
def test_vlm_kernel_path_against_plain(cuda, policy, act):
    """llama-3.2-vision-90b's smoke config served on the card (prefill of 8,
    6 decode steps, media on the card, gates nonzero): the kernel path
    against ``ops.plain_path()`` on the same tree, teacher-forced, within
    1e-3 of max|logit| at f32 and 5e-2 at bf16 (phase (e)'s limits); per
    call 7 K3 a layer, 4 a cross layer, one over the media and the head's;
    per call one K2 a layer, per step one K6 a layer."""
    import dataclasses

    from repro_torch import configs, serve
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES

    cfg = configs.get_smoke("llama3_2_vision_90b").with_(
        quant=dataclasses.replace(POLICIES[policy], activations=act))
    qp = serve.load_params(_gate_on(serve.quantize_params(cfg, T.init_params(cfg, 7, device=cuda)),
                                    160))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    media = _rand((2, cfg.num_media_tokens, cfg.media_d), 161).to(cuda)
    runs = {}
    for path in ("kernel", "plain"):
        ops.reset_launch_counts()
        ctx = ops.plain_path() if path == "plain" else torch.no_grad()
        with ctx:
            logits, cache = serve.make_prefill_step(cfg, 14)(qp, {"tokens": tokens, "media": media})
            outs = [logits]
            fed = runs.get("fed") or [None] * 6
            feed = []
            for i in range(6):
                tok = logits.argmax(-1) if fed[i] is None else fed[i]
                feed.append(tok)
                logits, cache = serve.make_serve_step(cfg)(qp, {"token": tok, "media": media},
                                                           cache)
                outs.append(logits)
        runs["fed"] = feed
        runs[path] = torch.stack(outs)
        if path == "kernel":
            counts = {k: v for k, v in ops.launch_counts().items() if v}
    impl = "bits" if policy == "takum" else "lut"  # the weights' codec; the t8 KV's is lut
    L, Lc = cfg.num_layers, cfg.num_layers // cfg.cross_attn_every
    assert counts == {f"takum_matmul[{impl}]": 7 * (7 * L + 4 * Lc + 2),
                      "takum_encode_into[lut]": 7 * L,
                      "takum_decode_attention[lut]": 6 * L,
                      f"takum_decode_rows[{impl}]": 7}, counts
    k, p = runs["kernel"], runs["plain"]
    tol = 1e-3 if act == "f32" else 5e-2
    assert torch.isfinite(k).all()
    assert ((k - p).abs().amax(dim=(1, 2)) / p.abs().amax(dim=(1, 2))).max() <= tol
    ops.reset_launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["musicgen_large", "kimi_k2_1t_a32b", "dbrx_132b", "gemma2_2b",
                                  "llama3_8b", "llama3_2_3b", "granite_34b", "hymba_1_5b",
                                  "llama3_2_vision_90b", "mamba2_780m"])
def test_f32_cache_prefill_decode_consistency(cuda, arch):
    """``repro``'s consistency case on the card under an f32 KV cache (K2
    appending raw bits, K6 reading them): prefill of 8 and 8 decode steps
    against the full forward over 16 tokens, within 2e-2 (moe at capacity
    factor E, the vlm's gates nonzero)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import QuantPolicy

    cfg = configs.get_smoke(arch).with_(quant=QuantPolicy(kv_cache="f32", activations="f32"))
    if cfg.family == "moe":
        cfg = cfg.with_(moe_capacity_factor=float(cfg.num_experts))
    params = T.init_params(cfg, 2, device=cuda)
    media = None
    if cfg.family == "vlm":
        _gate_on(params, 170)
        media = _rand((2, cfg.num_media_tokens, cfg.media_d), 171).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    full, _ = T.forward(cfg, params, tokens, media)
    last, cache = T.prefill(cfg, params, tokens[:, :8], media, cache_len=16)
    assert torch.allclose(last, full[:, 7], rtol=2e-2, atol=2e-2)
    ops.reset_launch_counts()
    for t in range(8, 16):
        lg, cache = T.decode_step(cfg, params, tokens[:, t], cache, media)
        assert torch.allclose(lg, full[:, t], rtol=2e-2, atol=2e-2), t
    if cfg.family != "ssm":
        assert ops.launch_counts()["takum_decode_attention[bits]"] == 8 * cfg.num_layers
    ops.reset_launch_counts()


@pytest.mark.gpu
def test_prefill_takes_a_sliced_prompt(cuda):
    """A prompt sliced from a longer token tensor (``tokens[:, :8]``, not
    contiguous) through a packed embedding on the card: K1 reads the ids
    made contiguous, the same logits and cache as from a contiguous copy."""
    import dataclasses

    from repro_torch import configs, serve
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES

    cfg = configs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(POLICIES["takum"], activations="f32"))
    qp = serve.load_params(serve.quantize_params(cfg, T.init_params(cfg, 8, device=cuda)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda)
    sliced = tokens[:, :8]
    assert not sliced.is_contiguous()
    a, ca = T.prefill(cfg, qp, sliced, cache_len=10)
    b, cb = T.prefill(cfg, qp, sliced.contiguous(), cache_len=10)
    assert torch.equal(a, b) and torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)


@pytest.mark.gpu
def test_capture_resolves_event_spans_and_adds_no_launch(cuda):
    """Under a telemetry capture an op's span is a pair of CUDA events that
    stays unresolved until ``snapshot()``, a device count stays on the card
    until then, and the capture launches no kernel of the port: the same
    ``launch_counts()`` and the same bits as the uncaptured call."""
    from repro_torch.core import telemetry
    from repro_torch.core.formats import count_specials

    x = _rand((4, 256), 1).to(cuda)
    w = takum_encode_2d(_rand((256, 512), 2), "t8").to(cuda)
    ops.reset_launch_counts()
    want = ops.matmul(x, w, "t8")
    base = ops.launch_counts()
    ops.reset_launch_counts()
    with telemetry.capture():
        got = ops.matmul(x, w, "t8")
        telemetry.emit("t.specials", count_specials(w, "t8"))
        assert len(telemetry._EVENT_SPANS) == 1 and len(telemetry._PENDING) == 1
        snap = telemetry.snapshot()
        assert not telemetry._EVENT_SPANS and not telemetry._PENDING
    (sp,) = snap["spans"]
    assert sp["name"] == "kernel.matmul.t8" and sp["cat"] == "kernel" and sp["t1"] > sp["t0"]
    assert snap["counters"]["kernel.calls.matmul.t8"] == 1.0
    assert snap["counters"]["t.specials"] == float(count_specials(w.cpu(), "t8"))
    assert ops.launch_counts() == base
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the executable takum ISA
# ---------------------------------------------------------------------------

def _roll1(t):
    """``t`` rolled by one, through the signed view (CUDA builds of torch
    have no roll on uint16)."""
    dt = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return torch.roll(t.view(dt), 1).view(t.dtype)


ISA_CALLS = {
    "VADDT": lambda f, a, b, n: f(a, b, n), "VSUBT": lambda f, a, b, n: f(a, b, n),
    "VMULT": lambda f, a, b, n: f(a, b, n), "VDIVT": lambda f, a, b, n: f(a, b, n),
    "VMINT": lambda f, a, b, n: f(a, b, n), "VMAXT": lambda f, a, b, n: f(a, b, n),
    "VCMPT": lambda f, a, b, n: f(a, b, n, "le"),
    "VFMADDT": lambda f, a, b, n: f(a, b, _roll1(b), n),
    "VSQRTT": lambda f, a, b, n: f(a, n), "VNEGT": lambda f, a, b, n: f(a, n),
    "VABST": lambda f, a, b, n: f(a, n), "VCVTPT2PS": lambda f, a, b, n: f(a, n),
    "VCVTT2T": lambda f, a, b, n: f(a, n, 24 - n),
    "VCVTPS2PT": lambda f, a, b, n: f(torch.cat([ops.decode(a, f"t{n}"), _rand(4096, 3).to(a.device)]), n),
    "VDPPT": lambda f, a, b, n: f(a.reshape(-1, 64), b.reshape(-1, 64), n),
}
#: the families that decode or encode through K1 / K2
ISA_CODEC = {"VADDT", "VSUBT", "VMULT", "VDIVT", "VFMADDT", "VSQRTT", "VCVTPT2PS", "VCVTPS2PT",
             "VDPPT"}


def _isa_pairs(n, dev):
    """t8: every (a, b) pair; t16: 2^16 seeded pairs."""
    from repro_torch.core.takum import pack

    if n == 8:
        c = torch.arange(1 << 16, dtype=torch.int64)
        a, b = c >> 8, c & 0xFF
    else:
        g = torch.Generator().manual_seed(16)
        a, b = (torch.randint(0, 1 << 16, (1 << 16,), generator=g) for _ in range(2))
    return pack(a, n).to(dev), pack(b, n).to(dev)


def _same_out(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
    elif got.dtype == torch.bool:
        assert torch.equal(got, want)
    else:
        w = got.element_size()
        dt = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[w]
        assert torch.equal(got.view(dt), want.view(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("n", (8, 16))
@pytest.mark.parametrize("name", list(ISA_CALLS))
def test_isa_family_on_card_equals_its_plain_path(cuda, name, n):
    from repro_torch.core import isa

    a, b = _isa_pairs(n, cuda)
    run = lambda a, b: ISA_CALLS[name](isa.REGISTRY[name], a, b, n)
    ops.reset_launch_counts()
    got = run(a, b)
    torch.cuda.synchronize()
    launched = sum(ops.launch_counts().values())
    assert (launched > 0) == (name in ISA_CODEC), (name, ops.launch_counts())
    with ops.plain_path():
        _same_out(got, run(a, b))
    _same_out(got.cpu(), run(a.cpu(), b.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("n", (5, 12, 24))
def test_isa_integer_families_short_of_their_container_on_card(cuda, n):
    """The decode-free families at widths that do not fill their storage
    dtype (keys sign-extended by shifts in the signed container), and on
    int64 codes, equal the host's."""
    from repro_torch.core import isa
    from repro_torch.core.takum import pack

    g = torch.Generator().manual_seed(n)
    a64, b64 = (torch.randint(0, 1 << n, (1 << 16,), generator=g) for _ in range(2))
    for a, b in ((pack(a64, n), pack(b64, n)), (a64, b64)):
        for name in ("VMINT", "VMAXT"):
            f = isa.REGISTRY[name]
            _same_out(f(a.to(cuda), b.to(cuda), n).cpu(), f(a, b, n))
        for op in ("lt", "eq", "ge"):
            _same_out(isa.vcmpt(a.to(cuda), b.to(cuda), n, op).cpu(), isa.vcmpt(a, b, n, op))
        for f in (isa.vnegt, isa.vabst):
            _same_out(f(a.to(cuda), n).cpu(), f(a, n))
        for m in (n // 2, min(2 * n, 32)):
            _same_out(isa.vcvtt2t(a.to(cuda), n, m).cpu(), isa.vcvtt2t(a, n, m))


@pytest.mark.gpu
def test_isa_t32_decode_on_card_equals_host(cuda):
    from repro_torch.core import isa, takum

    g = torch.Generator().manual_seed(32)
    codes = takum.pack(torch.randint(0, 1 << 32, (1 << 20,), generator=g), 32)
    got = isa.vcvtpt2ps(codes.to(cuda), 32)
    _same_out(got.cpu(), isa.vcvtpt2ps(codes, 32))
    _same_out(ops.decode(codes.to(cuda), "t32").cpu(), takum.takum_decode(codes, 32))
    x = _rand(1 << 16, 4) * 1e3
    _same_out(isa.vcvtps2pt(x.to(cuda), 32).cpu(), isa.vcvtps2pt(x, 32))
    lg = isa.vcvtpt2ps(codes.to(cuda), 32, mode="log").cpu()
    lh = isa.vcvtpt2ps(codes, 32, mode="log")
    ok = ~torch.isnan(lh)
    assert torch.equal(torch.isnan(lg), ~ok)
    assert int((lg[ok].view(torch.int32).long() - lh[ok].view(torch.int32).long()).abs().max()) <= 4
