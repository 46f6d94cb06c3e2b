#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) device: CUDA present; print the card's name and power limit.
  (b) build: compile every kernel from src/repro_torch/kernels/csrc.
  (c) kernels against their plain PyTorch versions, for t8, t16, e4m3, e5m2
      and bf16: K1 over every code and K2 over an f32 sweep, both also at the
      serving shapes and over one packed weight (all bit for bit); K3 at the
      serving shapes and ragged shapes, within 4e-6 of |x| @ |w| (a limit
      two lossy t16 controls must exceed); K6 at the serving shape with
      length < S.  Then the mx containers mxe4m3, mxe5m2 and mxt8: K1-mx over
      every element code under every scale byte and K2-mx over a block sweep
      (zero, NaN, Inf and subnormal blocks, absmax near 2^-126 and 2^127,
      values above the cap), both again at [8192, 128] and [4096, 14336], bit
      for bit; K3-mx at ragged N (100, 4096) and, for mxt8, at the serving
      shapes; K6-mx at the serving shape and at head dims 16 and 80.  Each
      is timed with CUDA events.
  (d) serving: llama3-8b at full width and depth, random weights from a
      seed, B=4, a 256-token prompt and 32 greedy decode steps, with every
      kernel's launch count read around each run: first the takum policy
      (t16 weights, t8 KV cache), then mxfp8 (bf16 weights, mxe4m3 KV cache:
      K2-mx appends, K6-mx reads).
  (e) model parity: full width, 2 layers, takum, ofp8, mxfp8 and mxt8
      (mxt8 weights and KV cache: K1-mx, K2-mx, K3-mx and K6-mx), kernel path
      against the plain path (``ops.plain_path()``) on the same inputs,
      with the kernel path's launches counted.

Stdout ends with the card line, one JSON line of kernel measurements and
the result line {"ok": true, "device": {...}}.  The script exits nonzero,
without that line, when CUDA is absent, when src/repro_torch is not beside
it, or when any phase fails.  Detailed rows go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")
MX_FMTS = ("mxe4m3", "mxe5m2", "mxt8")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores with f32 accumulation, dense
#: K3's limit on |kernel - plain| as a share of (|x| @ |w|): about 8x the
#: largest reading of a sound kernel (f32 sums in another order) and 5x
#: below the t16 controls of phase (c), which lose bits K3 must keep
K3_LIMIT = 4e-6


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps=20, warmup=3, flush=None):
    """Median ms of ``reps`` launches of ``fn`` (CUDA events around each,
    the L2 flushed before each by writing ``flush``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def tf32(torch, t):
    """f32 ``t`` rounded to TF32's 10 fraction bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def bound(nbytes, flops, rate=F32_FLOPS):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def matmul_rate(torch, fmt, xdt):
    """The card's peak for K3's products: bf16 tensor cores where x is bf16
    and every decoded weight is exact in bf16, i.e. every format but t16
    (8-bit elements carry at most 4 significant bits, and a decoded product
    is a normal f32 or flushed, inside bf16's exponent range); else f32 FMA
    (t16's 12 significant bits fit neither bf16 nor TF32, an f32 x fits no
    tensor-core type)."""
    return BF16_FLOPS if xdt == torch.bfloat16 and fmt != "t16" else F32_FLOPS


# ---------------------------------------------------------------------------
# phase (c): kernels against plain versions
# ---------------------------------------------------------------------------


def same_bits_f32(torch, a, b):
    """Equal f32 bits with NaN matching NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    return torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))


def as_i64(torch, bits):
    wf_bits = bits.element_size() * 8
    signed = {8: torch.uint8, 16: torch.int16, 32: torch.int32}[wf_bits]
    return bits.view(signed).to(torch.int64) & ((1 << wf_bits) - 1)


def all_codes(torch, wf, dev):
    """Every code of ``wf`` as a [n/256, 256] storage tensor on ``dev``
    (16-bit codes made through the signed view)."""
    c = torch.arange(1 << wf.nbits, device=dev, dtype=torch.int64)
    if wf.nbits == 16:
        c = torch.where(c >= 1 << 15, c - (1 << 16), c)
    return c.to(wf.signed_storage).view(wf.storage).reshape(-1, 256)


def encode_sweep(torch, fmt, dev, gen):
    """f32 inputs for K2: random binades, specials, DAZ subnormals, the f32
    rails, random bit patterns and every tie between neighbouring codes."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_codec import decode_2d_plain

    n = 1 << 16
    mant = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) + 1.0
    expo = torch.randint(-130, 128, (n,), generator=gen, device=dev).to(torch.float64)
    sign = torch.randint(0, 2, (n,), generator=gen, device=dev).to(torch.float64) * 2 - 1
    x = (mant * torch.exp2(expo) * sign).to(torch.float32)
    raw = torch.randint(-(2 ** 31), 2 ** 31 - 1, (n,), generator=gen, device=dev,
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    f32 = torch.finfo(torch.float32)
    specials = torch.tensor(
        [0.0, -0.0, math.inf, -math.inf, math.nan, f32.max, -f32.max, f32.tiny,
         -f32.tiny, 1e-45, -1e-45, 1e-40, -1e-40, 1.0, 448.0, 464.0, 480.0, 57344.0,
         61440.0, 3.4e38], dtype=torch.float32, device=dev)
    wf = wire_format(fmt)
    vals = decode_2d_plain(all_codes(torch, wf, dev), fmt).reshape(-1)
    vals = torch.unique(vals[torch.isfinite(vals) & (vals > 0)]).to(torch.float64)
    mids = ((vals[1:] + vals[:-1]) / 2).to(torch.float32)
    ties = torch.cat([mids, torch.nextafter(mids, torch.full_like(mids, math.inf)),
                      torch.nextafter(mids, torch.zeros_like(mids))])
    return torch.cat([x, raw, specials, ties, -ties])


def phase_kernels(torch, dev, rows):
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_attention import decode_attention_plain, takum_decode_attention
    from repro_torch.kernels.takum_codec import (decode_2d_plain, encode_2d_plain,
                                                 takum_decode_2d, takum_encode_2d)
    from repro_torch.kernels.takum_matmul import takum_matmul, takum_matmul_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    F = torch.nn.functional

    for fmt in FMTS:
        wf = wire_format(fmt)
        # K1: every code, bit for bit (NaN matches NaN)
        codes = all_codes(torch, wf, dev)
        check(same_bits_f32(torch, takum_decode_2d(codes, fmt), decode_2d_plain(codes, fmt)),
              f"K1 {fmt}: kernel decode differs from the plain decode")
        # K2: f32 sweep, bit for bit
        x = encode_sweep(torch, fmt, dev, gen)
        x = torch.cat([x, x.new_zeros(-x.numel() % 64)]).reshape(-1, 64)
        got, want = takum_encode_2d(x, fmt), encode_2d_plain(x, fmt)
        nbad = int((as_i64(torch, got) != as_i64(torch, want)).sum())
        check(nbad == 0, f"K2 {fmt}: {nbad} of {x.numel()} codes differ from the plain encode")
        log(f"K1/K2 {fmt}: {codes.numel()} codes and {x.numel()} f32 inputs bit-exact")

        # K1 / K2 at the serving shapes, bit for bit: the embedding rows
        # [B*S0, d] (4.2 M elements, past the grid cap of csrc/takum_codec.cu,
        # so threads take the grid-stride step) and the KV block [B*S0*Kv, hd]
        for kname, shape in (("takum_decode_2d", (1024, 4096)), ("takum_encode_2d", (8192, 128))):
            xf = torch.randn(shape, generator=gen, device=dev)
            bits = encode_2d_plain(xf, fmt)
            if kname == "takum_decode_2d":
                kern, plain, arg = takum_decode_2d, decode_2d_plain, bits
                got, want = takum_decode_2d(bits, fmt), decode_2d_plain(bits, fmt)
                check(same_bits_f32(torch, got, want), f"K1 {fmt} {shape}: differs from plain")
                err = (got - want).abs().max()
                nbytes = bits.numel() * (wf.nbits // 8 + 4)
                lib = (lambda: bits.view(torch.bfloat16).float()) if fmt == "bf16" else None
            else:
                kern, plain, arg = takum_encode_2d, encode_2d_plain, xf
                got = takum_encode_2d(xf, fmt)
                nbad = int((as_i64(torch, got) != as_i64(torch, bits)).sum())
                check(nbad == 0, f"K2 {fmt} {shape}: {nbad} codes differ from plain")
                err = (decode_2d_plain(got, fmt) - decode_2d_plain(bits, fmt)).abs().max()
                nbytes = xf.numel() * (4 + wf.nbits // 8)
                lib = (lambda: xf.to(torch.bfloat16)) if fmt == "bf16" else None
            b_ms, b_by = bound(nbytes, 0)
            rows.append(dict(
                kernel=kname, fmt=fmt, shape=list(shape), max_abs_err=float(err),
                ms=time_ms(torch, lambda: kern(arg, fmt), flush=flush),
                plain_ms=time_ms(torch, lambda: plain(arg, fmt), flush=flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib, flush=flush) if lib else None))

        # K2 packing one weight [d, d_ff] (58.7 M elements, many grid-stride
        # steps per thread) and K1 decoding it back, both bit for bit
        xf = torch.randn((4096, 14336), generator=gen, device=dev) * 4096 ** -0.5
        want = encode_2d_plain(xf, fmt)
        nbad = int((as_i64(torch, takum_encode_2d(xf, fmt)) != as_i64(torch, want)).sum())
        check(nbad == 0, f"K2 {fmt} [4096, 14336]: {nbad} codes differ from plain")
        check(same_bits_f32(torch, takum_decode_2d(want, fmt), decode_2d_plain(want, fmt)),
              f"K1 {fmt} [4096, 14336]: differs from plain")
        del xf, want
        log(f"K1/K2 {fmt}: bit-exact at [1024, 4096], [8192, 128] and [4096, 14336]")

        # K3 at the takum serving shapes (bf16 activations: decode M=4,
        # prefill M=B*S0=1024) and ragged shapes for each tile size with f32
        # and bf16 x.  Limit K3_LIMIT * (|x| @ |w|); for t16 two controls
        # that lose precision K3 must keep (decoded weights rounded to bf16;
        # both operands rounded to TF32) must exceed it.
        K = 4096
        shapes = [(M, K, N, torch.bfloat16) for M in (4, 1024) for N in (1024, 4096, 14336, 128256)]
        shapes += [(M, 1000, 777, dt) for M in (5, 37) for dt in (torch.float32, torch.bfloat16)]
        for M, K_, N, xdt in shapes:
            xm = torch.randn((M, K_), generator=gen, device=dev).to(xdt)
            w = encode_2d_plain(torch.randn((K_, N), generator=gen, device=dev) * 0.5, fmt)
            got = takum_matmul(xm, w, fmt)
            want = takum_matmul_plain(xm, w, fmt)
            wd = decode_2d_plain(w, fmt)
            scale = torch.matmul(xm.float().abs(), wd.abs())
            ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
            tag = f"K3 {fmt} {M}x{K_}x{N} x {str(xdt)[6:]}"
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
            check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
            row = dict(kernel="takum_matmul", fmt=fmt, shape=[M, K_, N], x=str(xdt)[6:],
                       max_abs_err=float((got - want).abs().max()), err_over_absprod=ratio)
            del got
            if fmt == "t16" and K_ == K:
                for name, ctrl in (
                        ("bf16_weights", lambda: torch.matmul(xm.float(), wd.bfloat16().float())),
                        ("tf32_operands", lambda: torch.matmul(tf32(torch, xm.float()), tf32(torch, wd)))):
                    c = float(((ctrl() - want).abs() / scale.clamp(min=1e-30)).max())
                    check(c > K3_LIMIT, f"{tag}: control {name} ({c:.3g}) passes the limit")
                    row[f"control_{name}_over_absprod"] = c
            xb = xm.element_size()
            b_ms, b_by = bound(M * K_ * xb + K_ * N * wf.nbits // 8 + M * N * 4, 2.0 * M * N * K_,
                               matmul_rate(torch, fmt, xdt))
            row.update(
                ms=time_ms(torch, lambda: takum_matmul(xm, w, fmt), flush=flush),
                plain_ms=time_ms(torch, lambda: takum_matmul_plain(xm, w, fmt), flush=flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lambda: torch.matmul(xm.float(), wd), flush=flush))
            rows.append(row)
            del wd, scale, want
        log(f"K3 {fmt}: {len(shapes)} shapes within {K3_LIMIT} of |x|@|w|")

        # K6: B=4, H=32, Kv=8, hd=128 over the cache's [B, S, Kv, hd] layout, S=288
        B, H, Kv, hd, S = 4, 32, 8, 128, 288
        cache = encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
        kc = cache.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        vcache = encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
        vc = vcache.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        vmax = float(decode_2d_plain(vcache, fmt).abs().max())
        for length, window, cap in ((270, 0, 0.0), (S, 0, 0.0), (200, 64, 30.0)):
            got = takum_decode_attention(q, kc, vc, fmt, length=length, window=window, softcap=cap)
            want = decode_attention_plain(q, kc, vc, fmt, length, window, cap)
            err = float((got - want).abs().max())
            check(err <= 1e-5 * vmax, f"K6 {fmt} length={length}: err {err} > 1e-5 max|v|")
            if length != S:
                continue
            kf = decode_2d_plain(cache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
            vf = decode_2d_plain(vcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
            kf = kf.repeat_interleave(H // Kv, dim=1).contiguous()
            vf = vf.repeat_interleave(H // Kv, dim=1).contiguous()
            q4 = q[:, :, None, :]
            nbytes = q.numel() * 4 * 2 + 2 * B * Kv * length * hd * wf.nbits // 8
            b_ms, b_by = bound(nbytes, 4.0 * B * H * length * hd)
            rows.append(dict(
                kernel="takum_decode_attention", fmt=fmt, shape=[B, H, Kv, S, hd],
                length=length, max_abs_err=err,
                ms=time_ms(torch, lambda: takum_decode_attention(q, kc, vc, fmt, length=length),
                           flush=flush),
                plain_ms=time_ms(torch, lambda: decode_attention_plain(q, kc, vc, fmt, length),
                                 flush=flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q4, kf, vf),
                                   flush=flush)))
        log(f"K6 {fmt}: within 1e-5 max|v| at length 270, 288 and a window of 64")
    del flush


def phase_mx_kernels(torch, dev, rows):
    """K1-mx, K2-mx, K3-mx and K6-mx against their plain versions."""
    from repro_torch.kernels.takum_attention import decode_attention_plain, takum_decode_attention
    from repro_torch.kernels.takum_codec import (decode_2d_plain, encode_2d_plain,
                                                 takum_decode_2d, takum_encode_2d)
    from repro_torch.kernels.mx_cases import mx_all_codes, mx_sweep
    from repro_torch.kernels.takum_matmul import takum_matmul, takum_matmul_plain
    from repro_torch.quant import blockscale

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    F = torch.nn.functional
    plen = blockscale.payload_len

    for fmt in MX_FMTS:
        codes = mx_all_codes(dev)
        check(same_bits_f32(torch, takum_decode_2d(codes, fmt), decode_2d_plain(codes, fmt)),
              f"K1-mx {fmt}: kernel decode differs from the plain decode")
        x = mx_sweep(gen, 1 << 13).reshape(-1, 64)
        got, want = takum_encode_2d(x, fmt), encode_2d_plain(x, fmt)
        nbad = int((got != want).sum())
        check(nbad == 0, f"K2-mx {fmt}: {nbad} of {want.numel()} payload bytes differ from plain")
        log(f"K1-mx/K2-mx {fmt}: 65536 codes x scales and {x.numel() // 32} blocks bit-exact")

        # the serving shapes: the prefill's KV append [B*S0*Kv, hd], the
        # embedding rows [B*S0, d] and one packed weight [d, d_ff] (past the
        # kernels' grid cap), encode and decode each bit for bit
        for shape in ((8192, 128), (1024, 4096), (4096, 14336)):
            xf = torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5
            bits = encode_2d_plain(xf, fmt)
            nbad = int((takum_encode_2d(xf, fmt) != bits).sum())
            check(nbad == 0, f"K2-mx {fmt} {shape}: {nbad} payload bytes differ from plain")
            dec = takum_decode_2d(bits, fmt)
            check(same_bits_f32(torch, dec, decode_2d_plain(bits, fmt)),
                  f"K1-mx {fmt} {shape}: differs from plain")
            nel, npay = xf.numel(), bits.numel()
            for kname, kern, plain, arg, nbytes in (
                    ("takum_decode_2d", takum_decode_2d, decode_2d_plain, bits, npay + 4 * nel),
                    ("takum_encode_2d", takum_encode_2d, encode_2d_plain, xf, 4 * nel + npay)):
                if shape == (4096, 14336):
                    continue  # checked only: no serving call has this shape
                b_ms, b_by = bound(nbytes, 0)
                rows.append(dict(
                    kernel=kname, fmt=fmt, shape=list(shape), max_abs_err=0.0,
                    ms=time_ms(torch, lambda: kern(arg, fmt), flush=flush),
                    plain_ms=time_ms(torch, lambda: plain(arg, fmt), flush=flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None))
            del xf, bits, dec
        log(f"K1-mx/K2-mx {fmt}: bit-exact at [8192, 128], [1024, 4096] and [4096, 14336]")

        # K3-mx: ragged N (a padded last group) at both tile sizes with f32
        # and bf16 x; for mxt8 also the serving shapes of the mxt8 policy
        # (bf16 x, M = 4 decode and M = 1024 prefill, d_ff and the head)
        shapes = [(M, 1000, N, dt) for M in (5, 37) for N in (100, 4096)
                  for dt in (torch.float32, torch.bfloat16)]
        if fmt == "mxt8":
            shapes += [(M, 4096, N, torch.bfloat16) for M in (4, 1024) for N in (14336, 128256)]
        for M, K_, N, xdt in shapes:
            xm = torch.randn((M, K_), generator=gen, device=dev).to(xdt)
            w = encode_2d_plain(blockscale.pad_block(
                torch.randn((K_, N), generator=gen, device=dev) * K_ ** -0.5), fmt)
            got = takum_matmul(xm, w, fmt, n=N)
            want = takum_matmul_plain(xm, w, fmt, n=N)
            wd = decode_2d_plain(w, fmt)[:, :N]
            scale = torch.matmul(xm.float().abs(), wd.abs())
            ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
            tag = f"K3-mx {fmt} {M}x{K_}x{N} x {str(xdt)[6:]}"
            check(tuple(got.shape) == (M, N), f"{tag}: shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
            check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
            row = dict(kernel="takum_matmul", fmt=fmt, shape=[M, K_, N], x=str(xdt)[6:],
                       max_abs_err=float((got - want).abs().max()), err_over_absprod=ratio)
            del got, scale, want
            if K_ == 4096:
                b_ms, b_by = bound(M * K_ * xm.element_size() + K_ * plen(N) + M * N * 4,
                                   2.0 * M * N * K_, matmul_rate(torch, fmt, xdt))
                row.update(
                    ms=time_ms(torch, lambda: takum_matmul(xm, w, fmt, n=N), flush=flush),
                    plain_ms=time_ms(torch, lambda: takum_matmul_plain(xm, w, fmt, n=N),
                                     flush=flush),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(torch, lambda: torch.matmul(xm.float(), wd), flush=flush))
            rows.append(row)
            del wd, w
        log(f"K3-mx {fmt}: {len(shapes)} shapes within {K3_LIMIT} of |x|@|w|")

        # K6-mx over the cache's [B, S, Kv, payload_len(hd)] layout, S = 288,
        # at hd = 128 (the serving shape) and the head dims 16 and 80, whose
        # last group is padded
        B, H, Kv, S = 4, 32, 8, 288
        for hd in (128, 16, 80):
            def cache_of():
                xc = torch.randn((B * S * Kv, hd), generator=gen, device=dev)
                return encode_2d_plain(blockscale.pad_block(xc), fmt)
            kcache, vcache = cache_of(), cache_of()
            kc = kcache.reshape(B, S, Kv, -1).permute(0, 2, 1, 3)
            vc = vcache.reshape(B, S, Kv, -1).permute(0, 2, 1, 3)
            q = torch.randn((B, H, hd), generator=gen, device=dev)
            vmax = float(decode_2d_plain(vcache, fmt)[:, :hd].abs().max())
            for length, window, cap in ((270, 0, 0.0), (S, 0, 0.0), (270, 64, 30.0)):
                got = takum_decode_attention(q, kc, vc, fmt, length=length, window=window,
                                             softcap=cap)
                want = decode_attention_plain(q, kc, vc, fmt, length, window, cap)
                err = float((got - want).abs().max())
                check(err <= 1e-5 * vmax, f"K6-mx {fmt} hd={hd} length={length} window={window}: "
                                          f"err {err} > 1e-5 max|v|")
                if length != S or hd != 128:
                    continue
                kf = decode_2d_plain(kcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
                vf = decode_2d_plain(vcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
                kf = kf.repeat_interleave(H // Kv, dim=1).contiguous()
                vf = vf.repeat_interleave(H // Kv, dim=1).contiguous()
                q4 = q[:, :, None, :]
                nbytes = q.numel() * 4 * 2 + 2 * B * Kv * length * plen(hd)
                b_ms, b_by = bound(nbytes, 4.0 * B * H * length * hd)
                rows.append(dict(
                    kernel="takum_decode_attention", fmt=fmt, shape=[B, H, Kv, S, hd],
                    length=length, max_abs_err=err,
                    ms=time_ms(torch, lambda: takum_decode_attention(q, kc, vc, fmt, length=length),
                               flush=flush),
                    plain_ms=time_ms(torch, lambda: decode_attention_plain(q, kc, vc, fmt, length),
                                     flush=flush),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(q4, kf, vf),
                                       flush=flush)))
        log(f"K6-mx {fmt}: within 1e-5 max|v| at hd 128, 16 and 80, length 270 and 288, "
            f"a window of 64 with a softcap")
    del flush


# ---------------------------------------------------------------------------
# phase (d): full-depth serving; phase (e): kernel path vs plain path
# ---------------------------------------------------------------------------


def packed_params(torch, cfg, seed):
    from repro_torch import serve
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, seed, device="cuda")
    qp = serve.quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    return qp


def phase_serving(torch, dev, policy):
    """Full-depth serving under ``policy``, counted: launches reset just
    before the prefill and read just after the last decode step."""
    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.quant.policy import POLICIES

    cfg = configs.get("llama3_8b").with_(quant=POLICIES[policy])
    B, S0, STEPS = 4, 256, 32
    t0 = time.perf_counter()
    qp = serve.load_params(packed_params(torch, cfg, seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
    prefill = serve.make_prefill_step(cfg, cache_len=S0 + STEPS + 2)
    step = serve.make_serve_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(qp, {"tokens": prompt})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = []
    for _ in range(STEPS):
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok)
        logits, cache = step(qp, {"token": tok}, cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()

    check(tuple(logits.shape) == (B, cfg.vocab_size), f"{policy}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{policy}: non-finite logits after decoding")
    L = cfg.num_layers
    calls = 1 + STEPS
    check(counts["takum_decode_attention"] == L * STEPS, f"{policy}: K6 launches {counts}")
    check(counts["takum_encode_2d"] >= 2 * L * calls, f"{policy}: K2 launches {counts}")
    if policy == "takum":
        check(counts["takum_matmul"] >= 7 * L * calls, f"{policy}: K3 launches {counts}")
        check(counts["takum_decode_2d"] == calls, f"{policy}: K1 launches {counts}")  # embedding rows
    else:  # mxfp8: bf16 weights, so every linear is torch.matmul
        check(counts["takum_matmul"] == 0 and counts["takum_decode_2d"] == 0,
              f"{policy}: K1/K3 launches {counts}")
    check(cache.pos == S0 + STEPS, f"{policy}: cache.pos {cache.pos}")
    decode_s = t2 - t1
    trace = profile_decode(torch, step, qp, logits, cache)
    if trace["device_busy_ms"]:
        # the profiler's host overhead stretches its own wall; the counted
        # decode window above ran unprofiled
        trace["idle_share_of_counted_step"] = 1 - trace["device_busy_ms"] / 2 / (
            decode_s / STEPS * 1e3)
    out = dict(
        arch=cfg.name, policy=policy, weights=cfg.quant.weights, kv_cache=cfg.quant.kv_cache,
        layers=L, batch=B, prompt=S0, decode_steps=STEPS,
        init_and_pack_s=init_s, prefill_ms=(t1 - t0) * 1e3,
        decode_ms_per_token=decode_s / STEPS * 1e3, decode_tokens_per_s=B * STEPS / decode_s,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        weight_bytes=sum(_nbytes(v) for v in _leaves(qp)),
        kv_cache_bytes=cache.k.numel() * cache.k.element_size() * 2,
        launches=counts, first_tokens=[int(t) for t in torch.stack(tokens, 1)[0, :8]],
        profile_two_decode_steps=trace,
    )
    del qp, cache, logits
    torch.cuda.empty_cache()
    return out


def profile_decode(torch, step, qp, logits, cache):
    """Two more decode steps under torch.profiler (outside the counted run):
    device time by kernel and the device's idle share of the profiled wall
    time (which the profiler's own host work inflates)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            logits, cache = step(qp, {"token": torch.argmax(logits, -1)}, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy if busy else None,
                idle_share=(1 - busy / wall_ms) if busy else None,
                top_kernels_ms=[[k[:80], v] for k, v in top])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(leaf):
    t = getattr(leaf, "bits", leaf)
    return t.numel() * t.element_size()


def phase_parity(torch, dev):
    """Full width, 2 layers: kernel path vs plain path, teacher-forced with
    the kernel path's greedy tokens.  Tolerance on max|diff| / max|logit|
    per step: 1e-3 at f32 activations (accumulation order, plus the 8-bit
    KV codes that an order ulp moves across a rounding boundary: one t8
    code step is about 12 % of the value), 5e-2 at bf16 activations (an
    order ulp can also flip the bf16 rounding of an activation, about 2^-8
    relative, and the flip propagates).  At f32 activations the two paths'
    greedy tokens must agree at every step.

    Control, at f32 for the policies whose linears run through K3 (takum,
    mxt8): a third run of the plain path with its matmuls accumulated in
    f64, an equally valid order.  How far it moves the plain path measures
    the model's own order sensitivity, and the kernel path must lie within
    1e-3 of it.  Under mxt8 that sensitivity reached 1.3e-3 (the plain path
    against its f64 twin, measured by this phase on an H100 80GB HBM3 at
    700 W), so its kernel-vs-plain limit is 2e-3.

    The kernel path's launches are counted (reset just before it, read just
    after): under mxt8 this is the path that drives K1-mx and K3-mx."""
    import contextlib
    import dataclasses

    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.quant.policy import POLICIES, QuantPolicy

    policies = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}
    routes = {"kernel": contextlib.nullcontext, "plain": ops.plain_path,
              "plain_f64": lambda: ops.plain_path(torch.float64)}

    B, S0, STEPS = 4, 64, 8
    results = []
    for policy in ("takum", "ofp8", "mxfp8", "mxt8"):
        for act, tol in (("f32", 2e-3 if policy == "mxt8" else 1e-3), ("bf16", 5e-2)):
            quant = dataclasses.replace(policies[policy], activations=act)
            cfg = configs.get("llama3_8b").with_(num_layers=2, quant=quant)
            qp = packed_params(torch, cfg, seed=1)
            gen = torch.Generator(device=dev)
            gen.manual_seed(11)
            prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
            runs = {}
            fed = None
            paths = ("kernel", "plain")
            if act == "f32" and quant.weights in ("t16", "mxt8"):
                paths += ("plain_f64",)
            for path in paths:
                ops.reset_launch_counts()
                with routes[path]():
                    lp = serve.load_params(qp)
                    logits, cache = serve.make_prefill_step(cfg, S0 + STEPS)(lp, {"tokens": prompt})
                    outs, toks = [logits], []
                    for i in range(STEPS):
                        tok = torch.argmax(logits, -1) if fed is None else fed[i]
                        toks.append(tok)
                        logits, cache = serve.make_serve_step(cfg)(lp, {"token": tok}, cache)
                        outs.append(logits)
                    torch.cuda.synchronize()
                if path == "kernel":
                    counts = ops.launch_counts()
                fed = toks
                runs[path] = torch.stack(outs)
            k, p = runs["kernel"], runs["plain"]
            check(bool(torch.isfinite(k).all()), f"{policy}/{act}: non-finite kernel-path logits")

            def rel(a, b):
                return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).tolist()

            errs = rel(k, p)
            agree = float((k.argmax(-1) == p.argmax(-1)).float().mean())
            res = dict(policy=policy, activations=act, tol=tol, max_rel_err=max(errs),
                       rel_err_per_step=errs, greedy_agreement=agree, launches=counts)
            if "plain_f64" in runs:
                res.update(control_f64_vs_plain=rel(runs["plain_f64"], p),
                           kernel_vs_f64=rel(k, runs["plain_f64"]))
            results.append(res)
            log(f"parity {policy}/{act}: max rel err {max(errs):.3e} (tol {tol}), "
                f"greedy agreement {agree:.3f}, kernel-path launches {counts}")
            check(max(errs) <= tol, f"{policy}/{act}: kernel vs plain {max(errs)} > {tol}")
            if "plain_f64" in runs:
                ctrl, kf = max(res["control_f64_vs_plain"]), max(res["kernel_vs_f64"])
                log(f"parity {policy}/{act}: control plain f64 vs plain {ctrl:.3e}, "
                    f"kernel vs plain f64 {kf:.3e} (limit 1e-3)")
                check(kf <= 1e-3, f"{policy}/{act}: kernel vs f64-accumulated plain {kf} > 1e-3")
            if act == "f32":
                check(agree == 1.0, f"{policy}/{act}: greedy tokens differ ({agree:.3f})")
            L, calls = cfg.num_layers, 1 + STEPS
            check(counts["takum_decode_attention"] == L * STEPS, f"{policy}/{act}: K6 {counts}")
            check(counts["takum_encode_2d"] >= 2 * L * calls, f"{policy}/{act}: K2 {counts}")
            if policy == "mxt8":
                check(counts["takum_matmul"] >= 7 * L * calls + calls, f"{policy}/{act}: K3 {counts}")
                check(counts["takum_decode_2d"] >= calls, f"{policy}/{act}: K1 {counts}")
            del qp, lp, runs, k, p
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------


KERNEL_INFO = {
    "takum_decode_2d": ("K1", "src/repro_torch/kernels/csrc/takum_codec.cu",
                        "src/repro/kernels/takum_codec.py:51"),
    "takum_encode_2d": ("K2", "src/repro_torch/kernels/csrc/takum_codec.cu",
                        "src/repro/kernels/takum_codec.py:61"),
    "takum_matmul": ("K3", "src/repro_torch/kernels/csrc/takum_matmul.cu",
                     "src/repro/kernels/takum_matmul.py:56"),
    "takum_decode_attention": ("K6", "src/repro_torch/kernels/csrc/takum_attention.cu",
                               "src/repro/kernels/takum_attention.py:56"),
}

#: (kernel, format, shape, path) rows that stand for each kernel in the
#: summary line: the shapes and formats each counted path gives each kernel.
#: Paths: "takum" and "mxfp8" are phase (d)'s full-depth runs, "mxt8" the
#: 2-layer kernel path of phase (e) under mxt8 weights and KV cache (bf16
#: activations, the policy's own)
SUMMARY = [
    ("takum_decode_2d", "t16", [1024, 4096], "takum"),
    ("takum_encode_2d", "t8", [8192, 128], "takum"),
    ("takum_matmul", "t16", [4, 4096, 14336], "takum"),
    ("takum_matmul", "t16", [1024, 4096, 14336], "takum"),
    ("takum_matmul", "t16", [4, 4096, 128256], "takum"),
    ("takum_decode_attention", "t8", [4, 32, 8, 288, 128], "takum"),
    ("takum_encode_2d", "mxe4m3", [8192, 128], "mxfp8"),
    ("takum_decode_attention", "mxe4m3", [4, 32, 8, 288, 128], "mxfp8"),
    ("takum_decode_2d", "mxt8", [1024, 4096], "mxt8"),
    ("takum_encode_2d", "mxt8", [8192, 128], "mxt8"),
    ("takum_matmul", "mxt8", [4, 4096, 14336], "mxt8"),
    ("takum_matmul", "mxt8", [1024, 4096, 14336], "mxt8"),
    ("takum_matmul", "mxt8", [4, 4096, 128256], "mxt8"),
    ("takum_decode_attention", "mxt8", [4, 32, 8, 288, 128], "mxt8"),
]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not readable"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")

    from repro_torch.kernels import _build
    _build.build_all()
    build_s = _build.last_build_seconds
    log(f"(b) kernels built in {build_s:.1f} s into {_build.build_dir()}")

    rows = []
    t0 = time.perf_counter()
    phase_kernels(torch, dev, rows)
    log(f"(c) flat kernels match their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_mx_kernels(torch, dev, rows)
    log(f"(c) mx kernels match their plain versions ({time.perf_counter() - t0:.1f} s)")

    serving = {}
    for policy in ("takum", "mxfp8"):
        t0 = time.perf_counter()
        serving[policy] = phase_serving(torch, dev, policy)
        log(f"(d) serving {policy} " + json.dumps(serving[policy]))
        log(f"(d) {policy} done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parity = phase_parity(torch, dev)
    log(f"(e) parity done in {time.perf_counter() - t0:.1f} s")

    launches = {p: serving[p]["launches"] for p in serving}
    launches["mxt8"] = next(r["launches"] for r in parity
                            if r["policy"] == "mxt8" and r["activations"] == "bf16")
    summary = []
    for kname, fmt, shape, path in SUMMARY:
        row = next(r for r in rows if r["kernel"] == kname and r["fmt"] == fmt and r["shape"] == shape)
        tag, source, replaces = KERNEL_INFO[kname]
        mx = "-mx" if fmt.startswith("mx") else ""
        check(launches[path][kname] > 0, f"{tag}{mx} was never launched on the {path} path")
        summary.append(dict(
            name=f"{tag}{mx} {kname} {fmt} {'x'.join(map(str, shape))}", route="cuda",
            source=source, replaces=replaces, path=path, launches=launches[path][kname],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, build_s=build_s,
             kernel_rows=rows, serving=serving, parity=parity,
             total_s=time.perf_counter() - t_start), indent=1))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
