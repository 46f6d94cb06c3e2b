#!/usr/bin/env python3
"""K1 and K2 (src/repro_torch/kernels/csrc/takum_codec.cu) on one GPU, as the
main path calls them, for one tree of this repository.

    python3 tools/codec_rows.py                      # this tree, the rows
    python3 tools/codec_rows.py --tree build/parent --tag parent
    python3 tools/codec_rows.py --launches           # also the decode step's launches

Rows (each checked bit for bit against its plain version before it is
timed): K1 over every flat format and mx container and codec at [1024,
4096] (the prefill's embedding rows) and [4096, 14336] (one packed weight
decoded back), K2 at [8192, 128] (the prefill's KV block) and [4096,
14336] (what ``serve.quantize_params`` packs per weight).  Then what the
model calls at the decode step: the KV append of one layer (K and V,
[4, 1, 8, 128] bf16 each, into a t8 / mxe4m3 cache at position 200 of 288)
through ``transformer._append_kv`` where the tree has it, else through the
composition it replaces (``_encode_cache`` then ``_put``, per tensor); and
the embedding rows through ``transformer._embed`` (4 token ids, and the
prefill's 4 x 256, from a [128256, 4096] table in t16, t8 and mxt8) to
bf16.  Each row carries ``ms`` (``chip_smoke.time_ms``: median of 20
calls, CUDA events, L2 flushed before each: at these sizes mostly the
host's launch path), ``device_ms`` (``chip_smoke.device_ms``: calls
replayed from a CUDA graph, flushes subtracted), the same two for the
library call where one PyTorch call computes the function (K1: the gather
from the decode table, bf16's shift; K2 over bf16: ``x.to(bfloat16)``),
``bound_ms`` (bytes read once and written once over 3.35 TB/s) and, for
the model's calls, the device kernels one call runs (``torch.profiler``).

``--launches`` serves llama3-8b at full depth under takum, takum8 and
mxfp8 (random weights, B = 4, a 16-token prompt) and counts, under
``torch.profiler``, the device kernels of one decode step after a warm
one, with the device's busy ms.  ``--serving`` runs the tree's own
``chip_smoke.phase_serving`` (B = 4, a 256-token prompt, 32 decode steps,
launches held to the tree's policy) under the same three policies and keeps
its prefill and decode times.

Only ``takum_codec.cu`` is built unless ``--launches`` is given.  The tree
builds into its own ``build/``.  Results go to
``chiprun_out/codec_rows_<tag>.json`` of this repository.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_tree(tree: Path, full_build: bool):
    """Import ``tree``'s ``repro_torch``; unless ``full_build``, make its
    ``_build.build_all`` compile ``takum_codec.cu`` alone."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build

    if not full_build:
        def build_codec_only():
            out = _build.build_dir()
            out.mkdir(parents=True, exist_ok=True)
            lib = out / "libtakum_codec.so"
            if not lib.exists():
                t0 = time.perf_counter()
                subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", str(lib),
                                str(_build._CSRC / "takum_codec.cu")], check=True)
                print(f"built takum_codec.cu in {time.perf_counter() - t0:.1f} s", flush=True)
            return out

        _build.build_all = build_codec_only
    return _build


def codec_rows(torch, cs, dev, out):
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_codec import (decode_2d_plain, encode_2d_plain,
                                                 takum_decode_2d, takum_encode_2d)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for fmt in cs.FMTS + cs.MX_FMTS:
        wf = wire_format(fmt)
        mx = wf.is_block_scaled
        for kname, shapes in (("takum_decode_2d", ((1024, 4096), (4096, 14336))),
                              ("takum_encode_2d", ((8192, 128), (4096, 14336)))):
            for shape in shapes:
                xf = torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5
                bits = encode_2d_plain(xf, fmt, "bits")
                nel, nst = xf.numel(), bits.numel() * bits.element_size()
                if kname == "takum_decode_2d":
                    impls, arg, kern, plain = cs.impls_of(fmt, "decode"), bits, takum_decode_2d, \
                        decode_2d_plain
                    lib = None if mx else ((lambda: bits.view(torch.bfloat16).float())
                                           if fmt == "bf16" else cs.gather_yardstick(torch, fmt, bits))
                else:
                    impls, arg, kern, plain = cs.impls_of(fmt, "encode"), xf, takum_encode_2d, \
                        encode_2d_plain
                    lib = (lambda: xf.to(torch.bfloat16)) if fmt == "bf16" else None
                b_ms, b_by = cs.bound(nst + 4 * nel, 0)
                lib_ms = cs.time_ms(torch, lib, flush=flush) if lib else None
                lib_dev = cs.device_ms(torch, lib, flush=flush) if lib else None
                for impl in impls:
                    got, want = kern(arg, fmt, impl), plain(arg, fmt, impl)
                    same = (cs.same_bits_f32(torch, got, want) if kname == "takum_decode_2d"
                            else torch.equal(cs.as_i64(torch, got), cs.as_i64(torch, want)))
                    cs.check(same, f"{kname}[{impl}] {fmt} {shape}: differs from plain")
                    del got, want
                    fn = lambda: kern(arg, fmt, impl)
                    row = dict(kernel=kname, fmt=fmt, impl=impl, shape=list(shape),
                               occupancy=occupancy(kname, wf, impl),
                               ms=cs.time_ms(torch, fn, flush=flush),
                               device_ms=cs.device_ms(torch, fn, flush=flush),
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                               library_device_ms=lib_dev)
                    out.append(row)
                    print(json.dumps(row), flush=True)
                del xf, bits
    del flush


def occupancy(kname, wf, impl):
    """(SMs, blocks per SM) of the kernel a 2-D launch ran, where the tree
    plans its grid from them (None otherwise)."""
    from repro_torch.kernels import takum_codec as tc

    if not hasattr(tc, "_occupancy"):
        return None
    return list(tc._occupancy(0 if kname == "takum_decode_2d" else 1, wf.code, impl, 0, 0))


def kernels_per_call(torch, fn):
    """Device kernels one call of ``fn`` runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if "CUDA" in str(getattr(ev, "device_type", "")))


def model_rows(torch, cs, dev, out):
    """The decode step's KV append of one layer and the embedding rows."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES
    from repro_torch.quant.qtensor import quantize

    gen = torch.Generator(device=dev)
    gen.manual_seed(2021)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    B, Kv, hd, S, pos = 4, 8, 128, 288, 200
    for policy in ("takum8", "mxfp8"):
        cfg = configs.get("llama3_8b").with_(num_layers=1, quant=POLICIES[policy])
        k = torch.randn((B, 1, Kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, 1, Kv, hd), generator=gen, device=dev).to(torch.bfloat16)
        cache = T.init_cache(cfg, B, S, dev)
        if hasattr(T, "_append_kv"):
            fn = lambda c=cache, cfg=cfg, k=k, v=v: T._append_kv(cfg, c, 0, k, v, pos)
        else:
            def fn(c=cache, cfg=cfg, k=k, v=v):
                T._put(c.k[0, :, pos:pos + 1], T._encode_cache(cfg, k))
                T._put(c.v[0, :, pos:pos + 1], T._encode_cache(cfg, v))
        fn()
        ref = T.init_cache(cfg, B, S, dev)
        with ops.plain_path():
            fn(ref)
        cs.check(torch.equal(cache.k.view(torch.uint8), ref.k.view(torch.uint8))
                 and torch.equal(cache.v.view(torch.uint8), ref.v.view(torch.uint8)),
                 f"append {policy}: kernel cache differs from the plain path's")
        feat = cache.k.shape[-1]
        nbytes = 2 * (k.numel() * 2 + B * Kv * feat * cache.k.element_size())
        b_ms, b_by = cs.bound(nbytes, 0)
        ops.reset_launch_counts()
        fn()
        launches = {key: n for key, n in ops.launch_counts().items() if n}
        row = dict(kernel="kv_append", policy=policy, fmt=cfg.quant.kv_cache,
                   shape=[2, B * Kv, hd], ms=cs.time_ms(torch, fn, flush=flush),
                   device_ms=cs.device_ms(torch, fn, flush=flush), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, launches=launches,
                   kernels_per_call=kernels_per_call(torch, fn))
        out.append(row)
        print(json.dumps(row), flush=True)
        del cache, ref

    V, d = 128256, 4096
    for policy, fmt in (("takum", "t16"), ("takum8", "t8"), ("mxt8", "mxt8")):
        w = torch.randn((V, d), generator=gen, device=dev) * d ** -0.5
        q = quantize(w, fmt, scaled=True)
        del w
        params = {"embed": q}
        for rows in ((4,), (4, 256)):
            tokens = torch.randint(0, V, rows, generator=gen, device=dev)
            fn = lambda t=tokens: T._embed(params, t, torch.bfloat16)
            got = fn()
            with ops.plain_path():
                want = fn()
            cs.check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                     f"embed {fmt} {rows}: kernel rows differ from the plain path's")
            n = tokens.numel()
            nbytes = n * (q.bits.shape[-1] * q.bits.element_size() + 2 * d)
            b_ms, b_by = cs.bound(nbytes, 0)
            ops.reset_launch_counts()
            fn()
            launches = {key: c for key, c in ops.launch_counts().items() if c}
            row = dict(kernel="embed_rows", policy=policy, fmt=fmt, shape=[n, V, d],
                       ms=cs.time_ms(torch, fn, flush=flush),
                       device_ms=cs.device_ms(torch, fn, flush=flush), bound_ms=b_ms,
                       bound_by=b_by, library_ms=None, launches=launches,
                       kernels_per_call=kernels_per_call(torch, fn))
            out.append(row)
            print(json.dumps(row), flush=True)
        del q, params
        torch.cuda.empty_cache()
    del flush


def decode_launches(torch, dev, out):
    """Device kernels of one llama3-8b decode step, per policy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES

    B, S0 = 4, 16
    for policy in ("takum", "takum8", "mxfp8"):
        cfg = configs.get("llama3_8b").with_(quant=POLICIES[policy])
        params = T.init_params(cfg, 0, device=dev)
        qp = serve.quantize_params(cfg, params)
        del params
        torch.cuda.empty_cache()
        qp = serve.load_params(qp)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
        logits, cache = serve.make_prefill_step(cfg, cache_len=S0 + 4)(qp, {"tokens": prompt})
        step = serve.make_serve_step(cfg)
        logits, cache = step(qp, {"token": torch.argmax(logits, -1)}, cache)
        tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = step(qp, {"token": tok}, cache)
            torch.cuda.synchronize()
        counted = {k: n for k, n in ops.launch_counts().items() if n}
        kernels, busy, other = 0, 0.0, 0
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            t = getattr(ev, "self_device_time_total", None)
            busy += (t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
            if ev.key.startswith(("Memcpy", "Memset")):
                other += ev.count
            else:
                kernels += ev.count
        row = dict(policy=policy, kernels_per_decode_step=kernels, memcpy_memset=other,
                   device_busy_ms=busy, wrapper_launches=counted)
        out.append(row)
        print(json.dumps(row), flush=True)
        del qp, cache, logits
        torch.cuda.empty_cache()


def serving(torch, tree: Path, dev, out):
    """``phase_serving`` of the tree's own chip_smoke.py, per policy."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"chip_smoke_{abs(hash(tree))}",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for policy in ("takum", "takum8", "mxfp8"):
        r = mod.phase_serving(torch, dev, policy)
        trace = r["profile_two_decode_steps"]
        row = {k: r[k] for k in ("policy", "prefill_ms", "first_prefill_ms",
                                 "decode_ms_per_token", "max_memory_allocated_gb")}
        row.update(device_busy_two_steps_ms=trace["device_busy_ms"],
                   idle_share_of_counted_step=trace.get("idle_share_of_counted_step"))
        out.append(row)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE), help="root of the tree to measure")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--launches", action="store_true")
    ap.add_argument("--no-rows", action="store_true")
    ap.add_argument("--serving", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    _build = load_tree(tree, args.launches or args.serving)
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("codec_rows.py: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or torch.cuda.get_device_name(0)
    print(f"tree {tree} ({args.tag}); card: {card}", flush=True)
    dev = torch.device("cuda")
    _build.build_all()
    res = dict(card=card, tree=str(tree), tag=args.tag, rows=[], model_rows=[], decode=[],
               serving=[])
    if not args.no_rows:
        codec_rows(torch, cs, dev, res["rows"])
        model_rows(torch, cs, dev, res["model_rows"])
    if args.launches:
        decode_launches(torch, dev, res["decode"])
    if args.serving:
        serving(torch, tree, dev, res["serving"])
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"codec_rows_{args.tag}.json").write_text(json.dumps(res, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
