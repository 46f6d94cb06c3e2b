#!/usr/bin/env python3
"""Variants of the tensor-core tiles (src/repro_torch/kernels/csrc/
matmul_mma.cuh, the bf16-x tile; matmul_wgmma.cuh, the f32-x wgmma tile),
each built and timed on one GPU, to find what bounds them and to show which
faults chip_smoke.py's limits catch.

    python3 tools/tile_variants.py            # from the repository root
    python3 tools/tile_variants.py base f32_nomma   # only these variants

Each variant is a copy of ``src/`` under ``build/tile_variants/<name>/``
(only the sources it measures kept: ``takum_matmul.cu`` for the bf16-x
tile, ``takum_matmul_wt.cu`` for the f32-x tile, both for ``base``; all
built in parallel) with text substitutions in its header, each of whose
texts must occur exactly once (``tests/test_torch_tiles.py`` applies them
all to the headers on the CPU):

- ``base``: none.
- ``direct``: the bf16-x tile's MMAs accumulate straight into the running
  sums, with no partial per 32 k terms (the order the tile would have
  without its blocked sum).
- ``noflag``: flat 8-bit lut decodes without the flagged bf16 table (the
  f32 table, then the vote's checks per element).
- ``bk64``: 64 k per stage, and so per partial sum.
- ``stages8``: an 8-stage ring of raw bits instead of 4.
- ``nomma``: every MMA replaced by one integer operation (a timing of
  everything else; its outputs are meaningless).
- ``f32_direct``: the wgmma tile's products go straight into the running
  sums (scale-d 1 from the first), no partial per stage.
- ``f32_nomma``: every wgmma replaced by one float add of its descriptors'
  bits (the producers' copy, decode and split and the consumers' waits,
  without the MMAs; its outputs are meaningless).
- ``f32_five``: t16 stages run five of the six part products, dropping
  x lo * w lo (at most 2^-24 of the product): the pair loop starts at 1.
- ``f32_slots3``: a bf16 ring of 3 slots (the producers two stages ahead)
  over a raw ring of 3.
- ``f32_nofence``: the producers' proxy fence before they release a stage
  left out (a timing probe: what the fence costs; its outputs may be wrong).
- ``f32_nox``, ``f32_now``: the producers copy no x tile (``nox``) or no
  weight bits (``now``) on either copy path and cast no vote, decoding
  whatever the ring holds (timing probes: what those copies cost; their
  outputs are meaningless).
- ``f32_fetchlate``: the producers issue the next raw stage's copies after
  they release the current one, not before they decode it.
- ``f32_cpasync``: every launch on the per-thread cp.async copies (and a
  producer barrier per stage), none on the tensor-map copies.
- ``f32_bulk``: the tensor-map copies replaced by one ``cp.async.bulk`` per
  staged x row and weight line (160-256 a stage), issued by producer warp
  0 on the same mbarriers into unswizzled rows; whole tiles only (no edge
  in M, N or K), as at the shapes it times.

Per variant, in its own process, for the bf16-x tile (``base`` and the
next five): K3 at llama3-8b's wi shape, M = 1024, K = 4096, N = 14336,
bf16 x, for t8 lut, t16 bits and bf16 bits (``chip_smoke.time_ms``: median
of 20 launches, CUDA events, L2 flushed before each); and, but for
``nomma``, ``chip_smoke.k3_exact_reading`` at ``chip_smoke.POSITIVE_SHAPES``
for t8 and t16, on random and on all-positive inputs (the latter are
chip_smoke.py's all-positive rows, input for input, held there to
``K3_LIMIT``).  For the f32-x tile (``base`` and the ``f32_`` variants):
K5's backward, the transposed K3 over wi's stored [4096, 14336] at
M = 1024 (g [1024, 14336]), t8 lut and t16 bits; and, but for the probes
``f32_nomma``, ``f32_nox`` and ``f32_now``, the same readings with f32 x
through the transposed launch over a transposed copy, which equals K3 with
f32 x bit for bit (so the all-positive ones are chip_smoke.py's f32 rows,
input for input).
``base`` runs first and last.  One JSON line per run; the card's name and
power limit first.  Exits nonzero without CUDA.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "tile_variants"
CSRC = Path("src/repro_torch/kernels/csrc")
MMA = CSRC / "matmul_mma.cuh"
WGMMA = CSRC / "matmul_wgmma.cuh"

#: ``f32_bulk``: the wgmma tile's TMA copies replaced by one cp.async.bulk per
#: staged row, issued by producer warp 0 into unswizzled rows (whole tiles
#: only: no edge in M, N or K, as at the shapes it times)
BULK = [
    ("  return off ^ (((off >> 7) & MASK) << 4);", "  return off;"),
    ("// wait until the phase of `bar` with this parity has completed\n", r"""
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of `bar` with this parity has completed
"""),
    ("""      mbar_expect_tx(&raw_full[r], C::kTmaBytes);
      tma_2d(smem + C::kOffRawX + r * C::kXSlot, &tmx, s * kBK, m0, &raw_full[r]);
      uint8_t* wdst = smem + C::kOffRawW + r * C::kWSlot;
      if constexpr (WT) {
        tma_2d(wdst, &tmw, s * kBK, n0, &raw_full[r]);
      } else {
        tma_2d(wdst, &tmw, n0, s * kBK, &raw_full[r]);
      }
""", """      if (pt == 0) mbar_expect_tx(&raw_full[r], C::kTmaBytes);
      __syncwarp();
      uint8_t* xdst = smem + C::kOffRawX + r * C::kXSlot;
      for (int m = pt; m < BM; m += 32) {
        bulk_copy(xdst + m * kBK * 4, x + static_cast<long long>(m0 + m) * K + s * kBK, kBK * 4,
                  &raw_full[r]);
      }
      uint8_t* wdst = smem + C::kOffRawW + r * C::kWSlot;
      constexpr int kLine = (WT ? kBK : BN) * EB;
      for (int l = pt; l < (WT ? BN : kBK); l += 32) {
        const uint8_t* src = WT ? w + (static_cast<long long>(n0 + l) * K + s * kBK) * EB
                                : w + (static_cast<long long>(s * kBK + l) * N + n0) * EB;
        bulk_copy(wdst + l * kLine, src, kLine, &raw_full[r]);
      }
"""),
    ("      if (pt == 0) {\n        for (int s = 0; s < kRaw - 1; ++s) fetch_tma(s);",
     "      if (pt < 32) {\n        for (int s = 0; s < kRaw - 1; ++s) fetch_tma(s);"),
    ("        if (pt == 0) fetch_tma(s + kRaw - 1);", "        if (pt < 32) fetch_tma(s + kRaw - 1);"),
]

#: name -> (header, [(text, replacement)]), each text found exactly once in
#: the header
VARIANTS = {
    "base": (MMA, []),
    "direct": (MMA, [
        ("mma_bf16_first(part[i][j], a[i], b[j][0], b[j][1]);",
         "mma_bf16(run[i][j], a[i], b[j][0], b[j][1]);"),
        ("mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);",
         "mma_bf16(run[i][j], a[i], b[j][0], b[j][1]);"),
        ("for (int r = 0; r < 4; ++r) run[i][j][r] += part[i][j][r];",
         "for (int r = 0; r < 4; ++r) (void)part[i][j][r];"),
    ]),
    "noflag": (MMA, [
        ("    IMPL == repro::kLut && !repro::kIsMx<FMT> && repro::kElemBits<FMT> == 8;",
         "    false;"),
    ]),
    "bk64": (MMA, [("constexpr int kBK = 32;", "constexpr int kBK = 64;")]),
    "stages8": (MMA, [("constexpr int kStages = 4;", "constexpr int kStages = 8;")]),
    "nomma": (MMA, [
        ('''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));''',
         "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x00800000u);"),
        ('''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));''',
         "  d[0] = d[1] = d[2] = d[3] = __uint_as_float((a[0] ^ b0 ^ b1) & 0x00800000u);"),
    ]),
    "f32_direct": (WGMMA, [
        ("wgmma<BN>(part, da, db, i == 0 && kh == 0 ? 0 : 1);",
         "wgmma<BN>(run, da, db, 1);"),
        ("fence_operands(part);", "fence_operands(run);"),
        ("for (int r = 0; r < BN / 2; ++r) run[r] += part[r];",
         "for (int r = 0; r < BN / 2; ++r) (void)part[r];"),
    ]),
    "f32_nomma": (WGMMA, [
        ("wgmma<BN>(part, da, db, i == 0 && kh == 0 ? 0 : 1);",
         "part[0] += __uint_as_float(static_cast<uint32_t>(da ^ db) & 0x00800000u);"),
    ]),
    "f32_five": (WGMMA, [
        ("for (int i = 0; i < C::kPairs; ++i) {", "for (int i = C::kSplit; i < C::kPairs; ++i) {"),
        ("wgmma<BN>(part, da, db, i == 0 && kh == 0 ? 0 : 1);",
         "wgmma<BN>(part, da, db, i == C::kSplit && kh == 0 ? 0 : 1);"),
    ]),
    "f32_slots3": (WGMMA, [("constexpr int kRaw = 4;", "constexpr int kRaw = 3;"),
                           ("constexpr int kSlots = 2;", "constexpr int kSlots = 3;")]),
    "f32_nofence": (WGMMA, [
        ("      // one arrival per warp, after all its lanes' writes\n"
         '      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");',
         "      // one arrival per warp, after all its lanes' writes (no proxy fence)"),
    ]),
    "f32_nox": (WGMMA, [
        ("for (int i = 0; i < BM * 8 / C::kPT; ++i) {", "for (int i = 0; i < 0; ++i) {"),
        ("      mbar_expect_tx(&raw_full[r], C::kTmaBytes);\n"
         "      tma_2d(smem + C::kOffRawX + r * C::kXSlot, &tmx, s * kBK, m0, &raw_full[r]);\n",
         "      mbar_expect_tx(&raw_full[r], C::kTmaBytes - BM * kBK * 4);\n"),
        ("      if (bad) *vote = 1;\n      __syncwarp();", "      (void)bad;\n      __syncwarp();"),
    ]),
    "f32_now": (WGMMA, [
        ("for (int i = 0; i < (C::kWLines * C::kWCh + C::kPT - 1) / C::kPT; ++i) {",
         "for (int i = 0; i < 0; ++i) {"),
        ("      mbar_expect_tx(&raw_full[r], C::kTmaBytes);",
         "      mbar_expect_tx(&raw_full[r], BM * kBK * 4);"),
        ("""      if constexpr (WT) {
        tma_2d(wdst, &tmw, s * kBK, n0, &raw_full[r]);
      } else {
        tma_2d(wdst, &tmw, n0, s * kBK, &raw_full[r]);
      }
""", "      (void)wdst;\n"),
        ("      if (bad) *vote = 1;\n      __syncwarp();", "      (void)bad;\n      __syncwarp();"),
    ]),
    "f32_fetchlate": (WGMMA, [
        ("        if (pt == 0) fetch_tma(s + kRaw - 1);\n", ""),
        ("        fetch(s + kRaw - 1);\n      }\n      const int d", "      }\n      const int d"),
        ("        if constexpr (TMA) mbar_arrive(&raw_empty[s % kRaw]);\n      }\n",
         "        if constexpr (TMA) mbar_arrive(&raw_empty[s % kRaw]);\n      }\n"
         "      if constexpr (TMA) {\n"
         "        if (pt == 0) fetch_tma(s + kRaw - 1);\n"
         "      } else {\n"
         "        fetch(s + kRaw - 1);\n"
         "      }\n"),
    ]),
    "f32_cpasync": (WGMMA, [("  const bool tma = x_vec &&", "  const bool tma = false && x_vec &&")]),
    "f32_bulk": (WGMMA, BULK),
}

MEASURE = r'''
import json, sys, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke as cs
from repro_torch.kernels.takum_matmul import takum_matmul, takum_matmul_t
from repro_torch.kernels.takum_codec import encode_2d_plain
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)
flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
name, family = sys.argv[3], sys.argv[4]
out = {"variant": name, "ms": {}, "err_over_absprod": {}}
if family in ("bf16", "both"):
    x = torch.randn((1024, 4096), generator=gen, device=dev).to(torch.bfloat16)
    for fmt, impl in (("t8", "lut"), ("t16", "bits"), ("bf16", "bits")):
        w = encode_2d_plain(torch.randn((4096, 14336), generator=gen, device=dev) * 0.02, fmt)
        out["ms"][f"{fmt}[{impl}] 1024x4096x14336"] = cs.time_ms(
            torch, lambda: takum_matmul(x, w, fmt, decode_impl=impl), flush=flush)
if family in ("f32", "both"):
    g = torch.randn((1024, 14336), generator=gen, device=dev)
    for fmt, impl in (("t8", "lut"), ("t16", "bits")):
        w = encode_2d_plain(torch.randn((4096, 14336), generator=gen, device=dev) * 0.02, fmt)
        out["ms"][f"{fmt}[{impl}] backward wi 1024"] = cs.time_ms(
            torch, lambda: takum_matmul_t(g, w, fmt, impl), flush=flush)
if name not in ("nomma", "f32_nomma", "f32_nox", "f32_now"):  # timing probes only
    for M, K, N in cs.POSITIVE_SHAPES:
        for positive in (False, True):
            kind = "all-positive" if positive else "random"
            for fmt in ("t8", "t16"):
                if family in ("bf16", "both"):
                    reading, _, _ = cs.k3_exact_reading(torch, dev, fmt, M, K, N, positive)
                    for impl, r in reading.items():
                        out["err_over_absprod"][f"{fmt}[{impl}] {M}x{K}x{N} {kind}"] = r
                if family in ("f32", "both"):
                    reading, _, _ = cs.k3_exact_reading(torch, dev, fmt, M, K, N, positive,
                                                        torch.float32, transposed=True)
                    for impl, r in reading.items():
                        out["err_over_absprod"][f"{fmt}[{impl}] {M}x{K}x{N} {kind} f32 x"] = r
    out["k3_limit"] = cs.K3_LIMIT
print(json.dumps(out), flush=True)
'''


def header_of(name: str) -> Path:
    """The header that variant ``name`` edits."""
    return VARIANTS[name][0]


def family_of(name: str) -> str:
    """What variant ``name`` measures: ``"bf16"`` (the bf16-x tile), ``"f32"``
    (the wgmma tile) or ``"both"`` (``base``)."""
    if name == "base":
        return "both"
    return "f32" if header_of(name) == WGMMA else "bf16"


def apply(name: str, text: str) -> str:
    """The header ``text`` with variant ``name``'s substitutions made;
    ValueError where a text does not occur exactly once."""
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: substitution not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def make(name: str) -> Path:
    tree = WORK / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src", ignore=shutil.ignore_patterns("__pycache__"))
    keep = {"bf16": {"takum_matmul.cu"}, "f32": {"takum_matmul_wt.cu"},
            "both": {"takum_matmul.cu", "takum_matmul_wt.cu"}}[family_of(name)]
    for cu in (tree / CSRC).glob("*.cu"):
        if cu.name not in keep:
            cu.unlink()
    header = tree / header_of(name)
    header.write_text(apply(name, header.read_text()))
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tile_variants.py: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "card not readable")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"tile_variants.py: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    trees = {name: make(name) for name in names}
    build = "import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels import _build; _build.build_all()"
    procs = [subprocess.Popen([sys.executable, "-c", build, str(t / "src")]) for t in trees.values()]
    if any([p.wait() for p in procs]):
        print("tile_variants.py: a variant failed to build", file=sys.stderr)
        return 1
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in [*names, *(["base"] if "base" in names else [])]:
        res = subprocess.run([sys.executable, "-c", MEASURE, str(trees[name] / "src"), str(ROOT),
                              name, family_of(name)],
                             capture_output=True, text=True, env=env, timeout=900)
        if res.returncode:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
