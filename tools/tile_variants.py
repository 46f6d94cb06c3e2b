#!/usr/bin/env python3
"""Variants of the tensor-core tile (src/repro_torch/kernels/csrc/matmul_mma.cuh),
each built and timed on one GPU, to find what bounds it and to show which
faults chip_smoke.py's limits catch.

    python3 tools/tile_variants.py            # from the repository root

Each variant is a copy of ``src/`` under ``build/tile_variants/<name>/``
(only ``takum_matmul.cu`` kept, so the builds take about a minute and a
half, all in parallel) with text substitutions in the header, each of whose
texts must occur exactly once (``tests/test_torch_tiles.py`` applies them
all to the header on the CPU):

- ``base``: none.
- ``direct``: the MMAs accumulate straight into the running sums, with no
  partial per 32 k terms (the order the tile would have without its
  blocked sum).
- ``noflag``: flat 8-bit lut decodes without the flagged bf16 table (the
  f32 table, then the vote's checks per element).
- ``bk64``: 64 k per stage, and so per partial sum.
- ``stages8``: an 8-stage ring of raw bits instead of 4.
- ``nomma``: every MMA replaced by one integer operation (a timing of
  everything else; its outputs are meaningless).

Per variant, in its own process: K3 at llama3-8b's wi shape, M = 1024,
K = 4096, N = 14336, bf16 x, for t8 lut, t16 bits and bf16 bits
(``chip_smoke.time_ms``: median of 20 launches, CUDA events, L2 flushed
before each); and, but for ``nomma``, ``chip_smoke.k3_exact_reading`` at
``chip_smoke.POSITIVE_SHAPES`` for t8 and t16, on random and on
all-positive inputs (the latter are chip_smoke.py's all-positive rows,
input for input, held there to ``K3_LIMIT``).  ``base`` runs first and
last.  One JSON line per run; the card's name and power limit first.
Exits nonzero without CUDA.
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
HEADER = Path("src/repro_torch/kernels/csrc/matmul_mma.cuh")

#: name -> [(text, replacement)], each text found exactly once in the header
VARIANTS = {
    "base": [],
    "direct": [
        ("mma_bf16_first(part[i][j], a[i], b[j][0], b[j][1]);",
         "mma_bf16(run[i][j], a[i], b[j][0], b[j][1]);"),
        ("mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);",
         "mma_bf16(run[i][j], a[i], b[j][0], b[j][1]);"),
        ("for (int r = 0; r < 4; ++r) run[i][j][r] += part[i][j][r];",
         "for (int r = 0; r < 4; ++r) (void)part[i][j][r];"),
    ],
    "noflag": [
        ("    IMPL == repro::kLut && !repro::kIsMx<FMT> && repro::kElemBits<FMT> == 8;",
         "    false;"),
    ],
    "bk64": [("constexpr int kBK = 32;", "constexpr int kBK = 64;")],
    "stages8": [("constexpr int kStages = 4;", "constexpr int kStages = 8;")],
    "nomma": [
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
    ],
}

MEASURE = r'''
import json, sys, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chip_smoke as cs
from repro_torch.kernels.takum_matmul import takum_matmul
from repro_torch.kernels.takum_codec import encode_2d_plain
dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(0)
flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
name = sys.argv[3]
out = {"variant": name, "ms": {}, "err_over_absprod": {}}
x = torch.randn((1024, 4096), generator=gen, device=dev).to(torch.bfloat16)
for fmt, impl in (("t8", "lut"), ("t16", "bits"), ("bf16", "bits")):
    w = encode_2d_plain(torch.randn((4096, 14336), generator=gen, device=dev) * 0.02, fmt)
    out["ms"][f"{fmt}[{impl}] 1024x4096x14336"] = cs.time_ms(
        torch, lambda: takum_matmul(x, w, fmt, decode_impl=impl), flush=flush)
if name != "nomma":
    for M, K, N in cs.POSITIVE_SHAPES:
        for positive in (False, True):
            for fmt in ("t8", "t16"):
                reading, _ = cs.k3_exact_reading(torch, dev, fmt, M, K, N, positive)
                for impl, r in reading.items():
                    kind = "all-positive" if positive else "random"
                    out["err_over_absprod"][f"{fmt}[{impl}] {M}x{K}x{N} {kind}"] = r
    out["k3_limit"] = cs.K3_LIMIT
print(json.dumps(out), flush=True)
'''


def apply(name: str, text: str) -> str:
    """The header ``text`` with variant ``name``'s substitutions made;
    ValueError where a text does not occur exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: substitution not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def make(name: str) -> Path:
    tree = WORK / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src", ignore=shutil.ignore_patterns("__pycache__"))
    for cu in (tree / "src/repro_torch/kernels/csrc").glob("*.cu"):
        if cu.name != "takum_matmul.cu":
            cu.unlink()
    header = tree / HEADER
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
    trees = {name: make(name) for name in VARIANTS}
    build = "import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels import _build; _build.build_all()"
    procs = [subprocess.Popen([sys.executable, "-c", build, str(t / "src")]) for t in trees.values()]
    if any([p.wait() for p in procs]):
        print("tile_variants.py: a variant failed to build", file=sys.stderr)
        return 1
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name in [*VARIANTS, "base"]:
        res = subprocess.run([sys.executable, "-c", MEASURE, str(trees[name] / "src"), str(ROOT),
                              name],
                             capture_output=True, text=True, env=env, timeout=900)
        if res.returncode:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
