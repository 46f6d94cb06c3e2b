#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  (a) device: CUDA present; print the card's name and power limit.
  (b) build: compile every kernel from src/repro_torch/kernels/csrc.
  (c) kernels against their plain PyTorch versions, under each codec the
      format has ("bits", and "lut" where it has tables: every format's
      decode, every encode but bf16's), each plain version running the same
      codec, and every lut kernel bit for bit against the bits kernel.  For
      t8, t16, e4m3, e5m2 and bf16: K1 over every code and K2 over an f32
      sweep, both also at the serving shapes ([1024, 4096], [8192, 128])
      and over one packed weight [4096, 14336] (all bit for bit, each timed
      by events and as device time beside the library call's); K3 at the
      serving shapes (M = 4: every linear of the decode step, the split-K
      matvec; M = 1024: the bf16 tensor-core
      tile, t16 through its hi/lo split), with f32 x at M = 1024 on wi for
      t8 and t16 (the wgmma tile, x split into three bf16 parts) and ragged
      shapes (M = 37 with bf16 x: the tensor-core tile; with f32 x: the
      wgmma tile), within 4e-6 of |x| @ |w| (a limit two lossy t16 controls
      must exceed), each row
      holding the loop it ran (the wrapper's ``last_loop``: the loop
      ``takum_matmul.tile_for`` named, which the C entry runs or refuses)
      and, at M = 1024, a bf16-output ``torch.matmul`` as a second yardstick
      of speed; for t8 and t16 also all-positive inputs at M = 1024 and the
      prefill's deepest sums (K = 4096 and 14336), bf16 and f32 x, within
      the same limit of the exact product (``k3_exact_reading``): there
      every partial sum is the whole |x| @ |w|, so an accumulation that
      truncates shows, and with f32 x two lossy controls (x as hi + mid of
      its split; both operands TF32) must exceed the limit; K6
      (split S) at the serving shape with length < S.  Then the mx containers mxe4m3,
      mxe5m2 and mxt8: K1-mx over every element code under every scale byte
      and K2-mx over a block sweep (zero, NaN, Inf and subnormal blocks,
      absmax near 2^-126 and 2^127, values above the cap), both again at
      [8192, 128], [1024, 4096] and [4096, 14336], bit for bit and timed;
      K3-mx at ragged N (100,
      4096) and, for mxt8, at the serving shapes and with f32 x at
      M = 1024 on wi; K6-mx at the serving shape
      and at head dims 16 and 80.  Then, every format and codec, K2 and K1 as
      the model launches them: one layer's KV append (K and V bf16, one
      ``takum_encode_into`` launch into the cache slots: the decode step's
      2 x [32, 128] and the prefill's 2 x [8192, 128]) and the embedding
      rows (``takum_decode_rows``: 4 and 1024 ids from a [128256, 4096]
      table, scaled, to bf16), bit for bit against the compositions they
      replaced; the bf16 KV append's row carries a ``copy_`` of K and V into
      their slots as its library call.  Then the other dense archs' new
      shapes: the tied head, the transposed K3 over the stored table at
      M = 4 (gemma2's [256000, 2304], llama3.2-3b's [128256, 3072]; t16
      bits and t8 lut) within K3's limit, timed beside its byte bound and
      ``torch.matmul(x, decode(e).T)``; K1-mx over gemma2's table in mxt8
      (the mx tied head); K6 at gemma2's shape (hd 256, softcap 50, a
      window of 4096 under the length) and granite's (H 48 over one kv
      head), past 48 KiB of shared memory, timed beside SDPA.  Each is
      timed with CUDA events, and the
      lut gather's shared-memory bank conflicts are probed by timing K1, K3
      and the transposed K3 (K5's backward) under a broadcast, a random and
      an 8-way-conflict code pattern.  The K3 rows at M = 4 and the K6 rows
      also carry their device time (calls replayed from a CUDA graph) beside
      the library call's, since their CUDA-event time is mostly the host's
      launch path (so do the K1 / K2 rows); and per policy the decode step's
      K3 total, launches x time over the five shapes.
  (d) serving: llama3-8b at full width and depth, random weights from a
      seed, B=4, a 256-token prompt and 32 greedy decode steps, with every
      kernel's launch count read around each run and held to the policy
      (per call one K2 append per layer and one K1 over the embedding rows;
      the packing and loading of the tree counted apart): takum (t16
      weights, t8 KV cache), takum8 (t8 weights and KV cache:
      every kernel through its lut codec), then mxfp8 (bf16 weights, mxe4m3
      KV cache: K2-mx appends, K6-mx reads).  One uncounted prefill first
      (its time kept as ``first_prefill_ms``), so that the counted one is
      warm whatever earlier phases ran.  After the counted run, two decode
      steps on its cache, then one prefill, under torch.profiler: device
      busy ms, the kernel launches per decode step, K3's share of the
      prefill and the other top device operations.
  (e) model parity: full width, 2 layers, takum, takum8, ofp8, mxfp8, mxt8
      (mxt8 weights and KV cache: K1-mx, K2-mx, K3-mx and K6-mx) and bf16
      (bf16 KV cache: K2 and K6 with the bits codec), kernel path against
      the plain path (``ops.plain_path()``) on the same inputs, with the
      kernel path's launches counted.
  (f) the producers, through the ``out_fmt`` epilogues of K3, K4 and K6 and
      K4 (the dual matmul): every producer (K3, K4, K6, flat and mx) under
      each decode codec and every out format (t8, t16, e4m3, e5m2, bf16,
      mxe4m3, mxe5m2, mxt8) with each encode codec it has, at odd shapes
      that reach the matvec (M = 3) and the tiles (M = 37), bit for bit
      against K2's encode of the
      same kernel's unfused output (the count of differing codes is
      printed); K4 unfused within K3's limit of its plain version; NaN/Inf
      rows and overflow mapped to each out family's specials.  Then the
      producer path at llama3-8b's widths through ``ops.matmul`` /
      ``dual_matmul`` / ``decode_attention`` with out_fmt, counted, checked
      the same way and timed against the unfused pair (the producer, then K2)
      and, for K4, ``torch.matmul`` on the decoded operands in f32 (the
      library call) and in bf16 (a yardstick of speed that rounds its
      output to bf16).
  (g) K5, ``takum_matmul_ad``: its backward, the transposed K3 (K3's loop
      reading the stored weight transposed, csrc/takum_matmul_wt.cu), for
      every flat format under each codec at both loops (M = 3: the matvec,
      M = 37: the wgmma tile) and odd shapes,
      within K3's limit of its plain version and bit for bit equal to K3
      over a transposed copy; the forward equal to K3; a bf16 dx for a bf16
      x; mx refused; one autograd step per format launching exactly one K3
      and one transposed K3, x.grad against the plain path.  Then the
      backward of llama3-8b's wi (M = 4 and 1024), w2 (M = 1024) and head
      (M = 4), t8 and t16, through autograd, counted, and timed against its
      bound (at the bf16 rate over the MMAs of the split, and beside it at
      the f32 rate; a matmul row's ``bound_rate`` names its rate), its
      plain version, ``torch.matmul(g, decode(w).T)`` and the copy
      yardstick (the bits transposed into a copy, then K3).
      Phase (b) prints each source's nvcc time and kernel count.
  (h) training.  First the token ids (F3, F4): K1's embedding rows equal
      their plain version for int32 and int64 ids and for ids off the table
      (wrapped, then clamped), and the process launches kernels after.
      (h1) one train step at smoke size under takum, kernels and then
      ``ops.plain_path()`` from clones of one state: params, moment codes
      and rng bit for bit (K1 and K2 are exact and nothing else differs),
      with stochastic and with nearest-even moment refreshes, launches
      counted; (h2) ``adamw_update`` on the wi leaf [4096, 14336] with t16
      and t8 moments, kernel against plain path bit for bit, timed; (h3)
      llama3-8b at full width cut to 4 layers, B = 4, S = 256, random init
      from a seed, 5 steps on one batch each under takum, takum8 and bf16:
      the CE falls,
      K1 counted around one step (2 per parameter leaf under quantised
      moments, none under bf16's f32 moments) and K2 around the init, step
      ms and the peak of ``max_memory_allocated``; (h4) the smoke launcher
      (``repro_torch.launch.train``, bf16) and the loop under takum with an
      f32 checkpoint, each crashed at step 7 and restarted from its step-4
      checkpoint, end equal to an unbroken run bit for bit.
  (i) the other dense archs.  (i1) gemma2-2b at published widths and depth
      (26 layers, tied head, alternating 4096-key local and global layers,
      post-norms, softcaps) under takum and takum8, B = 4, a 4160-token
      prompt (longer than the window: the local layers drop keys in the
      prefill and in every decode step) and 32 decode steps; (i2)
      llama3.2-3b (28 layers, tied) and musicgen-large (cut to 24 of 48
      layers) under takum, prompt 256; (i3) granite-34b at published widths cut to 8 of 88
      layers (its 47.2B parameters are 94.5 GB at t16) under takum8, MQA
      (g = 48 in K6).  Each through ``phase_serving``: launches counted
      and held to the config's own tree (packed leaves and gains counted
      from it: one transposed K3 per call for a tied head), warm prefill ms,
      decode ms/token, peak memory, a profiled decode and prefill.  (i4)
      each arch at full width and 2 layers, kernel path against
      ``ops.plain_path()`` under takum and takum8 (and mxt8 for gemma2: the
      K1-mx head) at f32 and bf16 activations, with phase (e)'s limits;
      (i5) gemma2's smoke train step, kernels against the plain path bit
      for bit, with SR and RNE refreshes.
  (j) the MoE family (dbrx-132b: 16 experts, top 4; kimi-k2-1t-a32b: 384
      experts, top 8, a shared expert), every expert one K3 launch per
      weight over its slice of the stacked leaf (dbrx 53 K3 a layer and
      call, kimi 1160).  Phase (c) first holds K3 at the routers' narrow N
      (4, 8, 16, 384; f32 and bf16 x; M = 4, 24, 1024; t8 and t16) to its
      limit and times the routers, the experts' wi at M = 4 and dbrx's at
      M = 320 (its prefill tile), K6 at dbrx's g = 6 and one MoE layer's
      decode launches against the byte bound of all its experts.  (j0) the
      chunked packed build (``chunked_packed_params``: leaf by leaf, chunk
      by chunk, no f32 copy of a whole leaf) equals ``quantize_params`` of
      the same draws at smoke size, bit for bit; (j1) serving at published
      widths, depth cut to fit: dbrx under takum8 at 8 of 40 layers and
      under takum at 4, kimi under takum8 at 2 of 61, B = 4, prompt 256, 32
      decode steps, through ``phase_serving`` (launches counted, the pairs
      capacity dropped in the prefill, the profiled decode step's launches
      and idle share); (j2) the 2-layer (kimi 1-layer) kernel path against
      the plain path at f32 and bf16 activations with phase (e)'s limits
      and its f64 control, routing flips between the paths logged with
      their margins (one above ``FLIP_MARGIN`` fails); (j3) kimi's smoke
      train step, kernels against the plain path bit for bit.
  (k) the ssm and hybrid families (mamba2-780m: the Mamba-2 mixer alone,
      2 K3 a layer and call, no K/V; hymba-1.5b: attention and the mixer
      in parallel, then the MLP on f32 x: 9 K3, one K2 and one K6 a layer).
      Phase (c) first holds K3 at M = 4 over the mixers' in_proj (bf16 x;
      mamba2 [1536, 6448], hymba [1600, 3257], an odd N whose t16 rows
      are no 16-byte multiple) and hymba's head [1600, 32001], K3 on f32 x
      at M = 1024 over mamba2's out_proj [3072, 1536] (the wgmma tile),
      the transposed K3 over mamba2's tied table [50280, 1536] at M = 4
      and K6 at hymba's shape (H 25 over 5 kv heads, hd 64, length 2080, a
      1024-key window), t16 bits and t8 lut, each against its plain version
      and timed beside its bound and library call.  (k1) serving at
      published widths, depth cut to half, B = 4, 32 decode steps, under
      takum and takum8: mamba2-780m (24 of 48 layers, prompt 4096: 16 SSD
      chunks of 256) and hymba-1.5b (16 of 32, prompt 2048, past its window in the
      prefill and every decode step), through ``phase_serving``: launches
      counted and held (packing 10 / 19 K2, loading 7 / 8 K1: the gains and
      the mixer's six small leaves), warm and first prefill, decode
      ms/token, peak memory, the profiled decode step's launches, idle
      share and device time by class (K3, K6, K1 / K2, plain PyTorch);
      (k2) each at full width and 2 layers, kernel path against
      ``ops.plain_path()`` under takum and takum8 at f32 and bf16
      activations with phase (e)'s limits and its f64 control (mamba2 a
      512-token prompt, two chunks; hymba 1056, past its window), the conv
      tails and SSM states after the prefill and after the last step held
      to the same limits.
  (l) the vlm family (llama-3.2-vision-90b: a gated cross-attention onto
      4096 media tokens after every 5th layer; the media projected through
      K3 at M = B x 4096 = 16384, and each cross layer's media K/V through
      K3 at that M, in every call, the decode step's too) and the f32 KV
      cache (K2 appending raw f32 bits, K6 reading them).  (l0) K1 / K2 over
      f32 bit for bit (subnormals, -0, NaN payloads kept), the f32 KV
      append, K6 over an f32 cache at llama3-8b's and the vlm's decode
      shapes (g 4 and 8) and K6 t8 at the vlm's, K3 at the media shapes
      (media_proj [1408, 8192] and a cross wk [8192, 1024] at M = 16384, bf16
      x, t16 bits and t8 lut) within K3's limit, each timed beside its bound
      and library call.  (l1) serving at published widths (d 8192, 64 heads,
      8 kv heads, d_ff 28672, 4096 media tokens of width 1408, B = 4,
      prompt 256, 32 decode steps), depth cut in whole groups of 5 so that
      the script's time: takum8 at 20 of 100 layers, takum at 10, through
      ``phase_serving`` (the tree built leaf by leaf, the gates and cross
      norm gains drawn nonzero, launches held: 7 K3 a layer, 4 a cross
      layer, one over the media; the decode step's device time with the
      media projections' K3 apart).  (l2) 5 layers (one cross layer),
      kernel path against ``ops.plain_path()`` under takum and takum8 at
      f32 and bf16 activations with phase (e)'s limits and its f64 control,
      the cross layer's media K/V held too.  (l3) ``repro``'s
      prefill-then-decode consistency under an f32 KV cache (full forward
      over 16 tokens against a prefill of 8 and 8 decode steps, within
      2e-2) at full width: llama3-8b at 2 layers and the vlm at 5, t16
      weights.
  (m) observability and the fault guards.  (m1) llama3-8b at full width
      and depth under ``takum_guarded`` (t16 weights, t8 KV cache), B = 4,
      prompt 256, 8 decode steps, uncaptured, under ``telemetry.capture()``
      and uncaptured again: logits bit for bit, the same launches, each op's
      ``kernel.calls`` equal to its launches, ``kv.bytes`` the config's,
      ``kv.specials.t8`` 0; decode ms/token captured and uncaptured; one
      uncaptured decode step's kernel count (torch.profiler) beside
      PERF.md's 2960; the K3 and K6 spans' summed event time against the
      profiler's device time of their kernels (at least 0.95).  (m2) the
      prefill under ``faults.inject`` at a bit-flip rate of 1e-4 against a
      clean one: each differing cache byte one bit off, their count within
      6 binomial standard deviations, ``kv.specials.t8`` equal to the NaR
      bytes counted on the host, the same seed the same bytes; mxfp8 at 2
      layers with every scale byte NaN: ``kv.specials.mxe4m3`` 32 per
      block.  (m3) the guarded step at (h3)'s shape: a poisoned step holds
      every param and moment leaf and counts ``step.skipped``, a clean one
      moves them; (m1)'s capture exported as JSONL and Chrome trace, read
      back and validated.
  (n) dist: ranks are processes sharing the card (``torch.multiprocessing``
      "spawn", one process group on gloo, every payload host-staged: K2 on
      the card, a pinned host copy, gloo, a copy back, K1), spawned from
      here, reusing the build directory (each checks it rebuilt nothing).
      Every rank-to-rank time is host time on one card, not a wire speed.
      (n0) K2 and K1 as the ring launches them, bit for bit against their
      plain versions and timed: one row of the flat [4096 x 14336] payload
      for t16, t8, bf16, e4m3, e5m2, mxe4m3 and mxt8, and the train step's
      2^26-element chunk (K1 t16; K2-mx / K1-mx mxe5m2).  (n1) 4 ranks, each
      a [4096, 14336] f32 payload (llama3-8b's wi gradient) drawn from a
      seed and its rank: ``compressed_psum`` in f32, t16, t8, bf16, e4m3,
      e5m2, mxe4m3 and mxt8 with both ``exact_local`` settings: the ranks'
      sums the same bits (where they add the same terms), bit for bit the
      ring under ``ops.plain_path()``, max error / rms against the float64
      sum within ``tests/test_dist.py``'s limits, one K2 and P - 1 K1 a rank
      (one more K1 without ``exact_local``), ``wire.hop_bytes`` the packed
      bytes x (P - 1); ``degraded_psum`` with NaN / Inf planted in rank 1 and
      a bound t8 exceeds: every rank on t16, equal to that rung's ring of
      the contained input; 8 EF steps over t8 telescoping to the float64
      total less the final residuals within f32 rounding; hop drops and
      garbles under containment, ``wire.contained`` equal to a recount of
      the arrivals.  (n2) 4 stage ranks, each K3 over its own packed t16
      [4096, 4096] weight then tanh, 8 microbatches of [256, 4096]: f32, t16,
      t8 and mxt8 hops and a guarded t8 run, bit for bit the composition on
      one rank with the same kernels (the hops coded as each tick chose),
      the guarded run's per-tick escalations the same on every stage.
      (n3) the pod train step on a 2x1x1 mesh (two processes), llama3-8b at
      published widths cut to 1 layer (two ranks at 2 layers do not fit the
      card), B = 4 (2 a pod), S = 256, 3 steps on one batch under takum
      (t16 ring with SR: the plain SR encode out, K1 in) and mxfp8 (mxe5m2
      ring: K2-mx out, K1-mx in; t16 moments, its f32 ones do not fit): the
      CE falls, both ranks' params the same bits after every step, step ms,
      each rank's peak memory and the card's ``mem_get_info``, K1 / K2
      launches a step; one step with an f32 ring (bf16 moments, f32
      activations) whose gradients are within ``DIST_F32_LIMIT`` of the
      single-device step's on the whole batch.
      (n4) llama3-8b at published widths, 2 layers, takum at f32
      activations, B = 4 over 2 data ranks: each rank's logits rows over
      the prefill and 8 decode steps equal the single-process run's rows
      within ``SERVE_LIMIT``.

Stdout ends with the card line, one JSON line of kernel measurements and
the result line {"ok": true, "device": {...}}.  The script exits nonzero,
without that line, when CUDA is absent, when src/repro_torch is not beside
it, or when any phase fails.  Detailed rows go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
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


def device_ms(torch, fn, reps=20, flush=None):
    """Median ms of one call of ``fn`` on the device with the host out of the
    way: ``reps`` calls, each after writing ``flush`` (the L2 flush of
    ``time_ms``), captured in a CUDA graph and replayed between CUDA events,
    less the same graph of flushes alone; five replays of each.  One side
    stream serves every warm-up and capture of the process: each stream a
    ``torch.matmul`` runs on keeps a cuBLAS workspace (about 33 MB)
    allocated for good."""
    if not hasattr(device_ms, "stream"):
        device_ms.stream = torch.cuda.Stream()
    side = device_ms.stream

    def graph(body):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up on the capture stream
            body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(reps):
                body()
        return g

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        out = []
        for _ in range(5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return statistics.median(out)

    def flushed():
        if flush is not None:
            flush.zero_()
        fn()

    both = replay_ms(graph(flushed))
    alone = replay_ms(graph(lambda: flush.zero_())) if flush is not None else 0.0
    return max(both - alone, 0.0) / reps


#: the linears of one llama3-8b decode step, (K, N): launches per step
DECODE_LINEARS = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64, (14336, 4096): 32,
                  (4096, 128256): 1}


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
    """The card's peak for K3's products, and its name (a row's
    ``bound_rate``): bf16 tensor cores over as many MMAs per product as
    the operands' exact bf16 parts need.  Every decoded weight of the 8-bit
    formats, bf16 and the mx containers is exact in bf16 (8-bit elements
    carry at most 4 significant bits, a decoded mx product is a normal f32
    or flushed; f32's largest finite value, from saturating codes no encode
    produces, aside): one part; a t16 weight (12 significant bits) is the
    exact sum of two (hi, its low 16 bits cleared, and lo = w - hi).  A bf16
    x is one part, an f32 x the exact sum of three (hi, mid, lo:
    ``takum_matmul.split3_bf16``).  So BF16_FLOPS / (x parts x w parts):
    ``"bf16x1"``, ``"bf16x2"`` (t16), ``"bf16x3"`` (f32 x), ``"bf16x6"``
    (f32 x, t16)."""
    parts = (3 if xdt == torch.float32 else 1) * (2 if fmt == "t16" else 1)
    return BF16_FLOPS / parts, f"bf16x{parts}"


#: formats whose decoded weights are exact in bf16 (t16 is not), for the bf16
#: yardstick of the M = 1024 rows
BF16_EXACT = ("t8", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8")
#: (M, K, N) of K3's all-positive rows: the prefill's M = B * S0 at its two
#: depths of sum (K = 4096: every linear but w2; 14336: w2)
POSITIVE_SHAPES = ((1024, 4096, 4096), (1024, 14336, 4096))


def k3_exact_reading(torch, dev, fmt, M, K, N, positive, xdt=None, transposed=False):
    """K3 over x [M, K] (``xdt``: bf16, the default, or f32) and ``fmt``
    weights [K, N], drawn from N(0, 1) and N(0, 1/4) (``positive``: both in
    absolute value) by a generator seeded from the shape alone, so that a
    run of one row draws the same inputs (tools/tile_variants.py); with
    ``transposed`` (f32 x) through the transposed K3 over a transposed copy
    of the bits instead, which equals K3 bit for bit.  Returns ({codec:
    largest |kernel - exact| / (|x| @ |w|)}, the loop run, controls), exact
    being the decoded operands' product summed in f64; for f32 x the
    controls are the same reading of two lossy products, which K3_LIMIT
    must catch: x as hi + mid only (its three-way split without lo,
    ``takum_matmul.split3_bf16``), and both operands rounded to TF32.
    Raises where lut and bits differ."""
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain
    from repro_torch.kernels.takum_matmul import split3_bf16, takum_matmul, takum_matmul_t

    xdt = torch.bfloat16 if xdt is None else xdt
    gen = torch.Generator(device=dev)
    gen.manual_seed(M * K * N)
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.5
    if positive:
        x, w = x.abs(), w.abs()
    x, w = x.to(xdt), encode_2d_plain(w, fmt)
    wd = decode_2d_plain(w, fmt)
    exact = torch.matmul(x.double(), wd.double())
    scale = exact if positive else torch.matmul(x.double().abs(), wd.double().abs())

    def ratio(got):
        return float(((got.double() - exact).abs() / scale.clamp(min=1e-300)).max())

    controls = {}
    if xdt == torch.float32:
        hi, mid, _, _ = split3_bf16(x)
        controls["x_hi_mid"] = ratio(torch.matmul((hi.double() + mid.double()), wd.double()))
        del hi, mid
        controls["tf32_operands"] = ratio(torch.matmul(tf32(torch, x), tf32(torch, wd)))
    del wd
    copy = transposed_copy(torch, w) if transposed else None
    reading, first = {}, None
    for impl in impls_of(fmt, "decode"):
        if transposed:
            got = takum_matmul_t(x, copy, fmt, impl)
            loop = takum_matmul_t.last_loop
        else:
            got = takum_matmul(x, w, fmt, decode_impl=impl)
            loop = takum_matmul.last_loop
        check(first is None or same_bits_f32(torch, got, first),
              f"K3[{impl}] {fmt} {M}x{K}x{N}: differs from K3[bits]")
        first = got if first is None else first
        reading[impl] = ratio(got)
    return reading, loop, controls


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


def impls_of(fmt, op):
    """The codecs K1/K3/K6 (op "decode") or K2 (op "encode") take for
    ``fmt``: bits, and lut where the format (an mx format: its element
    format) has tables."""
    from repro_torch.core.formats import wire_format

    wf = wire_format(fmt)
    return ("bits", "lut") if (wf.supports_lut_decode if op == "decode"
                               else wf.supports_lut_encode) else ("bits",)


def gather_yardstick(torch, fmt, bits):
    """One PyTorch call computing K1's flat function: the gather
    ``tab[bits.long()]`` from the f32 decode table (16-bit bits indexed
    through their signed view)."""
    from repro_torch.core.takum import codes_of
    from repro_torch.kernels import lut

    tab = lut.tables_on(fmt, "decode", bits.device)[0].view(torch.float32)
    return lambda: tab[codes_of(bits)]


def cast_dtype(torch, fmt):
    """The torch dtype whose cast from f32 is wire ``fmt``'s RNE encode and
    whose view-and-widen is its decode, on finite data in range (bf16, e4m3,
    e5m2); None for takum and the mx containers."""
    return {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn,
            "e5m2": torch.float8_e5m2}.get(fmt)


def library_encode(torch, fmt, xf, bits):
    """K2's one-call library counterpart: the cast to ``cast_dtype(fmt)``,
    checked here to give K2's bits ``bits`` on ``xf`` (off this data the two
    part: torch's e4m3 cast saturates where the wire overflows to NaN, and
    keeps f32 subnormals that K2 flushes), or None."""
    dt = cast_dtype(torch, fmt)
    if dt is None:
        return None
    check(torch.equal(xf.to(dt).view(torch.uint8), bits.view(torch.uint8)),
          f"the {dt} cast of {list(xf.shape)} differs from K2 {fmt}")
    return lambda: xf.to(dt)


def library_decode(torch, fmt, bits, want):
    """K1's one-call library counterpart: for a ``cast_dtype`` wire the view
    and widen, checked here to give ``want`` (K1's output; off this data
    the two part on NaN payloads), for a takum the table gather, for mx
    None."""
    from repro_torch.core.formats import wire_format

    dt = cast_dtype(torch, fmt)
    if dt is None:
        return None if wire_format(fmt).is_block_scaled else gather_yardstick(torch, fmt, bits)
    check(same_bits_f32(torch, bits.view(dt).float(), want),
          f"the {dt} view of {list(bits.shape)} differs from K1 {fmt}")
    return lambda: bits.view(dt).float()


#: (kernel, shape) of the K1 / K2 rows of phase (c): the prefill's embedding
#: rows and KV block, and one packed weight [d, d_ff]
CODEC_SHAPES = (("takum_decode_2d", (1024, 4096)), ("takum_decode_2d", (4096, 14336)),
                ("takum_encode_2d", (8192, 128)), ("takum_encode_2d", (4096, 14336)))
#: the inputs' scale per shape (a weight's init scale for [d, d_ff])
CODEC_SCALE = {(4096, 14336): 4096 ** -0.5}


def codec_row(torch, kname, fmt, impl, shape, err, nbytes, kern, plain, lib, flush):
    """A K1 / K2 row: event and device time of the kernel and of the library
    call (None: there is none), the plain version's event time, and the
    byte bound."""
    b_ms, b_by = bound(nbytes, 0)
    return dict(kernel=kname, fmt=fmt, impl=impl, shape=list(shape), max_abs_err=err,
                ms=time_ms(torch, kern, flush=flush), device_ms=device_ms(torch, kern, flush=flush),
                plain_ms=time_ms(torch, plain, flush=flush), bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(torch, lib, flush=flush) if lib else None,
                library_device_ms=device_ms(torch, lib, flush=flush) if lib else None)


#: the model's codec launches timed in phase (c): (B, S, start, cache_len) of
#: the KV append (a decode step's slot, the prefill's range) and the
#: embedding rows' ids (a decode step's 4, the prefill's 4 x 256)
APPEND_CASES = ((4, 1, 200, 288), (4, 256, 0, 290))
EMBED_ROWS = (4, 1024)


def phase_model_codecs(torch, dev, rows):
    """K2 and K1 as the model launches them, every format and codec, each
    bit for bit against its plain version (the composition it replaced)
    and timed: ``takum_encode_into``, one layer's KV append (K and V, [B *
    S * Kv, hd] bf16 each, one launch) into the slots of a [B, cache_len *
    Kv * feat] cache (the whole cache compared, so the bytes around the
    slots too), and ``takum_decode_rows``, the embedding rows of random ids
    from a [128256, 4096] table of random codes, times a pow2 scale, to
    bf16."""
    from repro_torch.core.formats import kernel_wire_names, wire_format
    from repro_torch.kernels.takum_codec import (decode_rows_plain, encode_into_plain,
                                                 takum_decode_rows, takum_encode_into)
    from repro_torch.quant import blockscale

    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    Kv, hd, V, d = 8, 128, 128256, 4096
    for fmt in kernel_wire_names():
        wf = wire_format(fmt)
        feat = blockscale.payload_len(hd) if wf.is_block_scaled else hd
        esz = wf.nbits // 8
        for B, S, start, cache_len in APPEND_CASES:
            k, v = (torch.randn((B * S * Kv, hd), generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            cache = torch.zeros((2, B, cache_len * Kv * feat * esz), dtype=torch.uint8,
                                device=dev).view(wf.storage)
            want = cache.clone()

            def slots(c):
                return [c[i][:, start * Kv * feat:(start + S) * Kv * feat] for i in range(2)]

            lib = None
            if fmt == "bf16":  # the library's append: a copy_ of K and of V into their slots
                def lib():
                    for src, dst in zip((k, v), slots(want)):
                        dst.view(torch.bfloat16).copy_(src.view(B, -1))
            for impl in impls_of(fmt, "encode"):
                takum_encode_into((k, v), slots(cache), fmt, impl)
                encode_into_plain((k, v), slots(want), fmt, impl)
                check(torch.equal(cache.view(torch.uint8), want.view(torch.uint8)),
                      f"append[{impl}] {fmt} S={S}: the cache differs from the plain version's")
                if lib is not None:
                    lib()
                    check(torch.equal(cache.view(torch.uint8), want.view(torch.uint8)),
                          f"append {fmt} S={S}: the copy_ differs from the kernel's append")
                nbytes = 2 * (k.numel() * 2 + B * S * Kv * feat * esz)
                rows.append(codec_row(
                    torch, "takum_encode_into", fmt, impl, [2, B * S * Kv, hd], 0.0, nbytes,
                    lambda: takum_encode_into((k, v), slots(cache), fmt, impl),
                    lambda: encode_into_plain((k, v), slots(want), fmt, impl), lib, flush))
            del k, v, cache, want
        L = blockscale.payload_len(d) if wf.is_block_scaled else d
        table = torch.randint(0, 256, (V, L * esz), generator=gen, device=dev,
                              dtype=torch.uint8).view(wf.storage)
        scale = None if wf.is_block_scaled else torch.tensor(2.0 ** -6, device=dev)
        for n in EMBED_ROWS:
            ids = torch.randint(0, V, (n,), generator=gen, device=dev)
            for impl in impls_of(fmt, "decode"):
                got = takum_decode_rows(table, ids, fmt, impl, scale, torch.bfloat16)
                want = decode_rows_plain(table, ids, fmt, impl, scale, torch.bfloat16)
                check(same_bits_f32(torch, got.float(), want.float()),
                      f"embed[{impl}] {fmt} {n} rows: differs from the plain version")
                nbytes = n * (L * esz + 2 * d) + 4
                rows.append(codec_row(
                    torch, "takum_decode_rows", fmt, impl, [n, V, d], 0.0, nbytes,
                    lambda: takum_decode_rows(table, ids, fmt, impl, scale, torch.bfloat16),
                    lambda: decode_rows_plain(table, ids, fmt, impl, scale, torch.bfloat16),
                    None, flush))
        del table
        log(f"append / embedding rows {fmt}: bit-exact at the decode step's and the prefill's "
            f"shapes, timed")
    del flush


#: the tied heads of phase (c): (arch, V, d) of the packed table [V, d]
TIED_HEADS = (("gemma2_2b", 256000, 2304), ("llama3_2_3b", 128256, 3072))
#: K6 at the other archs' decode shapes, phase (c): arch -> (B, H, Kv, S,
#: hd, length, window, softcap): gemma2's local layer in its last decode
#: step of phase (i1) (a prompt of 4160, 32 steps; its cache 4194), and
#: granite's MQA (g = 48) at phase (i3)'s serving shape
ARCH_ATTENTION = {"gemma2_2b": (4, 8, 4, 4194, 256, 4192, 4096, 50.0),
                  "granite_34b": (4, 48, 1, 290, 128, 288, 0, 0.0)}


def tied_head_rows(torch, gen, flush, rows, arch, V, d, M=4):
    """The transposed K3 over a tied table ``[V, d]`` at M = ``M`` (x f32,
    the matvec), t16 bits and t8 lut, within K3_LIMIT of |x| @ |e|.T and
    lut == bits, one timed row per format (the codec the model runs) beside
    its bound and ``torch.matmul(x, decode(e).T)``.  Returns the table."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.lut import resolve_impl
    from repro_torch.kernels.takum_codec import decode_2d_plain, takum_encode_2d
    from repro_torch.kernels.takum_matmul import takum_matmul_t, takum_matmul_t_plain

    dev = flush.device
    table = torch.randn((V, d), generator=gen, device=dev) * d ** -0.5
    x = torch.randn((M, d), generator=gen, device=dev)
    for fmt in ("t16", "t8"):
        wf = wire_format(fmt)
        bits = takum_encode_2d(table, fmt)  # K2: bit for bit with its plain version above
        wd = decode_2d_plain(bits, fmt)
        scale = torch.matmul(x.abs(), wd.abs().T)
        got_bits = takum_matmul_t(x, bits, fmt, "bits")
        loop = takum_matmul_t.last_loop
        for impl in impls_of(fmt, "decode"):
            tag = f"head^T[{impl}] {fmt} {arch} [{V}, {d}]"
            got = got_bits if impl == "bits" else takum_matmul_t(x, bits, fmt, impl)
            want = takum_matmul_t_plain(x, bits, fmt, decode_impl=impl)
            ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
            check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|e|.T > {K3_LIMIT}")
            check(same_bits_f32(torch, got, got_bits), f"{tag}: differs from bits")
            if impl != resolve_impl(None, fmt):  # time the codec the model runs
                continue
            rate, rate_name = matmul_rate(torch, fmt, torch.float32)
            b_ms, b_by = bound(M * d * 4 + V * d * wf.nbits // 8 + M * V * 4,
                               2.0 * M * V * d, rate)
            kern = lambda: takum_matmul_t(x, bits, fmt, impl)
            lib = lambda: torch.matmul(x, wd.T)
            rows.append(dict(
                kernel="takum_matmul_t", fmt=fmt, impl=impl, shape=[M, d, V], x="float32",
                arch=arch, loop=loop, max_abs_err=float((got - want).abs().max()),
                err_over_absprod=ratio, ms=time_ms(torch, kern, flush=flush),
                plain_ms=time_ms(torch, lambda: takum_matmul_t_plain(
                    x, bits, fmt, decode_impl=impl), flush=flush),
                bound_ms=b_ms, bound_by=b_by, bound_rate=rate_name,
                library_ms=time_ms(torch, lib, flush=flush),
                device_ms=device_ms(torch, kern, flush=flush),
                library_device_ms=device_ms(torch, lib, flush=flush)))
            del want
        del bits, wd, scale, got_bits, got
        log(f"head^T {fmt} {arch} [{V}, {d}] at M = {M} ({loop}): within {K3_LIMIT} of "
            f"|x|@|e|.T, lut == bits, timed")
    return table


def attention_row(torch, gen, flush, rows, arch, shape, fmt="t8"):
    """K6 at ``shape`` = (B, H, Kv, S, hd, length, window, softcap) over a
    ``fmt`` cache (t8: lut and bits; f32: bits), within 1e-5 max|v| and
    lut == bits; one timed row (the codec the model runs) beside its bound
    and SDPA over the keys repeated to every query head with the window's
    mask (SDPA has no softcap)."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.lut import resolve_impl
    from repro_torch.kernels.takum_attention import (_valid_keys, decode_attention_plain,
                                                     takum_decode_attention)
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain

    dev = flush.device
    F = torch.nn.functional
    B, H, Kv, S, hd, length, window, cap = shape
    wf = wire_format(fmt)
    k8, v8 = (encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
              for _ in range(2))
    kc = k8.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    vc = v8.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    vmax = float(decode_2d_plain(v8, fmt).abs().max())
    args = dict(length=length, window=window, softcap=cap)
    got_bits = takum_decode_attention(q, kc, vc, fmt, decode_impl="bits", **args)
    for impl in impls_of(fmt, "decode"):
        tag = f"K6[{impl}] {fmt} {arch} {[B, H, Kv, S, hd]}"
        got = takum_decode_attention(q, kc, vc, fmt, decode_impl=impl, **args)
        want = decode_attention_plain(q, kc, vc, fmt, length, window, cap, decode_impl=impl)
        err = float((got - want).abs().max())
        check(err <= 1e-5 * vmax, f"{tag}: err {err} > 1e-5 max|v|")
        check(same_bits_f32(torch, got, got_bits), f"{tag}: differs from K6[bits]")
        if impl != resolve_impl(None, fmt):
            continue
        keys = length - (max(0, length - window) if window else 0)
        nbytes = q.numel() * 4 * 2 + 2 * B * Kv * keys * hd * wf.nbits // 8
        b_ms, b_by = bound(nbytes, 4.0 * B * H * keys * hd)
        g = H // Kv
        kf = decode_2d_plain(k8, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        vf = decode_2d_plain(v8, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        kf = kf.repeat_interleave(g, dim=1)[:, :, :length].contiguous()
        vf = vf.repeat_interleave(g, dim=1)[:, :, :length].contiguous()
        mask = _valid_keys(length, length, window, dev)[None, :]  # [1, keys] over q's one row
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q4, kf, vf, attn_mask=mask)
        kern = lambda: takum_decode_attention(q, kc, vc, fmt, decode_impl=impl, **args)
        rows.append(dict(
            kernel="takum_decode_attention", fmt=fmt, impl=impl, shape=[B, H, Kv, S, hd],
            arch=arch, length=length, window=window, softcap=cap, keys_read=keys,
            max_abs_err=err, ms=time_ms(torch, kern, flush=flush),
            plain_ms=time_ms(torch, lambda: decode_attention_plain(
                q, kc, vc, fmt, length, window, cap, decode_impl=impl), flush=flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, sdpa, flush=flush),
            device_ms=device_ms(torch, kern, flush=flush),
            library_device_ms=device_ms(torch, sdpa, flush=flush)))
        del kf, vf
    both = ", lut == bits" if len(impls_of(fmt, "decode")) > 1 else ""
    log(f"K6 {fmt} {arch} (H {H}, Kv {Kv}, hd {hd}, length {length}, window {window}, "
        f"softcap {cap}): within 1e-5 max|v|{both}, timed")


def phase_arch_kernels(torch, dev, rows):
    """The other dense archs' new kernel shapes against their plain
    versions, timed beside their bound and library call: the tied head, the
    transposed K3 over the stored table at M = 4 (``ops.matmul_t``, x f32,
    the matvec), t16 bits and t8 lut (``tied_head_rows``); the mx tied
    head's K1-mx decode of gemma2's table (mxt8 lut, bit for bit); K6 at
    gemma2's shape (hd 256, softcap 50, a window of 4096 under the length)
    and granite's (g = 48), t8 lut and bits (``attention_row``; both past 48
    KiB of shared memory)."""
    from repro_torch.kernels.takum_codec import decode_2d_plain, takum_decode_2d, takum_encode_2d

    gen = torch.Generator(device=dev)
    gen.manual_seed(2207)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for arch, V, d in TIED_HEADS:
        table = tied_head_rows(torch, gen, flush, rows, arch, V, d)
        if arch == "gemma2_2b":  # the mx tied head: K1-mx over the table, then a matmul
            payload = takum_encode_2d(table, "mxt8")
            got = takum_decode_2d(payload, "mxt8", "lut")
            check(same_bits_f32(torch, got, decode_2d_plain(payload, "mxt8", "lut")),
                  f"K1-mx head mxt8 {arch}: differs from the plain decode")
            del got
            rows.append(codec_row(
                torch, "takum_decode_2d", "mxt8", "lut", [V, d], 0.0,
                payload.numel() + V * d * 4,
                lambda: takum_decode_2d(payload, "mxt8", "lut"),
                lambda: decode_2d_plain(payload, "mxt8", "lut"), None, flush))
            log(f"K1-mx head mxt8 {arch} [{V}, {d}]: bit-exact, timed")
            del payload
        del table
        torch.cuda.empty_cache()
    for arch, shape in ARCH_ATTENTION.items():
        attention_row(torch, gen, flush, rows, arch, shape)
    del flush
    torch.cuda.empty_cache()


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
        dec_impls, enc_impls = impls_of(fmt, "decode"), impls_of(fmt, "encode")
        # K1: every code, K2: an f32 sweep, each codec bit for bit against its
        # plain version and the lut kernels against the bits kernels
        codes = all_codes(torch, wf, dev)
        ref_dec = takum_decode_2d(codes, fmt, "bits")
        for impl in dec_impls:
            got = takum_decode_2d(codes, fmt, impl)
            check(same_bits_f32(torch, got, decode_2d_plain(codes, fmt, impl)),
                  f"K1[{impl}] {fmt}: kernel decode differs from the plain decode")
            check(same_bits_f32(torch, got, ref_dec), f"K1[{impl}] {fmt}: differs from K1[bits]")
        x = encode_sweep(torch, fmt, dev, gen)
        x = torch.cat([x, x.new_zeros(-x.numel() % 64)]).reshape(-1, 64)
        ref_enc = as_i64(torch, takum_encode_2d(x, fmt, "bits"))
        for impl in enc_impls:
            got = as_i64(torch, takum_encode_2d(x, fmt, impl))
            nbad = int((got != as_i64(torch, encode_2d_plain(x, fmt, impl))).sum())
            check(nbad == 0, f"K2[{impl}] {fmt}: {nbad} of {x.numel()} codes differ from plain")
            nbad = int((got != ref_enc).sum())
            check(nbad == 0, f"K2[{impl}] {fmt}: {nbad} of {x.numel()} codes differ from K2[bits]")
        log(f"K1/K2 {fmt}: {codes.numel()} codes and {x.numel()} f32 inputs bit-exact, "
            f"codecs {dec_impls} / {enc_impls}")

        # K1 / K2 at the serving shapes, bit for bit, timed by events and as
        # device time beside the library call: the embedding rows [B*S0, d]
        # (K1), the prefill's KV block [B*S0*Kv, hd] (K2) and one packed
        # weight [d, d_ff] (58.7 M elements: what quantize_params packs, and
        # K1 decoding it back; many trips of the persistent grid)
        for kname, shape in CODEC_SHAPES:
            xf = torch.randn(shape, generator=gen, device=dev) * CODEC_SCALE.get(shape, 1.0)
            bits = encode_2d_plain(xf, fmt, "bits")
            for impl in (dec_impls if kname == "takum_decode_2d" else enc_impls):
                if kname == "takum_decode_2d":
                    kern, plain, arg = takum_decode_2d, decode_2d_plain, bits
                    got, want = takum_decode_2d(bits, fmt, impl), decode_2d_plain(bits, fmt, impl)
                    check(same_bits_f32(torch, got, want), f"K1[{impl}] {fmt} {shape}: differs from plain")
                    err = (got - want).abs().max()
                    nbytes = bits.numel() * (wf.nbits // 8 + 4)
                    lib = library_decode(torch, fmt, bits, want)
                else:
                    kern, plain, arg = takum_encode_2d, encode_2d_plain, xf
                    got = takum_encode_2d(xf, fmt, impl)
                    nbad = int((as_i64(torch, got) != as_i64(torch, bits)).sum())
                    check(nbad == 0, f"K2[{impl}] {fmt} {shape}: {nbad} codes differ from plain")
                    err = (decode_2d_plain(got, fmt) - decode_2d_plain(bits, fmt)).abs().max()
                    nbytes = xf.numel() * (4 + wf.nbits // 8)
                    lib = library_encode(torch, fmt, xf, bits)
                del got
                rows.append(codec_row(torch, kname, fmt, impl, shape, float(err), nbytes,
                                      lambda: kern(arg, fmt, impl), lambda: plain(arg, fmt, impl),
                                      lib, flush))
            del xf, bits
        log(f"K1/K2 {fmt}: bit-exact at [1024, 4096], [8192, 128] and [4096, 14336], timed")

        # K3 at the serving shapes (bf16 activations: decode M=4, prefill
        # M=B*S0=1024) and ragged shapes for each tile size with f32 and bf16
        # x.  Limit K3_LIMIT * (|x| @ |w|); for t16 two controls that lose
        # precision K3 must keep (decoded weights rounded to bf16; both
        # operands rounded to TF32) must exceed it.  K3[lut] must equal
        # K3[bits] bit for bit: the same decoded values summed in the same order.
        K = 4096
        shapes = [(M, K, N, torch.bfloat16) for M in (4, 1024) for N in (1024, 4096, 14336, 128256)]
        shapes += [(M, 14336, 4096, torch.bfloat16) for M in (4, 1024)]
        shapes += [(M, 1000, 777, dt) for M in (5, 37) for dt in (torch.float32, torch.bfloat16)]
        if fmt in ("t8", "t16"):
            # f32 x at the prefill's M over wi: the wgmma tile (x split three
            # ways), the forward of K5 at that shape
            shapes += [(1024, K, 14336, torch.float32)]
        for M, K_, N, xdt in shapes:
            xm = torch.randn((M, K_), generator=gen, device=dev).to(xdt)
            w = encode_2d_plain(torch.randn((K_, N), generator=gen, device=dev) * 0.5, fmt)
            wd = decode_2d_plain(w, fmt)
            scale = torch.matmul(xm.float().abs(), wd.abs())
            got_bits = takum_matmul(xm, w, fmt, decode_impl="bits")
            loop = takum_matmul.last_loop
            for impl in dec_impls:
                tag = f"K3[{impl}] {fmt} {M}x{K_}x{N} x {str(xdt)[6:]}"
                got = got_bits if impl == "bits" else takum_matmul(xm, w, fmt, decode_impl=impl)
                want = takum_matmul_plain(xm, w, fmt, decode_impl=impl)
                ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
                check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
                check(same_bits_f32(torch, got, got_bits), f"{tag}: differs from K3[bits]")
                row = dict(kernel="takum_matmul", fmt=fmt, impl=impl, shape=[M, K_, N],
                           x=str(xdt)[6:], loop=loop, max_abs_err=float((got - want).abs().max()),
                           err_over_absprod=ratio)
                del got
                if fmt == "t16" and K_ == K and impl == "bits":
                    for name, ctrl in (
                            ("bf16_weights", lambda: torch.matmul(xm.float(), wd.bfloat16().float())),
                            ("tf32_operands", lambda: torch.matmul(tf32(torch, xm.float()), tf32(torch, wd)))):
                        c = float(((ctrl() - want).abs() / scale.clamp(min=1e-30)).max())
                        check(c > K3_LIMIT, f"{tag}: control {name} ({c:.3g}) passes the limit")
                        row[f"control_{name}_over_absprod"] = c
                del want
                xb = xm.element_size()
                rate, rate_name = matmul_rate(torch, fmt, xdt)
                b_ms, b_by = bound(M * K_ * xb + K_ * N * wf.nbits // 8 + M * N * 4, 2.0 * M * N * K_,
                                   rate)
                kern = lambda: takum_matmul(xm, w, fmt, decode_impl=impl)
                lib = lambda: torch.matmul(xm.float(), wd)
                row.update(
                    ms=time_ms(torch, kern, flush=flush),
                    plain_ms=time_ms(torch, lambda: takum_matmul_plain(xm, w, fmt, decode_impl=impl),
                                     flush=flush),
                    bound_ms=b_ms, bound_by=b_by, bound_rate=rate_name,
                    library_ms=time_ms(torch, lib, flush=flush))
                if M == 4:
                    row.update(device_ms=device_ms(torch, kern, flush=flush),
                               library_device_ms=device_ms(torch, lib, flush=flush))
                if M == 1024 and fmt in BF16_EXACT and xdt == torch.bfloat16:
                    # a yardstick of speed only: it rounds its output to bf16
                    wb = wd.bfloat16()
                    row["library_bf16_out_ms"] = time_ms(torch, lambda: torch.matmul(xm, wb),
                                                         flush=flush)
                    del wb
                rows.append(row)
            del wd, scale, got_bits
        log(f"K3 {fmt}: {len(shapes)} shapes within {K3_LIMIT} of |x|@|w|, lut == bits")
        for M, K_, N in POSITIVE_SHAPES if fmt in ("t8", "t16") else ():
            for xdt in (torch.bfloat16, torch.float32):
                reading, loop, controls = k3_exact_reading(torch, dev, fmt, M, K_, N, True, xdt)
                for impl, ratio in reading.items():
                    tag = f"K3[{impl}] {fmt} {M}x{K_}x{N} x {str(xdt)[6:]} all-positive"
                    check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of the exact sum > {K3_LIMIT}")
                    rows.append(dict(kernel="takum_matmul", fmt=fmt, impl=impl, shape=[M, K_, N],
                                     x=str(xdt)[6:], loop=loop, inputs="all-positive",
                                     reference="exact", err_over_absprod=ratio,
                                     **{f"control_{k}_over_absprod": v for k, v in controls.items()}))
                for name, c in controls.items():
                    check(c > K3_LIMIT, f"K3 {fmt} {M}x{K_}x{N} all-positive: control {name} "
                                        f"({c:.3g}) passes the limit")
                log(f"K3 {fmt} {M}x{K_}x{N} x {str(xdt)[6:]} all-positive ({loop}): {reading} of "
                    f"the exact sum; controls {controls}")

        # K6: B=4, H=32, Kv=8, hd=128 over the cache's [B, S, Kv, hd] layout, S=288
        B, H, Kv, hd, S = 4, 32, 8, 128, 288
        cache = encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
        kc = cache.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        vcache = encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
        vc = vcache.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        vmax = float(decode_2d_plain(vcache, fmt).abs().max())
        kf = decode_2d_plain(cache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        vf = decode_2d_plain(vcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
        kf = kf.repeat_interleave(H // Kv, dim=1).contiguous()
        vf = vf.repeat_interleave(H // Kv, dim=1).contiguous()
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q4, kf, vf)
        lib_ms = time_ms(torch, sdpa, flush=flush)
        lib_device_ms = device_ms(torch, sdpa, flush=flush)
        del kf, vf, sdpa
        for length, window, cap in ((270, 0, 0.0), (S, 0, 0.0), (200, 64, 30.0)):
            args = dict(length=length, window=window, softcap=cap)
            got_bits = takum_decode_attention(q, kc, vc, fmt, decode_impl="bits", **args)
            for impl in dec_impls:
                got = takum_decode_attention(q, kc, vc, fmt, decode_impl=impl, **args)
                want = decode_attention_plain(q, kc, vc, fmt, length, window, cap, decode_impl=impl)
                err = float((got - want).abs().max())
                check(err <= 1e-5 * vmax, f"K6[{impl}] {fmt} length={length}: err {err} > 1e-5 max|v|")
                check(same_bits_f32(torch, got, got_bits),
                      f"K6[{impl}] {fmt} length={length}: differs from K6[bits]")
                if length != S:
                    continue
                nbytes = q.numel() * 4 * 2 + 2 * B * Kv * length * hd * wf.nbits // 8
                b_ms, b_by = bound(nbytes, 4.0 * B * H * length * hd)
                kern = lambda: takum_decode_attention(q, kc, vc, fmt, length=length,
                                                      decode_impl=impl)
                rows.append(dict(
                    kernel="takum_decode_attention", fmt=fmt, impl=impl, shape=[B, H, Kv, S, hd],
                    length=length, max_abs_err=err, ms=time_ms(torch, kern, flush=flush),
                    plain_ms=time_ms(torch, lambda: decode_attention_plain(
                        q, kc, vc, fmt, length, decode_impl=impl), flush=flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    device_ms=device_ms(torch, kern, flush=flush),
                    library_device_ms=lib_device_ms))
        log(f"K6 {fmt}: within 1e-5 max|v| at length 270, 288 and a window of 64, lut == bits")
    del flush


def phase_mx_kernels(torch, dev, rows):
    """K1-mx, K2-mx, K3-mx and K6-mx against their plain versions, each
    codec (bits, lut) and lut against bits."""
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
        dec_impls, enc_impls = impls_of(fmt, "decode"), impls_of(fmt, "encode")
        codes = mx_all_codes(dev)
        ref_dec = takum_decode_2d(codes, fmt, "bits")
        for impl in dec_impls:
            got = takum_decode_2d(codes, fmt, impl)
            check(same_bits_f32(torch, got, decode_2d_plain(codes, fmt, impl)),
                  f"K1-mx[{impl}] {fmt}: kernel decode differs from the plain decode")
            check(same_bits_f32(torch, got, ref_dec), f"K1-mx[{impl}] {fmt}: differs from K1-mx[bits]")
        x = mx_sweep(gen, 1 << 13).reshape(-1, 64)
        ref_enc = takum_encode_2d(x, fmt, "bits")
        for impl in enc_impls:
            got, want = takum_encode_2d(x, fmt, impl), encode_2d_plain(x, fmt, impl)
            nbad = int((got != want).sum())
            check(nbad == 0, f"K2-mx[{impl}] {fmt}: {nbad} of {want.numel()} payload bytes differ "
                             f"from plain")
            nbad = int((got != ref_enc).sum())
            check(nbad == 0, f"K2-mx[{impl}] {fmt}: {nbad} payload bytes differ from K2-mx[bits]")
        log(f"K1-mx/K2-mx {fmt}: 65536 codes x scales and {x.numel() // 32} blocks bit-exact, "
            f"codecs {dec_impls} / {enc_impls}")

        # the serving shapes: the prefill's KV append [B*S0*Kv, hd], the
        # embedding rows [B*S0, d] and one packed weight [d, d_ff] (past the
        # kernels' grid cap), encode and decode each bit for bit
        for shape in ((8192, 128), (1024, 4096), (4096, 14336)):
            xf = torch.randn(shape, generator=gen, device=dev) * shape[1] ** -0.5
            bits = encode_2d_plain(xf, fmt, "bits")
            for impl in enc_impls:
                nbad = int((takum_encode_2d(xf, fmt, impl) != bits).sum())
                check(nbad == 0, f"K2-mx[{impl}] {fmt} {shape}: {nbad} payload bytes differ from plain")
            want = decode_2d_plain(bits, fmt, "bits")
            for impl in dec_impls:
                check(same_bits_f32(torch, takum_decode_2d(bits, fmt, impl), want),
                      f"K1-mx[{impl}] {fmt} {shape}: differs from plain")
            nel, npay = xf.numel(), bits.numel()
            for kname, kern, plain, arg, nbytes, impls in (
                    ("takum_decode_2d", takum_decode_2d, decode_2d_plain, bits, npay + 4 * nel,
                     dec_impls),
                    ("takum_encode_2d", takum_encode_2d, encode_2d_plain, xf, 4 * nel + npay,
                     enc_impls)):
                for impl in impls:
                    rows.append(codec_row(torch, kname, fmt, impl, shape, 0.0, nbytes,
                                          lambda: kern(arg, fmt, impl),
                                          lambda: plain(arg, fmt, impl), None, flush))
            del xf, bits, want
        log(f"K1-mx/K2-mx {fmt}: bit-exact at [8192, 128], [1024, 4096] and [4096, 14336], timed")

        # K3-mx: ragged N (a padded last group) at both tile sizes with f32
        # and bf16 x; for mxt8 also the serving shapes of the mxt8 policy
        # (bf16 x, M = 4 decode and M = 1024 prefill, d_ff and the head)
        shapes = [(M, 1000, N, dt) for M in (5, 37) for N in (100, 4096)
                  for dt in (torch.float32, torch.bfloat16)]
        if fmt == "mxt8":
            shapes += [(M, 4096, N, torch.bfloat16) for M in (4, 1024) for N in (14336, 128256)]
            shapes += [(1024, 4096, 14336, torch.float32)]  # the wgmma tile
        for M, K_, N, xdt in shapes:
            xm = torch.randn((M, K_), generator=gen, device=dev).to(xdt)
            w = encode_2d_plain(blockscale.pad_block(
                torch.randn((K_, N), generator=gen, device=dev) * K_ ** -0.5), fmt)
            wd = decode_2d_plain(w, fmt)[:, :N]
            scale = torch.matmul(xm.float().abs(), wd.abs())
            got_bits = takum_matmul(xm, w, fmt, n=N, decode_impl="bits")
            loop = takum_matmul.last_loop
            for impl in dec_impls:
                tag = f"K3-mx[{impl}] {fmt} {M}x{K_}x{N} x {str(xdt)[6:]}"
                got = got_bits if impl == "bits" else takum_matmul(xm, w, fmt, n=N, decode_impl=impl)
                want = takum_matmul_plain(xm, w, fmt, n=N, decode_impl=impl)
                ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
                check(tuple(got.shape) == (M, N), f"{tag}: shape {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
                check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
                check(same_bits_f32(torch, got, got_bits), f"{tag}: differs from K3-mx[bits]")
                row = dict(kernel="takum_matmul", fmt=fmt, impl=impl, shape=[M, K_, N],
                           x=str(xdt)[6:], loop=loop, max_abs_err=float((got - want).abs().max()),
                           err_over_absprod=ratio)
                del got, want
                if K_ == 4096:
                    rate, rate_name = matmul_rate(torch, fmt, xdt)
                    b_ms, b_by = bound(M * K_ * xm.element_size() + K_ * plen(N) + M * N * 4,
                                       2.0 * M * N * K_, rate)
                    kern = lambda: takum_matmul(xm, w, fmt, n=N, decode_impl=impl)
                    lib = lambda: torch.matmul(xm.float(), wd)
                    row.update(
                        ms=time_ms(torch, kern, flush=flush),
                        plain_ms=time_ms(torch, lambda: takum_matmul_plain(
                            xm, w, fmt, n=N, decode_impl=impl), flush=flush),
                        bound_ms=b_ms, bound_by=b_by, bound_rate=rate_name,
                        library_ms=time_ms(torch, lib, flush=flush))
                    if M == 4:
                        row.update(device_ms=device_ms(torch, kern, flush=flush),
                                   library_device_ms=device_ms(torch, lib, flush=flush))
                    if M == 1024 and xdt == torch.bfloat16:
                        # a yardstick of speed only: it rounds its output to bf16
                        wb = wd.bfloat16()
                        row["library_bf16_out_ms"] = time_ms(torch, lambda: torch.matmul(xm, wb),
                                                             flush=flush)
                        del wb
                rows.append(row)
            del wd, w, scale, got_bits
        log(f"K3-mx {fmt}: {len(shapes)} shapes within {K3_LIMIT} of |x|@|w|, lut == bits")

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
            lib_ms = lib_device_ms = None
            if hd == 128:
                kf = decode_2d_plain(kcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
                vf = decode_2d_plain(vcache, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
                kf = kf.repeat_interleave(H // Kv, dim=1).contiguous()
                vf = vf.repeat_interleave(H // Kv, dim=1).contiguous()
                q4 = q[:, :, None, :]
                sdpa = lambda: F.scaled_dot_product_attention(q4, kf, vf)
                lib_ms = time_ms(torch, sdpa, flush=flush)
                lib_device_ms = device_ms(torch, sdpa, flush=flush)
                del kf, vf, sdpa
            for length, window, cap in ((270, 0, 0.0), (S, 0, 0.0), (270, 64, 30.0)):
                args = dict(length=length, window=window, softcap=cap)
                got_bits = takum_decode_attention(q, kc, vc, fmt, decode_impl="bits", **args)
                for impl in dec_impls:
                    tag = f"K6-mx[{impl}] {fmt} hd={hd} length={length} window={window}"
                    got = takum_decode_attention(q, kc, vc, fmt, decode_impl=impl, **args)
                    want = decode_attention_plain(q, kc, vc, fmt, length, window, cap,
                                                  decode_impl=impl)
                    err = float((got - want).abs().max())
                    check(err <= 1e-5 * vmax, f"{tag}: err {err} > 1e-5 max|v|")
                    check(same_bits_f32(torch, got, got_bits), f"{tag}: differs from K6-mx[bits]")
                    if length != S or hd != 128:
                        continue
                    nbytes = q.numel() * 4 * 2 + 2 * B * Kv * length * plen(hd)
                    b_ms, b_by = bound(nbytes, 4.0 * B * H * length * hd)
                    kern = lambda: takum_decode_attention(q, kc, vc, fmt, length=length,
                                                          decode_impl=impl)
                    rows.append(dict(
                        kernel="takum_decode_attention", fmt=fmt, impl=impl,
                        shape=[B, H, Kv, S, hd], length=length, max_abs_err=err,
                        ms=time_ms(torch, kern, flush=flush),
                        plain_ms=time_ms(torch, lambda: decode_attention_plain(
                            q, kc, vc, fmt, length, decode_impl=impl), flush=flush),
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        device_ms=device_ms(torch, kern, flush=flush),
                        library_device_ms=lib_device_ms))
        log(f"K6-mx {fmt}: within 1e-5 max|v| at hd 128, 16 and 80, length 270 and 288, "
            f"a window of 64 with a softcap, lut == bits")
    del flush


def phase_bank_probe(torch, dev):
    """Shared-memory bank conflicts of the lut gather, measured by timing:
    K1 over the t8 embedding rows [1024, 4096] and K3 at M=4 over a t8
    weight [4096, 14336] (bf16 x), each codec, under three code patterns
    along a warp's 32 consecutive elements: one code (a broadcast: one
    shared-memory wavefront per warp), uniform random codes (NaR replaced),
    and codes 32 j + 1 for j = element index mod 8 (eight words of one
    bank: an 8-way conflict, the most a 256-entry table allows).  The bits
    codec reads no table and is the control.  K5's backward (the transposed
    K3, g [4, 14336]) over the same weight decodes 32 consecutive codes of
    one stored row per warp as K3 does, so it meets the same patterns."""
    from repro_torch.kernels.takum_codec import takum_decode_2d
    from repro_torch.kernels.takum_matmul import takum_matmul, takum_matmul_t

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def patterns(shape):
        rnd = torch.randint(0, 256, shape, generator=gen, device=dev)
        rnd = torch.where(rnd == 0x80, 0x7F, rnd)
        conflict = (torch.arange(shape[1], device=dev) % 8 * 32 + 1).expand(shape)
        return {"one code": torch.full(shape, 0x41, device=dev), "random": rnd,
                "8-way conflict": conflict}

    out = []
    xm = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((4, 14336), generator=gen, device=dev)
    for kname, shape in (("takum_decode_2d", (1024, 4096)), ("takum_matmul", (4096, 14336)),
                         ("takum_matmul_t", (4096, 14336))):
        for pattern, codes in patterns(shape).items():
            bits = codes.to(torch.uint8).contiguous()
            for impl in ("bits", "lut"):
                if kname == "takum_decode_2d":
                    fn = lambda: takum_decode_2d(bits, "t8", impl)
                elif kname == "takum_matmul":
                    fn = lambda: takum_matmul(xm, bits, "t8", decode_impl=impl)
                else:
                    fn = lambda: takum_matmul_t(g, bits, "t8", decode_impl=impl)
                out.append(dict(kernel=kname, fmt="t8", shape=list(shape), pattern=pattern,
                                impl=impl, ms=time_ms(torch, fn, flush=flush)))
            log(f"bank probe {kname} {pattern}: " + ", ".join(
                f"{r['impl']} {r['ms']:.4f} ms" for r in out[-2:]))
    return out


# ---------------------------------------------------------------------------
# phase (f): the producers (K3, K4, K6 with out_fmt, and K4 unfused)
# ---------------------------------------------------------------------------

#: every out format a producer stores
OUT_FMTS = FMTS + MX_FMTS


def out_cases():
    """(out format, encode codec) for every out format and every encode
    codec it has: 15 cases (bf16 has no encode tables)."""
    return [(o, oi) for o in OUT_FMTS for oi in impls_of(o, "encode")]


def bytes_differing(torch, a, b):
    """Count of differing storage bytes (differing codes of an 8-bit format,
    differing halves of a 16-bit one; a shape mismatch counts all)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel()) * a.element_size()
    return int((a.contiguous().view(torch.uint8) != b.contiguous().view(torch.uint8)).sum())


def dual_rate(fmt):
    """The card's peak for K4's products and its name: bf16 tensor cores
    where both decoded operands are exact in bf16 (every format but t16),
    else f32 FMA."""
    return (F32_FLOPS, "f32") if fmt == "t16" else (BF16_FLOPS, "bf16x1")


def phase_producers_exact(torch, dev):
    """(f) 1-3: every producer (K3, K3-mx, K4, K4-mx, K6, K6-mx) under each
    decode codec and each (out_fmt, encode codec) of ``out_cases``, at both
    K3/K4 loops (M = 3: the matvec; M = 37: the tiles), K not a multiple of
    the K tile (flat x: K =
    1000; an mx x is whole 32-blocks, K = 992), N = 96 (whole mx blocks, not a
    multiple of the 64-column tile), K6 at S = 100, d = 64 and 128, g = 4,
    and with length, window and softcap: the fused output must equal, bit
    for bit, K2's encode of the same kernel's unfused output.  K4 unfused
    against its plain version within K3_LIMIT of |decode(x)| @ |w|.  Then
    the specials: a NaN or Inf row of x gives the out family's special in
    exactly that row (head, for K6) and finite values elsewhere, and an
    overflow takes each family's route (t8 saturates finite, e4m3 NaN, e5m2
    and bf16 Inf).  Returns the differing-code counts per producer."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_attention import takum_decode_attention
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain, takum_decode_2d
    from repro_torch.kernels.takum_codec import takum_encode_2d
    from repro_torch.kernels.takum_matmul import (takum_dual_matmul, takum_dual_matmul_plain,
                                                  takum_matmul)
    from repro_torch.quant import blockscale

    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    cases = out_cases()
    differing = {}

    def held(producer, fused_fn, unfused, tag):
        """Every out case of one producer launch against K2 of its unfused
        output; flattens a [B, H, d] output to rows for K2."""
        flat = unfused.reshape(-1, unfused.shape[-1])
        nbad_all = 0
        for out, oi in cases:
            fused = fused_fn(out, oi)
            want = takum_encode_2d(flat, out, oi).reshape(*unfused.shape[:-1], -1)
            nbad = bytes_differing(torch, fused, want)
            nbad_all += nbad
            check(nbad == 0, f"{producer} {tag} -> {out}:{oi}: {nbad} codes differ from K2 of "
                             f"the unfused output")
        differing[producer] = differing.get(producer, 0) + nbad_all

    N = 96
    for fmt in FMTS + MX_FMTS:
        wf = wire_format(fmt)
        mx = wf.is_block_scaled
        kind = "mx" if mx else "flat"
        for impl in impls_of(fmt, "decode"):
            for M, xdt in ((3, torch.float32), (37, torch.bfloat16)):
                # K3: K = 1000 (not a multiple of either K tile)
                K = 1000
                x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
                w = encode_2d_plain(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5,
                                    fmt)
                unfused = takum_matmul(x, w, fmt, N, impl)
                held(f"K3 {kind}", lambda o, oi: takum_matmul(x, w, fmt, N, impl, o, oi),
                     unfused, f"{fmt}[{impl}] M={M} K={K} x {str(xdt)[6:]}")
                # K4: both operands fmt; an mx x is whole blocks along K
                K = 992 if mx else 1000
                xb = encode_2d_plain(torch.randn((M, K), generator=gen, device=dev), fmt)
                w = encode_2d_plain(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5,
                                    fmt)
                unfused = takum_dual_matmul(xb, w, fmt, N, impl)
                want = takum_dual_matmul_plain(xb, w, fmt, N, decode_impl=impl)
                scale = torch.matmul(decode_2d_plain(xb, fmt).abs(), decode_2d_plain(w, fmt).abs())
                ratio = float(((unfused - want).abs() / scale.clamp(min=1e-30)).max())
                check(bool(torch.isfinite(unfused).all()), f"K4 {fmt}[{impl}] M={M}: non-finite")
                check(ratio <= K3_LIMIT, f"K4 {fmt}[{impl}] M={M} K={K}: err {ratio:.3g} of "
                                         f"|x|@|w| > {K3_LIMIT}")
                held(f"K4 {kind}", lambda o, oi: takum_dual_matmul(xb, w, fmt, N, impl, o, oi),
                     unfused, f"{fmt}[{impl}] M={M} K={K}")
            # K6: S = 100, g = 4, d = 64 and 128, the full cache and a
            # length / window / softcap case
            B, H, Kv, S = 2, 8, 2, 100
            for d in (64, 128):
                def cache():
                    c = encode_2d_plain(torch.randn((B * S * Kv, d), generator=gen, device=dev),
                                        fmt)
                    return c.reshape(B, S, Kv, -1).permute(0, 2, 1, 3)
                kc, vc = cache(), cache()
                q = torch.randn((B, H, d), generator=gen, device=dev)
                for args in (dict(), dict(length=77, window=40, softcap=20.0)):
                    unfused = takum_decode_attention(q, kc, vc, fmt, decode_impl=impl, **args)
                    held(f"K6 {kind}", lambda o, oi: takum_decode_attention(
                        q, kc, vc, fmt, decode_impl=impl, out_fmt=o, encode_impl=oi, **args),
                         unfused, f"{fmt}[{impl}] d={d} {args}")
    log(f"(f) fused == K2(unfused) for {len(cases)} out cases; differing codes {differing}")

    # specials: NaN / Inf rows of x (NaR rows of x bits for K4, a NaN in
    # head 0's q for K6) must give the out family's special in exactly those
    # rows, every other row finite
    def family_special(y, out):
        wf = wire_format(out)
        ok = not bool(torch.isfinite(y).any())
        if wf.special in ("nar", "nan") or wf.is_block_scaled:
            ok = ok and bool(torch.isnan(y).all())
        return ok

    M, K, Nsp = 8, 64, 64
    for out in OUT_FMTS:
        for fmt in ("t8", "e4m3"):
            x = torch.randn((M, K), generator=gen, device=dev) * 0.1
            x[0, 0], x[1, 1] = math.nan, math.inf
            w = encode_2d_plain(torch.randn((K, Nsp), generator=gen, device=dev) * 0.1, fmt)
            y = takum_decode_2d(takum_matmul(x, w, fmt, out_fmt=out), out)
            check(family_special(y[:2], out) and bool(torch.isfinite(y[2:]).all()),
                  f"K3 {fmt} -> {out}: specials not confined to the poisoned rows")
        for fmt in ("t8", "t16"):
            x = torch.randn((M, K), generator=gen, device=dev) * 0.3
            x[0, 0], x[1, 1] = math.nan, math.inf
            xb = encode_2d_plain(x, fmt)
            w = encode_2d_plain(torch.randn((K, Nsp), generator=gen, device=dev) * 0.3, fmt)
            y = takum_decode_2d(takum_dual_matmul(xb, w, fmt, out_fmt=out), out)
            check(family_special(y[:2], out) and bool(torch.isfinite(y[2:]).all()),
                  f"K4 {fmt} -> {out}: specials not confined to the poisoned rows")
            kc = encode_2d_plain(torch.randn((40, 32), generator=gen, device=dev), fmt)
            kc = kc.reshape(1, 2, 20, 32)
            q = torch.randn((1, 4, 32), generator=gen, device=dev)
            q[0, 0, 0] = math.nan
            y = takum_decode_2d(takum_decode_attention(q, kc, kc, fmt, out_fmt=out)[0], out)
            check(family_special(y[0], out) and bool(torch.isfinite(y[1:]).all()),
                  f"K6 {fmt} -> {out}: specials not confined to head 0")
    # overflow: 64 products of 50 * 50 (160000: past e4m3's and e5m2's
    # range), and one product 1.843e19 * 2^64 (3.3998e38: finite in f32,
    # rounds past bf16's largest finite value)
    big = (torch.full((4, 64), 50.0, device=dev),
           encode_2d_plain(torch.full((64, 32), 50.0, device=dev), "t16"))
    huge_x = torch.zeros((4, 16), device=dev)
    huge_x[:, 0] = 1.843e19
    huge = (huge_x, encode_2d_plain(torch.full((16, 32), 2.0 ** 64, device=dev), "t16"))
    for out, (x, w), want in (("t8", big, "finite"), ("t8", huge, "finite"), ("e4m3", big, "nan"),
                              ("e5m2", big, "inf"), ("bf16", huge, "inf")):
        y = takum_decode_2d(takum_matmul(x, w, "t16", out_fmt=out), out)
        got = ("finite" if bool((torch.isfinite(y) & (y > 0)).all()) else
               "nan" if bool(torch.isnan(y).all()) else
               "inf" if bool((y == math.inf).all()) else "mixed")
        check(got == want, f"overflow to {out}: {got}, want {want}")
    log("(f) specials confined to their rows for every out format; overflow: t8 saturates, "
        "e4m3 NaN, e5m2 and bf16 Inf")
    return differing


#: (f) 4, the full-width rows: (producer, fmt, M, K, N, out_fmt, encode
#: impl); producer "K3" (bf16 x at the serving widths, the head at M=4),
#: "K4" (x bits of fmt), "K6" (B=4, H=32, Kv=8, S=288, hd=128); out None is
#: the unfused launch.  Every codec is its format's default.
FULL_ROWS = (
    [("K3", w, M, 4096, 14336, o, "lut") for w in ("t8", "t16") for M in (4, 1024)
     for o in ("t8", "mxt8")]
    + [("K3", "t8", 4, 4096, 128256, "t8", "lut")]
    + [("K4", f, M, 4096, 14336, o, oi) for M in (4, 1024)
       for f, o, oi in (("t8", None, None), ("t8", "t16", "lut"), ("t8", "t8", "lut"),
                        ("mxt8", None, None), ("mxt8", "mxt8", "lut"))]
    + [("K6", "t8", 4, 128, 0, "t8", "lut"), ("K6", "mxe4m3", 4, 128, 0, "mxe4m3", None)]
)


def phase_producers_full(torch, dev):
    """(f) 4: the producers at llama3-8b's widths, driven once through the
    ``ops`` entry points with the launch counts reset just before and read
    just after (the producer path of this phase), then each row checked
    (fused == K2 of the unfused output of the same kernel, bit for bit; K4
    unfused against its plain version within K3_LIMIT and against
    ``torch.matmul`` on pre-decoded bf16 operands) and timed: the kernel, its
    plain version, the unfused pair (K3/K4/K6 then K2) for a fused row, and
    ``torch.matmul`` on the pre-decoded operands for K4.  Returns (rows,
    launch counts of the producer path)."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels import lut, ops
    from repro_torch.kernels.takum_attention import decode_attention_plain
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain, takum_encode_2d
    from repro_torch.kernels import takum_matmul as tm
    from repro_torch.kernels.takum_matmul import takum_dual_matmul_plain, takum_matmul_plain
    from repro_torch.quant import blockscale

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    inputs = {}

    def operands(prod, fmt, M, K, N):
        key = (prod, fmt, M, K, N)
        if key not in inputs:
            if prod == "K6":
                B, H, Kv, S, hd = 4, 32, 8, 288, K
                def cache():
                    c = torch.randn((B * S * Kv, hd), generator=gen, device=dev)
                    return encode_2d_plain(c, fmt).reshape(B, S, Kv, -1).permute(0, 2, 1, 3)
                inputs[key] = (torch.randn((B, H, hd), generator=gen, device=dev), cache(),
                               cache())
            else:
                w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
                w = encode_2d_plain(w, fmt)
                x = torch.randn((M, K), generator=gen, device=dev)
                x = x.to(torch.bfloat16) if prod == "K3" else encode_2d_plain(x, fmt)
                inputs[key] = (x, w)
        return inputs[key]

    def call(prod, fmt, M, K, N, out, oi, plain=False):
        with ops.plain_path() if plain else contextlib.nullcontext():
            if prod == "K3":
                x, w = operands(prod, fmt, M, K, N)
                return ops.matmul(x, w, fmt, out_fmt=out, encode_impl=oi)
            if prod == "K4":
                x, w = operands(prod, fmt, M, K, N)
                return ops.dual_matmul(x, w, fmt, out_fmt=out, encode_impl=oi)
            q, kc, vc = operands(prod, fmt, M, K, N)
            return ops.decode_attention(q, kc, vc, fmt, out_fmt=out, encode_impl=oi)

    for row in FULL_ROWS:  # make every input before the counted run
        operands(*row[:5])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for row in FULL_ROWS:
        call(*row)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"(f) producer path launches: { {k: v for k, v in counts.items() if v} }")

    kname = {"K3": "takum_matmul", "K4": "takum_dual_matmul", "K6": "takum_decode_attention"}
    rows = []
    for prod, fmt, M, K, N, out, oi in FULL_ROWS:
        wf = wire_format(fmt)
        impl = lut.resolve_impl(None, fmt)
        out_name, out_impl = lut.resolve_out_fmt(out, oi)
        tag = f"{prod} {fmt}[{impl}] M={M} K={K} N={N}" + (f" -> {out_name}:{out_impl}" if out
                                                            else "")
        unfused = call(prod, fmt, M, K, N, None, None)
        loop = None
        if prod != "K6":
            loop = (tm.takum_matmul if prod == "K3" else tm.takum_dual_matmul).last_loop
        row = dict(kernel=kname[prod], producer=prod, fmt=fmt, impl=impl, loop=loop, out_fmt=out_name,
                   encode_impl=out_impl, shape=[M, K, N] if prod != "K6" else [4, 32, 8, 288, K],
                   launch_key=f"{kname[prod]}[{impl}" + (f">{out_name}:{out_impl}]" if out
                                                          else "]"))
        flat = unfused.reshape(-1, unfused.shape[-1])
        if out is not None:
            fused = call(prod, fmt, M, K, N, out, oi)
            want = takum_encode_2d(flat, out_name, out_impl).reshape(*unfused.shape[:-1], -1)
            nbad = bytes_differing(torch, fused, want)
            check(nbad == 0, f"{tag}: {nbad} codes differ from K2 of the unfused output")
            row.update(differing_codes=nbad, max_abs_err=0.0)
            del fused, want
        if prod == "K4":
            x, w = operands(prod, fmt, M, K, N)
            xd, wd = decode_2d_plain(x, fmt), decode_2d_plain(w, fmt)
            want = takum_dual_matmul_plain(x, w, fmt)
            scale = torch.matmul(xd.abs(), wd.abs())
            ratio = float(((unfused - want).abs() / scale.clamp(min=1e-30)).max())
            check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
            lib_in = (xd.to(torch.bfloat16), wd.to(torch.bfloat16))
            lib = torch.matmul(*lib_in).float()
            check(bool(((lib - unfused).abs() <= 1e-2 * scale + 1e-6).all()),
                  f"{tag}: far from torch.matmul on pre-decoded bf16 operands")
            row.update(err_over_absprod=ratio)
            if out is None:
                row["max_abs_err"] = float((unfused - want).abs().max())
            lib_f32 = (xd, wd)
            del want, scale, lib
        # bound: inputs read once, output written once; products at the
        # operands' peak rate
        out_wf = wire_format(out_name) if out else None
        if prod == "K6":
            B, H, Kv, S, hd = 4, 32, 8, 288, K
            cache = 2 * B * Kv * S * (blockscale.payload_len(hd) if wf.is_block_scaled
                                      else hd * wf.nbits // 8)
            out_bytes = B * H * (4 * hd if out_wf is None else
                                 blockscale.payload_len(hd) if out_wf.is_block_scaled
                                 else hd * out_wf.nbits // 8)
            b_ms, b_by = bound(B * H * hd * 4 + cache + out_bytes, 4.0 * B * H * S * hd)
        else:
            x, w = operands(prod, fmt, M, K, N)
            out_bytes = (M * N * 4 if out_wf is None else
                         M * blockscale.payload_len(N) if out_wf.is_block_scaled
                         else M * N * out_wf.nbits // 8)
            rate, rate_name = (matmul_rate(torch, fmt, torch.bfloat16) if prod == "K3"
                               else dual_rate(fmt))
            b_ms, b_by = bound(x.numel() * x.element_size() + w.numel() * w.element_size()
                               + out_bytes, 2.0 * M * N * K, rate)
            row["bound_rate"] = rate_name
        row.update(
            ms=time_ms(torch, lambda: call(prod, fmt, M, K, N, out, oi), flush=flush),
            plain_ms=time_ms(torch, lambda: call(prod, fmt, M, K, N, out, oi, plain=True),
                             flush=flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if out is not None:
            # the unfused pair this launch replaces: the producer, then K2
            row["unfused_pair_ms"] = time_ms(torch, lambda: takum_encode_2d(
                call(prod, fmt, M, K, N, None, None).reshape(-1, flat.shape[-1]), out_name,
                out_impl), flush=flush)
        if prod == "K4" and out is None:
            # the same function on the pre-decoded operands (f32), and as a
            # yardstick of speed only the bf16 product, which rounds its
            # output to bf16
            row["library_ms"] = time_ms(torch, lambda: torch.matmul(*lib_f32), flush=flush)
            row["library_bf16_out_ms"] = time_ms(torch, lambda: torch.matmul(*lib_in), flush=flush)
        if prod == "K4":
            del lib_f32, lib_in
        rows.append(row)
        log(f"(f) {tag}: {row['ms']:.4f} ms, loop {loop} (bound {b_ms:.4f}, {b_by}; plain "
            f"{row['plain_ms']:.3f}; pair {row.get('unfused_pair_ms')}; torch.matmul "
            f"{row['library_ms']}, bf16 out {row.get('library_bf16_out_ms')})")
        del unfused, flat
    del flush, inputs
    torch.cuda.empty_cache()
    return rows, counts


# ---------------------------------------------------------------------------
# phase (g): K5, takum_matmul_ad (K3 forward, transposed-K3 backward)
# ---------------------------------------------------------------------------


def transposed_copy(torch, w):
    """``w.T`` as a contiguous copy, 16-bit bits moved through their int16
    view (CUDA torch copies few uint16 tensors)."""
    signed = torch.int16 if w.dtype == torch.uint16 else w.dtype
    return w.view(signed).T.contiguous().view(w.dtype)


def phase_ad_exact(torch, dev):
    """(g) 1-2: the transposed K3 (K5's backward) for every flat format under
    each decode codec at M = 3 and 37 (the matvec and the FMA tile) over a
    stored weight
    [96, 1000] (the backward's reduction, 1000, a multiple of neither K
    tile), within K3_LIMIT of |g| @ |decode(w)|.T of its plain version and
    bit for bit equal to K3 over a transposed copy of the bits; the forward
    of ``takum_matmul_ad`` bit for bit equal to ``takum_matmul``; a bf16 x
    gets a bf16 dx; every mx format is refused.  Then one autograd step,
    ``(takum_matmul_ad(x, w) ** 2).sum().backward()``, per flat format at
    M = 37: exactly one K3 and one transposed K3 launched, and x.grad
    against the plain path.  Returns the largest error ratio per format."""
    from repro_torch.kernels import lut, ops
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain
    from repro_torch.kernels.takum_matmul import (takum_matmul, takum_matmul_ad, takum_matmul_t,
                                                  takum_matmul_t_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(516)
    K, N = 96, 1000
    worst = {}
    for fmt in FMTS:
        w = encode_2d_plain(torch.randn((K, N), generator=gen, device=dev) * N ** -0.5, fmt)
        wd = decode_2d_plain(w, fmt)
        copy = transposed_copy(torch, w)
        for M in (3, 37):
            g = torch.randn((M, N), generator=gen, device=dev)
            scale = torch.matmul(g.abs(), wd.abs().T)
            for impl in impls_of(fmt, "decode"):
                tag = f"K5 backward {fmt}[{impl}] M={M} stored {K}x{N}"
                got = takum_matmul_t(g, w, fmt, impl)
                want = takum_matmul_t_plain(g, w, fmt, decode_impl=impl)
                ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
                check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |g|@|w|.T > {K3_LIMIT}")
                check(same_bits_f32(torch, got, takum_matmul(g, copy, fmt, decode_impl=impl)),
                      f"{tag}: differs from K3 over the transposed copy")
                worst[fmt] = max(worst.get(fmt, 0.0), ratio)
            x = torch.randn((M, K), generator=gen, device=dev)
            check(same_bits_f32(torch, takum_matmul_ad(x, w, fmt), takum_matmul(x, w, fmt)),
                  f"K5 forward {fmt} M={M}: differs from takum_matmul")
            xb = x.to(torch.bfloat16).requires_grad_()
            takum_matmul_ad(xb, w, fmt).sum().backward()
            check(xb.grad.dtype == torch.bfloat16, f"K5 {fmt}: bf16 x got a {xb.grad.dtype} dx")
        del w, wd, copy
    for fmt in MX_FMTS:
        try:
            takum_matmul_ad(torch.zeros((8, 32), device=dev),
                            torch.zeros((32, 33), dtype=torch.uint8, device=dev), fmt)
        except ValueError as e:
            check("block-scaled" in str(e), f"K5 {fmt}: refused with {e}")
        else:
            raise PhaseError(f"K5 {fmt}: a block-scaled weight was not refused")
    log(f"(g) transposed K3 within {K3_LIMIT} of |g|@|w|.T at M=3 and 37, equal to K3 over the "
        f"copy; forward == K3; bf16 dx; mx refused; worst {worst}")

    # one autograd step per format, counted, against the plain path
    M = 37
    for fmt in FMTS:
        impl = lut.resolve_impl(None, fmt)
        w = encode_2d_plain(torch.randn((K, N), generator=gen, device=dev) * N ** -0.5, fmt)
        wd = decode_2d_plain(w, fmt)
        x0 = torch.randn((M, K), generator=gen, device=dev)
        x = x0.clone().requires_grad_()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        y = takum_matmul_ad(x, w, fmt)
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        got = {k: v for k, v in ops.launch_counts().items() if v}
        want = {f"takum_matmul[{impl}]": 1, f"takum_matmul[{impl}^T]": 1}
        check(got == want, f"K5 {fmt} autograd step: launches {got}, want {want}")
        xp = x0.clone().requires_grad_()
        with ops.plain_path():
            yp = takum_matmul_ad(xp, w, fmt)
            (yp ** 2).sum().backward()
        # the kernel's dx against the plain backward of the same cotangent,
        # and against the whole plain path: its cotangent 2 y differs by the
        # forward's own allowed error, 2 K3_LIMIT (|x| @ |w|), carried by |w|.T
        g = 2 * y.detach()
        own = takum_matmul_t_plain(g, w, fmt)
        check(bool(((x.grad - own).abs() <= K3_LIMIT * (g.abs() @ wd.abs().T)).all()),
              f"K5 {fmt} autograd step: x.grad off the plain backward of its cotangent")
        path_limit = K3_LIMIT * (g.abs() @ wd.abs().T
                                 + 2 * (x0.abs() @ wd.abs()) @ wd.abs().T)
        check(bool(((x.grad - xp.grad).abs() <= path_limit).all()),
              f"K5 {fmt} autograd step: x.grad off the plain path's")
    ops.reset_launch_counts()
    log("(g) one autograd step per flat format: one K3 and one transposed K3 each, x.grad "
        "within K3_LIMIT of the plain path")
    return worst


#: (g) 3, the full-width rows: (weight, stored [K, N], M, format) for the
#: backward of llama3-8b's wi (a long reduction, 14336, into 4096 outputs),
#: w2 (a short one, 4096, into 14336) and head; each format's default codec
#: (t8 lut, t16 bits)
AD_ROWS = ([("wi", 4096, 14336, M, fmt) for M in (4, 1024) for fmt in ("t8", "t16")]
           + [("w2", 14336, 4096, 1024, fmt) for fmt in ("t8", "t16")]
           + [("head", 4096, 128256, 4, fmt) for fmt in ("t8", "t16")])


def phase_ad_full(torch, dev):
    """(g) 3: K5 at llama3-8b's widths, driven once through
    ``takum_matmul_ad`` (f32 x, ``(y ** 2).sum().backward()`` per row) with
    the launch counts reset just before and read just after (the K5 path of
    this phase), each step holding exactly one K3 and one transposed K3.
    Then each row's backward checked against its plain version within
    K3_LIMIT and timed: the transposed K3, its plain version, the library
    call ``torch.matmul(g, decode(w).T)``, the copy yardstick (the bits
    transposed into a copy, then K3) and, for comparison in the same call,
    K3 alone over that copy and the forward K3.  Returns (rows, launch
    counts of the K5 path)."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels import lut, ops
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain
    from repro_torch.kernels.takum_matmul import (takum_matmul, takum_matmul_ad, takum_matmul_t,
                                                  takum_matmul_t_plain)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2016)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    weights = {}
    for name, K, N, _, fmt in AD_ROWS:
        if (name, fmt) not in weights:
            w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
            weights[name, fmt] = encode_2d_plain(w, fmt)
            del w
    xs = [torch.randn((M, K), generator=gen, device=dev).requires_grad_()
          for _, K, _, M, _ in AD_ROWS]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    grads = []
    for (name, K, N, M, fmt), x in zip(AD_ROWS, xs):
        before = ops.launch_counts()
        y = takum_matmul_ad(x, weights[name, fmt], fmt)
        (y ** 2).sum().backward()
        grads.append(2 * y.detach())
        impl = lut.resolve_impl(None, fmt)
        step = {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()
                if v != before.get(k, 0)}
        want = {f"takum_matmul[{impl}]": 1, f"takum_matmul[{impl}^T]": 1}
        check(step == want, f"K5 {name} {fmt} M={M}: step launches {step}, want {want}")
        del y
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"(g) K5 path launches: { {k: v for k, v in counts.items() if v} }")

    rows = []
    for (name, K, N, M, fmt), x, g in zip(AD_ROWS, xs, grads):
        wf = wire_format(fmt)
        impl = lut.resolve_impl(None, fmt)
        w = weights[name, fmt]
        wd = decode_2d_plain(w, fmt)
        tag = f"K5 backward {name} {fmt}[{impl}] M={M} stored {K}x{N}"
        got = takum_matmul_t(g, w, fmt)
        loop = takum_matmul_t.last_loop
        want = takum_matmul_t_plain(g, w, fmt)
        scale = torch.matmul(g.abs(), wd.abs().T)
        ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
        check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |g|@|w|.T > {K3_LIMIT}")
        check(same_bits_f32(torch, got, x.grad), f"{tag}: differs from the autograd step's dx")
        err = float((got - want).abs().max())
        del got, want, scale
        # bound: g, the weight bits and dx each moved once; the products at
        # the bf16 rate over the parts of the f32 g and the weight (3 MMAs a
        # product, 6 for t16), and beside it at the f32 rate
        rate, rate_name = matmul_rate(torch, fmt, torch.float32)
        nbytes = M * N * 4 + K * N * wf.nbits // 8 + M * K * 4
        b_ms, b_by = bound(nbytes, 2.0 * M * N * K, rate)
        copy = transposed_copy(torch, w)
        x_f = x.detach()
        row = dict(
            kernel="takum_matmul_ad", weight=name, fmt=fmt, impl=impl, shape=[M, K, N], loop=loop,
            launch_key=f"takum_matmul[{impl}^T]", max_abs_err=err, err_over_absprod=ratio,
            ms=time_ms(torch, lambda: takum_matmul_t(g, w, fmt), flush=flush),
            plain_ms=time_ms(torch, lambda: takum_matmul_t_plain(g, w, fmt), flush=flush),
            bound_ms=b_ms, bound_by=b_by, bound_rate=rate_name,
            bound_f32_ms=bound(nbytes, 2.0 * M * N * K, F32_FLOPS)[0],
            library_ms=time_ms(torch, lambda: torch.matmul(g, wd.T), flush=flush),
            copy_yardstick_ms=time_ms(torch, lambda: takum_matmul(
                g, transposed_copy(torch, w), fmt), flush=flush),
            k3_over_copy_ms=time_ms(torch, lambda: takum_matmul(g, copy, fmt), flush=flush),
            forward_k3_ms=time_ms(torch, lambda: takum_matmul(x_f, w, fmt), flush=flush))
        rows.append(row)
        log(f"(g) {tag}: {row['ms']:.4f} ms on {loop} (bound {b_ms:.4f}, {b_by} at "
            f"{rate_name}; f32 {row['bound_f32_ms']:.4f}; plain "
            f"{row['plain_ms']:.3f}; torch.matmul {row['library_ms']:.4f}; copy + K3 "
            f"{row['copy_yardstick_ms']:.4f}; K3 over the copy {row['k3_over_copy_ms']:.4f}; "
            f"forward K3 {row['forward_k3_ms']:.4f})")
        del wd, copy
    del flush, weights, xs, grads
    torch.cuda.empty_cache()
    return rows, counts


# ---------------------------------------------------------------------------
# phase (d): full-depth serving; phase (e): kernel path vs plain path
# ---------------------------------------------------------------------------


#: a vlm's leaves drawn at these stds in place of their init of zero: at
#: tanh(0) = 0 the gates would take the whole cross path out of the logits,
#: so a wrong cross-attention would pass every check
VLM_DRAWN = {("cross_layers", "gate"): 1.0, ("cross_layers", "ln"): 0.5}


def packed_params(torch, cfg, seed):
    from repro_torch import serve
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, seed, device="cuda")
    if cfg.family == "vlm":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 991)
        for (a, b), std in VLM_DRAWN.items():
            leaf = params[a][b]
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=leaf.device) * std)
    qp = serve.quantize_params(cfg, params)
    del params
    torch.cuda.empty_cache()
    return qp


def packed_counts(qp):
    """(packed leaves, packed leaves that loading decodes) of a packed tree:
    what packing it launches K2 for, and what ``serve.load_params``
    launches K1 for (the stacked norm gains, the mixer's six small
    ``MambaParams`` leaves, a vlm's cross-layer gains)."""
    from repro_torch.models.mamba2 import SMALL_LEAVES
    from repro_torch.models.transformer import GAINS
    from repro_torch.quant.qtensor import QTensor

    layers = qp["layers"]
    leaves = sum(isinstance(x, QTensor) for x in _leaves(qp))
    decoded = [layers.get(k) for k in GAINS]
    if "ssm" in layers:
        decoded += [getattr(layers["ssm"], k) for k in SMALL_LEAVES]
    if "cross_layers" in qp:
        decoded.append(qp["cross_layers"]["ln"])
    return leaves, sum(isinstance(x, QTensor) for x in decoded)


def expected_packed(cfg):
    """``packed_counts`` of a packed tree of ``cfg``: the embedding, the
    stacked gains (ln1, ln2, and gemma2's ln1_post, ln2_post; an ssm layer
    has ln1 alone), the weights of a layer (4 attention and 3 MLP; a moe
    layer's router and 3 stacked expert leaves instead of the MLP, and 3
    shared-expert leaves; an ssm layer none of them; ssm and hybrid add the
    mixer's 8 stacked leaves, 6 of which loading decodes), and the head
    unless tied (final_norm is 1-D); a vlm adds its cross layers' 4
    weights and gains (which loading decodes) and ``media_proj`` (its gates
    are 1-D): mamba2 (10, 7), hymba (19, 8), the vlm (17, 3)."""
    gains = 4 if cfg.alt_local_global else 1 if cfg.family == "ssm" else 2
    mlp = 4 + (3 if cfg.num_shared_experts else 0) if cfg.family == "moe" else 3
    weights = 0 if cfg.family == "ssm" else 4 + mlp
    mixer = 8 if cfg.family in ("ssm", "hybrid") else 0
    cross = 6 if cfg.family == "vlm" else 0
    decoded = gains + (6 if mixer else 0) + (1 if cross else 0)
    return 1 + gains + weights + mixer + cross + (0 if cfg.tie_embeddings else 1), decoded


def k3_per_layer(cfg):
    """K3 launches of one layer in one model call: the 4 attention linears
    and SwiGLU's 3, or for moe the router, 3 per expert (every expert runs)
    and 3 for the shared expert: dbrx 4 + 1 + 48 = 53, kimi 4 + 1 + 1152 +
    3 = 1160; the mixer's in_proj and out_proj: ssm 2, hybrid 7 + 2 = 9."""
    if cfg.family == "ssm":
        return 2
    if cfg.family == "hybrid":
        return 9
    if cfg.family != "moe":
        return 7
    return 4 + 1 + 3 * cfg.num_experts + (3 if cfg.num_shared_experts else 0)


def k3_cross(cfg):
    """K3 launches of a vlm's cross path in one model call: ``media_proj``
    over the media, then per cross layer ``wq``, ``wk`` and ``wv`` (the
    media's K and V, at M = B x num_media_tokens) and ``wo``; 0 for the
    other families."""
    return 4 * (cfg.num_layers // cfg.cross_attn_every) + 1 if cfg.family == "vlm" else 0


def media_batch(torch, cfg, B, gen, dev):
    """A vlm's batch extra: ``{"media": [B, num_media_tokens, media_d]}``
    f32 normals from ``gen`` on ``dev`` (the stub encoder's output); {} for
    the other families."""
    if cfg.family != "vlm":
        return {}
    return {"media": torch.randn((B, cfg.num_media_tokens, cfg.media_d), generator=gen,
                                 device=dev)}


def phase_serving(torch, dev, policy, arch="llama3_8b", layers=None, S0=256, STEPS=32):
    """Serving of ``arch`` (full depth, or cut to ``layers``) under
    ``policy``, B = 4, an ``S0``-token prompt and ``STEPS`` greedy decode
    steps, counted: launches reset just before the prefill and read just
    after the last decode step.  What earlier phases of the process still
    hold allocated (it counts in the peak) is recorded beside the peak."""
    from repro_torch import configs, serve
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES

    held_before = torch.cuda.memory_allocated()
    cfg = configs.get(arch).with_(quant=POLICIES[policy])
    full_depth = cfg.num_layers
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    tag = f"{arch}/{policy}"
    B = 4
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    moe = cfg.family == "moe"
    chunked = moe or cfg.family == "vlm"
    if chunked:  # leaf by leaf: no f32 copy of a whole leaf (104 GB and more at full depth)
        packed, k2_launches = chunked_packed_params(torch, cfg, 0, dev)
    else:
        packed = packed_params(torch, cfg, seed=0)
    n_packed, n_gains = packed_counts(packed)
    if wire_format(cfg.quant.weights).family != "ieee":
        check((n_packed, n_gains) == expected_packed(cfg),
              f"{tag}: packed leaves and gains {(n_packed, n_gains)}, want {expected_packed(cfg)}")
    qp = serve.load_params(packed)
    del packed
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pack_counts = ops.launch_counts()
    check_pack_launches(pack_counts, cfg, tag, k2_launches if chunked else n_packed, n_gains)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
    extra = media_batch(torch, cfg, B, gen, dev)
    prefill = serve.make_prefill_step(cfg, cache_len=S0 + STEPS + 2)
    step = serve.make_serve_step(cfg)

    # an uncounted prefill first: the counted one then finds every kernel of
    # its shapes loaded (cuBLAS's among them), whatever earlier phases ran;
    # for moe it also reads the routing (the pairs capacity dropped)
    routes = []
    with record_routing(routes) if moe else contextlib.nullcontext():
        t0 = time.perf_counter()
        prefill(qp, {"tokens": prompt, **extra})
        torch.cuda.synchronize()
        first_prefill_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(qp, {"tokens": prompt, **extra})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = []
    for _ in range(STEPS):
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok)
        logits, cache = step(qp, {"token": tok, **extra}, cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()

    check(tuple(logits.shape) == (B, cfg.vocab_size), f"{tag}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits after decoding")
    L = cfg.num_layers
    check_launches(counts, cfg, 1 + STEPS, STEPS, tag)
    check(cache.pos == S0 + STEPS, f"{tag}: cache.pos {cache.pos}")
    decode_s = t2 - t1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kv_cache_bytes = cache.k.numel() * cache.k.element_size() * 2
    state_bytes = sum(t.numel() * t.element_size() for t in (cache.conv, cache.ssm)
                      if t is not None)
    trace = profile_decode(torch, step, qp, logits, cache, extra)
    del cache
    prefill_trace = profile_prefill(torch, prefill, qp, prompt, extra)
    if trace["device_busy_ms"]:
        # the profiler's host overhead stretches its own wall; the counted
        # decode window above ran unprofiled
        trace["idle_share_of_counted_step"] = 1 - trace["device_busy_ms"] / 2 / (
            decode_s / STEPS * 1e3)
    out = dict(
        arch=cfg.name, policy=policy, weights=cfg.quant.weights, kv_cache=cfg.quant.kv_cache,
        layers=L, published_layers=full_depth, batch=B, prompt=S0, decode_steps=STEPS,
        windows=sorted(set(T._layer_windows(cfg))), tied_head=cfg.tie_embeddings,
        init_and_pack_s=init_s, first_prefill_ms=first_prefill_ms, prefill_ms=(t1 - t0) * 1e3,
        decode_ms_per_token=decode_s / STEPS * 1e3, decode_tokens_per_s=B * STEPS / decode_s,
        max_memory_allocated_gb=peak_gb,
        allocated_before_gb=held_before / 1e9,
        weight_bytes=sum(_nbytes(v) for v in _leaves(qp)),
        kv_cache_bytes=kv_cache_bytes, recurrent_state_bytes=state_bytes,
        launches=counts, pack_launches={k: v for k, v in pack_counts.items() if v},
        first_tokens=[int(t) for t in torch.stack(tokens, 1)[0, :8]],
        profile_prefill=prefill_trace, profile_two_decode_steps=trace,
    )
    if cfg.family == "vlm":
        media_k3 = media_k3_ms(torch, cfg, qp, extra["media"])
        split = trace["device_ms_per_step_by_class"]
        split["k3_media"] = media_k3
        split["k3_rest"] = split["k3"] - media_k3
        out.update(k2_pack_launches=k2_launches, k3_cross_per_call=k3_cross(cfg),
                   media_tokens=cfg.num_media_tokens, cross_layers=L // cfg.cross_attn_every)
    if moe:
        out.update(k2_pack_launches=k2_launches, k3_per_layer=k3_per_layer(cfg),
                   capacity=routes[0]["capacity"],
                   prefill_pairs_dropped_share=1 - sum(float(r["keep"].float().mean())
                                                       for r in routes) / len(routes),
                   prefill_pairs_dropped_by_layer=[1 - float(r["keep"].float().mean())
                                                   for r in routes])
    del qp, logits
    torch.cuda.empty_cache()
    return out


def check_launches(counts, cfg, calls, steps, tag, gains=0):
    """Hold the launch counts of a serving run (a prefill and ``steps``
    decode steps: ``calls`` model calls) to what ``cfg``'s policy drives,
    each surface through the codec its format defaults to
    (``lut.resolve_impl(None, ...)``): per call one K2 append per layer
    (``takum_encode_into``: K and V in one launch) and, for packed weights,
    ``k3_per_layer`` K3 per layer (and a vlm's ``k3_cross``), one K1 over
    the embedding rows (``takum_decode_rows``)
    and the head: one K3 (untied), one transposed K3 over the stored table
    (``takum_matmul[impl^T]``, tied, flat format) or one K1-mx decode of
    the table (``takum_decode_2d``, tied, mx format); per decode step one K6
    per layer, whatever the layer's window; an ssm config none of K2 or
    K6.  ``gains`` more K1 (``takum_decode_2d``) where the run also decoded
    the packed leaves of loading (``packed_counts``) itself.  Every other kernel, the other codec's and the old
    composition's (``takum_encode_2d``) included, must show no launch."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.lut import resolve_impl

    L, kv, w = cfg.num_layers, cfg.quant.kv_cache, cfg.quant.weights
    want = {}
    if cfg.family != "ssm":  # an ssm layer has no K/V: no append, no K6
        want = {f"takum_encode_into[{resolve_impl(None, kv, 'encode')}]": L * calls,
                f"takum_decode_attention[{resolve_impl(None, kv)}]": L * steps}
    if wire_format(w).family != "ieee":  # bf16/f32 weights: every linear is torch.matmul
        impl = resolve_impl(None, w)
        tied = cfg.tie_embeddings
        want[f"takum_matmul[{impl}]"] = (k3_per_layer(cfg) * L + k3_cross(cfg)
                                          + (0 if tied else 1)) * calls
        want[f"takum_decode_rows[{impl}]"] = calls
        decodes = gains
        if tied and wire_format(w).is_block_scaled:
            decodes += calls
        elif tied:
            want[f"takum_matmul[{impl}^T]"] = calls
        if decodes:
            want[f"takum_decode_2d[{impl}]"] = decodes
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{tag}: launches {got}, want {want}")


def check_pack_launches(counts, cfg, tag, leaves, gains):
    """The launches of packing a random tree and loading it
    (``serve.quantize_params`` then ``serve.load_params``): one K2
    (``takum_encode_2d``, the weight format's default encode) per packed
    leaf of the tree (``leaves``) and one K1 (``takum_decode_2d``) per packed
    leaf that loading decodes (``gains``: the stacked norm gains and the
    mixer's six small leaves); none for bf16 / f32 weights."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.lut import resolve_impl

    w = cfg.quant.weights
    want = {}
    if wire_format(w).family != "ieee":
        want = {f"takum_encode_2d[{resolve_impl(None, w, 'encode')}]": leaves,
                f"takum_decode_2d[{resolve_impl(None, w)}]": gains}
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{tag}: packing launches {got}, want {want}")


def device_ms_by_name(prof):
    """Device ms per kernel name of a finished torch.profiler run."""
    by_name = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t / 1e3
    return by_name


def profile_decode(torch, step, qp, logits, cache, extra=None):
    """Two more decode steps under torch.profiler (outside the counted run):
    device time by kernel and the device's idle share of the profiled wall
    time (which the profiler's own host work inflates).  ``extra``: the
    batch's other entries (a vlm's media)."""
    extra = extra or {}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            logits, cache = step(qp, {"token": torch.argmax(logits, -1), **extra}, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kernels = sum(ev.count for ev in prof.key_averages()
                  if "CUDA" in str(getattr(ev, "device_type", ""))
                  and not ev.key.startswith(("Memcpy", "Memset")))
    split = dict.fromkeys(("k3", "k6", "k1_k2", "plain"), 0.0)
    for k, v in by_name.items():
        split[kernel_class(k)] += v / 2
    return dict(wall_ms=wall_ms, device_busy_ms=busy if busy else None,
                idle_share=(1 - busy / wall_ms) if busy else None,
                kernel_launches_per_step=kernels / 2,
                device_ms_per_step_by_class=split,
                top_kernels_ms=[[k[:80], v] for k, v in top])


def kernel_class(name):
    """Which of the port's kernels a profiled device kernel is: "k3" (K3's
    loops and the matvec's combine), "k6" (K6's split and combine), "k1_k2"
    (the codec kernels), else "plain" (PyTorch's own kernels: the SSM's,
    the norms', the residual's, the prefill attention's)."""
    if any(ns in name for ns in K3_NAMESPACES):
        return "k3"
    if "(anonymous namespace)::split_kernel" in name or \
            "(anonymous namespace)::combine_kernel" in name:
        return "k6"
    if any(f"(anonymous namespace)::{k}_kernel" in name
           for k in ("decode", "encode", "mx_decode", "mx_encode")):
        return "k1_k2"
    return "plain"


#: the namespaces of K3's kernels (the tensor-core tile, the FMA tile, the
#: matvec and its combine pass, the f32-x wgmma tile: a MoE prefill's wo
#: launches over the f32 h) in the profiler's kernel names
K3_NAMESPACES = ("repro_mma::", "repro_mm::", "repro_mv::", "repro_wg::")


def media_k3_ms(torch, cfg, qp, media):
    """Ms of a vlm decode step's K3 over the media, timed alone: the same
    launches the step makes (``media_proj`` over the media, then each cross
    layer's ``wk`` and ``wv`` over the projected media), which
    ``profile_decode``'s kernel names cannot tell from the other K3.  CUDA
    events around the whole set (median of 5, after one warm-up): each
    launch runs for milliseconds, so the host's share is negligible."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import linear

    adt = T._act_dtype(cfg)
    cross = qp["cross_layers"]

    def media_work():
        me = T._media_emb(cfg, qp, media, adt)
        for c in range(cfg.num_layers // cfg.cross_attn_every):
            linear(me, cross["wk"][c])
            linear(me, cross["wv"][c])

    return time_ms(torch, media_work, reps=5, warmup=1)


def profile_prefill(torch, prefill, qp, prompt, extra=None):
    """One more prefill under torch.profiler (outside the counted run):
    device busy ms, K3's share of it (every kernel of K3's loops), and the
    five other device operations that took most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = prefill(qp, {"tokens": prompt, **(extra or {})})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    k3 = {k: v for k, v in by_name.items() if any(ns in k for ns in K3_NAMESPACES)}
    others = sorted(((k, v) for k, v in by_name.items() if k not in k3), key=lambda kv: -kv[1])
    return dict(wall_ms=wall_ms, device_busy_ms=busy if busy else None,
                k3_ms=sum(k3.values()), k3_share=sum(k3.values()) / busy if busy else None,
                k3_kernels_ms=[[k[:100], v] for k, v in sorted(k3.items(), key=lambda kv: -kv[1])],
                top_other_ms=[[k[:80], v] for k, v in others[:5]])


def _leaves(tree):
    """The leaves of nested dicts and NamedTuples (``MambaParams``), a
    QTensor one leaf."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(leaf):
    t = getattr(leaf, "bits", leaf)
    return t.numel() * t.element_size()


#: the policies of phase (e), in order
PARITY_POLICIES = ("takum", "takum8", "ofp8", "mxfp8", "mxt8", "bf16")
#: phase (e) limits at f32 activations, (kernel vs plain, kernel vs the f64
#: control), for the policies (or (arch, policy) pairs of phase (i4)) whose
#: own order sensitivity exceeds the 1e-3 of the others (see
#: ``phase_parity``).  llama3.2-3b under takum: the plain path moved 1.59e-3
#: against its f64 twin (its t8 KV cache differing in 2.5e-4 of its bytes),
#: the kernel path read 1.20e-3 against the plain path and 1.58e-3 against
#: the f64 control (H100 80GB HBM3, 700 W).  llama-3.2-vision-90b under takum
#: at 5 layers (phase (l2)): the prefill's logits (no cache read) 3.6e-6 from
#: the plain path's, then the decode steps drift with the t8 KV codes the
#: prefill's K3 tile order moved: the kernel path's cache differs from the
#: plain path's in 7.1e-4 of its bytes (the f64 control's in 3.3e-4), and it
#: read 1.32e-3 against the plain path, 1.23e-3 against the f64 control, the
#: control 6.8e-4 (H100 80GB HBM3, 700 W); ``PREFILL_LIMITS`` holds its
#: prefill beside it
F32_LIMITS = {"mxt8": (2e-3, 1e-3), "takum8": (3e-3, 3e-3),
              ("llama3_2_3b", "takum"): (2e-3, 2e-3),
              ("llama3_2_vision_90b", "takum"): (2e-3, 2e-3)}
#: limits at f32 activations on the prefill's logits alone (call 0, before
#: any decode step reads the KV cache), kernel vs plain, for (arch, policy)
#: pairs whose decode drift ``F32_LIMITS`` widens: their K3 and attention
#: must still agree where no KV code can have flipped
PREFILL_LIMITS = {("llama3_2_vision_90b", "takum"): 1e-4}


def phase_parity(torch, dev, arch="llama3_8b", policies=PARITY_POLICIES, layers=2, steps=8,
                 S0=64):
    """``arch`` at full width, ``layers`` layers: kernel path vs plain path,
    teacher-forced with the kernel path's greedy tokens over ``steps``
    decode steps.  Tolerance on max|diff| / max|logit|
    per step: 1e-3 at f32 activations (accumulation order, plus the 8-bit
    KV codes that an order ulp moves across a rounding boundary: one t8
    code step is about 12 % of the value), 5e-2 at bf16 activations (an
    order ulp can also flip the bf16 rounding of an activation, about 2^-8
    relative, and the flip propagates).  At f32 activations the two paths'
    greedy tokens must agree at every step.

    Control, at f32 for the policies whose linears run through K3 (takum,
    takum8, mxt8): a third run of the plain path with its matmuls accumulated
    in f64, an equally valid order.  How far it moves the plain path measures
    the model's own order sensitivity, and the kernel path must lie within
    1e-3 of it.  Where that sensitivity alone exceeds 1e-3 (measured by this
    phase on an H100 80GB HBM3 at 700 W), ``F32_LIMITS`` sets the policy's (or the arch's)
    limits instead: under mxt8 the plain path moved 1.3e-3 against its f64
    twin; under takum8 1.44e-3, and the kernel path read 2.58e-3 against
    either plain run, its t8 KV cache differing from the plain path's in
    6.7e-4 of its bytes against 1.9e-4 between the two plain runs.  The
    prompt's K/V come from the prefill (M = B * 64 rows: K3's tile, which
    adds each output's k terms one by one in f32, an order that moves more
    of the projected K/V values across a t8 rounding boundary); the decode
    steps' split-K matvec, whose order is a tree over warps and splits,
    leaves both readings where they were.

    The kernel path's launches are counted (reset just before it, read just
    after) and held to the policy (``check_launches``), then one more
    kernel-path prefill is timed (warm, uncounted: ``kernel_prefill_ms``): under mxt8 this is
    the path that drives K1-mx and K3-mx, under bf16 (bf16 weights and KV
    cache) the one that drives the bits codec of K2 and K6.  Every reading
    (per-step errors, the control, the share of KV-cache bytes in which the
    runs differ) is logged before it is checked.

    A moe arch's tree is ``chunked_packed_params``'s, and every path's
    router probs are recorded per layer and call (``record_routing``): a
    token whose top-k expert set differs between the kernel and the plain
    path is a routing flip, logged with its margin (the plain path's k-th
    minus (k+1)-th prob) and the paths' largest probs difference for that
    token.  A flipped token's output moves by O(1) and the row's later
    tokens attend to it, so a row leaves the logit comparison (and the
    greedy agreement) from the call of its first flip on.  At f32 a row's
    first flips at a margin above ``FLIP_MARGIN`` are a fault.  At bf16 the
    paths' probs differ by up to 2e-2 (an order ulp flips an activation's
    bf16 rounding, and the 8-bit KV codes follow: phase (e)'s bf16 logits
    differ by 4e-3 to 1.25e-2), so every flip's margin must lie under twice
    its token's probs difference (the two swapped probs can each move by
    that much), and more than half the calls must keep a row.

    An ssm or hybrid arch's recurrent cache is held too: each path's conv
    tails and SSM states (all layers) after the prefill and after the last
    step, the kernel path within the logits' limit of the plain path
    (max|diff| / max|value| of each tensor), the plain path's own distance
    to its f64 twin recorded beside it (and setting the limit where it is
    larger, ``F32_LIMITS``).

    A vlm's tree is ``chunked_packed_params``' too (its gates drawn
    nonzero), every call gets the same media, and the first cross layer's
    media K and V (``wk`` / ``wv`` over the projected media, M = B x 4096)
    are computed on each path after the run and held to the logits'
    limit."""
    import dataclasses

    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import linear
    from repro_torch.quant.policy import POLICIES, QuantPolicy

    named = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}
    routes = {"kernel": contextlib.nullcontext, "plain": ops.plain_path,
              "plain_f64": lambda: ops.plain_path(torch.float64)}

    B, STEPS = 4, steps
    results = []
    for policy in policies:
        f32_tol, f64_tol = F32_LIMITS.get((arch, policy), F32_LIMITS.get(policy, (1e-3, 1e-3)))
        for act, tol in (("f32", f32_tol), ("bf16", 5e-2)):
            quant = dataclasses.replace(named[policy], activations=act)
            cfg = configs.get(arch).with_(num_layers=layers, quant=quant)
            moe, vlm = cfg.family == "moe", cfg.family == "vlm"
            ops.reset_launch_counts()
            qp = (chunked_packed_params(torch, cfg, 1, dev)[0] if moe or vlm
                  else packed_params(torch, cfg, 1))
            pack_counts = {k: v for k, v in ops.launch_counts().items() if v}
            gains = packed_counts(qp)[1]
            gen = torch.Generator(device=dev)
            gen.manual_seed(11)
            prompt = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen, device=dev)
            extra = media_batch(torch, cfg, B, gen, dev)
            runs, caches, routing, states, media_kv = {}, {}, {}, {}, {}
            fed = None
            paths = ("kernel", "plain")
            if act == "f32" and quant.weights in ("t16", "t8", "mxt8"):
                paths += ("plain_f64",)
            for path in paths:
                ops.reset_launch_counts()
                routing[path] = []
                with routes[path](), (record_routing(routing[path]) if moe
                                      else contextlib.nullcontext()):
                    lp = serve.load_params(qp)
                    logits, cache = serve.make_prefill_step(cfg, S0 + STEPS)(
                        lp, {"tokens": prompt, **extra})
                    if cache.ssm is not None:
                        states[path] = [cache.conv.float().clone(), cache.ssm.clone()]
                    outs, toks = [logits], []
                    for i in range(STEPS):
                        tok = torch.argmax(logits, -1) if fed is None else fed[i]
                        toks.append(tok)
                        logits, cache = serve.make_serve_step(cfg)(lp, {"token": tok, **extra},
                                                                   cache)
                        outs.append(logits)
                    torch.cuda.synchronize()
                if path == "kernel":
                    counts = ops.launch_counts()
                    # one more prefill on the kernel path, warm and uncounted
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    serve.make_prefill_step(cfg, S0 + STEPS)(lp, {"tokens": prompt, **extra})
                    torch.cuda.synchronize()
                    prefill_ms = (time.perf_counter() - t0) * 1e3
                if vlm:  # the first cross layer's media K and V, after the counted run
                    with routes[path]():
                        me = T._media_emb(cfg, lp, extra["media"], T._act_dtype(cfg))
                        cp = T._layer(lp["cross_layers"], 0)
                        media_kv[path] = [linear(me, cp["wk"]).float(),
                                          linear(me, cp["wv"]).float()]
                        del me
                fed = toks
                if cache.ssm is not None:
                    states[path] += [cache.conv.float().clone(), cache.ssm.clone()]
                runs[path] = torch.stack(outs)
                caches[path] = torch.stack([cache.k, cache.v]).view(torch.uint8)
            k, p = runs["kernel"], runs["plain"]
            tag = f"{arch} {policy}/{act}"
            check(bool(torch.isfinite(k).all()), f"{tag}: non-finite kernel-path logits")

            keep, flips = None, []
            if moe:  # rows whose routing flipped leave the comparison from that call on
                flips = routing_flips(routing["kernel"], routing["plain"], layers)
                first = {}
                for c, layer, r, *_ in flips:
                    first.setdefault(r, (c, layer))
                keep = torch.ones((STEPS + 1, B), dtype=torch.bool, device=dev)
                for r, (c, _) in first.items():
                    keep[c:, r] = False
                primary = [f for f in flips if (f[0], f[1]) == first[f[2]]]

            def rel(a, b):
                d, m = (a - b).abs().amax(dim=2), b.abs().amax(dim=2)  # [steps + 1, B]
                if keep is None:
                    return (d.amax(1) / m.amax(1)).tolist()
                return [float(d[i][keep[i]].max() / m[i][keep[i]].max())
                        for i in range(d.shape[0]) if keep[i].any()]

            def kv_diff(a, b):  # None where there is no KV cache (ssm)
                if not caches[a].numel():
                    return None
                return float((caches[a] != caches[b]).float().mean())

            errs = rel(k, p)
            same = k.argmax(-1) == p.argmax(-1)
            agree = float((same if keep is None else same[keep]).float().mean())
            res = dict(arch=arch, policy=policy, activations=act, tol=tol, max_rel_err=max(errs),
                       rel_err_per_step=errs, greedy_agreement=agree, launches=counts,
                       pack_launches=pack_counts,
                       kernel_prefill_ms=prefill_ms,
                       kv_bytes_differing_kernel_vs_plain=kv_diff("kernel", "plain"))
            log(f"parity {tag}: max rel err {max(errs):.3e} (tol {tol}), per step "
                f"{[float(f'{e:.2e}') for e in errs]}, greedy agreement {agree:.3f}, KV bytes "
                f"differing {res['kv_bytes_differing_kernel_vs_plain']}, kernel-path "
                f"launches {counts}")
            if moe:
                res.update(routing_flips=flips, primary_flips=primary, routed_tokens=sum(
                    r["gate_idx"].shape[0] * r["gate_idx"].shape[1] for r in routing["plain"]),
                    min_margin=min(float(r["margin"].min()) for r in routing["plain"]),
                    rows_left_out_from_call={r: c for r, (c, _) in first.items()})
                log(f"parity {tag}: {len(flips)} routing flips of {res['routed_tokens']} "
                    f"routed tokens (call, layer, row, token, margin, probs diff): {flips}; "
                    f"the first of each row {primary}; rows left out from call "
                    f"{res['rows_left_out_from_call']}; smallest margin {res['min_margin']:.3g}")
            def state_rel(a, b):  # conv, ssm after the prefill, then after the last step
                return [float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(states[a], states[b])]

            if states:
                res.update(state_kernel_vs_plain=state_rel("kernel", "plain"))
                if "plain_f64" in states:
                    res.update(state_f64_vs_plain=state_rel("plain_f64", "plain"))
                log(f"parity {tag}: conv tail, SSM state (after the prefill, after the last "
                    f"step) kernel vs plain {res['state_kernel_vs_plain']}, plain f64 vs plain "
                    f"{res.get('state_f64_vs_plain')}")
            if media_kv:
                res.update(media_kv_kernel_vs_plain=[
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(media_kv["kernel"], media_kv["plain"])])
                log(f"parity {tag}: the cross layer's media K, V kernel vs plain "
                    f"{res['media_kv_kernel_vs_plain']}")
            if "plain_f64" in runs:
                res.update(control_f64_vs_plain=rel(runs["plain_f64"], p),
                           kernel_vs_f64=rel(k, runs["plain_f64"]),
                           kv_bytes_differing_f64_vs_plain=kv_diff("plain_f64", "plain"))
                ctrl, kf = max(res["control_f64_vs_plain"]), max(res["kernel_vs_f64"])
                log(f"parity {tag}: control plain f64 vs plain {ctrl:.3e} (KV bytes "
                    f"differing {res['kv_bytes_differing_f64_vs_plain']}), kernel vs plain "
                    f"f64 {kf:.3e} (limit {f64_tol})")
            results.append(res)
            if moe and act == "f32":
                check(all(f[4] <= FLIP_MARGIN for f in primary),
                      f"{tag}: a row's first routing flip at a margin above {FLIP_MARGIN}")
            if moe:  # every flip a near tie the paths' own probs difference explains
                check(all(f[4] < 2 * f[5] for f in flips),
                      f"{tag}: a routing flip at a margin above twice the probs difference")
                check(len(errs) > STEPS // 2, f"{tag}: too few rows kept ({errs})")
            check(max(errs) <= tol, f"{tag}: kernel vs plain {max(errs)} > {tol}")
            if act == "f32" and (arch, policy) in PREFILL_LIMITS:
                lim = PREFILL_LIMITS[(arch, policy)]
                check(errs[0] <= lim,
                      f"{tag}: the prefill's logits kernel vs plain {errs[0]} > {lim}")
            if media_kv:
                check(max(res["media_kv_kernel_vs_plain"]) <= tol,
                      f"{tag}: media K/V kernel vs plain {res['media_kv_kernel_vs_plain']} > {tol}")
            if states:
                check(max(res["state_kernel_vs_plain"]) <= tol,
                      f"{tag}: recurrent state kernel vs plain {res['state_kernel_vs_plain']} > {tol}")
            if "plain_f64" in runs:
                check(kf <= f64_tol, f"{tag}: kernel vs f64-accumulated plain {kf} > {f64_tol}")
            if act == "f32":
                check(agree == 1.0, f"{tag}: greedy tokens differ ({agree:.3f})")
            check_launches(counts, cfg, 1 + STEPS, STEPS, tag, gains=gains)
            del qp, lp, runs, caches, k, p, routing, states, media_kv, extra
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase (h): single-device training
# ---------------------------------------------------------------------------


def same_tree(torch, a, b):
    """Every leaf of two trees equal bit for bit (floats through their int
    view: NaN == NaN, -0 != +0), with equal dtypes and shapes."""
    from repro_torch import tree

    la, lb = tree.flatten(a)[0], tree.flatten(b)[0]
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype.is_floating_point or x.dtype in (torch.uint16, torch.uint32):
            w = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
            x, y = x.contiguous().view(w), y.contiguous().view(w)
        if not torch.equal(x, y):
            return False
    return True


def clone_tree(t):
    from repro_torch import tree

    return tree.map_leaves(lambda x: x.clone(), t)


def phase_token_ids(torch, dev):
    """F3 and F4 on the card: K1's embedding rows (``takum_decode_rows``)
    equal the plain version, bit for bit, for int32 and int64 ids and for
    ids off the table ([-V, -1, 5, V, V + 3]: wrapped, then clamped), for
    t16 (bits), t8 and mxt8 (lut).  The phases after this one launch more
    kernels in the same process: the context survived."""
    from repro_torch.kernels.takum_codec import decode_rows_plain, takum_decode_rows
    from repro_torch.quant.qtensor import quantize

    V, d = 1000, 256
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    table = torch.randn((V, d), generator=gen, device=dev)
    ids = torch.tensor([[-V, -1, 5, V, V + 3], [-V - 7, 0, V - 1, -2, 2 * V]], device=dev)
    cases = 0
    for fmt in ("t16", "t8", "mxt8"):
        q = quantize(table, fmt, scaled=True)
        scale = None if q.block_scaled else q.scale
        for dt in (torch.int32, torch.int64):
            got = takum_decode_rows(q.bits, ids.to(dt), fmt, scale=scale)
            want = decode_rows_plain(q.bits, ids.to(dt), fmt, scale=scale)
            check(same_bits_f32(torch, got, want), f"F3/F4: K1 rows {fmt} {dt} differ from plain")
            cases += 1
    torch.cuda.synchronize()
    return cases


#: llama3-8b's wi leaf of one layer, [d, d_ff] (phase (h2))
WI_SHAPE = (4096, 14336)
#: parameter leaves of llama3-8b (embed, final_norm, lm_head, ln1, ln2, the
#: four attention and three MLP weights): K1 decodes each one's two
#: quantised moments once a step
TRAIN_LEAVES = 12


def train_steps_exact(torch, dev, arch):
    """One train step of ``arch``'s smoke config under takum (SR refresh,
    then RNE refresh: K2), with the kernels and then under
    ``ops.plain_path()`` from clones of one state, one batch and one
    generator seed: params, moment codes and scales, the step and the rng
    equal bit for bit, K1 launched twice per parameter leaf of the tree
    (its two quantised moments; and K2 as often under RNE)."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut import resolve_impl
    from repro_torch.quant.policy import POLICIES
    from repro_torch.train.step import init_state, make_train_step

    out = {}
    for sr in (True, False):
        cfg = configs.get_smoke(arch).with_(
            quant=dataclasses.replace(POLICIES["takum"], stochastic_rounding=sr))
        st = init_state(cfg, 0, device=dev)
        leaves = len(tree.flatten(st.params)[0])
        batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=17).batch(0)
        step = make_train_step(cfg)
        ops.reset_launch_counts()
        k_state, k_m = step(clone_tree(st), batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        with ops.plain_path():
            p_state, p_m = step(clone_tree(st), batch)
        tag = f"{arch} takum {'SR' if sr else 'RNE'}"
        check(same_tree(torch, k_state, p_state), f"{tag}: kernel and plain steps differ")
        check(k_m["loss"].item() == p_m["loss"].item(), f"{tag}: losses differ")
        dec = f"takum_decode_2d[{resolve_impl(None, 't16')}]"
        enc = f"takum_encode_2d[{resolve_impl(None, 't16', 'encode')}]"
        want = {dec: 2 * leaves, **({} if sr else {enc: 2 * leaves})}
        check(counts == want, f"{tag}: launches {counts}, want {want}")
        out[tag] = dict(launches=counts, loss=k_m["loss"].item(), leaves=leaves)
    return out


def phase_train_exact(torch, dev):
    """(h1) ``train_steps_exact`` of llama3-8b (12 parameter leaves: K1 24
    a step).  (h2) ``adamw_update`` on llama3-8b's wi leaf [4096, 14336]
    with t16 and t8 moments, two updates (the second from non-zero
    moments), kernel path against plain path: codes and params bit for
    bit, each update timed."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init, adamw_update, generator_draws

    out = {f"h1 {k}": v for k, v in train_steps_exact(torch, dev, "llama3_8b").items()}
    check(all(v["leaves"] == TRAIN_LEAVES for v in out.values()), "h1: llama3-8b's leaves")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    wi = torch.randn(WI_SHAPE, generator=gen, device=dev) * WI_SHAPE[0] ** -0.5
    grads = [torch.randn(wi.shape, generator=gen, device=dev) * 1e-3 for _ in range(2)]
    for fmt in ("t16", "t8"):
        def run(seed):
            st = adamw_init({"wi": wi}, fmt=fmt)
            p = {"wi": wi}
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            for gr in grads:
                p, st = adamw_update({"wi": gr}, st, p, lr=3e-4, fmt=fmt, rnd=generator_draws(g))
            return p, st

        kp, ks = run(9)
        with ops.plain_path():
            pp, ps = run(9)
        check(same_tree(torch, (kp, ks), (pp, ps)), f"h2 {fmt}: kernel and plain updates differ")
        st = adamw_init({"wi": wi}, fmt=fmt)
        p, st = adamw_update({"wi": grads[0]}, st, {"wi": wi}, lr=3e-4, fmt=fmt)

        def update():
            adamw_update({"wi": grads[1]}, st, p, lr=3e-4, fmt=fmt,
                         rnd=generator_draws(gen))

        def update_rne():
            adamw_update({"wi": grads[1]}, st, p, lr=3e-4, fmt=fmt)

        row = dict(ms_sr=time_ms(torch, update, reps=5, warmup=1),
                   ms_rne=time_ms(torch, update_rne, reps=5, warmup=1))
        with ops.plain_path():
            row["plain_ms_sr"] = time_ms(torch, update, reps=5, warmup=1)
        out[f"h2 wi {fmt}"] = row
        del kp, ks, pp, ps, st, p
    del wi, grads
    torch.cuda.empty_cache()
    return out


#: phase (h3): llama3-8b at full width, cut to this many layers
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4, 256, 5


def phase_train_full(torch, dev, policy):
    """(h3) llama3-8b at full width and TRAIN_LAYERS layers, random init
    from a seed, TRAIN_STEPS AdamW steps of B = 4, S = 256 under ``policy``,
    every step on the same ``SyntheticLM`` batch: the CE falls from step 1
    to the last; launches counted around the init (K2 packs the zero
    moments) and around step 2 (K1: two per parameter leaf under quantised
    moments, none under f32 moments); each step timed (host clock,
    synchronised); the peak of ``max_memory_allocated`` (with what the
    process held before); one more step profiled.  One batch,
    because over a 128256-token vocabulary the Markov chain's 1024 tokens
    of one batch barely recur in the next: eight fresh batches show no fall
    beyond the batch-to-batch spread (on the CPU at d = 1024, V = 32768:
    10.907, 10.939, ..., 10.878), where a wrong gradient or update would
    still fail to fit one batch (the same run on one batch: 10.907 -> 0.062)."""
    from repro_torch import configs, tree
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut import resolve_impl
    from repro_torch.quant.policy import POLICIES
    from repro_torch.train.step import init_state, make_train_step

    cfg = configs.get("llama3_8b").with_(num_layers=TRAIN_LAYERS, quant=POLICIES[policy])
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = init_state(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_counts = {k: v for k, v in ops.launch_counts().items() if v}
    n_params = sum(p.numel() for p in tree.flatten(st.params)[0])
    pipe = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=17)
    step = make_train_step(cfg)
    ces, step_ms, counts = [], [], None
    batch = pipe.batch(0)
    for i in range(TRAIN_STEPS):
        if i == 1:
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        ces.append(m["ce"].item())
        check(m["grad_ok"].item() == 1.0, f"h3 {policy}: non-finite gradients at step {i + 1}")
    fmt = cfg.quant.opt_state
    quantised = fmt not in ("f32", "bf16")
    want = {f"takum_decode_2d[{resolve_impl(None, fmt)}]": 2 * TRAIN_LEAVES} if quantised else {}
    check(counts == want, f"h3 {policy}: launches in one step {counts}, want {want}")
    want_init = ({f"takum_encode_2d[{resolve_impl(None, fmt, 'encode')}]": 2 * TRAIN_LEAVES}
                 if quantised else {})
    check(init_counts == want_init, f"h3 {policy}: init launches {init_counts}")
    check(all(math.isfinite(c) for c in ces) and ces[-1] < ces[0],
          f"h3 {policy}: CE did not fall: {ces}")
    peak = torch.cuda.max_memory_allocated()
    profile = profile_train_step(torch, step, st, batch)
    del st, m
    torch.cuda.empty_cache()
    return dict(policy=policy, opt_state=fmt, layers=TRAIN_LAYERS, batch=TRAIN_B, seq=TRAIN_S,
                params=n_params, init_s=init_s, init_launches=init_counts, step_launches=counts,
                ce=ces, step_ms=step_ms, step_ms_median_2_on=statistics.median(step_ms[1:]),
                tokens_per_s=TRAIN_B * TRAIN_S / statistics.median(step_ms[1:]) * 1e3,
                allocated_before_gb=held_before / 1e9, max_memory_allocated_gb=peak / 1e9,
                profile_one_step=profile)


#: kernel-name fragments of the training step's device time by part: the
#: f32 GEMMs (cuBLAS / CUTLASS) and K1
TRAIN_GEMM = ("gemm", "cutlass", "nvjet")
TRAIN_K1 = ("decode_kernel",)


def profile_train_step(torch, step, st, batch):
    """One more step (after the counted ones) under torch.profiler: device
    busy ms, the GEMMs' and K1's shares, the kernels launched, and the top
    device operations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items() if any(f in k for f in TRAIN_GEMM))
    k1 = sum(v for k, v in by_name.items() if any(f in k for f in TRAIN_K1))
    kernels = sum(ev.count for ev in prof.key_averages()
                  if "CUDA" in str(getattr(ev, "device_type", ""))
                  and not ev.key.startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy if busy else None,
                idle_share=(1 - busy / wall_ms) if busy else None, gemm_ms=gemm, k1_ms=k1,
                kernel_launches=kernels, top_kernels_ms=[[k[:80], v] for k, v in top])


def phase_train_restart(torch, dev):
    """(h4) A crash injected at step 7, a restart from the step-4
    checkpoint, and the final state equal, bit for bit, to an unbroken
    run's: ``launch.train --smoke`` on the card under bf16 (whose checkpoint
    format is f32), and ``TrainLoop`` over ``make_train_step`` under takum
    with an f32 checkpoint (the SR draws seeded from the restored rng)."""
    import shutil

    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.quant.policy import POLICIES
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.train.step import init_state, make_train_step

    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--smoke", "--steps", "12", "--batch", "4", "--seq", "64", "--policy", "bf16",
            "--ckpt-every", "4", "--device", dev.type]
    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum"])
    pipe = SyntheticLM(cfg.vocab_size, 64, 4, seed=17)

    def takum_loop(d, hook=None):
        loop = TrainLoop(TrainLoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(d),
                                         ckpt_fmt="f32", log_every=4),
                         make_train_step(cfg), pipe.batch,
                         lambda: init_state(cfg, 0, device=dev), hook)
        return loop.run(), loop.metrics_history

    runs = {"launcher bf16": lambda d, hook=None: launch.main(args + ["--ckpt-dir", str(d)],
                                                              failure_hook=hook),
            "loop takum": takum_loop}

    def crash(step):
        if step == 7:
            raise RuntimeError("injected failure")

    ce = {}
    for name, run in runs.items():
        ref, hist = run(root / name / "unbroken")
        try:
            run(root / name / "restarted", crash)
            check(False, f"h4 {name}: the injected failure did not stop the run")
        except RuntimeError as e:
            check("injected" in str(e), f"h4 {name}: unexpected failure {e}")
        resumed, _ = run(root / name / "restarted")
        check(same_tree(torch, ref, resumed),
              f"h4 {name}: the restarted run differs from the unbroken one")
        ce[name] = [m["ce"] for m in hist]
    shutil.rmtree(root, ignore_errors=True)
    return dict(steps=12, crash_at=7, resumed_from=4, ce=ce)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase (i): the other dense archs
# ---------------------------------------------------------------------------

#: phase (i1-i3) serving runs: (arch, policies, layers (None: published
#: depth), prompt).  gemma2's prompt is longer than its 4096-key window, so
#: its local layers drop keys in the prefill and in every decode step;
#: granite is cut to 8 of its 88 layers (its SwiGLU 47.2B parameters are
#: 94.5 GB at t16, and ``packed_params`` first draws an f32 tree on the card)
OTHER_ARCHS = (("gemma2_2b", ("takum", "takum8"), None, 4160),
               ("llama3_2_3b", ("takum",), None, 256),
               ("musicgen_large", ("takum",), 24, 256),
               ("granite_34b", ("takum8",), 8, 256))
#: phase (i4): arch -> the policies of its 2-layer kernel-vs-plain parity
#: (mxt8 on a tied arch: the K1-mx head)
OTHER_PARITY = {"llama3_2_3b": ("takum", "takum8"), "gemma2_2b": ("takum", "takum8", "mxt8"),
                "granite_34b": ("takum", "takum8"), "musicgen_large": ("takum", "takum8")}


def phase_other_archs(torch, dev, card):
    """(i1-i3) ``phase_serving`` of each run of ``OTHER_ARCHS``; (i4)
    ``phase_parity`` of each arch of ``OTHER_PARITY``; (i5)
    ``train_steps_exact`` of gemma2 (13 parameter leaves)."""
    from repro_torch import configs

    serving = {}
    for arch, policies, layers, S0 in OTHER_ARCHS:
        cfg = configs.get(arch)
        if cfg.sliding_window:
            check(S0 > cfg.sliding_window, f"{arch}: the prompt must outrun the window")
        for policy in policies:
            t0 = time.perf_counter()
            r = serving[f"{arch}/{policy}"] = phase_serving(torch, dev, policy, arch, layers, S0)
            log(f"(i) serving {arch} {policy}, {r['layers']} of {r['published_layers']} layers, "
                f"B={r['batch']} prompt {S0}: warm prefill {r['prefill_ms']:.1f} ms (first "
                f"{r['first_prefill_ms']:.1f}), decode {r['decode_ms_per_token']:.2f} ms/token, "
                f"peak {r['max_memory_allocated_gb']:.2f} GB, launches per decode step "
                f"(torch.profiler) {r['profile_two_decode_steps']['kernel_launches_per_step']}, "
                f"counted launches {r['launches']}, packing {r['pack_launches']}; card: {card} "
                f"({time.perf_counter() - t0:.1f} s)")
    parity = []
    for arch, policies in OTHER_PARITY.items():
        t0 = time.perf_counter()
        parity += phase_parity(torch, dev, arch, policies)
        log(f"(i4) parity {arch} {policies} done in {time.perf_counter() - t0:.1f} s")
    train = train_steps_exact(torch, dev, "gemma2_2b")
    log("(i5) gemma2 smoke train steps, kernels == plain bit for bit " + json.dumps(train))
    return dict(serving=serving, parity=parity, train=train)


# ---------------------------------------------------------------------------
# phase (j): the MoE family (dbrx-132b, kimi-k2-1t-a32b)
# ---------------------------------------------------------------------------

#: elements of one drawn chunk of a 2-D leaf (rows of the embedding, the head)
CHUNK_ELEMS = 1 << 26


def leaf_chunks(shape):
    """The chunks a leaf is drawn in: each trailing [r, c] matrix of a leaf
    of 3 or more axes (a layer's, or a layer's expert's), blocks of rows of
    a 2-D leaf (at most ``CHUNK_ELEMS`` elements), a 1-D leaf whole."""
    import itertools

    if len(shape) >= 3:
        return list(itertools.product(*map(range, shape[:-2])))
    if len(shape) == 2:
        rows = max(1, CHUNK_ELEMS // shape[1])
        return [slice(r, min(r + rows, shape[0])) for r in range(0, shape[0], rows)]
    return [slice(None)]


def draw_chunk(torch, spec, j, i, seed, dev):
    """Chunk ``i`` of leaf ``j`` (``param_specs``' order): f32 normal times
    the leaf's std from a generator of its own (seed, leaf, chunk), or zeros."""
    path, shape, std = spec
    c = leaf_chunks(shape)[i]
    cshape = shape[-2:] if isinstance(c, tuple) else (len(range(*c.indices(shape[0]))),
                                                        *shape[1:])
    if not std:
        return torch.zeros(cshape, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 1000003 + j) * 1000003 + i)
    return torch.randn(cshape, generator=gen, device=dev) * std


def pow2_of_ms(torch, ms):
    """``qtensor.pow2_scale``'s power of two from a leaf's mean square."""
    from repro_torch.core import takum

    rms = torch.sqrt(torch.clamp(ms, min=1e-30))
    e = torch.round(torch.log2(rms))
    exact = takum.pow2_f32(torch.nan_to_num(e, nan=0.0, posinf=0.0).to(torch.int64))
    return torch.where(torch.isfinite(e), exact, torch.exp2(e))


def chunked_packed_params(torch, cfg, seed, dev):
    """``serve.quantize_params`` of a random tree of ``cfg``, built leaf by
    leaf and chunk by chunk (``leaf_chunks``) so that no f32 copy of a whole
    leaf exists on the card: a flat format's pow2 scale is ``pow2_scale`` of
    the whole leaf (its mean square accumulated over the chunks in f64, then
    rounded to f32), then each chunk is drawn again, divided by it and packed
    by K2 into its slice of the leaf's bits; an mx leaf packs chunk by chunk
    (its scales are per 32-block of the last axis); IEEE weights and 1-D
    leaves are cast chunk by chunk.  Returns (tree, K2 launches: one per
    packed chunk).

    What it saves, against ``packed_params``' whole f32 tree drawn on the
    card (phase (j1), ``T.param_specs``' sizes): dbrx-132b takum8 at 8
    layers, 109.2 GB f32 for a 27.3 GB packed tree (its largest leaf, the
    stacked experts' wi, 33.8 GB f32); dbrx takum at 4 layers, 57.1 GB for
    28.5 GB (16.9 GB); kimi-k2 takum8 at 2 layers, 146.1 GB for 36.5 GB
    (45.1 GB).  The transient here is one chunk (a [6144, 10752] f32 expert
    matrix, 264 MB; a row block of the embedding or the head, 268 MB) and
    its quotient.  A vlm's gates and cross norm gains are drawn at
    ``VLM_DRAWN``'s stds, not left at zero."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant import blockscale
    from repro_torch.quant.qtensor import QTensor

    wf = wire_format(cfg.quant.weights)
    tree, k2 = {}, 0
    for j, spec in enumerate(T.param_specs(cfg)):
        path, shape, _ = spec
        if cfg.family == "vlm":  # the gates and cross gains drawn nonzero
            spec = (path, shape, VLM_DRAWN.get(path, spec[2]))
        chunks = leaf_chunks(shape)
        draws = (lambda: (draw_chunk(torch, spec, j, i, seed, dev) for i in range(len(chunks))))
        if wf.family == "ieee" or len(shape) < 2:  # quantize_params' cast
            dt = torch.bfloat16 if wf.name == "bf16" else torch.float32
            leaf = torch.empty(shape, dtype=dt, device=dev)
            for c, x in zip(chunks, draws()):
                leaf[c] = x.to(dt)
        elif wf.is_block_scaled:
            payload = torch.empty((*shape[:-1], blockscale.payload_len(shape[-1])),
                                  dtype=torch.uint8, device=dev)
            for c, x in zip(chunks, draws()):
                payload[c] = ops.encode(blockscale.pad_block(x), wf)
                k2 += 1
            leaf = QTensor.from_payload(payload, wf.name, shape[-1])
        else:
            ss = torch.zeros((), dtype=torch.float64, device=dev)
            for x in draws():
                ss += torch.sum(torch.square(x), dtype=torch.float64)
            scale = pow2_of_ms(torch, (ss / math.prod(shape)).to(torch.float32))
            bits = torch.empty(shape, dtype=wf.signed_storage, device=dev)
            for c, x in zip(chunks, draws()):
                bits[c] = ops.encode(x / scale, wf).view(wf.signed_storage)
                k2 += 1
            leaf = QTensor(bits.view(wf.storage), wf.name, scale)
        T.set_path(tree, path, leaf)
    return tree, k2


def check_chunked_build(torch, dev):
    """At each MoE arch's smoke config under takum, takum8 and mxt8 (and
    llama3-8b's under takum): ``chunked_packed_params`` equals
    ``serve.quantize_params`` of the same draws assembled whole, bit for bit
    (bits, scales, mx payloads), with one K2 launch per packed chunk."""
    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import POLICIES, QuantPolicy

    named = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}
    cases = 0
    for arch, policy in (("dbrx_132b", "takum"), ("dbrx_132b", "takum8"),
                         ("kimi_k2_1t_a32b", "takum8"), ("kimi_k2_1t_a32b", "mxt8"),
                         ("llama3_8b", "takum")):
        cfg = configs.get_smoke(arch).with_(quant=named[policy])
        ops.reset_launch_counts()
        got, k2 = chunked_packed_params(torch, cfg, 3, dev)
        n = sum(ops.launch_counts().values())
        check(n == k2 and k2 > 0, f"chunked build {arch}/{policy}: {n} launches, {k2} chunks")
        whole = {}
        for j, spec in enumerate(T.param_specs(cfg)):
            path, shape, _ = spec
            parts = [draw_chunk(torch, spec, j, i, 3, dev) for i in range(len(leaf_chunks(shape)))]
            leaf = (torch.stack(parts).reshape(shape) if len(shape) >= 3
                    else torch.cat(parts) if len(shape) == 2 else parts[0])
            T.set_path(whole, path, leaf)
        want = serve.quantize_params(cfg, whole)
        check(same_tree(torch, got, want),
              f"chunked build {arch}/{policy}: differs from quantize_params of the same draws")
        cases += 1
    return cases


#: at f32 activations, a batch row's first routing flip between the kernel
#: and the plain path at a margin (k-th minus (k+1)-th router prob) above
#: this is a fault (phase (j2)); the row's later flips follow from it (the
#: flipped token's output moves by O(1) and later tokens attend to it)
FLIP_MARGIN = 1e-4


@contextlib.contextmanager
def record_routing(out):
    """Inside the block, every ``moe.moe_block`` call appends its routing to
    ``out``: probs, gate_idx, keep, capacity and each token's margin."""
    from repro_torch.models import moe

    block = moe.moe_block

    def recorded(x, *a, top_k, capacity_factor, **kw):
        trace = {}
        y = block(x, *a, top_k=top_k, capacity_factor=capacity_factor, trace=trace, **kw)
        top = trace["probs"].topk(top_k + 1, dim=-1).values
        out.append(dict(trace, margin=top[..., -2] - top[..., -1],
                        capacity=moe.capacity(capacity_factor, top_k, x.shape[1],
                                              trace["probs"].shape[-1])))
        return y

    moe.moe_block = recorded
    try:
        yield out
    finally:
        moe.moe_block = block


def routing_flips(got, want, layers):
    """Tokens whose top-k expert set differs between two runs' recorded
    routings (``record_routing``, the same calls of ``layers`` layers in the
    same order): (call, layer, row, token, margin in ``want``, the largest
    difference of the two runs' probs for that token)."""
    flips = []
    for n, (a, b) in enumerate(zip(got, want)):
        differ = (a["gate_idx"].sort(-1).values != b["gate_idx"].sort(-1).values).any(-1)
        for r, t in differ.nonzero().tolist():
            flips.append((n // layers, n % layers, r, t, float(b["margin"][r, t]),
                          float((a["probs"][r, t] - b["probs"][r, t]).abs().max())))
    return flips


#: phase (c) for the MoE family: K3 at the narrow routers' N, every x kind
#: and the decode / prefill rows (M = 4, 24 and 1024) over K = 6144
NARROW_N = (4, 8, 16, 384)
NARROW_M = (4, 24, 1024)
#: the expert weights of the served archs: (arch, K, N) of wi / wg
EXPERT_SHAPES = (("dbrx_132b", 6144, 10752), ("kimi_k2_1t_a32b", 7168, 2048))
#: the routers: (arch, d, E)
ROUTERS = (("dbrx_132b", 6144, 16), ("kimi_k2_1t_a32b", 7168, 384))
#: K6 at dbrx's group of 6 (H 48 over 8 kv heads) at (j1)'s last decode step
DBRX_ATTENTION = (4, 48, 8, 290, 128, 288)
#: one MoE layer's decode launches: (arch, d, d_ff, experts)
MOE_DECODE_LAYERS = (("dbrx_132b", 6144, 10752, 16), ("kimi_k2_1t_a32b", 7168, 2048, 384))


def k3_row(torch, flush, fmt, impl, xm, w, wd, tag, timed=True, **extra):
    """K3 (``takum_matmul``) on x ``xm`` over packed ``w`` (decoded ``wd``)
    against its plain version within K3_LIMIT of |x| @ |w| and lut == bits
    where the format has both; timed (events and device time), beside its
    bound and ``torch.matmul(x, decode(w))``, when ``timed``."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_matmul import takum_matmul, takum_matmul_plain

    M, K = xm.shape
    N = wd.shape[1]
    wf = wire_format(fmt)
    scale = torch.matmul(xm.float().abs(), wd.abs())
    got = takum_matmul(xm, w, fmt, decode_impl=impl)
    loop = takum_matmul.last_loop
    want = takum_matmul_plain(xm, w, fmt, decode_impl=impl)
    ratio = float(((got - want).abs() / scale.clamp(min=1e-30)).max())
    check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
    check(ratio <= K3_LIMIT, f"{tag}: err {ratio:.3g} of |x|@|w| > {K3_LIMIT}")
    if impl == "lut":
        check(same_bits_f32(torch, got, takum_matmul(xm, w, fmt, decode_impl="bits")),
              f"{tag}: differs from K3[bits]")
    row = dict(kernel="takum_matmul", fmt=fmt, impl=impl, shape=[M, K, N],
               x=str(xm.dtype)[6:], loop=loop, max_abs_err=float((got - want).abs().max()),
               err_over_absprod=ratio, **extra)
    if timed:
        rate, rate_name = matmul_rate(torch, fmt, xm.dtype)
        b_ms, b_by = bound(M * K * xm.element_size() + K * N * wf.nbits // 8 + M * N * 4,
                           2.0 * M * N * K, rate)
        kern = lambda: takum_matmul(xm, w, fmt, decode_impl=impl)
        lib = lambda: torch.matmul(xm.float(), wd)
        row.update(ms=time_ms(torch, kern, flush=flush),
                   plain_ms=time_ms(torch, lambda: takum_matmul_plain(xm, w, fmt, decode_impl=impl),
                                    flush=flush),
                   bound_ms=b_ms, bound_by=b_by, bound_rate=rate_name,
                   library_ms=time_ms(torch, lib, flush=flush),
                   device_ms=device_ms(torch, kern, flush=flush),
                   library_device_ms=device_ms(torch, lib, flush=flush))
    return row


def phase_moe_kernels(torch, dev, rows):
    """Phase (c) for the MoE family.  K3 at the narrow routers' widths (N 4,
    8, 16, 384; the wgmma tile stages a weight row under 16 bytes by
    cp.async), f32 and bf16 x, M = 4, 24, 1024, t8 lut and t16 bits, within
    K3_LIMIT of its plain version; timed rows: the routers (f32 x, t8 lut,
    M = 4 and 1024 over dbrx's [6144, 16] and kimi's [7168, 384]), the
    experts' wi at M = 4 (bf16 x: dbrx's [6144, 10752] t8 lut and t16 bits,
    kimi's [7168, 2048] t8 lut) and at M = 320, dbrx's prefill tile (t8 lut,
    t16 bits); K6 at dbrx's g = 6, t8 lut, within 1e-5 max|v| and lut ==
    bits, beside SDPA.  Then one MoE layer's decode launches: the 3E expert
    K3 of a decode step (M = 4: bf16 x for wi and wg, the f32 h for wo),
    t8 lut, dbrx (48) and kimi (1152), device time against the byte bound
    of reading every expert once (returned, not a kernel row)."""
    from repro_torch.core.formats import wire_format
    from repro_torch.kernels.takum_attention import decode_attention_plain, takum_decode_attention
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain
    from repro_torch.kernels.takum_matmul import takum_matmul

    gen = torch.Generator(device=dev)
    gen.manual_seed(2301)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    F = torch.nn.functional
    narrow = 0
    for N in NARROW_N:
        K = 7168 if N == 384 else 6144
        wf32 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        for fmt, impl in (("t8", "lut"), ("t16", "bits")):
            w = encode_2d_plain(wf32, fmt)
            wd = decode_2d_plain(w, fmt)
            for M in NARROW_M:
                for xdt in (torch.float32, torch.bfloat16):
                    xm = torch.randn((M, K), generator=gen, device=dev).to(xdt)
                    router = (xdt == torch.float32 and fmt == "t8" and M in (4, 1024)
                              and (K, N) in ((6144, 16), (7168, 384)))
                    row = k3_row(torch, flush, fmt, impl, xm, w, wd,
                                 f"K3[{impl}] {fmt} narrow {M}x{K}x{N} x {str(xdt)[6:]}",
                                 timed=router, use="router" if router else "narrow")
                    narrow += 1
                    if router:
                        rows.append(row)
        del wf32
    log(f"(c) K3 at the narrow N {NARROW_N} x M {NARROW_M} x f32 / bf16 x x t8 / t16: "
        f"{narrow} cases within {K3_LIMIT} of |x|@|w|")

    for arch, K, N in EXPERT_SHAPES:
        wf32 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        cases = [("t8", "lut", 4)] + ([("t16", "bits", 4), ("t8", "lut", 320), ("t16", "bits", 320)]
                                      if arch == "dbrx_132b" else [])
        for fmt, impl, M in cases:
            w = encode_2d_plain(wf32, fmt)
            wd = decode_2d_plain(w, fmt)
            xm = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            rows.append(k3_row(torch, flush, fmt, impl, xm, w, wd,
                               f"K3[{impl}] {fmt} expert {arch} {M}x{K}x{N}", use="expert",
                               arch=arch))
            del w, wd
        del wf32
        log(f"(c) K3 over {arch}'s expert [{K}, {N}]: within {K3_LIMIT}, timed")

    B, H, Kv, S, hd, length = DBRX_ATTENTION
    fmt = "t8"
    k8, v8 = (encode_2d_plain(torch.randn((B * S * Kv, hd), generator=gen, device=dev), fmt)
              for _ in range(2))
    kc = k8.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    vc = v8.reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    vmax = float(decode_2d_plain(v8, fmt).abs().max())
    got_bits = takum_decode_attention(q, kc, vc, fmt, decode_impl="bits", length=length)
    got = takum_decode_attention(q, kc, vc, fmt, decode_impl="lut", length=length)
    want = decode_attention_plain(q, kc, vc, fmt, length, 0, 0.0, decode_impl="lut")
    err = float((got - want).abs().max())
    check(err <= 1e-5 * vmax, f"K6[lut] t8 dbrx g=6: err {err} > 1e-5 max|v|")
    check(same_bits_f32(torch, got, got_bits), "K6[lut] t8 dbrx g=6: differs from K6[bits]")
    g = H // Kv
    kf = decode_2d_plain(k8, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    vf = decode_2d_plain(v8, fmt).reshape(B, S, Kv, hd).permute(0, 2, 1, 3)
    kf = kf.repeat_interleave(g, dim=1)[:, :, :length].contiguous()
    vf = vf.repeat_interleave(g, dim=1)[:, :, :length].contiguous()
    q4 = q[:, :, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q4, kf, vf)
    kern = lambda: takum_decode_attention(q, kc, vc, fmt, decode_impl="lut", length=length)
    b_ms, b_by = bound(q.numel() * 4 * 2 + 2 * B * Kv * length * hd, 4.0 * B * H * length * hd)
    rows.append(dict(
        kernel="takum_decode_attention", fmt=fmt, impl="lut", shape=[B, H, Kv, S, hd],
        arch="dbrx_132b", length=length, window=0, softcap=0.0, keys_read=length,
        max_abs_err=err, ms=time_ms(torch, kern, flush=flush),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(
            q, kc, vc, fmt, length, 0, 0.0, decode_impl="lut"), flush=flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, sdpa, flush=flush),
        device_ms=device_ms(torch, kern, flush=flush),
        library_device_ms=device_ms(torch, sdpa, flush=flush)))
    log(f"(c) K6 t8 dbrx (H {H}, Kv {Kv}, g {g}, length {length}): within 1e-5 max|v|, "
        f"lut == bits, timed")
    del k8, v8, kc, vc, kf, vf

    layer_rows = []
    for arch, d, f_, E in MOE_DECODE_LAYERS:
        fmt = "t8"
        w_in = [encode_2d_plain(torch.randn((d, f_), generator=gen, device=dev) * d ** -0.5, fmt)
                for _ in range(2 * E)]
        w_out = [encode_2d_plain(torch.randn((f_, d), generator=gen, device=dev) * f_ ** -0.5, fmt)
                 for _ in range(E)]
        xb = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        h = torch.randn((4, f_), generator=gen, device=dev)

        def layer():
            for e in range(E):
                takum_matmul(xb, w_in[2 * e], fmt)
                takum_matmul(xb, w_in[2 * e + 1], fmt)
                takum_matmul(h, w_out[e], fmt)

        nbytes = 3 * E * d * f_
        b_ms, b_by = bound(nbytes, 0)
        dev_ms = device_ms(torch, layer, reps=3, flush=flush)
        layer_rows.append(dict(arch=arch, fmt=fmt, impl="lut", experts=E, launches=3 * E,
                               expert_bytes=nbytes, device_ms=dev_ms, bound_ms=b_ms,
                               bound_by=b_by, ms=time_ms(torch, layer, reps=3, warmup=1)))
        log(f"(c) one {arch} MoE layer's {3 * E} expert K3 at M = 4, t8 lut: device "
            f"{dev_ms:.4f} ms against the byte bound {b_ms:.4f} ({nbytes / 1e9:.2f} GB)")
        del w_in, w_out
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return dict(narrow_cases=narrow, moe_layer_decode=layer_rows)


#: phase (j1) serving runs: (arch, policy, layers) at published widths, B =
#: 4, prompt 256, 32 decode steps: the depth cut so that the packed tree
#: fits the card with room (``chunked_packed_params``' docstring)
MOE_RUNS = (("dbrx_132b", "takum8", 8), ("dbrx_132b", "takum", 4),
            ("kimi_k2_1t_a32b", "takum8", 2))
#: phase (j2): (arch, policies, layers, decode steps) of the kernel-vs-plain
#: parity at full width: 4 decode steps, not phase (e)'s 8, since the plain
#: path decodes each of dbrx's 96 expert matrices on every call (t16 bits:
#: 25 ms each on an H100; 8 steps took 83 s for dbrx)
MOE_PARITY = (("dbrx_132b", ("takum", "takum8"), 2, 4), ("kimi_k2_1t_a32b", ("takum8",), 1, 4))


def phase_moe(torch, dev, card):
    """(j0) ``check_chunked_build`` at smoke size; (j1) ``phase_serving`` of
    each run of ``MOE_RUNS``; (j2) ``phase_parity`` of each entry of
    ``MOE_PARITY`` at f32 and bf16 activations, routing flips counted;
    (j3) ``train_steps_exact`` of kimi's smoke config (16 parameter leaves,
    4-D expert moments)."""
    chunked = check_chunked_build(torch, dev)
    log(f"(j0) the chunked packed build equals quantize_params of the same draws "
        f"({chunked} smoke trees)")
    serving = {}
    for arch, policy, layers in MOE_RUNS:
        t0 = time.perf_counter()
        r = serving[f"{arch}/{policy}"] = phase_serving(torch, dev, policy, arch, layers)
        log(f"(j1) serving {arch} {policy}, {r['layers']} of {r['published_layers']} layers, "
            f"B={r['batch']} prompt {r['prompt']}: warm prefill {r['prefill_ms']:.1f} ms (first "
            f"{r['first_prefill_ms']:.1f}), decode {r['decode_ms_per_token']:.2f} ms/token, "
            f"peak {r['max_memory_allocated_gb']:.2f} GB, packed {r['weight_bytes'] / 1e9:.2f} GB "
            f"(K2 {r['k2_pack_launches']} chunks), launches per decode step (torch.profiler) "
            f"{r['profile_two_decode_steps']['kernel_launches_per_step']}, device busy "
            f"{r['profile_two_decode_steps']['device_busy_ms']} ms over two steps, idle share "
            f"{r['profile_two_decode_steps']['idle_share']}, of the counted step "
            f"{r['profile_two_decode_steps'].get('idle_share_of_counted_step')}; prefill pairs "
            f"dropped {r['prefill_pairs_dropped_share']:.4f} (capacity {r['capacity']}); "
            f"counted launches {r['launches']}; card: {card} "
            f"({time.perf_counter() - t0:.1f} s)")
    parity = []
    for arch, policies, layers, steps in MOE_PARITY:
        t0 = time.perf_counter()
        parity += phase_parity(torch, dev, arch, policies, layers, steps)
        log(f"(j2) parity {arch} {policies} at {layers} layers done in "
            f"{time.perf_counter() - t0:.1f} s")
    train = train_steps_exact(torch, dev, "kimi_k2_1t_a32b")
    check(all(v["leaves"] == 16 for v in train.values()), "j3: kimi smoke's 16 leaves")
    log("(j3) kimi smoke train steps, kernels == plain bit for bit " + json.dumps(train))
    return dict(chunked_build_cases=chunked, serving=serving, parity=parity, train=train)


# ---------------------------------------------------------------------------
# phase (k): the ssm and hybrid families (mamba2-780m, hymba-1.5b)
# ---------------------------------------------------------------------------

#: phase (c)'s K3 rows for the SSM archs: (arch, weight, M, K, N, x dtype):
#: the mixers' in_proj at M = 4 (bf16 x, the decode step; hymba's N = 3257
#: odd: a t16 row pitch that is no 16-byte multiple), hymba's untied head,
#: and mamba2's out_proj on the f32 y at M = 1024 (the prefill's wgmma tile)
SSM_K3 = (("mamba2_780m", "in_proj", 4, 1536, 6448, "bfloat16"),
          ("hymba_1_5b", "in_proj", 4, 1600, 3257, "bfloat16"),
          ("hymba_1_5b", "lm_head", 4, 1600, 32001, "bfloat16"),
          ("mamba2_780m", "out_proj", 1024, 3072, 1536, "float32"))
#: mamba2's tied head: (arch, V, d)
SSM_TIED_HEAD = ("mamba2_780m", 50280, 1536)
#: K6 at hymba's last decode step of (k1): (B, H, Kv, S, hd, length,
#: window, softcap), g = 5, a window of 1024 under the length
HYMBA_ATTENTION = (4, 25, 5, 2080, 64, 2080, 1024, 0.0)
#: phase (k1) serving runs: (arch, policies, layers (None: published depth),
#: prompt): mamba2's 4096 tokens are 16 SSD chunks of 256, hymba's 2048 run
#: past its 1024-key window; half depth keeps the script inside its time
#: limit
SSM_RUNS = (("mamba2_780m", ("takum", "takum8"), 24, 4096),
            ("hymba_1_5b", ("takum", "takum8"), 16, 2048))
#: phase (k2): (arch, policies, prompt) of the 2-layer kernel-vs-plain parity:
#: mamba2 two chunks of 256, hymba past its window (1056: six chunks of 176)
SSM_PARITY = (("mamba2_780m", ("takum", "takum8"), 512), ("hymba_1_5b", ("takum", "takum8"), 1056))


def phase_ssm_kernels(torch, dev, rows):
    """Phase (c) for the SSM archs: K3 at ``SSM_K3``'s shapes, t16 bits and
    t8 lut, within K3_LIMIT of |x| @ |w| (``k3_row``, timed beside its bound
    and ``torch.matmul(x, decode(w))``); the transposed K3 over mamba2's
    tied table at M = 4 (``tied_head_rows``); K6 at hymba's shape, t8 lut
    and bits (``attention_row``)."""
    from repro_torch.kernels.takum_codec import decode_2d_plain, encode_2d_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(2401)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for arch, leaf, M, K, N, xdt in SSM_K3:
        wf32 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        xm = torch.randn((M, K), generator=gen, device=dev).to(getattr(torch, xdt))
        for fmt, impl in (("t16", "bits"), ("t8", "lut")):
            w = encode_2d_plain(wf32, fmt)
            wd = decode_2d_plain(w, fmt)
            rows.append(k3_row(torch, flush, fmt, impl, xm, w, wd,
                               f"K3[{impl}] {fmt} {arch} {leaf} {M}x{K}x{N} x {xdt}",
                               use=leaf, arch=arch))
            del w, wd
        del wf32
        log(f"(c) K3 over {arch}'s {leaf} [{K}, {N}] at M = {M}, x {xdt}: within {K3_LIMIT}, "
            f"timed")
    tied_head_rows(torch, gen, flush, rows, *SSM_TIED_HEAD)  # the table it returns is dropped
    torch.cuda.empty_cache()
    attention_row(torch, gen, flush, rows, "hymba_1_5b", HYMBA_ATTENTION)
    del flush
    torch.cuda.empty_cache()


def phase_ssm(torch, dev, card):
    """(k1) ``phase_serving`` of each run of ``SSM_RUNS`` at published widths
    and depth (launches held by ``check_launches``: 2 K3 a layer for ssm
    and no K2 or K6; 9 K3, 1 K2 and 1 K6 a layer for hybrid), the decode
    step's device time split by ``kernel_class``; (k2) ``phase_parity`` of
    each entry of ``SSM_PARITY`` at 2 layers, f32 and bf16 activations, the
    conv tails and SSM states held beside the logits."""
    from repro_torch import configs

    serving = {}
    for arch, policies, layers, S0 in SSM_RUNS:
        cfg = configs.get(arch)
        if cfg.sliding_window:
            check(S0 > cfg.sliding_window, f"{arch}: the prompt must outrun the window")
        for policy in policies:
            t0 = time.perf_counter()
            r = serving[f"{arch}/{policy}"] = phase_serving(torch, dev, policy, arch, layers, S0)
            prof = r["profile_two_decode_steps"]
            log(f"(k1) serving {arch} {policy}, {r['layers']} of {r['published_layers']} layers, "
                f"B={r['batch']} prompt {S0}: warm prefill {r['prefill_ms']:.1f} ms (first "
                f"{r['first_prefill_ms']:.1f}), decode {r['decode_ms_per_token']:.2f} ms/token, "
                f"peak {r['max_memory_allocated_gb']:.2f} GB, packed "
                f"{r['weight_bytes'] / 1e9:.2f} GB, recurrent state "
                f"{r['recurrent_state_bytes'] / 1e6:.1f} MB, KV {r['kv_cache_bytes'] / 1e6:.1f} "
                f"MB, launches per decode step (torch.profiler) "
                f"{prof['kernel_launches_per_step']}, device busy {prof['device_busy_ms']} ms "
                f"over two steps, idle share {prof['idle_share']}, of the counted step "
                f"{prof.get('idle_share_of_counted_step')}; decode device ms a step by class "
                f"{prof['device_ms_per_step_by_class']}; prefill busy "
                f"{r['profile_prefill']['device_busy_ms']} ms, K3 share "
                f"{r['profile_prefill']['k3_share']}; counted launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }, packing "
                f"{r['pack_launches']}; card: {card} ({time.perf_counter() - t0:.1f} s)")
    parity = []
    for arch, policies, S0 in SSM_PARITY:
        t0 = time.perf_counter()
        parity += phase_parity(torch, dev, arch, policies, S0=S0)
        log(f"(k2) parity {arch} {policies} at 2 layers, prompt {S0}, done in "
            f"{time.perf_counter() - t0:.1f} s")
    return dict(serving=serving, parity=parity)


# ---------------------------------------------------------------------------
# phase (l): the vlm family and the f32 KV cache
# ---------------------------------------------------------------------------

VLM = "llama3_2_vision_90b"
#: K6 over an f32 cache (B, H, Kv, S, hd, length, window, softcap) at
#: llama3-8b's decode shape (g 4) and the vlm's (g 8); and K6 t8 at the vlm's
#: last decode step of (l1)
F32_ATTENTION = (("llama3_8b", (4, 32, 8, 288, 128, 288, 0, 0.0)),
                 (VLM, (4, 64, 8, 288, 128, 288, 0, 0.0)))
VLM_ATTENTION = (4, 64, 8, 290, 128, 288, 0, 0.0)
#: K3 at the vlm's media shapes, bf16 x: (leaf, M = B x 4096, K, N)
VLM_K3 = (("media_proj", 16384, 1408, 8192), ("cross wk", 16384, 8192, 1024))
#: (l1) serving runs (policy, layers of 100): whole groups of 5 (a cross
#: layer each).  The packed tree fits at twice these (takum8 at 40 layers
#: 37.5 GB, takum at 20 39.6 GB); half of that keeps the script, with phase
#: (n), inside its time limit (as (k1) and musicgen in (i2))
VLM_RUNS = (("takum8", 20), ("takum", 10))
#: (l2): the kernel-vs-plain parity at 5 layers, one cross layer
VLM_PARITY_LAYERS = 5
#: (l3): the f32 KV cache's prefill-then-decode consistency at full width,
#: (arch, layers)
F32_CACHE_RUNS = (("llama3_8b", 2), (VLM, 5))


def f32_words(torch, n, gen, dev):
    """n f32 values as raw words: random bit patterns (subnormals, NaN
    payloads and +-Inf among them), then the named classes (+-0, the
    subnormal extremes, a signalling NaN, a payload NaN)."""
    w = torch.randint(-(2 ** 31), 2 ** 31 - 1, (n,), generator=gen, device=dev,
                      dtype=torch.int64)
    named = torch.tensor([0, -(2 ** 31), 1, 0x007FFFFF, -(2 ** 31) + 1, 0x7F800000, -0x00800000,
                          0x7FC00000, 0x7F800001, 0x7FF00F0F], dtype=torch.int64, device=dev)
    w[:named.numel()] = named
    return w.to(torch.int32).view(torch.float32)


def phase_vlm_kernels(torch, dev, rows):
    """(l0): K1 / K2 over f32 at [1024, 4096], bit for bit against their
    plain versions and against the raw words (no DAZ, payloads kept), timed
    beside a copy; the f32 KV append (``takum_encode_into`` of bf16 K and V
    into an f32 cache's slots, the decode step's and the prefill's) bit for
    bit, timed beside a ``copy_``; K6 over an f32 cache at
    ``F32_ATTENTION``'s shapes and K6 t8 at the vlm's (``attention_row``);
    K3 at ``VLM_K3``'s media shapes, t16 bits and t8 lut, within K3_LIMIT
    (``k3_row``)."""
    from repro_torch.kernels.takum_codec import (decode_2d_plain, encode_2d_plain,
                                                 encode_into_plain, takum_decode_2d,
                                                 takum_encode_2d, takum_encode_into)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2501)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    R, C = 1024, 4096
    x = f32_words(torch, R * C, gen, dev).reshape(R, C)
    words = x.view(torch.int32)
    bits = takum_encode_2d(x, "f32")
    check(torch.equal(bits.view(torch.int32), words), "K2 f32: not the raw words")
    check(torch.equal(bits.view(torch.int32), encode_2d_plain(x, "f32").view(torch.int32)),
          "K2 f32: differs from the plain version")
    back = takum_decode_2d(bits, "f32")
    check(torch.equal(back.view(torch.int32), words), "K1 f32: not the raw words")
    check(torch.equal(back.view(torch.int32), decode_2d_plain(bits, "f32").view(torch.int32)),
          "K1 f32: differs from the plain version")
    nbytes = 2 * R * C * 4
    rows.append(codec_row(torch, "takum_encode_2d", "f32", "bits", [R, C], 0.0, nbytes,
                          lambda: takum_encode_2d(x, "f32"), lambda: encode_2d_plain(x, "f32"),
                          lambda: words.clone(), flush))
    rows.append(codec_row(torch, "takum_decode_2d", "f32", "bits", [R, C], 0.0, nbytes,
                          lambda: takum_decode_2d(bits, "f32"),
                          lambda: decode_2d_plain(bits, "f32"), lambda: words.clone(), flush))
    log(f"(l0) K1 / K2 f32 [{R}, {C}]: the raw words both ways (subnormals, -0, NaN payloads "
        f"kept), equal to the plain versions, timed")
    del x, words, bits, back
    Kv, hd = 8, 128
    for B, S, start, cache_len in APPEND_CASES:
        k, v = (torch.randn((B * S * Kv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        cache = torch.zeros((2, B, cache_len * Kv * hd), dtype=torch.float32,
                            device=dev).view(torch.uint32)
        want = cache.clone()

        def slots(c):
            return [c[i][:, start * Kv * hd:(start + S) * Kv * hd] for i in range(2)]

        def lib():
            for src, dst in zip((k, v), slots(want)):
                dst.view(torch.float32).copy_(src.view(B, -1))

        takum_encode_into((k, v), slots(cache), "f32")
        encode_into_plain((k, v), slots(want), "f32")
        check(torch.equal(cache.view(torch.int32), want.view(torch.int32)),
              f"append f32 S={S}: the cache differs from the plain version's")
        lib()
        check(torch.equal(cache.view(torch.int32), want.view(torch.int32)),
              f"append f32 S={S}: the copy_ differs from the kernel's append")
        rows.append(codec_row(
            torch, "takum_encode_into", "f32", "bits", [2, B * S * Kv, hd], 0.0,
            2 * (k.numel() * 2 + B * S * Kv * hd * 4),
            lambda: takum_encode_into((k, v), slots(cache), "f32"),
            lambda: encode_into_plain((k, v), slots(want), "f32"), lib, flush))
        del k, v, cache, want
    log("(l0) the f32 KV append (bf16 K and V into an f32 cache's slots, one launch): bit for "
        "bit, timed beside a copy_")
    for arch, shape in F32_ATTENTION:
        attention_row(torch, gen, flush, rows, arch, shape, fmt="f32")
    attention_row(torch, gen, flush, rows, VLM, VLM_ATTENTION)
    for leaf, M, K, N in VLM_K3:
        wf32 = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        xm = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        for fmt, impl in (("t16", "bits"), ("t8", "lut")):
            w = encode_2d_plain(wf32, fmt)
            wd = decode_2d_plain(w, fmt)
            rows.append(k3_row(torch, flush, fmt, impl, xm, w, wd,
                               f"K3[{impl}] {fmt} {VLM} {leaf} {M}x{K}x{N}", use=leaf, arch=VLM))
            del w, wd
        del wf32, xm
        torch.cuda.empty_cache()
        log(f"(l0) K3 over the vlm's {leaf} [{K}, {N}] at M = {M}, bf16 x: within {K3_LIMIT}, "
            f"timed")
    del flush
    torch.cuda.empty_cache()


def phase_f32_cache(torch, dev, arch, layers):
    """(l3): ``repro``'s prefill-then-decode consistency at ``arch``'s
    published width and ``layers`` layers under ``QuantPolicy(weights="t16",
    kv_cache="f32", activations="f32")``: the full forward over 16 tokens
    against a prefill of 8 and 8 decode steps (K2 appending raw f32 bits,
    K6 reading them), within 2e-2 (rtol and atol, as ``repro``'s test);
    the launches counted around the prefill and the steps."""
    from repro_torch import configs, serve
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.quant.policy import QuantPolicy

    cfg = configs.get(arch).with_(num_layers=layers, quant=QuantPolicy(
        weights="t16", kv_cache="f32", activations="f32"))
    qp = serve.load_params(chunked_packed_params(torch, cfg, 5, dev)[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    B, S, S0 = 2, 16, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    media = media_batch(torch, cfg, B, gen, dev).get("media")
    full, _ = T.forward(cfg, qp, tokens, media)
    ops.reset_launch_counts()
    last, cache = T.prefill(cfg, qp, tokens[:, :S0], media, cache_len=S)
    check(cache.k.dtype == torch.float32, f"f32 cache {arch}: cache dtype {cache.k.dtype}")
    diffs = [float((last - full[:, S0 - 1]).abs().max())]
    ok = bool(torch.allclose(last, full[:, S0 - 1], rtol=2e-2, atol=2e-2))
    for t in range(S0, S):
        lg, cache = T.decode_step(cfg, qp, tokens[:, t], cache, media)
        diffs.append(float((lg - full[:, t]).abs().max()))
        ok = ok and bool(torch.allclose(lg, full[:, t], rtol=2e-2, atol=2e-2))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    L = cfg.num_layers
    out = dict(arch=cfg.name, layers=L, max_abs_diff_per_call=diffs,
               max_abs_logit=float(full.abs().max()), launches=counts)
    log(f"(l3) f32 KV cache {arch} at {L} layers: prefill + {S - S0} decode steps against the "
        f"full forward, max |diff| per call {[float(f'{d:.2e}') for d in diffs]} (max |logit| "
        f"{out['max_abs_logit']:.3g}), launches {counts}")
    check(ok, f"f32 cache {arch}: prefill-then-decode beyond 2e-2 of the full forward")
    check(counts.get("takum_encode_into[bits]") == L * (1 + S - S0)
          and counts.get("takum_decode_attention[bits]") == L * (S - S0),
          f"f32 cache {arch}: launches {counts}")
    del qp, cache, full
    torch.cuda.empty_cache()
    return out


def phase_vlm(torch, dev, card):
    """(l1) ``phase_serving`` of the vlm for each run of ``VLM_RUNS`` at
    published widths, B = 4, prompt 256, 32 decode steps; (l2)
    ``phase_parity`` at ``VLM_PARITY_LAYERS`` layers under takum and
    takum8; (l3) ``phase_f32_cache`` for each of ``F32_CACHE_RUNS``."""
    serving = {}
    for policy, layers in VLM_RUNS:
        t0 = time.perf_counter()
        r = serving[f"{VLM}/{policy}"] = phase_serving(torch, dev, policy, VLM, layers)
        prof = r["profile_two_decode_steps"]
        log(f"(l1) serving {VLM} {policy}, {r['layers']} of {r['published_layers']} layers "
            f"({r['cross_layers']} cross), B={r['batch']} prompt {r['prompt']}, "
            f"{r['media_tokens']} media tokens: warm prefill {r['prefill_ms']:.1f} ms (first "
            f"{r['first_prefill_ms']:.1f}), decode {r['decode_ms_per_token']:.2f} ms/token, "
            f"peak {r['max_memory_allocated_gb']:.2f} GB (held before "
            f"{r['allocated_before_gb']:.2f}), packed {r['weight_bytes'] / 1e9:.2f} GB, KV "
            f"{r['kv_cache_bytes'] / 1e6:.1f} MB, launches per decode step (torch.profiler) "
            f"{prof['kernel_launches_per_step']}, device busy {prof['device_busy_ms']} ms over "
            f"two steps, idle share {prof['idle_share']}, of the counted step "
            f"{prof.get('idle_share_of_counted_step')}; decode device ms a step by class "
            f"{prof['device_ms_per_step_by_class']}; prefill busy "
            f"{r['profile_prefill']['device_busy_ms']} ms, K3 share "
            f"{r['profile_prefill']['k3_share']}; counted launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }, packing "
            f"{r['pack_launches']}; card: {card} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    parity = phase_parity(torch, dev, VLM, ("takum", "takum8"), layers=VLM_PARITY_LAYERS)
    log(f"(l2) parity {VLM} at {VLM_PARITY_LAYERS} layers done in "
        f"{time.perf_counter() - t0:.1f} s")
    f32_cache = {}
    for arch, layers in F32_CACHE_RUNS:
        f32_cache[arch] = phase_f32_cache(torch, dev, arch, layers)
    return dict(serving=serving, parity=parity, f32_cache=f32_cache)


# ---------------------------------------------------------------------------
# (m) observability and the fault guards on the card
# ---------------------------------------------------------------------------

#: (m1) serving shape: llama3-8b at full width and depth, B, prompt, decode steps
OBS_B, OBS_S0, OBS_STEPS = 4, 256, 8
#: the wrapper each observed op launches (``ops._observed``'s op names);
#: matmul and matmul_t share ``takum_matmul``, the latter's keys end in "^T"
OBS_WRAPPER = {"encode": "takum_encode_2d", "decode": "takum_decode_2d",
               "encode_into": "takum_encode_into", "decode_rows": "takum_decode_rows",
               "matmul": "takum_matmul", "matmul_t": "takum_matmul",
               "dual_matmul": "takum_dual_matmul", "decode_attention": "takum_decode_attention"}
#: (m2) the bit-flip rate of the fault census, and how many standard
#: deviations of the binomial count the flipped bytes may stray
OBS_FLIP_RATE, OBS_FLIP_SD = 1e-4, 6.0
#: PERF.md's kernel count of one takum decode step of llama3-8b (phase (d)'s profile)
DECODE_KERNELS_BEFORE = 2960


def launches_by_op(counts):
    """``launch_counts()`` summed by the observed op that launches each
    wrapper: {op: launches}."""
    out = {}
    for key, n in counts.items():
        wrapper, impl = key.split("[", 1)
        for op, w in OBS_WRAPPER.items():
            if w == wrapper and (op == "matmul_t") == impl.endswith("^T]"):
                out[op] = out.get(op, 0) + n
    return {op: n for op, n in out.items() if n}


def calls_by_op(ctrs):
    """``kernel.calls.<op>.<fmt>`` counters summed by op."""
    out = {}
    for tag, v in ctrs.items():
        if tag.startswith("kernel.calls."):
            op = tag.split(".")[2]
            out[op] = out.get(op, 0) + int(v)
    return out


def profiled_step(torch, fn):
    """``fn()`` under torch.profiler: (its result, device ms by kernel name,
    the kernels launched but copies and sets)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = sum(ev.count for ev in prof.key_averages()
                  if "CUDA" in str(getattr(ev, "device_type", ""))
                  and not ev.key.startswith(("Memcpy", "Memset")))
    return out, device_ms_by_name(prof), kernels


def obs_model(torch, dev, cfg):
    """A packed, loaded tree of ``cfg`` (seed 0) and (m)'s prompt."""
    from repro_torch import serve

    qp = serve.load_params(packed_params(torch, cfg, seed=0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    return qp, torch.randint(0, cfg.vocab_size, (OBS_B, OBS_S0), generator=gen, device=dev)


def obs_serving(torch, dev, card):
    """(m1) llama3-8b at full width and depth under ``takum_guarded`` (t16
    weights, t8 KV cache), B = 4, prompt 256, 8 greedy decode steps: run
    uncaptured, under ``telemetry.capture()``, and uncaptured again.  The
    logits of the three runs equal bit for bit; the captured run's launches
    equal the uncaptured one's (a capture launches no kernel of the port);
    each op's ``kernel.calls`` equals its launches; ``kv.bytes`` is the
    config's and ``kv.specials.t8`` is 0.  Then one uncaptured decode step
    under torch.profiler (its kernel count beside ``DECODE_KERNELS_BEFORE``)
    and one captured one: the ``kernel.matmul.*`` and
    ``kernel.decode_attention.*`` spans' summed event ms against the
    profiler's device ms of K3's and K6's kernels, each ratio >= 0.95 (an
    event pair brackets its kernels).  Returns the results and the captured
    run's snapshot."""
    from repro_torch import configs, serve
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.quant.policy import POLICIES

    cfg = configs.get("llama3_8b").with_(quant=POLICIES["takum_guarded"])
    L, Kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    qp, prompt = obs_model(torch, dev, cfg)
    prefill = serve.make_prefill_step(cfg, cache_len=OBS_S0 + OBS_STEPS + 2)
    step = serve.make_serve_step(cfg)

    def run():
        ops.reset_launch_counts()
        logits, cache = prefill(qp, {"tokens": prompt})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [logits]
        for _ in range(OBS_STEPS):
            logits, cache = step(qp, {"token": torch.argmax(logits, -1)}, cache)
            outs.append(logits)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / OBS_STEPS * 1e3
        return torch.stack(outs), cache, ms, {k: v for k, v in ops.launch_counts().items() if v}

    plain, _, ms_before, launches = run()
    with telemetry.capture():
        logits, cache, ms_captured, launches_captured = run()
        snap = telemetry.snapshot()
    again, _, ms_after, _ = run()
    ctrs = snap["counters"]
    check(same_bits_f32(torch, logits, plain) and same_bits_f32(torch, again, plain),
          "m1: the captured run's logits differ from the uncaptured runs'")
    check(launches_captured == launches,
          f"m1: a capture changed the launches {launches_captured} vs {launches}")
    calls, by_op = calls_by_op(ctrs), launches_by_op(launches)
    check(calls == by_op, f"m1: kernel.calls by op {calls} != launches by op {by_op}")
    kv_bytes = 2 * L * OBS_B * (OBS_S0 + OBS_STEPS) * Kv * hd
    check(ctrs.get("kv.bytes.t8") == kv_bytes,
          f"m1: kv.bytes.t8 {ctrs.get('kv.bytes.t8')}, want {kv_bytes}")
    check(ctrs.get("kv.specials.t8") == 0.0, f"m1: kv.specials.t8 {ctrs.get('kv.specials.t8')}")
    check(ctrs.get("kv.appends.t8") == 2 + 2 * L * OBS_STEPS,
          f"m1: kv.appends.t8 {ctrs.get('kv.appends.t8')}")
    spans = snap["spans"]
    check(len(spans) == sum(calls.values()) and snap["dropped_spans"] == 0,
          f"m1: {len(spans)} spans for {sum(calls.values())} calls")

    tok = torch.argmax(logits[-1], -1)
    _, _, uncaptured_kernels = profiled_step(torch, lambda: step(qp, {"token": tok}, cache))

    def captured_step():
        with telemetry.capture():
            step(qp, {"token": tok}, cache)
        return telemetry.spans()

    step_spans, by_name, captured_kernels = profiled_step(torch, captured_step)
    ratios = {}
    for cls, op in (("k3", "kernel.matmul."), ("k6", "kernel.decode_attention.")):
        span_ms = sum((s["t1"] - s["t0"]) * 1e3 for s in step_spans if s["name"].startswith(op))
        prof_ms = sum(v for k, v in by_name.items() if kernel_class(k) == cls)
        ratios[cls] = dict(span_ms=span_ms, profiler_ms=prof_ms,
                           ratio=span_ms / prof_ms if prof_ms else None)
        check(prof_ms > 0 and span_ms / prof_ms >= 0.95,
              f"m1: {cls} spans {span_ms:.4f} ms against the profiler's {prof_ms:.4f} ms")
    out = dict(arch=cfg.name, policy="takum_guarded", batch=OBS_B, prompt=OBS_S0,
               decode_steps=OBS_STEPS, decode_ms_per_token_uncaptured=ms_before,
               decode_ms_per_token_captured=ms_captured,
               decode_ms_per_token_uncaptured_after=ms_after,
               kernels_one_uncaptured_decode_step=uncaptured_kernels,
               kernels_one_captured_decode_step=captured_kernels,
               kernels_before=DECODE_KERNELS_BEFORE, calls_by_op=calls, launches=launches,
               kv={k: v for k, v in ctrs.items() if k.startswith("kv.")},
               spans=len(spans), span_vs_profiler=ratios, card=card)
    del qp, cache, logits, plain, again
    torch.cuda.empty_cache()
    return out, snap


def cache_bytes(torch, cache, S):
    """The K and V bytes of a cache's first S positions, as one uint8 tensor."""
    return torch.cat([t[:, :, :S].contiguous().view(torch.uint8).reshape(-1)
                      for t in (cache.k, cache.v)])


def obs_fault_census(torch, dev, card):
    """(m2) The fault census on (m1)'s model: a clean prefill, then the same
    prefill under ``inject(FaultConfig(seed=5, bit_flip_rate=1e-4))`` and a
    capture, then again with the same seed.  Every cache byte that differs
    from the clean cache differs in one bit, their count lies within
    ``OBS_FLIP_SD`` binomial standard deviations of rate x bytes,
    ``kv.specials.t8`` equals the NaR codes (0x80) counted on the host in
    the written slots, and the second run's cache equals the first's.  Then
    mxfp8 at full width and 2 layers under ``scale_nan_rate=1.0``:
    ``kv.specials.mxe4m3`` is 32 x the appended blocks."""
    from repro_torch import configs, serve
    from repro_torch.core import telemetry
    from repro_torch.dist import faults
    from repro_torch.quant import blockscale
    from repro_torch.quant.policy import POLICIES

    cfg = configs.get("llama3_8b").with_(quant=POLICIES["takum_guarded"])
    qp, prompt = obs_model(torch, dev, cfg)
    prefill = serve.make_prefill_step(cfg, cache_len=OBS_S0)
    clean = cache_bytes(torch, prefill(qp, {"tokens": prompt})[1], OBS_S0)
    fcfg = faults.FaultConfig(seed=5, bit_flip_rate=OBS_FLIP_RATE)
    runs = []
    for _ in range(2):
        with faults.inject(fcfg), telemetry.capture() as ctrs:
            logits, cache = prefill(qp, {"tokens": prompt})
        runs.append((logits, cache_bytes(torch, cache, OBS_S0), dict(ctrs)))
        del cache
    logits, bad, ctrs = runs[0]
    check(torch.equal(bad, runs[1][1]), "m2: the same seed gave other cache bytes")
    x = bad ^ clean
    diff = x[x != 0].to(torch.int32)
    check(bool(((diff & (diff - 1)) == 0).all()), "m2: a corrupted byte differs in more than one bit")
    n, N = diff.numel(), clean.numel()
    sd = math.sqrt(N * OBS_FLIP_RATE * (1 - OBS_FLIP_RATE))
    check(abs(n - N * OBS_FLIP_RATE) <= OBS_FLIP_SD * sd,
          f"m2: {n} of {N} bytes flipped, want {N * OBS_FLIP_RATE:.0f} +- {OBS_FLIP_SD * sd:.0f}")
    nar = int((bad.cpu() == 0x80).sum())
    check(ctrs.get("kv.specials.t8") == nar,
          f"m2: kv.specials.t8 {ctrs.get('kv.specials.t8')}, NaR bytes on the host {nar}")
    rows_nonfinite = int((~torch.isfinite(logits)).any(-1).sum())
    del qp, clean, bad, runs, x
    torch.cuda.empty_cache()

    mcfg = configs.get("llama3_8b").with_(num_layers=2, quant=POLICIES["mxfp8"])
    mqp, _ = obs_model(torch, dev, mcfg)
    with faults.inject(faults.FaultConfig(seed=5, scale_nan_rate=1.0)), \
            telemetry.capture() as mctrs:
        serve.make_prefill_step(mcfg, cache_len=OBS_S0)(mqp, {"tokens": prompt})
    blocks = (2 * mcfg.num_layers * OBS_B * OBS_S0 * mcfg.num_kv_heads
              * blockscale.payload_len(mcfg.resolved_head_dim) // 33)
    check(mctrs.get("kv.specials.mxe4m3") == 32 * blocks
          and mctrs.get("kv.bytes.mxe4m3") == 33 * blocks,
          f"m2: mxe4m3 kv.specials {mctrs.get('kv.specials.mxe4m3')}, want {32 * blocks}")
    del mqp
    torch.cuda.empty_cache()
    return dict(flip_rate=OBS_FLIP_RATE, cache_bytes=N, bytes_flipped=n,
                expected=N * OBS_FLIP_RATE, binomial_sd=sd, kv_specials_t8=nar,
                kv_counters={k: v for k, v in ctrs.items() if k.startswith("kv.")},
                nonfinite_logit_rows=rows_nonfinite, logit_rows=int(logits.shape[0]),
                mx_blocks=blocks, mx_kv_specials=mctrs.get("kv.specials.mxe4m3"), card=card)


def leaf_prints(torch, st):
    """Per leaf of the params and of the moments (QTensor bits and scales):
    (identity, version counter, int64 sum of its bits)."""
    from repro_torch import tree

    out = []
    for t in tree.flatten(st.params)[0] + tree.flatten(st.opt.m)[0] + tree.flatten(st.opt.v)[0]:
        w = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
        out.append((id(t), t._version, int(t.view(w).sum(dtype=torch.int64))))
    return out


def obs_guarded_step(torch, dev, card, snap):
    """(m3) The guarded train step at (h3)'s shape (llama3-8b full width,
    TRAIN_LAYERS layers, B = 4, S = 256) under ``takum_guarded``: one step
    under ``inject(FaultConfig(grad_poison_rate=1.0))`` leaves every param
    and moment leaf as it was (the same tensor, no in-place write, the same
    bit sum) and counts ``step.skipped`` 1; one clean step after it moves
    them (``step.skipped`` 0).  Then (m1)'s capture ``snap`` exported as
    JSONL and Chrome trace into a temporary directory, read back and
    validated."""
    import tempfile

    from repro_torch import configs
    from repro_torch.core import telemetry
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import faults
    from repro_torch.obs import trace_export
    from repro_torch.quant.policy import POLICIES
    from repro_torch.train.step import init_state, make_train_step

    cfg = configs.get("llama3_8b").with_(num_layers=TRAIN_LAYERS, quant=POLICIES["takum_guarded"])
    st = init_state(cfg, 0, device=dev)
    step = make_train_step(cfg)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=17).batch(0)
    before = leaf_prints(torch, st)
    t0 = time.perf_counter()
    with faults.inject(faults.FaultConfig(seed=3, grad_poison_rate=1.0)), \
            telemetry.capture() as ctrs:
        st, m = step(st, batch)
    poisoned_ms = (time.perf_counter() - t0) * 1e3
    check(ctrs.get("step.skipped") == 1.0 and m["grad_ok"].item() == 0.0,
          f"m3: poisoned step skipped {ctrs.get('step.skipped')}, grad_ok {m['grad_ok'].item()}")
    check(leaf_prints(torch, st) == before, "m3: the skipped step changed a param or moment leaf")
    check(st.opt.step.item() == 0, "m3: the skipped step advanced the optimizer")
    t0 = time.perf_counter()
    with telemetry.capture() as ctrs2:
        st, m = step(st, batch)
        torch.cuda.synchronize()
    clean_ms = (time.perf_counter() - t0) * 1e3
    after = leaf_prints(torch, st)
    moved = sum(a[2] != b[2] for a, b in zip(after, before))
    check(ctrs2.get("step.skipped") == 0.0 and m["grad_ok"].item() == 1.0
          and st.opt.step.item() == 1 and moved >= len(before) // 2,
          f"m3: the clean step moved {moved} of {len(before)} leaves")
    step_span = [s for s in telemetry.spans() if s["name"] == "step.train"]
    del st, m
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        jsonl, trace = f"{tmp}/obs.jsonl", f"{tmp}/obs_trace.json"
        n_lines = trace_export.export_jsonl(jsonl, snap)
        n_spans = trace_export.export_chrome_trace(trace, snap)
        lines = trace_export.load_jsonl(jsonl)
        evs = trace_export.validate_chrome_trace(trace_export.load_chrome_trace(trace))
    check(len(lines) == n_lines and len(evs) == n_spans == len(snap["spans"]) > 0,
          f"m3: exported {n_lines} lines / {n_spans} spans, read back {len(lines)} / {len(evs)}")
    check({e["cat"] for e in evs} == {"kernel"}, "m3: span categories")
    return dict(layers=TRAIN_LAYERS, batch=TRAIN_B, seq=TRAIN_S, leaves=len(before),
                poisoned_step_ms=poisoned_ms, clean_step_ms=clean_ms, leaves_moved=moved,
                step_span_ms=[(s["t1"] - s["t0"]) * 1e3 for s in step_span],
                exported_lines=n_lines, exported_spans=n_spans, card=card)


def phase_observability(torch, dev, card):
    """(m) observability and the fault guards on the card: (m1) serving
    captured against uncaptured, (m2) the fault census, (m3) the guarded
    step and the trace export."""
    t0 = time.perf_counter()
    serving, snap = obs_serving(torch, dev, card)
    log(f"(m1) llama3-8b takum_guarded B={OBS_B} prompt {OBS_S0}, {OBS_STEPS} decode steps: "
        f"decode {serving['decode_ms_per_token_uncaptured']:.2f} ms/token uncaptured, "
        f"{serving['decode_ms_per_token_captured']:.2f} captured, "
        f"{serving['decode_ms_per_token_uncaptured_after']:.2f} uncaptured again; logits bit "
        f"for bit; kernels of one uncaptured decode step (torch.profiler) "
        f"{serving['kernels_one_uncaptured_decode_step']} (PERF.md: {DECODE_KERNELS_BEFORE}), "
        f"captured {serving['kernels_one_captured_decode_step']}; kernel.calls by op "
        f"{serving['calls_by_op']} = launches; kv {serving['kv']}; spans {serving['spans']}; "
        f"span / profiler {json.dumps(serving['span_vs_profiler'])}; card: {card}")
    census = obs_fault_census(torch, dev, card)
    log(f"(m2) bit flips at {census['flip_rate']}: {census['bytes_flipped']} of "
        f"{census['cache_bytes']} cache bytes (expected {census['expected']:.0f} +- "
        f"{census['binomial_sd']:.0f}), one bit each, replayed; kv.specials.t8 "
        f"{census['kv_specials_t8']} = NaR bytes on the host; non-finite logit rows "
        f"{census['nonfinite_logit_rows']} of {census['logit_rows']}; mxfp8 2 layers, "
        f"scale_nan_rate 1: kv.specials.mxe4m3 {census['mx_kv_specials']} = 32 x "
        f"{census['mx_blocks']} blocks; card: {card}")
    guarded = obs_guarded_step(torch, dev, card, snap)
    log(f"(m3) guarded step, llama3-8b {guarded['layers']} layers B={guarded['batch']} "
        f"S={guarded['seq']}: poisoned step skipped, {guarded['leaves']} leaves held bit for bit "
        f"({guarded['poisoned_step_ms']:.1f} ms); clean step moved {guarded['leaves_moved']} "
        f"({guarded['clean_step_ms']:.1f} ms); (m1)'s capture exported "
        f"{guarded['exported_lines']} JSONL lines, {guarded['exported_spans']} trace spans, "
        f"read back and valid; card: {card}")
    seconds = time.perf_counter() - t0
    log(f"(m) observability and fault guards on the card done in {seconds:.1f} s")
    return dict(serving=serving, census=census, guarded=guarded, seconds=seconds)


# ---------------------------------------------------------------------------
# (n) dist: ranks sharing the card
# ---------------------------------------------------------------------------

DIST_P = 4
#: llama3-8b's wi gradient: each ring rank's payload
RING_SHAPE = (4096, 14336)
RING_FMTS = ("f32", "t16", "t8", "bf16", "e4m3", "e5m2", "mxe4m3", "mxt8")
#: max |ring - float64 sum| / rms of the payloads (``tests/test_dist.py``'s,
#: set there at 8192 elements).  f32 is held instead to the rounding bound
#: of a 4-term f32 sum in any order, |err| <= (P - 1) eps sum_j |x_j| per
#: element: at 58.7 M elements the f32 sum itself rounds past 1e-6 x rms
#: (1.14e-6 read on an H100, gloo's all-reduce), which its err / rms beside
#: 1e-6 shows
RING_LIMITS = {"f32": 1e-6, "t16": 2e-2, "bf16": 4e-2, "t8": 1.0, "e4m3": 1.0, "e5m2": 1.5,
               "mxe4m3": 1.0, "mxt8": 1.0}
EF_STEPS = 4
#: the pipeline: 4 stages of K3 over a packed t16 [d, d] weight then tanh, 8
#: microbatches of [256, d]
PIPE_D, PIPE_MB, PIPE_M = 4096, 256, 8
PIPE_WIRES = (None, "t16", "t8", "mxt8")
#: the guarded run: t8's relative rms error is about 0.04 on the stages'
#: outputs at scale 1 and about 0.19 at 1e-3 (a CPU simulation at d = 512,
#: ``ops``' plain path), so a bound of 0.1 passes the first 4 ticks and
#: trips the rest, at ticks 4-6 on some stages only
PIPE_GUARD_SCALE, PIPE_GUARD_REL_ERR = 1e-3, 0.1
#: the pod train step: llama3-8b at published width, cut to DIST_LAYERS
#: layers, mesh 2x1x1 (two processes on the card), B = 4, S = 256.  One
#: layer: at two, each rank's step peaked past 37 GB (the functional AdamW
#: holds old and new params and moments, 5 copies of the 5.9 GB of params,
#: beside its temporaries) and the two ranks ran out of the card's 79 GB
DIST_LAYERS, DIST_B, DIST_S, DIST_STEPS = 1, 4, 256, 3
#: the layers of the mesh serve steps (serving holds no optimizer state)
SERVE_LAYERS = 2
#: the runs of (n3): name, policy, grad_comm override, its quant overrides.
#: mxfp8 keeps f32 moments, 7 copies of the params in a step, which two
#: ranks cannot hold: its run stores t16 moments (the ring, mxe5m2, is the
#: subject).  The f32-ring run stores bf16 moments (an order ulp in a
#: gradient moves a moment by at most one bf16 step, where a t16 moment's
#: pow2 scale leaves tiny ones a few fraction bits) and f32 activations
DIST_RUNS = (("takum", "takum", None, {}),
             ("mxfp8", "mxfp8", None, {"opt_state": "t16"}),
             ("f32", "takum", "f32", {"opt_state": "bf16", "activations": "f32"}))
#: the f32-ring step (bf16 moments, f32 activations) against the
#: single-device step on the whole batch: the gradients AdamW receives, on
#: every 97th element of each leaf, max |difference| / the leaf's max |g|
#: (the two sum the same terms in another order).  The params are printed
#: beside it, not held: AdamW's first step moves a param by about lr x
#: sign(g), so a gradient within rounding of zero moves its param by up to
#: lr (3e-4) in one order and not in the other (3.02e-4 read on an H100)
DIST_F32_LIMIT = 1e-5
DIST_GRAD_STRIDE = 97
#: the mesh serve steps: llama3-8b 2 layers, takum at f32 activations, B =
#: 4 over 2 data ranks, prompt 64, 8 decode steps; max |rank rows - single
#: rows| / max |logit| (phase (e)'s limit at f32 activations)
SERVE_S0, SERVE_STEPS, SERVE_LIMIT = 64, 8, 1e-3


def digest(torch, t):
    """Three int64 sums over the 32-bit words of ``t`` (all, every third,
    every seventh from the second): equal digests, the same bits, but for a
    collision no test here can meet by chance."""
    b = t.contiguous().reshape(-1).view(torch.int32)
    return [int(b.sum(dtype=torch.int64)), int(b[::3].sum(dtype=torch.int64)),
            int(b[1::7].sum(dtype=torch.int64))]


def k_counts(counts):
    """(K2 launches, K1 launches) of a launch-count dict (any codec)."""
    return (sum(v for k, v in counts.items() if k.startswith("takum_encode_2d[")),
            sum(v for k, v in counts.items() if k.startswith("takum_decode_2d[")))


def packed_bytes(torch, fmt, shape) -> int:
    """Bytes of ``fmt``'s packed payload of an f32 tensor of ``shape``."""
    from repro_torch.core.formats import wire_format
    from repro_torch.quant import blockscale

    wf = wire_format(fmt)
    if wf.is_block_scaled:
        return math.prod(shape[:-1]) * blockscale.payload_len(shape[-1])
    return math.prod(shape) * torch.empty((), dtype=wf.storage).element_size()


def ring_payload(torch, rank, dev, salt=2700):
    g = torch.Generator(device=dev)
    g.manual_seed(salt + rank)
    return torch.randn(RING_SHAPE, generator=g, device=dev)


def _rank_setup():
    """A rank's card (shared by all ranks under gloo) and the kernel build,
    reused from the parent's build directory."""
    import torch

    from repro_torch.dist.spawn import rank_device
    from repro_torch.kernels import _build

    dev = rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library("takum_codec")
    return torch, dev, _build.last_build_seconds


def rank_ring():
    """(n1) on one rank: the compressed ring over every format, the guarded
    ladder, error feedback and hop faults.  Returns host values only."""
    torch, dev, rebuilt_s = _rank_setup()
    import torch.distributed as dist

    from repro_torch.core import telemetry
    from repro_torch.dist import collectives as C
    from repro_torch.dist import comm
    from repro_torch.dist import error_feedback as EF
    from repro_torch.dist import faults
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.quant.policy import GuardPolicy

    mesh = make_mesh((DIST_P,), ("pod",))
    g, r = mesh.group("pod"), mesh.index("pod")
    x = ring_payload(torch, r, dev)
    out = dict(rank=r, rebuild_s=rebuilt_s, rings={})
    exact = rms = absum = None
    if r == 0:  # the float64 sum of every rank's payload, drawn again here
        exact = torch.zeros(RING_SHAPE, dtype=torch.float64, device=dev)
        absum = torch.zeros(RING_SHAPE, dtype=torch.float64, device=dev)
        sq = 0.0
        for j in range(DIST_P):
            xj = ring_payload(torch, j, dev)
            exact += xj
            absum += xj.abs()
            sq += float(torch.sum(xj.double() ** 2))
        rms = math.sqrt(sq / (DIST_P * x.numel()))

    def timed(fn):
        dist.barrier(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t0) * 1e3

    for fmt in RING_FMTS:
        for el in (True, False):
            ops.reset_launch_counts()
            y, ms = timed(lambda: C.compressed_psum(x, g, fmt, exact_local=el))
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            with ops.plain_path():
                yp = C.compressed_psum(x, g, fmt, exact_local=el)
            row = dict(ms=ms, counts=counts, digest=digest(torch, y),
                       plain_same=bool(torch.equal(y.view(torch.int32), yp.view(torch.int32))))
            if r == 0:
                diff = (y.double() - exact).abs()
                row["err_over_rms"] = float(diff.max()) / rms
                if fmt == "f32":
                    eps = torch.finfo(torch.float32).eps
                    row["err_over_order_bound"] = float(
                        (diff / ((DIST_P - 1) * eps * absum).clamp(min=1e-300)).max())
                del diff
            out["rings"][f"{fmt}/{int(el)}"] = row
            del y, yp
        if fmt != "f32":
            with telemetry.capture():
                C.compressed_psum(x, g, fmt)
                out["rings"][f"{fmt}/1"]["counters"] = {
                    k: v for k, v in telemetry.counters().items() if k.startswith("wire.")}
            out["rings"][f"{fmt}/1"]["packed_bytes"] = packed_bytes(torch, fmt, x.shape)

    def degraded(xb, fmt, guard):
        """``degraded_psum`` of ``xb``: its counters, the rung taken, this
        rank's own check at each rung it tried (before the all-reduce), and
        whether the output is that rung's ``compressed_psum`` of the
        contained input."""
        local = []
        real = C.trips

        def record(spec, rel, guard_, group):
            local.append(bool((spec > guard_.max_special_frac) | (rel > guard_.max_rel_err)))
            return real(spec, rel, guard_, group)

        C.trips = record
        try:
            with telemetry.capture():
                y = C.degraded_psum(xb, g, fmt, guard)
                ctr = {k: v for k, v in telemetry.counters().items() if k.startswith("wire.")}
        finally:
            C.trips = real
        clean = torch.where(torch.isfinite(xb), xb, torch.zeros((), device=dev))
        rung = guard.ladder_from(fmt)[int(ctr["wire.rung"])]
        want = C.compressed_psum(clean, g, rung)
        return dict(counters=ctr, rung=rung, local=local,
                    equals_rung=bool(torch.equal(y.view(torch.int32), want.view(torch.int32))))

    # the guarded ladder: NaN / Inf planted in rank 1's payload, a relative
    # error bound that t8 (about 3e-2 on a normal payload) exceeds
    xb = x.clone()
    if r == 1:
        xb[0, :5] = float("nan")
        xb[7, 3] = float("inf")
    out["degraded"] = degraded(xb, "t8", GuardPolicy(max_rel_err=0.01))
    # rank 2's payload alone trips e4m3 (x 1000 overflows): every rank
    # must escalate to t16 all the same
    out["one_trips"] = degraded(x * 1000.0 if r == 2 else x, "e4m3", GuardPolicy())
    del xb

    # error feedback over t8: the outputs telescope to the exact total less
    # the final residuals
    err = EF.ef_init(x)
    acc = torch.zeros(RING_SHAPE, dtype=torch.float32, device=dev)
    total = torch.zeros(RING_SHAPE, dtype=torch.float64, device=dev) if r == 0 else None
    mag = torch.zeros(RING_SHAPE, dtype=torch.float64, device=dev) if r == 0 else None
    t0 = time.perf_counter()
    for t in range(EF_STEPS):
        gt = ring_payload(torch, r, dev, salt=3000 + 10 * t)
        red, err = EF.ef_compressed_psum(gt, err, g, "t8")
        acc += red
        if r == 0:
            for j in range(DIST_P):
                gj = ring_payload(torch, j, dev, salt=3000 + 10 * t)
                total += gj
                mag += gj.abs()
    torch.cuda.synchronize()
    ef_ms = (time.perf_counter() - t0) * 1e3 / EF_STEPS
    res = comm.all_reduce(err.double(), g)
    if r == 0:
        diff = (acc.double() - (total - res)).abs()
        eps = torch.finfo(torch.float32).eps
        bound = 2 * (EF_STEPS + DIST_P) * eps * (mag + res.abs())
        out["ef"] = dict(steps=EF_STEPS, ms_per_step=ef_ms,
                         max_err_over_bound=float((diff / bound.clamp(min=1e-30)).max()),
                         max_abs_err=float(diff.max()), max_residual=float(res.abs().max()))
    del acc, err, res, total, mag

    # hop faults under containment: what the ring contained against what
    # its arrivals decode to off the rail
    seen = []
    real = faults.corrupt_hop

    def record(msg, group=None):
        got = real(msg, group)
        seen.append(got.to(dev, copy=True))
        return got

    C.faults.corrupt_hop = record
    try:
        with faults.inject(faults.FaultConfig(seed=9, hop_drop_rate=0.25, hop_garble_rate=0.5)), \
                telemetry.capture():
            y = C.degraded_psum(x, g, "t8", GuardPolicy(contain_abs=16.0))
            ctr = {k: v for k, v in telemetry.counters().items() if k.startswith("wire.")}
    finally:
        C.faults.corrupt_hop = real
    bad = 0
    for msg in seen:
        d = ops.decode(msg, "t8")
        bad += int((~torch.isfinite(d) | (d.abs() > 16.0)).sum())
    dropped = sum(int(not bool(m.any())) for m in seen)
    out["hops"] = dict(counters=ctr, recounted=bad, arrivals=len(seen), dropped=dropped,
                       finite=bool(torch.isfinite(y).all()))
    return out


def _stage_weight(torch, ops, p, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(2800 + p)
    return ops.encode(torch.randn((PIPE_D, PIPE_D), generator=g, device=dev) * PIPE_D ** -0.5,
                      "t16")


def rank_pipeline():
    """(n2) on one rank (one stage): K3 over its own packed t16 weight, then
    tanh; f32, t16, t8 and mxt8 hops and a guarded t8 run, each against
    the composition on rank 0 with the same kernels.  The guarded run's
    last PIPE_M / 2 microbatches are scaled by PIPE_GUARD_SCALE, so its
    first ticks pass t8's check and the later ones trip it on some stages
    only."""
    torch, dev, rebuilt_s = _rank_setup()
    import torch.distributed as dist

    from repro_torch.core import telemetry
    from repro_torch.dist import pipeline as PL
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.quant import blockscale
    from repro_torch.quant.policy import GuardPolicy

    mesh = make_mesh((DIST_P,), ("pipe",))
    g, p = mesh.group("pipe"), mesh.index("pipe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2900)
    x = torch.randn((PIPE_M, PIPE_MB, PIPE_D), generator=gen, device=dev)
    ws = [_stage_weight(torch, ops, q, dev) for q in range(DIST_P)]

    def stage(w, h):
        return torch.tanh(ops.matmul(h, w, "t16"))

    def hop(h, name):
        if name is None:
            return h
        v = blockscale.pad_block(h) if name.startswith("mx") else h
        return ops.decode(ops.encode(v, name), name)[..., :h.shape[-1]]

    def composition(names, x=x):
        """Microbatch by microbatch through every stage, the hop after stage
        q at tick m + q coded as ``names[tick]``."""
        out = torch.empty_like(x)
        for m in range(PIPE_M):
            h = x[m]
            for q in range(DIST_P):
                h = stage(ws[q], h)
                if q < DIST_P - 1:
                    h = hop(h, names[m + q])
            out[m] = h
        return out

    ticks = PIPE_M + DIST_P - 1
    res = {"rebuild_s": rebuilt_s}
    for wire in PIPE_WIRES:
        dist.barrier(g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.capture():
            y = PL.pipeline_apply(stage, ws[p], x, mesh=mesh, wire_fmt=wire)
            ctr = {k: v for k, v in telemetry.counters().items() if k.startswith("pipe.")}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = dict(ms=ms, counters=ctr, digest=digest(torch, y))
        if p == 0:
            row["equals_composition"] = bool(torch.equal(
                y.view(torch.int32), composition([wire] * ticks).view(torch.int32)))
        res[str(wire)] = row
    trips, local = [], []
    real = PL.trips

    def record(spec, rel, guard_, group):
        local.append(bool((spec > guard_.max_special_frac) | (rel > guard_.max_rel_err)))
        trips.append(real(spec, rel, guard_, group))
        return trips[-1]

    PL.trips = record
    guard = GuardPolicy(max_rel_err=PIPE_GUARD_REL_ERR)
    scale = torch.ones((PIPE_M, 1, 1), device=dev)
    scale[PIPE_M // 2:] = PIPE_GUARD_SCALE
    xg = x * scale
    try:
        dist.barrier(g)
        t0 = time.perf_counter()
        y = PL.pipeline_apply(stage, ws[p], xg, mesh=mesh, wire_fmt="t8", guard=guard)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        PL.trips = real
    esc = guard.ladder_from("t8")[1]
    row = dict(ms=ms, trips=trips, local=local, digest=digest(torch, y))
    if p == 0:
        row["equals_composition"] = bool(torch.equal(y.view(torch.int32), composition(
            [esc if t else "t8" for t in trips], xg).view(torch.int32)))
    res["guarded"] = row
    return res


def dist_train_cfg(policy, grad_comm=None, layers=None, **quant):
    import dataclasses

    from repro_torch import configs
    from repro_torch.quant.policy import POLICIES

    q = POLICIES[policy]
    q = dataclasses.replace(q, **({"grad_comm": grad_comm} if grad_comm else {}), **quant)
    return configs.get("llama3_8b").with_(num_layers=layers or DIST_LAYERS, quant=q)


def dist_batch(torch, cfg):
    from repro_torch.data import SyntheticLM

    return SyntheticLM(cfg.vocab_size, DIST_S, DIST_B, seed=17).batch(0)


def rank_pod_train(policy, grad_comm=None, steps=DIST_STEPS, compare_single=False, **quant):
    """(n3) on one rank of the 2x1x1 mesh: ``steps`` pod steps on one batch
    from the seeded init; per step the CE, the ms, a digest of every param
    leaf and (step 2) the kernel launches; the peak memory.  With
    ``compare_single`` rank 0 then runs the single-device step on the whole
    batch from the same init and returns the largest param difference."""
    torch, dev, rebuilt_s = _rank_setup()
    import gc

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import init_state, make_train_step

    from repro_torch.train import step as single_step

    cfg = dist_train_cfg(policy, grad_comm, **quant)
    mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
    seen = []  # with compare_single: every 97th gradient element AdamW receives, a step
    real_update = single_step.adamw_update

    def sampled(grads, *a, **k):
        if compare_single:
            seen.append([g.reshape(-1)[::DIST_GRAD_STRIDE].clone()
                         for g in tree.flatten(grads)[0]])
        return real_update(grads, *a, **k)

    single_step.adamw_update = sampled
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st = init_state(cfg, 0, device=dev)
    batch = dist_batch(torch, cfg)
    step = dstep.make_train_step(cfg, mesh)
    ce, ms, digests, counts = [], [], [], None
    for i in range(steps):
        if i == 1:
            ops.reset_launch_counts()
        dist.barrier(mesh.group("pod"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            counts = {k: v for k, v in ops.launch_counts().items() if v}
        ce.append(float(m["ce"]))
        digests.append([digest(torch, p) for p in tree.flatten(st.params)[0]])
    out = dict(rebuild_s=rebuilt_s, policy=policy, grad_comm=cfg.quant.grad_comm,
               layers=DIST_LAYERS, ce=ce,
               step_ms=ms, digests=digests, step_launches=counts,
               grad_ok=float(m["grad_ok"]), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               free_total_gb=[v / 1e9 for v in torch.cuda.mem_get_info()],
               params=sum(p.numel() for p in tree.flatten(st.params)[0]))
    if compare_single:
        pod = tree.flatten(st.params)[0]
        del st, m
        gc.collect()
        torch.cuda.empty_cache()
        if dist.get_rank() == 0:  # seen: the pod step's sample, then the single step's
            s1, _ = make_train_step(cfg)(init_state(cfg, 0, device=dev), batch)
            out["single_max_abs_diff"] = max(float((a - b).abs().max())
                                             for a, b in zip(pod, tree.flatten(s1.params)[0]))
            out["grad_max_rel_diff"] = max(
                float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(seen[0], seen[1]))
            del s1
        dist.barrier(mesh.group("pod"))
    single_step.adamw_update = real_update
    return out


def serve_cfg():
    return dist_train_cfg("takum", layers=SERVE_LAYERS, activations="f32")


def rank_serve():
    """(n4) on one data rank: the mesh prefill and decode steps over its two
    rows (teacher-forced tokens), the packed tree built from the seed."""
    torch, dev, rebuilt_s = _rank_setup()
    from repro_torch.dist import step as dstep
    from repro_torch.launch.mesh import make_mesh

    cfg = serve_cfg()
    mesh = make_mesh((2, 1), ("data", "model"))
    qp = serve_tree(torch, cfg, dev)
    prompt, toks = serve_tokens(torch, cfg, dev)
    t0 = time.perf_counter()
    logits, cache = dstep.make_prefill_step(cfg, mesh, SERVE_S0 + SERVE_STEPS)(
        qp, {"tokens": prompt})
    out = [logits]
    decode = dstep.make_serve_step(cfg, mesh)
    for s in range(SERVE_STEPS):
        logits, cache = decode(qp, {"token": toks[s]}, cache)
        out.append(logits)
    torch.cuda.synchronize()
    return dict(logits=torch.stack(out), rows=dstep.local_rows(mesh, DIST_B),
                ms=(time.perf_counter() - t0) * 1e3, rebuild_s=rebuilt_s)


def serve_tree(torch, cfg, dev):
    from repro_torch import serve
    from repro_torch.models import transformer as T

    return serve.load_params(serve.quantize_params(cfg, T.init_params(cfg, 0, device=dev)))


def serve_tokens(torch, cfg, dev):
    """The prompt and the teacher-forced decode tokens, on ``dev``."""
    g = torch.Generator()
    g.manual_seed(31)
    prompt = torch.randint(0, cfg.vocab_size, (DIST_B, SERVE_S0), generator=g)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_STEPS, DIST_B), generator=g)
    return prompt.to(dev), toks.to(dev)


def dist_codec_rows(torch, dev, rows):
    """K2 and K1 as the ring launches them, at its payload (one row of the
    flat [4096 x 14336] wi gradient) for every compressed format with its
    default codec, and at the train step's flat chunk (2^26 elements: K1
    t16, K2-mx / K1-mx mxe5m2): bit for bit against the plain versions,
    timed beside the byte bound and the library call."""
    from repro_torch.dist.collectives import RING_CHUNK
    from repro_torch.kernels.lut import resolve_impl
    from repro_torch.kernels.takum_codec import (decode_2d_plain, encode_2d_plain,
                                                 takum_decode_2d, takum_encode_2d)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2600)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(fmt, math.prod(RING_SHAPE), ("encode", "decode")) for fmt in RING_FMTS[1:]]
    cases += [("t16", RING_CHUNK, ("decode",)), ("mxe5m2", RING_CHUNK, ("encode", "decode"))]
    for fmt, n, ops_ in cases:
        xf = torch.randn((1, n), generator=gen, device=dev)
        bits = encode_2d_plain(xf, fmt)
        pb = bits.numel() * bits.element_size()
        for op in ops_:
            impl = resolve_impl(None, fmt, op) if op == "encode" else resolve_impl(None, fmt)
            if op == "encode":
                got = takum_encode_2d(xf, fmt, impl)
                check(torch.equal(got.view(torch.uint8), bits.view(torch.uint8)),
                      f"(n) K2 {fmt} [1, {n}]: differs from its plain version")
                lib = library_encode(torch, fmt, xf, bits)
                rows.append(codec_row(torch, "takum_encode_2d", fmt, impl, [1, n], 0.0,
                                      n * 4 + pb, lambda: takum_encode_2d(xf, fmt, impl),
                                      lambda: encode_2d_plain(xf, fmt, impl), lib, flush))
            else:
                got = takum_decode_2d(bits, fmt, impl)
                check(same_bits_f32(torch, got, decode_2d_plain(bits, fmt, impl)),
                      f"(n) K1 {fmt} [1, {n}]: differs from its plain version")
                lib = library_decode(torch, fmt, bits, got)
                rows.append(codec_row(torch, "takum_decode_2d", fmt, impl, list(bits.shape), 0.0,
                                      n * 4 + pb, lambda: takum_decode_2d(bits, fmt, impl),
                                      lambda: decode_2d_plain(bits, fmt, impl), lib, flush))
            del got
        del xf, bits
    del flush
    torch.cuda.empty_cache()


def phase_dist(torch, dev, card, rows):
    """(n) dist on the card: ranks are processes sharing it, gloo moving
    host-staged payloads.  (n0) K1 / K2 at the ring's and the train step's
    payloads; (n1) the ring, the ladder, EF and hop faults on 4 ranks; (n2)
    the pipeline on 4 stage ranks; (n3) the pod train step on 2 ranks at
    full width; (n4) the mesh serve steps on 2 data ranks."""
    import gc

    from repro_torch.dist.spawn import RankPool

    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    dist_codec_rows(torch, dev, rows)
    log(f"(n0) K1 / K2 at the ring's payload [1, {math.prod(RING_SHAPE)}] and the train "
        f"step's chunk bit for bit, timed ({time.perf_counter() - t0:.1f} s)")

    # (n4)'s single-rank reference, before any rank holds the card
    cfg = serve_cfg()
    qp = serve_tree(torch, cfg, dev)
    prompt, toks = serve_tokens(torch, cfg, dev)
    from repro_torch import serve

    logits, cache = serve.make_prefill_step(cfg, SERVE_S0 + SERVE_STEPS)(qp, {"tokens": prompt})
    single = [logits]
    for s in range(SERVE_STEPS):
        logits, cache = serve.make_serve_step(cfg)(qp, {"token": toks[s]}, cache)
        single.append(logits)
    single = torch.stack(single).float().cpu()
    del qp, cache, logits
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with RankPool(DIST_P, timeout_s=300, threads=2) as pool:
        ring = pool.run(rank_ring, timeout_s=600)
        out["spawn_and_ring_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        pipe = pool.run(rank_pipeline, timeout_s=300)
        out["pipeline_s"] = time.perf_counter() - t1
    raw = ROOT / "chiprun_out" / "chip_smoke_dist_raw.json"
    raw.parent.mkdir(exist_ok=True)
    raw.write_text(json.dumps(dict(ring=ring, pipeline=pipe), indent=1, default=str))
    n1 = check_ring(ring, card)
    n2 = check_pipeline(pipe, card)
    out.update(ring=n1, pipeline=n2)
    log(f"(n1, n2) done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with RankPool(2, timeout_s=600, threads=2,
                  env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}) as pool:
        train = {}
        for name, policy, grad_comm, kw in DIST_RUNS:
            t1 = time.perf_counter()
            got = pool.run(rank_pod_train, policy, grad_comm, 1 if name == "f32" else DIST_STEPS,
                           name == "f32", timeout_s=900, **kw)
            train[name] = check_pod_train(name, got, card)
            train[name]["seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        served = pool.run(rank_serve, timeout_s=300)
        n4 = check_serve(served, single, card)
        n4["seconds"] = time.perf_counter() - t1
    out.update(train=train, serve=n4)
    log(f"(n3, n4) done in {time.perf_counter() - t0:.1f} s")
    out["seconds"] = time.perf_counter() - t_all
    log(f"(n) dist on the card done in {out['seconds']:.1f} s; card: {card}")
    return out


def dist_summary(dist):
    """(kernel, format, codec, shape, path, launches) of phase (n)'s K2 / K1
    summary rows: each compressed ring format at the ring's payload, and the
    pod train step's chunk under takum (K1 t16) and mxfp8 (K2-mx / K1-mx
    mxe5m2)."""
    from repro_torch.dist.collectives import RING_CHUNK
    from repro_torch.quant import blockscale

    n = math.prod(RING_SHAPE)
    out = []
    for fmt, counts in dist["ring"]["launch_keys"].items():
        enc, dec = dist["ring"]["impl"][fmt]
        bits_shape = [1, n // 32 * 33] if fmt.startswith("mx") else [1, n]
        out.append(("takum_encode_2d", fmt, enc, [1, n], f"dist/ring/{fmt}",
                    counts.get(f"takum_encode_2d[{enc}]", 0)))
        out.append(("takum_decode_2d", fmt, dec, bits_shape, f"dist/ring/{fmt}",
                    counts.get(f"takum_decode_2d[{dec}]", 0)))
    takum = dist["train"]["takum"]["step_launches"]
    out.append(("takum_decode_2d", "t16", "bits", [1, RING_CHUNK], "dist/train/takum",
                takum.get("takum_decode_2d[bits]", 0)))
    mx = dist["train"]["mxfp8"]["step_launches"]
    enc, dec = dist["ring"]["impl"].get("mxe5m2") or _impls("mxe5m2")
    out.append(("takum_encode_2d", "mxe5m2", enc, [1, RING_CHUNK], "dist/train/mxfp8",
                mx.get(f"takum_encode_2d[{enc}]", 0)))
    out.append(("takum_decode_2d", "mxe5m2", dec, [1, blockscale.payload_len(RING_CHUNK)],
                "dist/train/mxfp8", mx.get(f"takum_decode_2d[{dec}]", 0)))
    return out


def _impls(fmt):
    from repro_torch.kernels.lut import resolve_impl

    return resolve_impl(None, fmt, "encode"), resolve_impl(None, fmt)


def check_ring(ring, card):
    """(n1)'s checks over the ranks' results; returns the summary."""
    from repro_torch.kernels.lut import resolve_impl

    P = DIST_P
    check(all(r["rebuild_s"] == 0.0 for r in ring), "(n1) a rank rebuilt the kernels")
    rows = {}
    for key in ring[0]["rings"]:
        fmt, el = key.split("/")
        el = el == "1"
        got = [r["rings"][key] for r in ring]
        check(all(g["plain_same"] for g in got),
              f"(n1) {key}: the kernel ring differs from the ring under ops.plain_path()")
        if fmt == "f32" or not el:
            check(all(g["digest"] == got[0]["digest"] for g in got),
                  f"(n1) {key}: the ranks' sums differ")
        err = got[0]["err_over_rms"]
        k2, k1 = zip(*(k_counts(g["counts"]) for g in got))
        want = (0, 0) if fmt == "f32" else (1, P - 1 + (0 if el else 1))
        log(f"(n1) ring {fmt} exact_local={el}: max err / rms {err:.3g} (limit "
            f"{RING_LIMITS[fmt]}" + (f"; / the order bound {got[0]['err_over_order_bound']:.3g}, "
                                      f"limit 1" if fmt == "f32" else "")
            + f"), K2 / K1 a rank {list(zip(k2, k1))}, host-staged ms a ring (rank 0..{P - 1}) "
            f"{[round(g['ms'], 2) for g in got]}; card: {card}")
        if fmt == "f32":
            check(got[0]["err_over_order_bound"] <= 1.0,
                  f"(n1) {key}: err {got[0]['err_over_order_bound']:.3g} of the order bound")
        else:
            check(err < RING_LIMITS[fmt],
                  f"(n1) {key}: max err / rms {err:.3g} >= {RING_LIMITS[fmt]}")
        check(all((a, b) == want for a, b in zip(k2, k1)),
              f"(n1) {key}: K2 / K1 launches a rank {list(zip(k2, k1))}, want {want}")
        row = dict(err_over_rms=err, ms=[g["ms"] for g in got], k2_k1=want,
                   counts=got[0]["counts"],
                   err_over_order_bound=got[0].get("err_over_order_bound"))
        if "counters" in got[0]:
            c = got[0]["counters"]
            hop = c.get("wire.hop_bytes")
            check(hop == got[0]["packed_bytes"] * (P - 1),
                  f"(n1) {key}: wire.hop_bytes {hop}, want {got[0]['packed_bytes']} x {P - 1}")
            row.update(hop_bytes=hop, packed_bytes=got[0]["packed_bytes"])
        rows[key] = row
    deg = [r["degraded"] for r in ring]
    check(len({d["rung"] for d in deg}) == 1 and all(d["equals_rung"] for d in deg),
          f"(n1) degraded_psum: rungs {[d['rung'] for d in deg]}, equal to the rung's ring "
          f"{[d['equals_rung'] for d in deg]}")
    check(deg[0]["rung"] == "t16", f"(n1) degraded_psum took {deg[0]['rung']}, want t16")
    check([d["counters"]["wire.specials_in"] for d in deg] == [0.0, 6.0, 0.0, 0.0],
          f"(n1) wire.specials_in {[d['counters']['wire.specials_in'] for d in deg]}")
    one = [r["one_trips"] for r in ring]
    check([d["local"][0] for d in one] == [q == 2 for q in range(P)],
          f"(n1) one rank trips e4m3: the ranks' own checks {[d['local'] for d in one]}")
    check(all(d["rung"] == "t16" and d["equals_rung"] for d in one),
          f"(n1) one rank trips e4m3: rungs {[d['rung'] for d in one]}, equal to the rung's "
          f"ring {[d['equals_rung'] for d in one]}")
    ef = ring[0]["ef"]
    check(ef["max_err_over_bound"] <= 1.0,
          f"(n1) EF: sum of outputs vs total - residuals {ef['max_err_over_bound']:.3g} of bound")
    hops = [r["hops"] for r in ring]
    for h in hops:
        check(h["counters"]["wire.contained"] == h["recounted"] and h["finite"],
              f"(n1) hop faults: wire.contained {h['counters']['wire.contained']}, recounted "
              f"{h['recounted']}, finite {h['finite']}")
    contained = [h["recounted"] for h in hops]
    check(sum(contained) > 0, "(n1) hop faults: nothing was contained")
    log(f"(n1) degraded_psum: t8 tripped, every rank took t16 and equals its ring; e4m3 "
        f"tripped on rank 2 alone (own checks {[d['local'] for d in one]}), every rank took t16 "
        f"and equals its ring; EF {EF_STEPS} "
        f"t8 steps telescope (max err {ef['max_abs_err']:.3g}, {ef['max_err_over_bound']:.3g} "
        f"of the f32 bound, {ef['ms_per_step']:.1f} ms a step host-staged); hop faults: "
        f"contained {contained} = recounted, dropped {[h['dropped'] for h in hops]} of "
        f"{hops[0]['arrivals']} arrivals; card: {card}")
    return dict(rings=rows, degraded=deg[0], one_trips=[d["local"] for d in one], ef=ef, hops=hops,
                launch_keys={fmt: rows[f"{fmt}/0"]["counts"] for fmt in RING_FMTS[1:]},
                impl={fmt: (resolve_impl(None, fmt, "encode"), resolve_impl(None, fmt))
                      for fmt in RING_FMTS[1:]})


def check_pipeline(pipe, card):
    ticks = PIPE_M + DIST_P - 1
    check(all(p["rebuild_s"] == 0.0 for p in pipe), "(n2) a rank rebuilt the kernels")
    out = {}
    for key in [str(w) for w in PIPE_WIRES] + ["guarded"]:
        got = [p[key] for p in pipe]
        check(all(g["digest"] == got[0]["digest"] for g in got),
              f"(n2) {key}: the stages' outputs differ")
        check(got[0]["equals_composition"], f"(n2) {key}: differs from the composition")
        if key == "guarded":
            trips = got[0]["trips"]
            check(all(g["trips"] == trips for g in got) and len(trips) == ticks,
                  f"(n2) guarded: the ticks' decisions differ {[g['trips'] for g in got]}")
            own = list(zip(*(g["local"] for g in got)))  # per tick, each stage's own check
            check(all(t == any(o) for t, o in zip(trips, own)),
                  f"(n2) guarded: a tick's decision is not its stages' checks OR'd {own}")
            check(0 < sum(trips) < ticks and any(any(o) and not all(o) for o in own),
                  f"(n2) guarded: want some ticks tripped, some not, and a tick whose stages "
                  f"disagree: {own}")
        else:
            check(all(g["counters"].get("pipe.ticks") == ticks for g in got),
                  f"(n2) {key}: pipe.ticks {[g['counters'] for g in got]}")
        out[key] = dict(ms=[g["ms"] for g in got], trips=got[0].get("trips"),
                        counters=got[0].get("counters"))
        log(f"(n2) pipeline hops {key}: bit for bit the composition, stages agree"
            + (f", escalations {sum(got[0]['trips'])} of {ticks} ticks, uniform; the stages' own "
               f"checks a tick {[''.join('x' if v else '.' for v in o) for o in own]}"
               if key == "guarded" else "")
            + f"; host-staged ms {[round(g['ms'], 1) for g in got]}; card: {card}")
    return out


def check_pod_train(name, got, card):
    a, b = got
    check(a["rebuild_s"] == b["rebuild_s"] == 0.0, f"(n3) {name}: a rank rebuilt the kernels")
    check(all(d == e for d, e in zip(a["digests"], b["digests"])),
          f"(n3) {name}: the ranks' params differ")
    if name != "f32":
        check(a["ce"][-1] < a["ce"][0], f"(n3) {name}: CE did not fall: {a['ce']}")
    check(a["grad_ok"] == 1.0, f"(n3) {name}: non-finite gradients")
    out = dict(ce=a["ce"], step_ms=[a["step_ms"], b["step_ms"]],
               peak_gb=[a["peak_gb"], b["peak_gb"]],
               free_total_gb=a["free_total_gb"], step_launches=a["step_launches"],
               grad_comm=a["grad_comm"], layers=a["layers"], params=a["params"])
    if name == "f32":
        d = a["grad_max_rel_diff"]
        check(d <= DIST_F32_LIMIT, f"(n3) f32 ring vs the single-device step: gradients {d:.3g}")
        out.update(grad_max_rel_diff=d, single_max_abs_diff=a["single_max_abs_diff"])
    log(f"(n3) pod step {name} (grad_comm {a['grad_comm']}), llama3-8b {a['layers']} layers "
        f"({a['params'] / 1e9:.3f}B params), mesh 2x1x1, B={DIST_B} S={DIST_S}: CE "
        f"{[round(c, 4) for c in a['ce']]}, ranks bit-identical after every step, step ms "
        f"{[round(m, 1) for m in a['step_ms']]} (host-staged ring), peak "
        f"{a['peak_gb']:.2f} / {b['peak_gb']:.2f} GB, mem_get_info (free, total) "
        f"{[round(v, 2) for v in a['free_total_gb']]} GB, launches a step {a['step_launches']}"
        + (f", against the single-device step on the whole batch: gradients max |diff| / "
           f"max |g| {out['grad_max_rel_diff']:.3g} (limit {DIST_F32_LIMIT}), params max |diff| "
           f"{out['single_max_abs_diff']:.3g} (AdamW's first step: up to lr x sign(g))"
           if name == "f32" else "") + f"; card: {card}")
    return out


def check_serve(served, single, card):
    check(all(r["rebuild_s"] == 0.0 for r in served), "(n4) a rank rebuilt the kernels")
    worst = 0.0
    for r in served:
        rows = r["rows"]
        want = single[:, rows].numpy()
        err = float(abs(r["logits"] - want).max() / abs(want).max())
        worst = max(worst, err)
    check(worst <= SERVE_LIMIT, f"(n4) the ranks' rows differ from the single run's: {worst:.3g}")
    check([r["rows"] for r in served] == [slice(0, 2), slice(2, 4)], "(n4) rows")
    log(f"(n4) llama3-8b {SERVE_LAYERS} layers takum (f32 activations), 2 data ranks x 2 rows, "
        f"prefill {SERVE_S0} + {SERVE_STEPS} decode steps: max |rows - single| / max |logit| "
        f"{worst:.3g} (limit {SERVE_LIMIT}); ms {[round(r['ms'], 1) for r in served]}; "
        f"card: {card}")
    return dict(max_err=worst, ms=[r["ms"] for r in served])


KERNEL_INFO = {
    "takum_decode_2d": ("K1", "src/repro_torch/kernels/csrc/takum_codec.cu",
                        "src/repro/kernels/takum_codec.py:51"),
    "takum_encode_2d": ("K2", "src/repro_torch/kernels/csrc/takum_codec.cu",
                        "src/repro/kernels/takum_codec.py:61"),
    "takum_encode_into": ("K2", "src/repro_torch/kernels/csrc/takum_codec.cu",
                          "src/repro/kernels/takum_codec.py:61"),
    "takum_decode_rows": ("K1", "src/repro_torch/kernels/csrc/takum_codec.cu",
                          "src/repro/kernels/takum_codec.py:51"),
    "takum_matmul": ("K3", "src/repro_torch/kernels/csrc/takum_matmul.cu",
                     "src/repro/kernels/takum_matmul.py:56"),
    "takum_decode_attention": ("K6", "src/repro_torch/kernels/csrc/takum_attention.cu",
                               "src/repro/kernels/takum_attention.py:56"),
    "takum_dual_matmul": ("K4", "src/repro_torch/kernels/csrc/takum_dual_matmul.cu",
                          "src/repro/kernels/takum_matmul.py:56"),
    "takum_matmul_ad": ("K5", "src/repro_torch/kernels/csrc/takum_matmul_wt.cu",
                        "src/repro/kernels/takum_matmul.py:190"),
    # the tied head: K3's loop reading the stored table transposed (K5's
    # backward launch as a forward op)
    "takum_matmul_t": ("K3^T", "src/repro_torch/kernels/csrc/takum_matmul_wt.cu",
                       "src/repro/kernels/takum_matmul.py:56"),
}
#: the launch counter of a summary row's kernel, where it is not its own
LAUNCH_KEY = {"takum_matmul_t": "takum_matmul[{impl}^T]"}

#: the header that holds each loop of K3, K4 and the transposed K3: a row
#: with a loop names it as its source, and its C entry's .cu as "entry"
LOOP_SOURCE = {
    "matvec": "src/repro_torch/kernels/csrc/matvec_splitk.cuh",
    "fma": "src/repro_torch/kernels/csrc/matmul_tile.cuh",
    "mma": "src/repro_torch/kernels/csrc/matmul_mma.cuh",
    "mma_split": "src/repro_torch/kernels/csrc/matmul_mma.cuh",
    "mma_f32": "src/repro_torch/kernels/csrc/matmul_wgmma.cuh",
}

#: (kernel, format, codec, shape, path[, x dtype]) rows that stand for each
#: kernel in the summary line: the shapes, formats and codecs each counted
#: path gives each kernel.  Paths: "takum", "takum8" and "mxfp8" are phase
#: (d)'s full-depth runs (the KV append through ``takum_encode_into``, the
#: embedding rows through ``takum_decode_rows``), "<policy>/pack" the
#: packing and loading of their trees (K2 per packed weight through
#: ``takum_encode_2d``, K1 over the norm gains through ``takum_decode_2d``);
#: "mxt8" (mxt8 weights and KV cache) and "bf16" (bf16 weights and KV cache,
#: the path that runs K2 and K6 with the bits codec) the 2-layer kernel
#: paths of phase (e) at the policy's own bf16 activations, "mxt8/f32" the
#: same at f32 activations (M = 256 there), "mxt8/pack" its packing; "ad"
#: phase (g)'s K5 path.  x is bf16 unless named.  The codec of each row is
#: its format's default.
SUMMARY = [
    ("takum_decode_rows", "t16", "bits", [4, 128256, 4096], "takum"),
    ("takum_encode_into", "t8", "lut", [2, 32, 128], "takum"),
    ("takum_encode_2d", "t16", "lut", [4096, 14336], "takum/pack"),
    ("takum_decode_2d", "t16", "bits", [1024, 4096], "takum/pack"),
    ("takum_matmul", "t16", "bits", [4, 4096, 4096], "takum"),
    ("takum_matmul", "t16", "bits", [4, 4096, 1024], "takum"),
    ("takum_matmul", "t16", "bits", [4, 4096, 14336], "takum"),
    ("takum_matmul", "t16", "bits", [4, 14336, 4096], "takum"),
    ("takum_matmul", "t16", "bits", [1024, 4096, 14336], "takum"),
    ("takum_matmul", "t16", "bits", [4, 4096, 128256], "takum"),
    ("takum_decode_attention", "t8", "lut", [4, 32, 8, 288, 128], "takum"),
    ("takum_decode_rows", "t8", "lut", [4, 128256, 4096], "takum8"),
    ("takum_encode_into", "t8", "lut", [2, 32, 128], "takum8"),
    ("takum_encode_2d", "t8", "lut", [4096, 14336], "takum8/pack"),
    ("takum_decode_2d", "t8", "lut", [1024, 4096], "takum8/pack"),
    ("takum_matmul", "t8", "lut", [4, 4096, 4096], "takum8"),
    ("takum_matmul", "t8", "lut", [4, 4096, 1024], "takum8"),
    ("takum_matmul", "t8", "lut", [4, 4096, 14336], "takum8"),
    ("takum_matmul", "t8", "lut", [4, 14336, 4096], "takum8"),
    ("takum_matmul", "t8", "lut", [1024, 4096, 14336], "takum8"),
    ("takum_matmul", "t8", "lut", [4, 4096, 128256], "takum8"),
    ("takum_decode_attention", "t8", "lut", [4, 32, 8, 288, 128], "takum8"),
    ("takum_encode_into", "mxe4m3", "bits", [2, 32, 128], "mxfp8"),
    ("takum_decode_attention", "mxe4m3", "lut", [4, 32, 8, 288, 128], "mxfp8"),
    ("takum_decode_rows", "mxt8", "lut", [4, 128256, 4096], "mxt8"),
    ("takum_decode_2d", "mxt8", "lut", [1024, 4096], "mxt8"),
    ("takum_encode_into", "mxt8", "lut", [2, 32, 128], "mxt8"),
    ("takum_encode_2d", "mxt8", "lut", [4096, 14336], "mxt8/pack"),
    ("takum_matmul", "mxt8", "lut", [4, 4096, 14336], "mxt8"),
    ("takum_matmul", "mxt8", "lut", [1024, 4096, 14336], "mxt8"),
    ("takum_matmul", "mxt8", "lut", [4, 4096, 128256], "mxt8"),
    ("takum_decode_attention", "mxt8", "lut", [4, 32, 8, 288, 128], "mxt8"),
    ("takum_encode_into", "bf16", "bits", [2, 32, 128], "bf16"),
    ("takum_decode_attention", "bf16", "bits", [4, 32, 8, 288, 128], "bf16"),
    # K3 with f32 x on the wgmma tile: the forward of K5's wi rows (phase
    # (g)'s autograd path) and mxt8's f32-activation path of phase (e)
    ("takum_matmul", "t8", "lut", [1024, 4096, 14336], "ad", "float32"),
    ("takum_matmul", "t16", "bits", [1024, 4096, 14336], "ad", "float32"),
    ("takum_matmul", "mxt8", "lut", [1024, 4096, 14336], "mxt8/f32", "float32"),
    # training (phase (h3)): K1 decodes each quantised moment every step, K2
    # packs the zero moments at init (the SR refresh is plain PyTorch); the
    # row is phase (c)'s at one layer's wi leaf
    ("takum_decode_2d", "t16", "bits", [4096, 14336], "train/takum"),
    ("takum_decode_2d", "t8", "lut", [4096, 14336], "train/takum8"),
    ("takum_encode_2d", "t16", "lut", [4096, 14336], "train/takum/init"),
    ("takum_encode_2d", "t8", "lut", [4096, 14336], "train/takum8/init"),
    # phase (i): the tied head (the transposed K3 over the packed table, x
    # f32 at M = 4; K1-mx over an mxt8 table), K6 at gemma2's and granite's
    # decode shapes; the rows are phase (c)'s
    ("takum_matmul_t", "t16", "bits", [4, 2304, 256000], "gemma2_2b/takum", "float32"),
    ("takum_matmul_t", "t8", "lut", [4, 2304, 256000], "gemma2_2b/takum8", "float32"),
    ("takum_matmul_t", "t16", "bits", [4, 3072, 128256], "llama3_2_3b/takum", "float32"),
    ("takum_decode_2d", "mxt8", "lut", [256000, 2304], "gemma2_2b/mxt8"),
    ("takum_decode_attention", "t8", "lut", [4, 8, 4, 4194, 256], "gemma2_2b/takum"),
    ("takum_decode_attention", "t8", "lut", [4, 48, 1, 290, 128], "granite_34b/takum8"),
    # phase (j): the MoE family's new K3 shapes (the experts' wi at M = 4,
    # the decode step's matvec, and at M = 320, dbrx's prefill tile; the
    # routers, f32 x, at N = 16 and 384) and K6 at dbrx's g = 6, each with
    # the launches of the (j1) serving run that gives it that shape (the
    # kimi routers' M = 1024 row: the f32-activation path of (j2))
    ("takum_matmul", "t8", "lut", [4, 6144, 10752], "dbrx_132b/takum8"),
    ("takum_matmul", "t16", "bits", [4, 6144, 10752], "dbrx_132b/takum"),
    ("takum_matmul", "t8", "lut", [4, 7168, 2048], "kimi_k2_1t_a32b/takum8"),
    ("takum_matmul", "t8", "lut", [320, 6144, 10752], "dbrx_132b/takum8"),
    ("takum_matmul", "t16", "bits", [320, 6144, 10752], "dbrx_132b/takum"),
    ("takum_matmul", "t8", "lut", [4, 6144, 16], "dbrx_132b/takum8", "float32"),
    ("takum_matmul", "t8", "lut", [1024, 6144, 16], "dbrx_132b/takum8", "float32"),
    ("takum_matmul", "t8", "lut", [4, 7168, 384], "kimi_k2_1t_a32b/takum8", "float32"),
    ("takum_matmul", "t8", "lut", [1024, 7168, 384], "kimi_k2_1t_a32b/takum8", "float32"),
    ("takum_decode_attention", "t8", "lut", [4, 48, 8, 290, 128], "dbrx_132b/takum8"),
    # phase (k): the SSM archs' new shapes, each with the launches of the
    # (k1) serving run that gives it that shape: the mixers' in_proj at
    # M = 4 (hymba's odd N), hymba's head, mamba2's out_proj on the f32 y
    # (its prefill's M = 16384 takes the same wgmma tile as the row's
    # M = 1024), mamba2's tied head, K6 at hymba's window
    ("takum_matmul", "t16", "bits", [4, 1536, 6448], "mamba2_780m/takum"),
    ("takum_matmul", "t8", "lut", [4, 1536, 6448], "mamba2_780m/takum8"),
    ("takum_matmul", "t16", "bits", [4, 1600, 3257], "hymba_1_5b/takum"),
    ("takum_matmul", "t8", "lut", [4, 1600, 3257], "hymba_1_5b/takum8"),
    ("takum_matmul", "t16", "bits", [4, 1600, 32001], "hymba_1_5b/takum"),
    ("takum_matmul", "t8", "lut", [4, 1600, 32001], "hymba_1_5b/takum8"),
    ("takum_matmul", "t16", "bits", [1024, 3072, 1536], "mamba2_780m/takum", "float32"),
    ("takum_matmul", "t8", "lut", [1024, 3072, 1536], "mamba2_780m/takum8", "float32"),
    ("takum_matmul_t", "t16", "bits", [4, 1536, 50280], "mamba2_780m/takum", "float32"),
    ("takum_matmul_t", "t8", "lut", [4, 1536, 50280], "mamba2_780m/takum8", "float32"),
    ("takum_decode_attention", "t8", "lut", [4, 25, 5, 2080, 64], "hymba_1_5b/takum"),
    # phase (l): the vlm's media shapes (K3 at M = 16384 over media_proj and a
    # cross layer's wk, in every call of its (l1) serving runs) and K6 at its
    # g = 8; the f32 KV cache's append and K6 on the (l3) paths
    ("takum_matmul", "t8", "lut", [16384, 1408, 8192], "llama3_2_vision_90b/takum8"),
    ("takum_matmul", "t16", "bits", [16384, 1408, 8192], "llama3_2_vision_90b/takum"),
    ("takum_matmul", "t8", "lut", [16384, 8192, 1024], "llama3_2_vision_90b/takum8"),
    ("takum_matmul", "t16", "bits", [16384, 8192, 1024], "llama3_2_vision_90b/takum"),
    ("takum_decode_attention", "t8", "lut", [4, 64, 8, 290, 128], "llama3_2_vision_90b/takum8"),
    ("takum_encode_into", "f32", "bits", [2, 32, 128], "f32cache/llama3_8b"),
    ("takum_encode_into", "f32", "bits", [2, 8192, 128], "f32cache/llama3_2_vision_90b"),
    ("takum_decode_attention", "f32", "bits", [4, 32, 8, 288, 128], "f32cache/llama3_8b"),
    ("takum_decode_attention", "f32", "bits", [4, 64, 8, 288, 128],
     "f32cache/llama3_2_vision_90b"),
]


def k3_decode_step(rows):
    """The K3 time of one llama3-8b decode step under the weights of takum
    (t16, bits) and takum8 (t8, lut): launches x time of phase (c)'s M = 4
    rows, summed over ``DECODE_LINEARS``, for each timing the rows carry."""
    out = {}
    for fmt, impl in (("t16", "bits"), ("t8", "lut")):
        tot = dict.fromkeys(("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms"), 0.0)
        for (K, N), n in DECODE_LINEARS.items():
            row = next(r for r in rows if r["kernel"] == "takum_matmul"
                       and (r["fmt"], r["impl"], r["shape"]) == (fmt, impl, [4, K, N]))
            for key, val in tot.items():
                tot[key] = None if val is None or row.get(key) is None else val + n * row[key]
        out[f"{fmt}[{impl}]"] = tot
    return out


def kernel_census(build_mod):
    """Per source: the wall time of its nvcc in this run's build, and its
    count of kernel instantiations with their registers, stack and shared
    memory (``cuobjdump -res-usage`` of the library; None where the
    toolkit has no cuobjdump)."""
    import os
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in sorted(build_mod.build_dir().glob("lib*.so")):
        src = lib.stem[3:] + ".cu"
        info = dict(nvcc_s=round(build_mod.last_build_by_source.get(src, 0.0), 1), kernels=None)
        if os.path.exists(cuobjdump):
            res = subprocess.run([cuobjdump, "-res-usage", str(lib)], capture_output=True,
                                 text=True, timeout=120)
            lines = res.stdout.splitlines()
            usage = [(a.strip(), b.strip()) for a, b in zip(lines, lines[1:])
                     if a.strip().startswith("Function ") and "REG:" in b]
            kernels = [u for u in usage if "kernel" in u[0]]
            info.update(kernels=len(kernels), res_usage=usage)
        out[src] = info
    return out


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
    build = kernel_census(_build)
    log(f"(b) kernels built in {build_s:.1f} s into {_build.build_dir()}")
    for src, info in build.items():
        log(f"(b) {src}: nvcc {info['nvcc_s']} s, {info['kernels']} kernel instantiations")

    rows = []
    t0 = time.perf_counter()
    phase_kernels(torch, dev, rows)
    log(f"(c) flat kernels match their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_mx_kernels(torch, dev, rows)
    log(f"(c) mx kernels match their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_model_codecs(torch, dev, rows)
    log(f"(c) the model's K1 / K2 launches match their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_arch_kernels(torch, dev, rows)
    log(f"(c) the other archs' head and K6 shapes match their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    moe_kernels = phase_moe_kernels(torch, dev, rows)
    log(f"(c) the MoE archs' router, expert and K6 shapes match their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_ssm_kernels(torch, dev, rows)
    log(f"(c) the SSM archs' mixer, head and K6 shapes match their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_vlm_kernels(torch, dev, rows)
    log(f"(c) the vlm's media K3 shapes, K6 at its g = 8 and f32 K1 / K2 / K6 match their "
        f"plain versions ({time.perf_counter() - t0:.1f} s)")
    k3_step = k3_decode_step(rows)
    log("(c) K3 per decode step (launches x ms over the five linears): " + json.dumps(k3_step))
    bank_probe = phase_bank_probe(torch, dev)

    serving = {}
    for policy in ("takum", "takum8", "mxfp8"):
        t0 = time.perf_counter()
        serving[policy] = phase_serving(torch, dev, policy)
        log(f"(d) serving {policy} " + json.dumps(serving[policy]))
        log(f"(d) {policy}: kernel launches per decode step (torch.profiler) "
            f"{serving[policy]['profile_two_decode_steps']['kernel_launches_per_step']}")
        log(f"(d) {policy} done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    parity = phase_parity(torch, dev)
    log(f"(e) parity done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    differing = phase_producers_exact(torch, dev)
    producer_rows, producer_counts = phase_producers_full(torch, dev)
    log(f"(f) producers done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ad_worst = phase_ad_exact(torch, dev)
    ad_rows, ad_counts = phase_ad_full(torch, dev)
    log(f"(g) K5 done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ids_cases = phase_token_ids(torch, dev)
    log(f"(h) F3/F4: K1 rows equal their plain version on int32 / int64 and off-table ids "
        f"({ids_cases} cases)")
    train_exact = phase_train_exact(torch, dev)
    log("(h1, h2) kernel and plain train steps and updates bit for bit " + json.dumps(train_exact))
    train_full = {}
    for policy in ("takum", "takum8", "bf16"):
        train_full[policy] = phase_train_full(torch, dev, policy)
        r = train_full[policy]
        log(f"(h3) {policy}: llama3-8b {r['layers']} layers ({r['params'] / 1e9:.3f}B params), "
            f"B={r['batch']} S={r['seq']}: CE {r['ce'][0]:.4f} -> {r['ce'][-1]:.4f}, "
            f"step {r['step_ms_median_2_on']:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
            f"peak {r['max_memory_allocated_gb']:.2f} GB (held before "
            f"{r['allocated_before_gb']:.2f}), profiled step {json.dumps(r['profile_one_step'])}, "
            f"launches per step "
            f"{r['step_launches']}, at init {r['init_launches']}; card: {card}")
    train_restart = phase_train_restart(torch, dev)
    log(f"(h4) restarts equal the unbroken runs {json.dumps(train_restart)}")
    log(f"(h) training done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    other = phase_other_archs(torch, dev, card)
    log(f"(i) the other dense archs done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    moe = phase_moe(torch, dev, card)
    log(f"(j) the MoE family done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ssm = phase_ssm(torch, dev, card)
    log(f"(k) the ssm and hybrid families done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    vlm = phase_vlm(torch, dev, card)
    log(f"(l) the vlm family and the f32 KV cache done in {time.perf_counter() - t0:.1f} s")

    observability = phase_observability(torch, dev, card)

    dist = phase_dist(torch, dev, card, rows)

    launches = {p: serving[p]["launches"] for p in serving}
    launches.update({f"{p}/pack": serving[p]["pack_launches"] for p in serving})
    for path in ("mxt8", "bf16"):
        launches[path] = next(r["launches"] for r in parity
                              if r["policy"] == path and r["activations"] == "bf16")
    launches["mxt8/pack"] = next(r["pack_launches"] for r in parity
                                 if r["policy"] == "mxt8" and r["activations"] == "bf16")
    launches["mxt8/f32"] = next(r["launches"] for r in parity
                                if r["policy"] == "mxt8" and r["activations"] == "f32")
    launches["ad"] = ad_counts
    for policy in ("takum", "takum8"):
        launches[f"train/{policy}"] = train_full[policy]["step_launches"]
        launches[f"train/{policy}/init"] = train_full[policy]["init_launches"]
    launches.update({path: r["launches"] for path, r in other["serving"].items()})
    launches.update({f"{r['arch']}/{r['policy']}": r["launches"] for r in other["parity"]
                     if r["activations"] == "bf16" and r["policy"] == "mxt8"})
    launches.update({path: r["launches"] for path, r in moe["serving"].items()})
    launches.update({f"{r['arch']}/{r['policy']}/f32": r["launches"] for r in moe["parity"]
                     if r["activations"] == "f32"})
    launches.update({path: r["launches"] for path, r in ssm["serving"].items()})
    launches.update({path: r["launches"] for path, r in vlm["serving"].items()})
    launches.update({f"f32cache/{arch}": r["launches"] for arch, r in vlm["f32_cache"].items()})
    summary = []
    for kname, fmt, impl, shape, path, *x in SUMMARY:
        row = next(r for r in rows if (r["kernel"], r["fmt"], r["impl"], r["shape"])
                   == (kname, fmt, impl, shape) and r.get("x", "bfloat16") == (x or ["bfloat16"])[0]
                   and "inputs" not in r)
        tag, source, replaces = KERNEL_INFO[kname]
        name = tag + ("-mx" if fmt.startswith("mx") else "") + ("-lut" if impl == "lut" else "")
        n = launches[path].get(LAUNCH_KEY.get(kname, "{kname}[{impl}]").format(
            kname=kname, impl=impl), 0)
        check(n > 0, f"{name} was never launched on the {path} path")
        loop = row.get("loop")
        summary.append(dict(
            name=f"{name} {kname} {fmt} {'x'.join(map(str, shape))}" + (f" {loop}" if loop else ""),
            route="cuda", source=LOOP_SOURCE.get(loop, source), entry=source, replaces=replaces,
            path=path, launches=n, loop=loop,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            **{k: row[k] for k in ("bound_rate", "device_ms", "library_device_ms",
                                   "library_bf16_out_ms") if k in row}))
    # phase (f): K4 and every fused variant, launches from its producer path
    for row in producer_rows:
        tag, source, replaces = KERNEL_INFO[row["kernel"]]
        name = (tag + ("-mx" if row["fmt"].startswith("mx") else "")
                + ("-lut" if row["impl"] == "lut" else "")
                + (f"+{row['out_fmt']}:{row['encode_impl']}" if row["out_fmt"] else ""))
        n = producer_counts.get(row["launch_key"], 0)
        check(n > 0, f"{name} was never launched on the producer path")
        loop = row.get("loop")
        summary.append(dict(
            name=f"{name} {row['kernel']} {row['fmt']} {'x'.join(map(str, row['shape']))}"
                 + (f" {loop}" if loop else ""),
            route="cuda", source=LOOP_SOURCE.get(loop, source), entry=source, replaces=replaces,
            path="producers", launches=n, loop=loop,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            **{k: row[k] for k in ("bound_rate", "library_bf16_out_ms") if k in row}))
    # phase (g): K5's backward, launches from its autograd path
    for row in ad_rows:
        tag, source, replaces = KERNEL_INFO[row["kernel"]]
        name = tag + ("-lut" if row["impl"] == "lut" else "")
        n = ad_counts.get(row["launch_key"], 0)
        check(n > 0, f"{name} was never launched on the K5 path")
        summary.append(dict(
            name=f"{name} {row['kernel']} backward {row['weight']} {row['fmt']} "
                 f"{'x'.join(map(str, row['shape']))} {row['loop']}",
            route="cuda", source=LOOP_SOURCE[row["loop"]], entry=source, replaces=replaces, path="ad",
            launches=n, loop=row["loop"],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], bound_rate=row["bound_rate"],
            bound_f32_ms=row["bound_f32_ms"], library_ms=row["library_ms"],
            copy_yardstick_ms=row["copy_yardstick_ms"]))
    # phase (n): K2 / K1 as the ring launches them, launches from rank 0's
    # ring of each format (exact_local=False) and from one pod train step
    for kname, fmt, impl, shape, path, n in dist_summary(dist):
        row = next(r for r in rows if (r["kernel"], r["fmt"], r["impl"], r["shape"])
                   == (kname, fmt, impl, shape))
        tag, source, replaces = KERNEL_INFO[kname]
        name = tag + ("-mx" if fmt.startswith("mx") else "") + ("-lut" if impl == "lut" else "")
        check(n > 0, f"{name} was never launched on the {path} path")
        summary.append(dict(
            name=f"{name} {kname} {fmt} {'x'.join(map(str, shape))}", route="cuda",
            source=source, entry=source, replaces=replaces, path=path, launches=n, loop=None,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            device_ms=row["device_ms"], library_device_ms=row["library_device_ms"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, build_s=build_s, build=build,
             kernel_rows=rows, k3_decode_step=k3_step, bank_probe=bank_probe, serving=serving,
             parity=parity,
             producers=dict(differing_codes=differing, rows=producer_rows,
                            launches={k: v for k, v in producer_counts.items() if v}),
             ad=dict(worst_err_over_absprod=ad_worst, rows=ad_rows,
                     launches={k: v for k, v in ad_counts.items() if v}),
             train=dict(token_id_cases=ids_cases, exact=train_exact, full=train_full,
                        restart=train_restart),
             other_archs=other, moe_kernels=moe_kernels, moe=moe, ssm=ssm, vlm=vlm,
             observability=observability, dist=dist, total_s=time.perf_counter() - t_start),
        indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
