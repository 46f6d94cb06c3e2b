"""K3 and K4: dequantising matmuls with f32 accumulation (counterparts of
``repro.kernels.takum_matmul.takum_matmul`` and ``takum_dual_matmul``).

K3 computes ``x[M, K] @ decode(w_bits[K, N])`` for f32 or bf16 ``x``; K4
computes ``decode(x_bits[M, K]) @ decode(w_bits[K, N])``, both operands in
one wire format (with ``out_fmt`` t16 over t8 operands, the paper's widening
dot product VDPPT8PT16).  An mx weight is the payload [K, ceil(N/32)*33],
blocked along N; ``n`` names its logical N, and the padded output columns
are dropped.  An mx ``x_bits`` is the payload [M, K/32*33], blocked along K.

``decode_impl`` picks the operand decode ("bits" or "lut", see :mod:`.lut`;
None is the format's default).  ``out_fmt`` fuses the output's wire encode
into the kernel's flush (``encode_impl`` picks its codec): the result is the
out format's packed bits, [M, N] (an mx out: the payload [M, N/32*33], N a
multiple of 32), equal bit for bit to ``ops.encode`` of the unfused output.

K5, ``takum_matmul_ad``, is K3 under autograd: its backward ``dx = g @
decode(w_bits).T`` is :func:`takum_matmul_t`, K3's loop reading the stored
weight transposed in place (``csrc/takum_matmul_wt.cu``); the bits get no
gradient, and an mx weight is refused (its scale bytes are bound to blocks
of the stored last axis).

Which loop a launch runs is :func:`tile_for`'s choice, from (M, x type,
format) alone, passed to the C entry as an int (``LOOPS``):

- M <= 16 (the decode step): the split-K matvec of
  ``csrc/matvec_splitk.cuh``, for K3, K4 and K3's transposed launch.
  :func:`matvec_plan` cuts K into chunks, one column of blocks each, and the
  wrapper allocates the f32 workspace [splits, M, N] that the kernel's
  second pass adds up in split order.
- M > 16 with bf16 x (K3), or K4 over any format but t16: the bf16
  tensor-core tile of ``csrc/matmul_mma.cuh`` (``"mma"``; t16 weights under
  K3 through the exact hi/lo split, ``"mma_split"``), its block shape from
  :func:`mma_plan`.
- M > 16 with f32 x (K3, and every transposed launch): the warp-specialised
  wgmma tile of ``csrc/matmul_wgmma.cuh`` (``"mma_f32"``), x through the
  exact three-way bf16 split of :func:`split3_bf16` (three MMAs per
  product, six for t16), the same block shapes.  It replaces, on Hopper,
  ``repro``'s ``_mm_kernel`` (``takum_matmul.py:56``) for f32 x and the
  backward rule ``_takum_matmul_bwd`` (``:211``); at M = 1024 on
  llama3-8b's wi its MMAs bound it at 0.365 ms (t8) and 0.730 ms (t16) on
  the H100's bf16 rate, against 1.795 ms for f32 FMAs.  Its producers load
  the raw tiles by tensor-map copies (TMA) where x's and the weight's rows
  are 16-byte multiples, else by per-thread cp.async (mx, ragged rows).
- M > 16, K4 over t16: the 64 x 64 FMA tile of ``csrc/matmul_tile.cuh``
  (``"fma"``): both split operands would need four products per pair.

A tensor-core block that meets a value its bf16 parts cannot carry exactly
(f32's largest finite value, from a saturating t8 / t16 code; an infinite
x under the t16 split; under the x split a non-finite x, a nonzero one off
bf16's grid below 2^-110, or an infinite weight) recomputes its tile on
the FMA loop inside the same kernel.

The C entry refuses a loop it has no kernel for; nothing falls back.

``takum_matmul`` / ``takum_dual_matmul`` / ``takum_matmul_t`` launch
``csrc/takum_matmul.cu`` / ``csrc/takum_dual_matmul.cu`` /
``csrc/takum_matmul_wt.cu`` for CUDA tensors and take the plain versions for
CPU tensors; ``.launches`` counts the kernel launches per codec, fused
launches under their own keys (``"lut>t8:lut"``) and the transposed launches
on ``takum_matmul`` under ``"lut^T"`` (see :func:`~.common.launch_key`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.formats import wire_format
from repro_torch.quant import blockscale
from . import _build, lut
from .common import (IMPL_CODE, TARGET_BLOCKS, count_launch, empty_out, epilogue_args,
                     kernel_format, launch_key, out_format, stream_of, table_ptrs)
from .takum_codec import decode_2d_plain, encode_2d_plain

#: the largest M the split-K matvec takes (``kMaxM`` of csrc/matvec_splitk.cuh)
MATVEC_MAX_M = 16
#: output columns per matvec block (``kBN``)
MATVEC_BN = 128
#: x floats a matvec block stages for its chunk (``kXFloats``)
MATVEC_X_FLOATS = 4096
#: the loops of K3, K4 and the transposed K3, by their C code
#: (``repro_mma::Loop`` of csrc/matmul_mma.cuh)
LOOPS = ("matvec", "fma", "mma", "mma_split", "mma_f32")
#: the tensor-core tiles' block shapes (rows, columns), largest first
#: (csrc/matmul_mma.cuh, csrc/matmul_wgmma.cuh); the C entries take the rows
#: as ``tile``
MMA_TILES = ((128, 128), (64, 64))
#: streaming multiprocessors of the H100: 128 x 128 blocks of the tensor-core
#: tile run one per SM, so a grid of fewer leaves SMs idle
SM_COUNT = 132


class MatvecPlan(NamedTuple):
    """The split of K for the matvec: blocks ``n_tiles`` x ``splits``, split
    s covering k in [s * chunk, min((s + 1) * chunk, K)); ``rows_per_stage``
    is the kernel's stage depth, of which ``chunk`` is a multiple."""

    chunk: int
    splits: int
    n_tiles: int
    rows_per_stage: int

    def workspace_shape(self, M: int, N: int) -> tuple[int, int, int]:
        """The f32 partial sums the kernel writes: [splits, M, N]."""
        return (self.splits, M, N)


def matvec_plan(M: int, N: int, K: int, fmt) -> MatvecPlan:
    """The split-K plan of K3 (and of its transposed launch) at M <= 16, from
    (M, N, K, format) alone, never the codec: chunks as long as they can be
    while the grid still holds ``TARGET_BLOCKS`` blocks (two per SM), a
    multiple of the stage depth (64 rows of 8-bit elements, 32 of 16-bit:
    64 bytes, four 16-byte copies, of a stored row under the transposed
    launch) and at most ``MATVEC_X_FLOATS / MB`` rows (MB = 4 for M <= 4,
    else 16: the x the block stages)."""
    if not 1 <= M <= MATVEC_MAX_M:
        raise ValueError(f"the matvec takes 1 <= M <= {MATVEC_MAX_M}, got {M}")
    wf = wire_format(fmt)
    elem_bits = 8 if wf.is_block_scaled else wf.nbits
    ks = 64 if elem_bits == 8 else 32
    cap = MATVEC_X_FLOATS // (4 if M <= 4 else MATVEC_MAX_M)
    n_tiles = math.ceil(N / MATVEC_BN)
    need = math.ceil(TARGET_BLOCKS / max(n_tiles, 1))
    chunk = max(ks, min(cap, K // need) // ks * ks)
    return MatvecPlan(chunk, max(1, math.ceil(K / chunk)), n_tiles, ks)


def tile_for(M: int, x_kind: str, fmt) -> str:
    """The loop of one K3 / K4 / transposed-K3 launch, from M, the kind of
    x (``"f32"``, ``"bf16"``, or ``"wire"``: K4's bits of ``fmt``) and the
    format alone (never the codec):

    - M <= 16: ``"matvec"``, the split-K matvec;
    - bf16 x: ``"mma"``, the bf16 tensor-core tile, whose products are exact
      because every decoded value but f32's largest finite one is exact in
      bf16; t16 (12 significant bits) takes ``"mma_split"``, its weights
      split into two bf16 parts;
    - K4 (``"wire"``): ``"mma"``, but t16 ``"fma"`` (both operands would need
      the split: four products per pair);
    - f32 x (K3 and its transposed launch): ``"mma_f32"``, the wgmma tile,
      x split into three bf16 parts (:func:`split3_bf16`), every format."""
    if x_kind not in ("f32", "bf16", "wire"):
        raise ValueError(f"x_kind must be 'f32', 'bf16' or 'wire', got {x_kind!r}")
    if M <= MATVEC_MAX_M:
        return "matvec"
    t16 = kernel_format(fmt, f32=False).name == "t16"
    if x_kind == "f32":
        return "mma_f32"
    if x_kind == "wire" and t16:
        return "fma"
    return "mma_split" if t16 else "mma"


#: the smallest |x| whose three bf16 parts always sum to x: below it, x's
#: lowest bits can fall under bf16's finest step, its smallest subnormal
SPLIT3_EDGE = 2.0 ** -110


def split3_bf16(x: torch.Tensor):
    """The three-way bf16 split of f32 ``x`` that the wgmma tile
    (``csrc/matmul_wgmma.cuh`` ``split3_8``) multiplies, as f32 tensors
    holding bf16 values, and its vote: ``(hi, mid, lo, vote)`` with hi =
    x with its low 16 bits cleared, mid the same of r = x - hi, lo = r -
    mid (both subtractions exact), and ``vote`` True where x is not the
    exact sum of three bf16 parts: x not finite, or lo off bf16's grid
    (not a multiple of 2^-133), which happens only for nonzero |x| <
    ``SPLIT3_EDGE``.  Elsewhere hi + mid + lo == x (for x = -0, +0)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    top = -(1 << 16)  # 0xFFFF0000 as int32
    hi = (bits & top).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & top).view(torch.float32)
    lo = r - mid
    vote = ~torch.isfinite(x) | ((lo.view(torch.int32) & 0xFFFF) != 0)
    return hi, mid, lo, vote


class MmaPlan(NamedTuple):
    """The tensor-core tile's grid: blocks of ``rows`` x ``cols`` outputs,
    ``m_tiles`` x ``n_tiles`` of them; ``rows`` is what the C entry takes as
    its ``tile``."""

    rows: int
    cols: int
    m_tiles: int
    n_tiles: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles


def mma_plan(M: int, N: int) -> MmaPlan:
    """The tensor-core tile's block shape from (M, N) alone: 128 x 128 where
    that gives at least one block per SM, else 64 x 64 (at llama3-8b's
    prefill, M = 1024: wq, wo and the MLP take 128 x 128, wk and wv, N =
    1024, 64 x 64)."""
    for rows, cols in MMA_TILES:
        plan = MmaPlan(rows, cols, math.ceil(M / rows), math.ceil(N / cols))
        if plan.blocks >= SM_COUNT:
            return plan
    return plan


def _logical_n(w_bits: torch.Tensor, wf, n) -> int:
    """The weight's logical N: its column count, or for an mx payload the
    ``n`` it was packed from (default: every payload column)."""
    if not wf.is_block_scaled:
        if n is not None and n != w_bits.shape[-1]:
            raise ValueError(f"n={n} does not match w_bits {tuple(w_bits.shape)}")
        return w_bits.shape[-1]
    n_pad = blockscale.elems_len(w_bits.shape[-1])
    if n is None:
        return n_pad
    if blockscale.payload_len(n) != w_bits.shape[-1] or n <= 0:
        raise ValueError(f"n={n} does not match the mx payload width {w_bits.shape[-1]}")
    return n


def takum_matmul_plain(x: torch.Tensor, w_bits: torch.Tensor, fmt, n=None,
                       acc: torch.dtype = torch.float32, decode_impl=None, out_fmt=None,
                       encode_impl=None) -> torch.Tensor:
    """Plain PyTorch K3: decode the whole weight (through ``decode_impl``),
    then one matmul in ``acc`` (float32; float64 is the order control of
    ``ops.plain_path``), returned as float32, or with ``out_fmt`` encoded by
    the plain encode (``encode_impl``)."""
    N = _logical_n(w_bits, wire_format(fmt), n)
    out_wf, out_impl = out_format(out_fmt, encode_impl, N)
    w = decode_2d_plain(w_bits, fmt, decode_impl)[:, :N]
    out = torch.matmul(x.to(acc), w.to(acc)).to(torch.float32)
    return out if out_wf is None else encode_2d_plain(out, out_wf, out_impl)


def takum_dual_matmul_plain(x_bits: torch.Tensor, w_bits: torch.Tensor, fmt, n=None,
                            acc: torch.dtype = torch.float32, decode_impl=None, out_fmt=None,
                            encode_impl=None) -> torch.Tensor:
    """Plain PyTorch K4: decode both operands (an mx x to its whole-block
    K), then one matmul in ``acc``; ``out_fmt`` as in
    :func:`takum_matmul_plain`."""
    x = decode_2d_plain(x_bits, fmt, decode_impl)
    return takum_matmul_plain(x, w_bits, fmt, n, acc, decode_impl, out_fmt, encode_impl)


def takum_matmul_t_plain(g: torch.Tensor, w_bits: torch.Tensor, fmt,
                         acc: torch.dtype = torch.float32, decode_impl=None) -> torch.Tensor:
    """Plain PyTorch transposed K3: decode the whole weight (through
    ``decode_impl``), then ``g @ w.T`` in ``acc``, returned as float32."""
    w = decode_2d_plain(w_bits, fmt, decode_impl)
    return torch.matmul(g.to(acc), w.to(acc).T).to(torch.float32)


def _check_device(a: torch.Tensor, b: torch.Tensor, names: str) -> bool:
    """True for two CPU tensors (the plain version runs); raises unless both
    are contiguous on one CUDA device."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return True
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{names} must share one CUDA device, got {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{names} must be contiguous")
    return False


def _check_dims(M: int, N: int, K: int) -> None:
    if max(M, N, K) >= 2**31:
        raise ValueError("matmul dims must fit in int32")


def _loop_args(M: int, N: int, K: int, x_kind: str, wf, device):
    """(loop name, workspace, chunk, tile) of one launch: the matvec plan's
    f32 workspace and chunk on the matvec (else None, 0) and the
    tensor-core tile's block rows on it (else 0)."""
    loop = tile_for(M, x_kind, wf)
    ws, chunk, tile = None, 0, 0
    if loop == "matvec":
        plan = matvec_plan(M, N, K, wf)
        ws = torch.empty(plan.workspace_shape(M, N), dtype=torch.float32, device=device)
        chunk = plan.chunk
    elif loop.startswith("mma"):
        tile = mma_plan(M, N).rows
    return loop, ws, chunk, tile


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(entry: str, fn, x, w_bits, dims: tuple, x_kind: str, wf, impl, out_wf, out_impl):
    """Allocate the output ([M, N] f32, or the out format's packed [M, N] or
    payload), run the C entry ``entry`` on (x, w_bits, out, workspace, M, N,
    K, chunk, loop, tile, *dims[3:], format, codec, tables, epilogue,
    stream), count the launch on ``fn`` and note its loop in
    ``fn.last_loop``."""
    M, N, K = dims[:3]
    _check_dims(M, N, K)
    out = empty_out((M,), N, out_wf, x.device)
    if out.numel():
        loop, ws, chunk, tile = _loop_args(M, N, K, x_kind, wf, x.device)
        _build.check(
            _build.entry(entry)(x.data_ptr(), w_bits.data_ptr(), out.data_ptr(), _ptr(ws), M, N, K,
                                chunk, LOOPS.index(loop), tile, *dims[3:], wf.code, IMPL_CODE[impl],
                                *table_ptrs(wf, impl, "decode", x.device),
                                *epilogue_args(out_wf, out_impl, x.device), stream_of(x)),
            fn.__name__,
        )
        count_launch(fn, launch_key(impl, out_wf and out_wf.name, out_impl))
        fn.last_loop = loop
    return out


def takum_matmul(x: torch.Tensor, w_bits: torch.Tensor, fmt, n=None, decode_impl=None,
                 out_fmt=None, encode_impl=None) -> torch.Tensor:
    """K3: x [M, K] f32/bf16 @ decode(w_bits [K, N]) -> [M, N] float32, or
    with ``out_fmt`` its packed encode; an mx ``w_bits`` is the payload
    [K, ceil(N/32)*33] and ``n`` its logical N."""
    wf = kernel_format(fmt, f32=False)
    impl = lut.resolve_impl(decode_impl, wf)
    if x.dim() != 2 or w_bits.dim() != 2 or x.shape[1] != w_bits.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(x.shape)} @ {tuple(w_bits.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_bits.dtype != wf.storage:
        raise TypeError(f"w_bits must be {wf.storage} for {wf.name}, got {w_bits.dtype}")
    N = _logical_n(w_bits, wf, n)
    out_wf, out_impl = out_format(out_fmt, encode_impl, N)
    if _check_device(x, w_bits, "x and w_bits"):
        return takum_matmul_plain(x, w_bits, wf, N, decode_impl=impl, out_fmt=out_wf,
                                  encode_impl=out_impl)
    M, K = x.shape
    bf16 = x.dtype == torch.bfloat16
    return _launch("repro_matmul", takum_matmul, x, w_bits, (M, N, K, int(bf16)),
                   "bf16" if bf16 else "f32", wf, impl, out_wf, out_impl)


def takum_dual_matmul(x_bits: torch.Tensor, w_bits: torch.Tensor, fmt, n=None, decode_impl=None,
                      out_fmt=None, encode_impl=None) -> torch.Tensor:
    """K4: decode(x_bits [M, K]) @ decode(w_bits [K, N]) -> [M, N] float32,
    or with ``out_fmt`` its packed encode.  Both operands are ``fmt``; for an
    mx format x_bits is the payload [M, K/32*33] (w_bits then has K rows)
    and w_bits [K, ceil(N/32)*33] with ``n`` its logical N."""
    wf = kernel_format(fmt, f32=False)
    impl = lut.resolve_impl(decode_impl, wf)
    if x_bits.dim() != 2 or w_bits.dim() != 2:
        raise ValueError(f"bad dual_matmul shapes {tuple(x_bits.shape)} @ {tuple(w_bits.shape)}")
    M, K = x_bits.shape
    if wf.is_block_scaled:
        K = blockscale.elems_len(K)
    if K != w_bits.shape[0]:
        raise ValueError(f"bad dual_matmul shapes {tuple(x_bits.shape)} @ {tuple(w_bits.shape)}")
    if x_bits.dtype != wf.storage or w_bits.dtype != wf.storage:
        raise TypeError(f"x_bits and w_bits must be {wf.storage} for {wf.name}")
    N = _logical_n(w_bits, wf, n)
    out_wf, out_impl = out_format(out_fmt, encode_impl, N)
    if _check_device(x_bits, w_bits, "x_bits and w_bits"):
        return takum_dual_matmul_plain(x_bits, w_bits, wf, N, decode_impl=impl, out_fmt=out_wf,
                                       encode_impl=out_impl)
    return _launch("repro_dual_matmul", takum_dual_matmul, x_bits, w_bits, (M, N, K), "wire", wf,
                   impl, out_wf, out_impl)


def _flat_format(fmt):
    """``fmt`` resolved for K5, which refuses a block-scaled format as
    ``repro`` does."""
    wf = kernel_format(fmt, f32=False)
    if wf.is_block_scaled:
        raise ValueError("takum_matmul_ad: block-scaled weights have no bit-transposed "
                         "backward payload; dequantize mx weights at the use site")
    return wf


def takum_matmul_t(g: torch.Tensor, w_bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """Transposed K3, K5's backward: g [M, N] float32 @ decode(w_bits [K, N]).T
    -> [M, K] float32, the stored weight read in place (no transposed copy);
    flat formats only.  Counts on ``takum_matmul`` under ``"impl^T"``."""
    wf = _flat_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    if g.dim() != 2 or w_bits.dim() != 2 or g.shape[1] != w_bits.shape[1]:
        raise ValueError(f"bad transposed matmul shapes {tuple(g.shape)} @ "
                         f"{tuple(w_bits.shape)}.T")
    if g.dtype != torch.float32:
        raise TypeError(f"g must be float32, got {g.dtype}")
    if w_bits.dtype != wf.storage:
        raise TypeError(f"w_bits must be {wf.storage} for {wf.name}, got {w_bits.dtype}")
    if _check_device(g, w_bits, "g and w_bits"):
        return takum_matmul_t_plain(g, w_bits, wf, decode_impl=impl)
    # the kernel's out[M, N] = g[M, K] @ decode(w[N, K])^T, in its own names
    # (the plan of K3 over a transposed copy, and the same order)
    (M, K), N = g.shape, w_bits.shape[0]
    _check_dims(M, N, K)
    out = torch.empty((M, N), dtype=torch.float32, device=g.device)
    if out.numel():
        loop, ws, chunk, tile = _loop_args(M, N, K, "f32", wf, g.device)
        fn = _build.entry("repro_matmul_wt")
        _build.check(
            fn(g.data_ptr(), w_bits.data_ptr(), out.data_ptr(), _ptr(ws), M, N, K, chunk,
               LOOPS.index(loop), tile, wf.code, IMPL_CODE[impl],
               *table_ptrs(wf, impl, "decode", g.device), stream_of(g)),
            "takum_matmul_t",
        )
        count_launch(takum_matmul, launch_key(impl, transposed=True))
        takum_matmul_t.last_loop = loop
    return out


class _TakumMatmulAD(torch.autograd.Function):
    """K3 forward, transposed-K3 backward to x; ``w_bits`` and the format
    get no gradient.  Inside ``ops.plain_path(acc)`` (read at the forward)
    both directions take their plain versions, accumulating in ``acc``."""

    @staticmethod
    def forward(ctx, x, w_bits, wf):
        from .ops import plain_acc  # ops imports this module

        acc = plain_acc()
        ctx.save_for_backward(w_bits)
        ctx.wf, ctx.x_dtype, ctx.acc = wf, x.dtype, acc
        if acc is None:
            return takum_matmul(x.contiguous(), w_bits.contiguous(), wf)
        return takum_matmul_plain(x, w_bits, wf, acc=acc)

    @staticmethod
    def backward(ctx, g):
        (w_bits,) = ctx.saved_tensors
        g = g.contiguous().float()
        if ctx.acc is None:
            dx = takum_matmul_t(g, w_bits.contiguous(), ctx.wf)
        else:
            dx = takum_matmul_t_plain(g, w_bits, ctx.wf, ctx.acc)
        return dx.to(ctx.x_dtype), None, None


def takum_matmul_ad(x: torch.Tensor, w_bits: torch.Tensor, fmt) -> torch.Tensor:
    """K5: ``takum_matmul(x, w_bits, fmt)`` (x [M, K] float32/bfloat16, w_bits
    [K, N] a flat format's bits, the format's default codec) under autograd.
    The backward propagates to x only, ``dx = g @ decode(w_bits).T`` in x's
    dtype, through :func:`takum_matmul_t`; the packed weight is storage and
    gets no gradient.  A block-scaled ``fmt`` raises ValueError."""
    return _TakumMatmulAD.apply(x, w_bits, _flat_format(fmt))


takum_matmul.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
takum_dual_matmul.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
#: the loop (``LOOPS``) of each wrapper's last kernel launch (None before one)
takum_matmul.last_loop = takum_dual_matmul.last_loop = takum_matmul_t.last_loop = None
