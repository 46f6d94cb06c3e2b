"""K1 / K2: wire-format decode and encode (counterpart of
``repro.kernels.takum_codec``).  Flat formats map [R, C] bits <-> [R, C]
f32 element by element; the mx containers map an interleaved payload
[R, C/32*33] <-> [R, C] f32 (encode needs C % 32 == 0).

``takum_decode_2d`` / ``takum_encode_2d`` launch the CUDA kernels in
``csrc/takum_codec.cu`` for a CUDA tensor and take the plain versions
``decode_2d_plain`` / ``encode_2d_plain`` for a CPU tensor.  The model's
calls go through two more entries of the same kernels:

* ``takum_encode_into`` (K2): one or two sources (f32 or bf16) encoded in
  one launch straight into 2-D strided destinations, such as a layer's K
  and V into their KV-cache slots;
* ``takum_decode_rows`` (K1): the rows a tensor of row ids picks (the
  embedding rows of the token ids), scaled by a per-tensor pow2 scale and
  rounded to f32 or bf16.

Their plain versions (``encode_into_plain``, ``decode_rows_plain``) are the
compositions they replace.  ``decode_impl`` / ``encode_impl`` pick the codec
("bits" or "lut", see :mod:`.lut`; None is the format's default), in the
kernel and in the plain version alike.  Each wrapper counts its kernel
launches per codec in ``.launches``.  A CUDA launch runs the plan of
:func:`codec_plan` or raises: no wrapper splits into other launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.formats import wire_format
from repro_torch.quant import blockscale
from . import _build, lut
from .common import IMPL_CODE, count_launch, kernel_format, stream_of, table_ptrs

#: threads per block of the codec kernels (``kThreads`` in csrc/takum_codec.cu)
THREADS = 256
#: mx groups one warp holds per run at most (``kMxRun``): 1056 payload bytes
MX_RUN = 32
#: the C entries' dtype ids of the f32 side (``SideDtype``): a decode's
#: output, an encode's sources
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class CodecPlan:
    """What one K1 / K2 launch runs.  ``grid`` blocks (a pair launch adds a
    second grid dimension of 2); ``vec`` elements per 16-byte access (1: the
    scalar loop takes every element; an mx launch: the groups of a warp's
    run); ``head`` / ``tail`` elements before / after the vector body,
    taken by the scalar loop."""

    grid: int
    vec: int
    head: int
    tail: int


def _co_aligned(ptrs, vec: int):
    """Smallest h < vec at which every (address, element size) of ``ptrs``
    is 16-byte aligned, or None."""
    for h in range(vec):
        if all((addr + h * size) % 16 == 0 for addr, size in ptrs):
            return h
    return None


def codec_plan(n: int, src_addrs, dst_addrs, src_size: int, dst_size: int, *, run=None,
               src_pitch=None, dst_pitch=None, mx: bool = False, sms: int = 132,
               blocks_per_sm: int = 8) -> CodecPlan:
    """The launch of K1 / K2 over ``n`` elements (the f32 side).

    ``src_addrs`` / ``dst_addrs``: the data pointers (an int, or one per
    pair), ``src_size`` / ``dst_size`` their element sizes in bytes.
    ``run``: elements per row (or destination run) when the range is cut
    into rows that start at a pitch or through a row index (None: one
    contiguous range), and ``src_pitch`` / ``dst_pitch`` the storage
    elements between row starts on each side (None: ``run``).  Flat
    formats: 16 bytes of the narrower side per access (16 elements for
    8-bit codes or a bf16 pair, 8 for 16-bit codes); the head aligns every
    pointer at once, the tail is what is left under a whole vector.  Rows
    take the vector path only from aligned row starts, with whole vectors
    per row and pitches of whole 16-byte chunks; where the pointers cannot
    be aligned together every element goes through the scalar loop
    (``vec`` 1, ``head`` n).  ``mx``: one warp per run of ``vec`` groups
    within a row of ``run`` elements (None: one row), ``MX_RUN`` unless
    that leaves fewer runs than the warps the card holds at once (then 16,
    8 or 4), head and tail 0.  The grid is persistent: enough blocks for
    one trip each, at most ``sms * blocks_per_sm``."""
    srcs = src_addrs if isinstance(src_addrs, (tuple, list)) else (src_addrs,)
    dsts = dst_addrs if isinstance(dst_addrs, (tuple, list)) else (dst_addrs,)
    return _plan(n, tuple(a % 16 for a in srcs), tuple(a % 16 for a in dsts), src_size, dst_size,
                 run, src_pitch, dst_pitch, mx, sms, blocks_per_sm)


@functools.lru_cache(maxsize=4096)
def _plan(n, srcs, dsts, src_size, dst_size, run, src_pitch, dst_pitch, mx, sms, blocks_per_sm):
    """:func:`codec_plan` of the pointers' residues mod 16."""
    cap = max(1, sms * blocks_per_sm)
    if mx:
        row = n if run is None else run
        for groups in (MX_RUN, MX_RUN // 2, MX_RUN // 4, MX_RUN // 8):
            runs = (n // row) * -(-(row // blockscale.BLOCK) // groups) if n else 0
            if runs >= cap * (THREADS // 32):  # a run for every warp the card holds
                break
        return CodecPlan(min(max(1, -(-runs // (THREADS // 32))), cap), groups, 0, 0)
    vec = 16 // min(src_size, dst_size)
    head = _co_aligned([(a, src_size) for a in srcs] + [(a, dst_size) for a in dsts], vec)
    if run is not None:
        sp = run if src_pitch is None else src_pitch
        dp = run if dst_pitch is None else dst_pitch
        if not (head == 0 and run % vec == 0 and sp * src_size % 16 == 0
                and dp * dst_size % 16 == 0):
            head = None
    if head is None or head >= n:
        vec, head, tail = 1, n, 0
    else:
        tail = (n - head) % vec
    units = (n - head - tail) // vec if vec > 1 else n
    return CodecPlan(min(max(1, -(-units // THREADS)), cap), vec, head, tail)


@functools.lru_cache(maxsize=None)
def _occupancy(op: int, code: int, impl: str, dtype: int, device_index: int) -> tuple[int, int]:
    """(SMs, blocks per SM) of the kernel a launch runs, from the device."""
    sms, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_build.entry("repro_codec_occupancy")(
            op, code, IMPL_CODE[impl], dtype, ctypes.addressof(sms), ctypes.addressof(blocks)),
            "repro_codec_occupancy")
    return sms.value, max(1, blocks.value)


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    raises unless they all lie on one CUDA device."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"tensors must share one CUDA device, got {sorted(map(str, devs))}")
    return False


def _check_2d(t: torch.Tensor, dtype, what: str) -> None:
    if t.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


#: elements per slice of the plain codecs: their int64 temporaries take about
#: 100 bytes per element, so a [4096, 128256] head stays in bounded memory
_PLAIN_CHUNK = 1 << 24


def _by_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply the element-wise ``fn`` to ``x`` in slices along dim 0."""
    if x.numel() <= _PLAIN_CHUNK:
        return fn(x)
    rows = max(1, _PLAIN_CHUNK // (x.numel() // x.shape[0]))
    return torch.cat([fn(x[r:r + rows]) for r in range(0, x.shape[0], rows)])


def decode_2d_plain(bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """Plain PyTorch K1: [R, C] packed bits (an mx payload [R, C/32*33]) ->
    [R, C] float32, through the table gather or the bits decode."""
    return _by_rows(lut.decode_fn(fmt, decode_impl), bits)


def encode_2d_plain(x: torch.Tensor, fmt, encode_impl=None) -> torch.Tensor:
    """Plain PyTorch K2: [R, C] float32 -> [R, C] packed bits (storage dtype),
    or the mx payload [R, C/32*33], through the table or the bits encode."""
    wf = wire_format(fmt)
    enc = lut.encode_fn(wf, encode_impl)
    packed = _by_rows(lambda c: wf.pack(enc(c)).view(wf.signed_storage), x.to(torch.float32))
    return packed.view(wf.storage)


def _launch_decode(counter, bits, rows, out, nrows, cols, pitch, nsrc, scale, wf, impl):
    """One K1 launch: output ``out`` [nrows, cols] from ``bits``' rows
    (through ``rows`` when given), rows ``pitch`` storage elements apart."""
    dev, dt = bits.device, DTYPE_CODE[out.dtype]
    sms, per_sm = _occupancy(0, wf.code, impl, dt, dev.index or 0)
    multi = rows is not None or nrows > 1
    plan = codec_plan(nrows * cols, bits.data_ptr(), out.data_ptr(), bits.element_size(),
                      out.element_size(), run=cols if multi else None, src_pitch=pitch,
                      mx=wf.is_block_scaled, sms=sms, blocks_per_sm=per_sm)
    fn = _build.entry("repro_decode")
    _build.check(fn(bits.data_ptr(), 0 if rows is None else rows.data_ptr(), out.data_ptr(),
                    nrows, cols, pitch, nsrc, 0 if scale is None else scale.data_ptr(), dt,
                    wf.code, IMPL_CODE[impl], *table_ptrs(wf, impl, "decode", dev),
                    plan.grid, plan.vec, plan.head, plan.tail,
                    0 if rows is None else rows.element_size(), stream_of(bits)),
                 counter.__name__)
    count_launch(counter, impl)


def _launch_encode(counter, srcs, dsts, n, run, pitch, wf, impl):
    """One K2 launch over the pairs (srcs[k] -> dsts[k]): ``n`` elements
    each, into runs of ``run`` storage elements ``pitch`` apart."""
    dev, dt = srcs[0].device, DTYPE_CODE[srcs[0].dtype]
    sms, per_sm = _occupancy(1, wf.code, impl, dt, dev.index or 0)
    src_ptrs = [s.data_ptr() for s in srcs]
    dst_ptrs = [d.data_ptr() for d in dsts]
    # an mx launch cuts warp runs from the contiguous sources, whatever the
    # destination's runs; a flat one keeps each vector inside one run
    cut = run < n and not wf.is_block_scaled
    plan = codec_plan(n, src_ptrs, dst_ptrs, srcs[0].element_size(), wf.nbits // 8,
                      run=run if cut else None, dst_pitch=pitch, mx=wf.is_block_scaled,
                      sms=sms, blocks_per_sm=per_sm)
    fn = _build.entry("repro_encode")
    _build.check(fn(src_ptrs[0], src_ptrs[-1], dst_ptrs[0], dst_ptrs[-1], len(srcs), n, run,
                    pitch, dt, wf.code, IMPL_CODE[impl], *table_ptrs(wf, impl, "encode", dev),
                    plan.grid, plan.vec, plan.head, plan.tail, stream_of(srcs[0])),
                 counter.__name__)
    count_launch(counter, impl)


def takum_decode_2d(bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """K1: [R, C] packed wire bits (an mx payload [R, C/32*33]) -> [R, C]
    float32 (kernel clamp semantics)."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    _check_2d(bits, wf.storage, "bits")
    R, L = bits.shape
    C = blockscale.elems_len(L) if wf.is_block_scaled else L
    if _on_cpu(bits):
        return decode_2d_plain(bits, wf, impl)
    out = torch.empty((R, C), dtype=torch.float32, device=bits.device)
    if out.numel():
        _launch_decode(takum_decode_2d, bits, None, out, 1, out.numel(), bits.numel(), 1, None,
                       wf, impl)
    return out


def takum_encode_2d(x: torch.Tensor, fmt, encode_impl=None) -> torch.Tensor:
    """K2: [R, C] float32 -> [R, C] packed wire bits; RNE, DAZ, saturation
    (takum) or overflow to NaN/Inf (OFP8, bf16).  An mx format gives the
    payload [R, C/32*33] and needs C % 32 == 0."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(encode_impl, wf, "encode")
    _check_2d(x, torch.float32, "x")
    R, C = x.shape
    if wf.is_block_scaled and C % blockscale.BLOCK:
        raise ValueError(f"block-scaled encode needs a 32-multiple column count, got {C}")
    if _on_cpu(x):
        return encode_2d_plain(x, wf, impl)
    cols = blockscale.payload_len(C) if wf.is_block_scaled else C
    out = torch.empty((R, cols), dtype=wf.storage, device=x.device)
    if x.numel():
        _launch_encode(takum_encode_2d, (x,), (out,), x.numel(), out.numel(), out.numel(), wf,
                       impl)
    return out


# ---------------------------------------------------------------------------
# the model's launches: the KV append, the embedding rows
# ---------------------------------------------------------------------------


def _into_args(srcs, dsts, wf):
    """Validate ``takum_encode_into``'s operands: (srcs, dsts, run, pitch)
    with run / pitch the destinations' storage elements per run and between
    run starts."""
    srcs = (srcs,) if isinstance(srcs, torch.Tensor) else tuple(srcs)
    dsts = (dsts,) if isinstance(dsts, torch.Tensor) else tuple(dsts)
    if not 1 <= len(srcs) <= 2 or len(dsts) != len(srcs):
        raise ValueError(f"one or two (source, destination) pairs, got {len(srcs)} and "
                         f"{len(dsts)}")
    s0, d0 = srcs[0], dsts[0]
    for s in srcs:
        if s.dim() != 2 or s.dtype not in DTYPE_CODE or not s.is_contiguous():
            raise ValueError(f"a source must be a contiguous 2-D f32 or bf16 tensor, got "
                             f"{tuple(s.shape)} {s.dtype}")
        if s.shape != s0.shape or s.dtype != s0.dtype:
            raise ValueError("the sources must share shape and dtype")
    R, C = s0.shape
    if wf.is_block_scaled and C % blockscale.BLOCK:
        raise ValueError(f"block-scaled encode needs a 32-multiple column count, got {C} "
                         f"(zero-pad with blockscale.pad_block)")
    want = R * (blockscale.payload_len(C) if wf.is_block_scaled else C)
    for d in dsts:
        if d.dim() != 2 or d.dtype != wf.storage:
            raise ValueError(f"a destination must be a 2-D {wf.storage} view, got "
                             f"{tuple(d.shape)} {d.dtype}")
        if d.shape != d0.shape or d.stride() != d0.stride():
            raise ValueError("the destinations must share shape and strides")
    runs, run = d0.shape
    pitch = d0.stride(0) if runs > 1 else run
    if runs * run != want or (run > 1 and d0.stride(1) != 1) or pitch < run:
        raise ValueError(f"destination {tuple(d0.shape)} with strides {d0.stride()} is not "
                         f"{want} storage elements in runs of contiguous elements")
    if wf.is_block_scaled and run % blockscale.GROUP:
        raise ValueError(f"an mx destination run must be whole 33-byte groups, got {run}")
    if pitch == run:  # runs back to back: one contiguous range
        run = pitch = want
    return srcs, dsts, run, pitch


def encode_into_plain(srcs, dsts, fmt, encode_impl=None) -> None:
    """Plain version of :func:`takum_encode_into`: the sources cast to f32,
    encoded (``encode_2d_plain``) and copied into the destinations (16-bit
    bits through their signed view)."""
    wf = wire_format(fmt)
    srcs, dsts, _, _ = _into_args(srcs, dsts, wf)
    signed = wf.signed_storage
    for s, d in zip(srcs, dsts):
        bits = encode_2d_plain(s.to(torch.float32), wf, encode_impl)
        d.view(signed).copy_(bits.view(signed).reshape(d.shape))


def takum_encode_into(srcs, dsts, fmt, encode_impl=None) -> None:
    """K2 into strided destinations, in one launch for one or two pairs.

    ``srcs``: one or two [R, C] contiguous tensors of one shape, f32 or
    bf16 (widened to f32 in registers, exactly, so the function is K2's).
    ``dsts``: one per source, 2-D views of ``fmt``'s storage dtype, runs of
    contiguous storage elements at a pitch (``stride(0)``): the source's
    packed bits, read row-major, fill the runs in order.  An mx format
    needs C % 32 == 0 and whole 33-byte groups per run; a caller whose last
    axis is not whole blocks pads first (``blockscale.pad_block``; no
    served config needs to: llama3-8b's head dim is 128).  The model
    appends a layer's K and V this way, straight into the KV cache slots.
    CPU tensors take :func:`encode_into_plain`."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(encode_impl, wf, "encode")
    srcs, dsts, run, pitch = _into_args(srcs, dsts, wf)
    if _on_cpu(*srcs, *dsts):
        encode_into_plain(srcs, dsts, wf, impl)
        return
    if srcs[0].numel():
        _launch_encode(takum_encode_into, srcs, dsts, srcs[0].numel(), run, pitch, wf, impl)


#: the row id dtypes K1 reads at their own width
ROW_DTYPES = (torch.int32, torch.int64)


def table_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Row ids -> the rows of an ``n``-row table they read, as ``repro``'s
    gather does (``params["embed"][tokens]``): an id in [-n, -1] wraps by
    adding n, then every id clamps to [0, n - 1].  Ids [-1, 5, 7, -9] on 5
    rows read rows 4, 4, 4, 0.  int64 out."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def _rows_args(bits, rows, wf, scale, out_dtype):
    _check_2d(bits, wf.storage, "bits")
    if rows.dtype not in ROW_DTYPES:
        raise TypeError(f"rows must be int32 or int64, got {rows.dtype}")
    if out_dtype not in DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if scale is not None and (scale.dtype != torch.float32 or scale.numel() != 1):
        raise ValueError(f"scale must be one float32 value, got {scale.dtype} {tuple(scale.shape)}")
    L = bits.shape[1]
    return blockscale.elems_len(L) if wf.is_block_scaled else L


def decode_rows_plain(bits, rows, fmt, decode_impl=None, scale=None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of :func:`takum_decode_rows`: gather the rows that
    int32 or int64 ``rows`` read (:func:`table_rows`: an id in [-V, -1]
    wraps by adding V, then every id clamps to [0, V - 1], as ``repro``'s
    gather does; 16-bit bits through their signed view), decode
    (``decode_2d_plain``), multiply by ``scale``, cast to ``out_dtype``."""
    wf = wire_format(fmt)
    C = _rows_args(bits, rows, wf, scale, out_dtype)
    g = bits.view(wf.signed_storage)[table_rows(rows, bits.shape[0])].view(bits.dtype)
    y = decode_2d_plain(g.reshape(-1, bits.shape[1]), wf, decode_impl)
    y = y.reshape(*rows.shape, C)
    return (y if scale is None else y * scale).to(out_dtype)


def takum_decode_rows(bits: torch.Tensor, rows: torch.Tensor, fmt, decode_impl=None,
                      scale=None, out_dtype=torch.float32) -> torch.Tensor:
    """K1 over the rows of ``bits`` [V, L] (packed bits, or an mx payload)
    that ``rows`` (int32 or int64 ids, any shape, contiguous; the kernel
    reads each id at its own width) picks, in one launch: ``[*rows.shape,
    C]`` in ``out_dtype`` (float32 or bfloat16), each decoded value
    multiplied by ``scale`` (a one-element f32 tensor on the same device,
    e.g. a QTensor's pow2 scale) in f32 and rounded to ``out_dtype`` with
    RNE.  An id off the table reads what ``repro``'s gather reads: an id in
    [-V, -1] wraps by adding V, then every id clamps to [0, V - 1]
    (:func:`table_rows`), in the kernel and the plain version alike.  The
    model decodes its embedding rows this way.  CPU tensors take
    :func:`decode_rows_plain`."""
    wf = kernel_format(fmt)
    impl = lut.resolve_impl(decode_impl, wf)
    C = _rows_args(bits, rows, wf, scale, out_dtype)
    if _on_cpu(bits, rows, *([] if scale is None else [scale])):
        return decode_rows_plain(bits, rows, wf, impl, scale, out_dtype)
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    out = torch.empty((*rows.shape, C), dtype=out_dtype, device=bits.device)
    if out.numel():
        _launch_decode(takum_decode_rows, bits, rows, out, rows.numel(), C, bits.shape[1],
                       bits.shape[0], scale, wf, impl)
    return out


takum_decode_2d.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
takum_encode_2d.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
takum_encode_into.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
takum_decode_rows.launches = dict.fromkeys(lut.DECODE_IMPLS, 0)
