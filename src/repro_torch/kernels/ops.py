"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``): ``encode``, ``decode``, ``matmul``, ``dual_matmul``,
``decode_attention``, ``matmul_t`` (the transposed K3: a tied head's
``x @ embed.T`` over the stored bits), and the model's two codec launches
``encode_into`` (K2 into strided destinations, a pair per launch: the KV
append) and ``decode_rows`` (K1 over gathered rows, scaled and cast: the
embedding).

Each op takes a wire-format handle (a registered name such as 't8', 'e4m3',
'bf16', 'mxe4m3', a :class:`~repro_torch.core.formats.WireFormat`, or a bare
takum width).  ``encode``, ``decode``, ``encode_into``, ``decode_rows`` and
``decode_attention`` also take "f32" (raw IEEE bits in uint32: an f32 KV
cache); ``matmul``, ``matmul_t``, ``dual_matmul`` and the producers'
``out_fmt`` do not.  ``encode``/``decode`` take any rank, empty tensors included,
and view it as 2-D for the K1/K2 kernels (a 0-d tensor as [1, 1]); the
result has the input's shape.  For the block-scaled mx formats the last axis
is the interleaved payload (n elements <-> n/32*33 bytes); a malformed
payload, a 0-d one, or an encode input that is not whole 32-element blocks
raises here, before any kernel or plain version sees it.

``decode_impl`` / ``encode_impl`` pick the codec inside each kernel: "bits"
(the format family's branch-free codec) or "lut" (a gather from the tables
of ``core/tables.py``); None takes the per-format default of
``lut.DEFAULT_DECODE_IMPL`` / ``DEFAULT_ENCODE_IMPL``, as in ``repro``.  The
knob is resolved (``lut.resolve_impl``: "lut" on a format without tables
raises) before any kernel or plain version runs, and the plain version runs
the same codec as the kernel.

The producers ``matmul``, ``dual_matmul`` and ``decode_attention`` take
``out_fmt=`` (and ``encode_impl=`` for its codec): the kernel encodes its
output in its flush and returns the out format's packed bits, equal bit for
bit to ``encode(<the unfused output>, out_fmt, encode_impl)`` (the contract
of ``ref.fused_matmul_ref``).  A fused launch that cannot run raises; it
never gives way to the unfused kernel followed by ``encode``.

Under a :func:`repro_torch.core.telemetry.capture` every op is observed as
in ``repro`` (``_observed``): one ``kernel.calls.<op>.<fmt>`` counter a
call, ``kernel.wire_bytes.<op>`` charged with the packed bytes it moved
(the packed operands, and the packed output of ``encode``, ``encode_into``
and the ``out_fmt`` producers), and a ``kernel.<op>.<fmt>`` span of category
``kernel`` timed by a pair of CUDA events around the launch on the card.
The port's own entries take their own ``op`` names: ``encode_into``,
``decode_rows`` (charged the rows it reads) and ``matmul_t``.  These count
calls of the ops; the kernels actually launched stay :func:`launch_counts`
(K5's autograd Function calls its wrappers directly, unobserved).
Outside a capture an op adds nothing.

t32 (a takum wider than 16 bits) has no kernel, as no Pallas codec of
``repro`` covers it (``repro``'s ``_kernel_fmt_ok``): ``encode`` / ``decode``
of t32 and every op over t32 operands take the plain PyTorch versions on any
device, as ``repro`` takes its jnp reference; ``out_fmt="t32"`` runs the
producer's kernel with f32 output and then the plain t32 encode, which is
``encode(<the unfused output>, "t32")`` by construction.  Each route is
chosen by format, never by a failure, and the launch counts show it.  The
codec knobs are not read for t32 (as in ``repro``).

On CUDA tensors the ops launch the kernels; on CPU tensors the kernel
wrappers take their plain versions.  Inside ``with plain_path():`` every op
takes its plain version on any device: it is the explicit reference mode
``chip_smoke.py`` holds the kernel path against, never a fallback taken on
an error.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import telemetry
from repro_torch.core.formats import kernel_wire_names, wire_format
from .lut import DECODE_IMPLS, resolve_impl
from .takum_attention import decode_attention_plain, takum_decode_attention
from .takum_codec import (decode_2d_plain, decode_rows_plain, encode_2d_plain, encode_into_plain,
                          takum_decode_2d, takum_decode_rows, takum_encode_2d, takum_encode_into)
from .takum_matmul import (takum_dual_matmul, takum_dual_matmul_plain, takum_matmul,
                           takum_matmul_plain, takum_matmul_t, takum_matmul_t_plain)

#: None: the ops launch the kernels; else they take the plain versions,
#: the plain matmul accumulating in this dtype (see :func:`plain_path`)
_PLAIN_ACC = None

#: every kernel wrapper; each counts its launches per codec in ``.launches``
WRAPPERS = (takum_decode_2d, takum_encode_2d, takum_encode_into, takum_decode_rows, takum_matmul,
            takum_dual_matmul, takum_decode_attention)
#: every unfused kernel, named ``wrapper[impl]`` (e.g. ``takum_matmul[lut]``):
#: one per wrapper and codec, each a template instantiation of its own.  A
#: fused producer launch counts under ``wrapper[impl>out_fmt:encode_impl]``
#: (e.g. ``takum_matmul[lut>t8:lut]``), and K5's backward (K3 over the
#: stored weight, transposed) under ``takum_matmul[impl^T]``: keys that exist
#: once launched.
KERNELS = {f"{fn.__name__}[{impl}]": (fn, impl) for fn in WRAPPERS for impl in DECODE_IMPLS}


@contextlib.contextmanager
def plain_path(acc: torch.dtype = torch.float32):
    """Route every op through its plain version inside the ``with`` block.
    ``acc=torch.float64`` accumulates the plain matmuls in float64, an
    equally valid summation order: how far that moves a model's logits is
    the model's own sensitivity to order."""
    global _PLAIN_ACC
    saved, _PLAIN_ACC = _PLAIN_ACC, acc
    try:
        yield
    finally:
        _PLAIN_ACC = saved


def plain_acc():
    """The accumulation dtype of the plain versions inside
    :func:`plain_path`, or None outside it (the kernels run)."""
    return _PLAIN_ACC


def plain_only(fmt) -> bool:
    """True for a takum wider than 16 bits (t32): no kernel codec moves it,
    so the ops take its plain version on any device."""
    wf = wire_format(fmt)
    return wf.family == "takum" and wf.nbits > 16


def _split_out(out_fmt):
    """A producer's ``out_fmt`` -> (the format its kernel encodes, the
    format encoded after it by the plain codec): (out_fmt, None), or (None,
    t32) for a plain-only out format."""
    if out_fmt is None or not plain_only(out_fmt):
        return out_fmt, None
    return None, wire_format(out_fmt)


def _plain_encode(x: torch.Tensor, wf) -> torch.Tensor:
    """The plain encode of a plain-only format, packed."""
    return wf.pack(wf.encode(x.to(torch.float32)))


def _finish_out(out: torch.Tensor, after) -> torch.Tensor:
    return out if after is None else _plain_encode(out, after)


def supported_wire_formats() -> tuple[str, ...]:
    """The registered wire formats every op routes to its kernel
    (``repro``'s ``supported_wire_formats``): those of
    ``kernel_wire_names()`` whose default codec resolves."""
    out = []
    for name in kernel_wire_names():
        try:
            resolve_impl(None, name)
        except (KeyError, ValueError):
            continue
        out.append(name)
    return tuple(out)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel of :data:`KERNELS`, and of each fused
    producer or transposed K3 launched, since the last
    :func:`reset_launch_counts`."""
    return {f"{fn.__name__}[{key}]": n for fn in WRAPPERS for key, n in fn.launches.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = dict.fromkeys(DECODE_IMPLS, 0)


def _nbytes(*ts) -> float:
    """Bytes of tensors (a number counts as itself)."""
    return float(sum(t if isinstance(t, (int, float)) else t.numel() * t.element_size()
                     for t in ts))


def _observed(op: str, name: str, device, call, *wire, out_is_wire: bool = False):
    """Run ``call()``, observed under a telemetry capture (see the module
    docstring): the call counter, the wire bytes of ``wire`` (and of the
    output, or outputs, when ``out_is_wire``), and the ``kernel.<op>.<fmt>``
    span, CUDA events on ``device``.  Outside a capture it only runs
    ``call()``."""
    if not telemetry.enabled():
        return call()
    telemetry.emit(f"kernel.calls.{op}.{name}", 1.0)
    with telemetry.trace_span(f"kernel.{op}.{name}", cat="kernel", device=device):
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = _nbytes(*wire) + (_nbytes(*outs) if out_is_wire else 0.0)
    if nbytes:
        telemetry.emit(f"kernel.wire_bytes.{op}", nbytes)
    return out


def _as_2d(x: torch.Tensor):
    """ND -> 2-D view for the element-wise codec kernels.  Returns
    ``(x2d, orig_shape_or_None)``; 0-d becomes [1, 1], 1-D one row, >= 3-D
    folds the leading dims onto the rows (counted, so that an empty tensor
    such as [2, 3, 0] becomes [6, 0])."""
    if x.dim() == 2:
        return x, None
    if x.dim() == 0:
        return x.reshape(1, 1), x.shape
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1]), x.shape


def _reshape_back(out: torch.Tensor, shape) -> torch.Tensor:
    """Undo :func:`_as_2d`, keeping the codec's last axis (an mx encode
    grows it by 33/32, a decode shrinks it)."""
    if shape is None:
        return out
    if not shape:
        return out.reshape(())
    return out.reshape(*shape[:-1], out.shape[-1])


def _check_mx_payload(bits: torch.Tensor, wf, what: str) -> None:
    """An mx payload is whole 33-byte ``[scale | 32 elems]`` groups on its
    last axis; anything else is truncated or misaligned and would shear
    scale bytes into element lanes, so it is rejected."""
    if not wf.is_block_scaled:
        return
    if bits.dim() == 0:
        raise ValueError(f"{what} for block-scaled format {wf.name!r} is 0-d: a payload is "
                         f"whole 33-byte groups along a last axis")
    L = bits.shape[-1]
    if L == 0 or L % 33:
        raise ValueError(
            f"{what} for block-scaled format {wf.name!r} has last dim {L}, not a "
            f"(nonzero) multiple of 33: the payload is truncated or misaligned")


def _check_mx_encode_input(x: torch.Tensor, wf) -> None:
    """An mx encode quantises whole 32-element blocks of the last axis
    (callers that own the logical shape pad with ``blockscale.pad_block``)."""
    if not wf.is_block_scaled:
        return
    if x.dim() == 0:
        raise ValueError(f"encode to block-scaled format {wf.name!r} needs a last axis of "
                         f"whole 32-element blocks, got a 0-d tensor")
    n = x.shape[-1]
    if n == 0 or n % 32:
        raise ValueError(
            f"encode to block-scaled format {wf.name!r} needs a last dim that is a "
            f"(nonzero) multiple of 32, got {n} (zero-pad with blockscale.pad_block)")


def encode(x: torch.Tensor, fmt, encode_impl=None) -> torch.Tensor:
    """float32 [...] -> packed wire bits of the same shape (K2); an mx format
    gives the payload, last dim n -> n/32*33."""
    wf = wire_format(fmt)
    if plain_only(wf):
        return _observed("encode", wf.name, x.device, lambda: _plain_encode(x, wf),
                         out_is_wire=True)
    _check_mx_encode_input(x, wf)
    impl = resolve_impl(encode_impl, wf, "encode")

    def call():
        x2, shape = _as_2d(x.to(torch.float32).contiguous())
        out = takum_encode_2d(x2, wf, impl) if _PLAIN_ACC is None else encode_2d_plain(x2, wf,
                                                                                       impl)
        return _reshape_back(out, shape)

    return _observed("encode", wf.name, x.device, call, out_is_wire=True)


def decode(bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """Packed wire bits [...] -> float32 of the same shape (K1); an mx
    payload's last dim L becomes L/33*32."""
    wf = wire_format(fmt)
    if plain_only(wf):
        return _observed("decode", wf.name, bits.device, lambda: wf.decode(bits), bits)
    _check_mx_payload(bits, wf, "decode payload")
    impl = resolve_impl(decode_impl, wf)

    def call():
        b2, shape = _as_2d(bits.contiguous())
        out = takum_decode_2d(b2, wf, impl) if _PLAIN_ACC is None else decode_2d_plain(b2, wf,
                                                                                       impl)
        return _reshape_back(out, shape)

    return _observed("decode", wf.name, bits.device, call, bits)


def encode_into(srcs, dsts, fmt, encode_impl=None) -> None:
    """K2 of one or two [R, C] sources (f32 or bf16) written into 2-D
    strided destinations in one launch; see
    :func:`~repro_torch.kernels.takum_codec.takum_encode_into`."""
    wf = wire_format(fmt)
    impl = resolve_impl(encode_impl, wf, "encode")

    def call():
        (takum_encode_into if _PLAIN_ACC is None else encode_into_plain)(srcs, dsts, wf, impl)
        return tuple(dsts)

    _observed("encode_into", wf.name, dsts[0].device, call, out_is_wire=True)


def decode_rows(bits: torch.Tensor, rows: torch.Tensor, fmt, decode_impl=None, scale=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """K1 over the rows of ``bits`` [V, L] that ``rows`` picks, times
    ``scale``, in ``out_dtype``; see
    :func:`~repro_torch.kernels.takum_codec.takum_decode_rows`."""
    wf = wire_format(fmt)
    _check_mx_payload(bits, wf, "decode_rows bits")
    impl = resolve_impl(decode_impl, wf)

    def call():
        fn = takum_decode_rows if _PLAIN_ACC is None else decode_rows_plain
        return fn(bits, rows, wf, impl, scale, out_dtype)

    if not telemetry.enabled():
        return call()
    row_bytes = bits[0].numel() * bits.element_size() if bits.dim() else 0
    return _observed("decode_rows", wf.name, bits.device, call, rows.numel() * row_bytes)


def matmul(x: torch.Tensor, w_bits: torch.Tensor, fmt, n=None, decode_impl=None, out_fmt=None,
           encode_impl=None) -> torch.Tensor:
    """x [M, K] @ decode(w_bits [K, N]) -> [M, N] float32 (K3), or with
    ``out_fmt`` its packed encode (an mx out: the payload [M, N/32*33]).  An
    mx ``w_bits`` is the payload [K, ceil(N/32)*33]; ``n`` is its logical N."""
    wf = wire_format(fmt)
    _check_mx_payload(w_bits, wf, "matmul w_bits")
    impl = "bits" if plain_only(wf) else resolve_impl(decode_impl, wf)
    kernel_out, after = _split_out(out_fmt)

    def call():
        if _PLAIN_ACC is None and not plain_only(wf):
            out = takum_matmul(x.contiguous(), w_bits.contiguous(), wf, n, impl, kernel_out,
                               encode_impl)
        else:
            out = takum_matmul_plain(x, w_bits, wf, n, _PLAIN_ACC or torch.float32, impl,
                                     kernel_out, encode_impl)
        return _finish_out(out, after)

    return _observed("matmul", wf.name, x.device, call, w_bits,
                     out_is_wire=out_fmt is not None)


def matmul_t(x: torch.Tensor, w_bits: torch.Tensor, fmt, decode_impl=None) -> torch.Tensor:
    """x [M, K] float32 @ decode(w_bits [N, K]).T -> [M, N] float32: the
    transposed K3 (K5's backward launch), reading the stored bits in place;
    flat formats only.  Counts on ``takum_matmul`` under ``"impl^T"``."""
    wf = wire_format(fmt)
    impl = "bits" if plain_only(wf) else resolve_impl(decode_impl, wf)

    def call():
        if _PLAIN_ACC is None and not plain_only(wf):
            return takum_matmul_t(x.contiguous(), w_bits.contiguous(), fmt, impl)
        return takum_matmul_t_plain(x, w_bits, wf, _PLAIN_ACC or torch.float32, impl)

    return _observed("matmul_t", wf.name, x.device, call, w_bits)


def dual_matmul(x_bits: torch.Tensor, w_bits: torch.Tensor, fmt, n=None, decode_impl=None,
                out_fmt=None, encode_impl=None) -> torch.Tensor:
    """decode(x_bits [M, K]) @ decode(w_bits [K, N]) -> [M, N] float32 (K4,
    the VDPPT analogue), or with ``out_fmt`` its packed encode.  Both operands
    are ``fmt``; an mx ``x_bits`` is the payload [M, K/32*33], an mx
    ``w_bits`` [K, ceil(N/32)*33] with ``n`` its logical N."""
    wf = wire_format(fmt)
    _check_mx_payload(x_bits, wf, "dual_matmul x_bits")
    _check_mx_payload(w_bits, wf, "dual_matmul w_bits")
    impl = "bits" if plain_only(wf) else resolve_impl(decode_impl, wf)
    kernel_out, after = _split_out(out_fmt)

    def call():
        if _PLAIN_ACC is None and not plain_only(wf):
            out = takum_dual_matmul(x_bits.contiguous(), w_bits.contiguous(), wf, n, impl,
                                    kernel_out, encode_impl)
        else:
            out = takum_dual_matmul_plain(x_bits, w_bits, wf, n, _PLAIN_ACC or torch.float32,
                                          impl, kernel_out, encode_impl)
        return _finish_out(out, after)

    return _observed("dual_matmul", wf.name, x_bits.device, call, x_bits, w_bits,
                     out_is_wire=out_fmt is not None)


def decode_attention(q, k_bits, v_bits, fmt, *, length=None, window=0, softcap=0.0,
                     scale=None, decode_impl=None, out_fmt=None,
                     encode_impl=None) -> torch.Tensor:
    """One-token GQA decode attention over a packed KV cache (K6), or with
    ``out_fmt`` its packed encode; see
    :func:`~repro_torch.kernels.takum_attention.takum_decode_attention`."""
    wf = wire_format(fmt)
    _check_mx_payload(k_bits, wf, "decode_attention k_bits")
    _check_mx_payload(v_bits, wf, "decode_attention v_bits")
    impl = "bits" if plain_only(wf) else resolve_impl(decode_impl, wf)
    kernel_out, after = _split_out(out_fmt)

    def call():
        kernel = _PLAIN_ACC is None and not plain_only(wf)
        fn = takum_decode_attention if kernel else decode_attention_plain
        out = fn(q.contiguous(), k_bits, v_bits, wf, length, window, softcap, scale, impl,
                 kernel_out, encode_impl)
        return _finish_out(out, after)

    return _observed("decode_attention", wf.name, q.device, call, k_bits, v_bits,
                     out_is_wire=out_fmt is not None)
