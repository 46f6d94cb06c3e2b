"""Executable semantics of the proposed takum vector ISA (paper Tables I-V),
the counterpart of ``repro.core.isa``: the same fifteen families under the
same names, arguments, output dtypes and NaR semantics, over *packed* takum
tensors (uint8 / uint16 / uint32 bit patterns, :func:`takum.storage_dtype`).

Where the codes live the ISA runs: on the card for CUDA tensors, on the host
for CPU tensors.  Inputs that are not tensors (numpy arrays, lists) go to
``device`` (default: the card, :func:`repro_torch.device.resolve_device`).

* Arithmetic is decode -> IEEE f32 compute -> encode, as a takum ALU with an
  internal linear representation would do it.  Linear t8 and t16 decode and
  encode through ``kernels.ops`` (K1 and K2 on the card, their plain
  versions on the host: the same bits); t32 and ``mode="log"`` through the
  plain codec of ``core/takum.py``, as ``repro`` has no kernel for them.
  The f32 steps are ``repro``'s as XLA's CPU backend computes them: no FMA
  contraction (``vfmaddt`` rounds ``x * y`` before adding ``z``), and a
  product below 2**-126 flushes to zero before it is added (``vfmaddt``,
  ``vdppt``), where torch would keep the subnormal.
* Compare, min, max, negate, absolute value and the takum-to-takum
  conversions need **no decode** (the paper's section IV-A): n-bit patterns
  read as two's-complement integers order like the values, negation is the
  two's complement, and takum(m) is takum(n)'s prefix, so widening is a left
  shift and narrowing rounds the bit string.  They are integer ops on either
  device, in the signed container of the codes' storage dtype (int8 / int16
  / int32), the n-bit pattern sign-extended there.
* ``vdppt`` is the widening dot product VDPPT{n}PT{2n}: decode, multiply and
  sum along the last axis in f32, encode once to takum-2n.  It broadcasts,
  so ``vdppt(a[:, None, :], b[None, :, :], 8)`` is the matrix form, which
  K4 tiles on the card (``ops.dual_matmul(a8, bT8, "t8", out_fmt="t16")``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from . import takum
from .takum import codes_of, pack

__all__ = [
    "vaddt", "vsubt", "vmult", "vdivt", "vfmaddt", "vsqrtt",
    "vcmpt", "vmint", "vmaxt", "vabst", "vnegt",
    "vcvtt2t", "vcvtps2pt", "vcvtpt2ps",
    "vdppt", "REGISTRY",
]

#: widths whose linear codec has a wire format (``kernels.ops``)
_WIRE_WIDTHS = (8, 16, 32)
_F32_MIN_NORMAL = 2.0 ** -126


def _tensor(a, device=None) -> torch.Tensor:
    """A tensor where it lies (moved when ``device`` is given); anything else
    as a tensor on ``device`` (the card by default).  Unsigned 16/32-bit
    numpy codes cross through their signed view."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(torch.device(device))
    dev = resolve_device(device)
    arr = np.asarray(a)
    signed = {np.dtype(np.uint16): (np.int16, torch.uint16),
              np.dtype(np.uint32): (np.int32, torch.uint32)}.get(arr.dtype)
    if signed is None:
        return torch.as_tensor(arr).to(dev)
    return torch.from_numpy(np.ascontiguousarray(arr).view(signed[0])).to(dev).view(signed[1])


def _decode(a, n: int, mode: str) -> torch.Tensor:
    """Packed takum-n -> float32: ``ops.decode`` for the wire widths in
    linear mode (K1 on the card for t8 / t16), else the plain codec."""
    if mode == "linear" and n in _WIRE_WIDTHS:
        return ops.decode(_packed(a, n), f"t{n}")
    return takum.takum_decode(a, n, mode)


def _encode(x: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """float32 -> packed takum-n: ``ops.encode`` for the wire widths in
    linear mode (K2 on the card for t8 / t16), else the plain codec."""
    if mode == "linear" and n in _WIRE_WIDTHS:
        return ops.encode(x, f"t{n}")
    return pack(takum.takum_encode(x.to(torch.float32), n, mode), n)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """f32 results below 2**-126 to zero, as XLA's CPU backend flushes them."""
    return torch.where(x.abs() < _F32_MIN_NORMAL, torch.zeros_like(x), x)


def _arith(op, doc: str):
    def f(a, b, n: int, *, mode: str = "linear", device=None):
        x = _decode(_tensor(a, device), n, mode)
        y = _decode(_tensor(b, device), n, mode)
        return _encode(op(x, y), n, mode)

    f.__doc__ = doc
    return f


vaddt = _arith(torch.add, "VADDT: a + b, one takum rounding.")
vsubt = _arith(torch.sub, "VSUBT: a - b, one takum rounding.")
vmult = _arith(torch.mul, "VMULT: a * b, one takum rounding.")
vdivt = _arith(torch.div, "VDIVT: a / b, one takum rounding (x / 0 is NaR).")


def vfmaddt(a, b, c, n: int, *, mode: str = "linear", device=None):
    """T-format FMA: a*b + c in f32 (two f32 roundings, a subnormal product
    flushed, as ``repro`` computes it), then one takum rounding."""
    x, y, z = (_decode(_tensor(v, device), n, mode) for v in (a, b, c))
    return _encode(_ftz(x * y) + z, n, mode)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's is: taken in float64
    and rounded once more to f32, which is exact for a square root (53 >=
    2 * 24 + 2 bits), where torch's f32 ``sqrt`` on the host is an ulp off on
    about 0.7 % of inputs."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def vsqrtt(a, n: int, *, mode: str = "linear", device=None):
    """VSQRTT: sqrt(a), correctly rounded in f32 (a negative value gives NaR)."""
    return _encode(_sqrt_f32(_decode(_tensor(a, device), n, mode)), n, mode)


# --- decode-free integer-domain ops (the paper's section IV-A) --------------

_SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16, torch.uint32: torch.int32}


def _packed(a, n: int, device=None) -> torch.Tensor:
    """Codes in :func:`takum.storage_dtype` (n): codes of another integer
    dtype are read by value, as ``repro``'s ``astype(uint32)`` reads them."""
    a = _tensor(a, device)
    return a if a.dtype == takum.storage_dtype(n) else pack(codes_of(a), n)


def _keys(a: torch.Tensor, n: int) -> torch.Tensor:
    """Packed takum-n -> keys that order like the values, in the signed
    container of the same width: the n-bit pattern sign-extended by a shift
    left and an arithmetic shift right (none where n fills the container)."""
    k = a.view(_SIGNED[a.dtype])
    sh = 8 * a.element_size() - n
    return (k << sh) >> sh if sh else k


def _store(k: torch.Tensor, n: int) -> torch.Tensor:
    """Keys in the signed container of takum-n -> its packed patterns (the
    low n bits)."""
    if n < 8 * k.element_size():
        k = k & ((1 << n) - 1)
    return k.view(takum.storage_dtype(n))


def vnegt(a, n: int, *, device=None):
    """Negate = two's complement; no decode (NaR and 0 map to themselves)."""
    return _store(torch.neg(_keys(_packed(a, n, device), n)), n)


def vabst(a, n: int, *, device=None):
    """|a|: the negation of the codes whose key is negative (NaR stays NaR)."""
    k = _keys(_packed(a, n, device), n)
    return _store(torch.where(k < 0, torch.neg(k), k), n)


_CMP = {"lt": torch.lt, "le": torch.le, "eq": torch.eq,
        "gt": torch.gt, "ge": torch.ge, "ne": torch.ne}


def vcmpt(a, b, n: int, op: str = "lt", *, device=None):
    """Compare takums as two's-complement ints (NaR = most negative =
    smallest); a bool tensor."""
    cmp = _CMP[op]  # KeyError for an unknown predicate, as repro's dict lookup
    return cmp(_keys(_packed(a, n, device), n), _keys(_packed(b, n, device), n))


def _select(a, b, n: int, cmp, device):
    ka, kb = _keys(_packed(a, n, device), n), _keys(_packed(b, n, device), n)
    return _store(torch.where(cmp(ka, kb), ka, kb), n)


def vmint(a, b, n: int, *, device=None):
    """min(a, b) by the integer order (NaR is the minimum)."""
    return _select(a, b, n, torch.lt, device)


def vmaxt(a, b, n: int, *, device=None):
    """max(a, b) by the integer order."""
    return _select(a, b, n, torch.gt, device)


# --- conversions -------------------------------------------------------------


def vcvtt2t(a, m: int, n: int, *, device=None):
    """takum(m) -> takum(n).  Widening is exact (a left shift); narrowing
    rounds the dropped bits (RNE on the bit string) with saturation away
    from 0 and NaR.  ``repro``'s steps on the keys, in the signed container
    of the wider format."""
    k = _keys(_packed(a, m, device), m)
    if n == m:
        return _store(k.clone(), n)
    if n > m:
        return _store(k.to(_SIGNED[takum.storage_dtype(n)]) << (n - m), n)
    t = m - n
    neg = k < 0
    mag = torch.where(neg, torch.neg(k), k)
    kept = mag >> t
    guard = (mag >> (t - 1)) & 1
    sticky = (mag & ((1 << (t - 1)) - 1)) != 0
    kept = kept + ((guard == 1) & (sticky | ((kept & 1) == 1))).to(kept.dtype)
    kept = kept.clamp(1, (1 << (n - 1)) - 1)
    out = torch.where(neg, torch.neg(kept), kept)
    out = torch.where(k == 0, torch.zeros_like(out), out)
    out = torch.where(k == -(1 << (m - 1)), torch.full_like(out, -(1 << (n - 1))), out)
    return _store(out.to(_SIGNED[takum.storage_dtype(n)]), n)


def vcvtps2pt(x, n: int, *, mode: str = "linear", device=None):
    """float32 -> packed takum-n (VCVTPS322PT*)."""
    return _encode(_tensor(x, device).to(torch.float32), n, mode)


def vcvtpt2ps(a, n: int, *, mode: str = "linear", device=None):
    """packed takum-n -> float32 (VCVTPT*2PS32)."""
    return _decode(_tensor(a, device), n, mode)


# --- widening dot products (paper group F08 -> PF3) --------------------------


def vdppt(a, b, n_in: int, *, mode: str = "linear", device=None):
    """VDPPT{n}PT{2n}: dot product of takum-n vectors along the last axis,
    accumulated in f32 (the 'internal wide accumulator'; products below
    2**-126 flushed), rounded once into takum-2n.  K4 is the tiled form on
    the card (``ops.dual_matmul`` with ``out_fmt``)."""
    x = _decode(_tensor(a, device), n_in, mode)
    y = _decode(_tensor(b, device), n_in, mode)
    return _encode(torch.sum(_ftz(x * y), dim=-1), 2 * n_in, mode)


REGISTRY = {
    # family name (paper's proposed mnemonic pattern) -> callable
    "VADDT": vaddt,
    "VSUBT": vsubt,
    "VMULT": vmult,
    "VDIVT": vdivt,
    "VFMADDT": vfmaddt,
    "VSQRTT": vsqrtt,
    "VNEGT": vnegt,
    "VABST": vabst,
    "VCMPT": vcmpt,
    "VMINT": vmint,
    "VMAXT": vmaxt,
    "VCVTT2T": vcvtt2t,
    "VCVTPS2PT": vcvtps2pt,
    "VCVTPT2PS": vcvtpt2ps,
    "VDPPT": vdppt,
}
