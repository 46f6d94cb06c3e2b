"""OCP-MX block scaling in plain PyTorch (counterpart of
``repro.quant.blockscale``): one shared E8M0 scale byte per block of 32
elements of an 8-bit element format (``mxe4m3``/``mxe5m2`` are OCP MXFP8,
``mxt8`` the same container around takum8).

Semantics, those of ``repro``'s jnp functions (and so of its kernels):

* **Scale** (absmax): the E8M0 byte is the biased f32 exponent of the
  block's absmax minus the element format's ``elem_emax``, clipped to
  1..254.  A zero or subnormal absmax gives byte 127 (scale 1.0, the
  all-zero block); an Inf or NaN in the block gives byte 255, and every
  element of that block is stored as bits 0 and decodes to NaN.  Byte 0 is
  never emitted and decodes clamped to 2^-126.
* **Elements** are scaled by the exact power of two 2^(127 - byte), clamped
  to the element format's largest value below 2^(elem_emax + 1)
  (:func:`elem_cap`: 448, 57344, 1.875) and encoded RNE.
* **DAZ/FTZ.**  ``repro`` runs on XLA's CPU backend, which flushes f32
  subnormal inputs and results to signed zero, with tininess judged before
  rounding.  torch keeps subnormals, so the flush is explicit here, by a
  test on the exponent field: an element whose exact scaled value lies
  below 2^-126 (or which is itself subnormal) is scaled to signed zero, and
  a decoded product below 2^-126 becomes signed zero.  (``repro``'s float64
  oracle ``decode_payload_np`` keeps such products, so it disagrees with
  its own jnp and Pallas paths there; the port follows the latter.)

**Payload**: one uint8 buffer whose last axis holds 33-byte groups
``[s, e0..e31]``, the scale byte beside its 32 element bytes.  Blocking is
along the last axis, a multiple of 32 at the codec level; :func:`pad_block`
zero-pads (zero padding never moves a block's scale and decodes to zeros).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.formats import wire_format
from repro_torch.core.takum import pow2_f32

BLOCK = 32  #: OCP MX block size
GROUP = BLOCK + 1  #: payload bytes per block: 1 scale byte + 32 element bytes
E8M0_NAN = 255  #: NaN-scale byte (the whole block decodes to NaN)
E8M0_BIAS = 127
E8M0_ZERO_BLOCK = 127  #: scale byte of an all-zero block (scale 1.0)


def _bs(fmt):
    """Resolve to a registered block-scaled format, loudly."""
    wf = wire_format(fmt)
    if not wf.is_block_scaled:
        raise ValueError(f"{wf.name!r} is not a block-scaled wire format")
    return wf


def padded_len(n: int) -> int:
    """Smallest multiple of BLOCK >= n."""
    return -(-n // BLOCK) * BLOCK


def payload_len(n: int) -> int:
    """Payload bytes for n elements (n padded to a block multiple)."""
    return (padded_len(n) // BLOCK) * GROUP


def elems_len(payload_cols: int) -> int:
    """Element count carried by a payload of ``payload_cols`` bytes."""
    if payload_cols % GROUP:
        raise ValueError(f"block payload length {payload_cols} is not a multiple of {GROUP}")
    return (payload_cols // GROUP) * BLOCK


def pad_block(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Zero-pad the last axis up to a BLOCK multiple (no-op when aligned)."""
    n = x.shape[-1] if n is None else n
    pad = padded_len(n) - n
    return x if pad == 0 else F.pad(x, (0, pad))


def _exponent_field(x: torch.Tensor) -> torch.Tensor:
    """Biased exponent field (0..255) of each float32 in ``x``, as int32."""
    return (x.to(torch.float32).contiguous().view(torch.int32) >> 23) & 0xFF


def _flush_tiny(x: torch.Tensor) -> torch.Tensor:
    """FTZ: f32 values whose exponent field is 0 become signed zero."""
    return torch.where(_exponent_field(x) == 0, x * 0.0, x)


def e8m0_decode(scale_bytes: torch.Tensor) -> torch.Tensor:
    """E8M0 byte -> f32 scale: 2**(b - 127); 255 -> NaN; 0 clamps to 2**-126."""
    b = scale_bytes.to(torch.int64)
    s = pow2_f32((b - E8M0_BIAS).clamp(-126, 127))
    return torch.where(b == E8M0_NAN, torch.full_like(s, float("nan")), s)


def scale_bytes(amax: torch.Tensor, elem_emax: int) -> torch.Tensor:
    """Per-block absmax (f32, >= 0 or NaN) -> E8M0 scale byte (uint8)."""
    e = _exponent_field(amax)
    byte = (e - elem_emax).clamp(1, 254)
    byte = torch.where(e == 0, torch.full_like(byte, E8M0_ZERO_BLOCK), byte)
    byte = torch.where(e == 255, torch.full_like(byte, E8M0_NAN), byte)
    return byte.to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _elem_cap(name: str) -> float:
    wf = _bs(name)
    top = 2.0 ** (wf.elem_emax + 1)
    vals = wf.elem.decode(torch.arange(1 << (wf.elem.nbits - 1), dtype=torch.int64))
    return float(vals[torch.isfinite(vals) & (vals < top)].max())


def elem_cap(fmt) -> float:
    """The element format's largest value below ``2**(elem_emax + 1)``: the
    saturation rail of the element conversion."""
    return _elem_cap(_bs(fmt).name)


def block_quantize(x: torch.Tensor, fmt, elem_encode=None):
    """f32 [..., n] (n % 32 == 0) -> (scales [..., n/32] uint8, bits [..., n] uint8).
    ``elem_encode`` (f32 -> int64 codes) replaces the element format's bits
    encode, e.g. by its table encode; it sees values already clamped to the
    element cap, so a non-saturating encoder is exact here."""
    wf = _bs(fmt)
    n = x.shape[-1]
    if n % BLOCK:
        raise ValueError(f"block-scaled last axis must be a multiple of {BLOCK}, got {n}")
    xb = x.to(torch.float32).reshape(*x.shape[:-1], n // BLOCK, BLOCK)
    amax = xb.abs().amax(dim=-1)  # NaN propagates -> NaN-scale block
    sb = scale_bytes(amax, wf.elem_emax)
    # divide by the scale as an exact power-of-two multiply; 127 - byte in
    # [-128, 126] needs the two-step split (one pow2_f32 clips at -126)
    k = E8M0_BIAS - sb.to(torch.int64)
    ka = k.clamp(-126, 127)
    xs = xb * pow2_f32(ka)[..., None] * pow2_f32(k - ka)[..., None]
    # DAZ in, FTZ out (tininess before rounding): an element that is itself
    # subnormal, or whose exact scaled value is below 2^-126, becomes signed
    # zero; every other product above is exact
    tiny = (_exponent_field(xb) == 0) | (_exponent_field(xb) + k[..., None] <= 0)
    xs = torch.where(tiny, xb * 0.0, xs)
    cap = elem_cap(wf)
    xs = xs.clamp(-cap, cap)  # the saturating MX conversion
    bits = (elem_encode or wf.elem.encode)(xs).to(torch.int64)
    # NaN-scale blocks carry zero element bits (decode is NaN regardless)
    bits = torch.where((sb == E8M0_NAN)[..., None], torch.zeros_like(bits), bits)
    return sb, bits.reshape(x.shape).to(torch.uint8)


def block_dequantize(scales: torch.Tensor, bits: torch.Tensor, fmt, elem_decode=None):
    """(scales [..., n/32], bits [..., n]) -> f32 [..., n]: ``scale * element``
    in f32, products below 2^-126 flushed; NaN-scale blocks are all NaN.
    ``elem_decode`` replaces the element format's bits decode (e.g. by its
    table gather)."""
    wf = _bs(fmt)
    n = bits.shape[-1]
    vals = (elem_decode or wf.elem.decode)(bits).reshape(*bits.shape[:-1], n // BLOCK, BLOCK)
    out = _flush_tiny(vals * e8m0_decode(scales)[..., None])
    return out.reshape(*bits.shape[:-1], n)


def pack_payload(scales: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(scales [..., nb], bits [..., nb*32]) -> payload uint8 [..., nb*33],
    each 33-byte group ``[scale, e0..e31]``."""
    nb = scales.shape[-1]
    grp = torch.cat([scales[..., None].to(torch.uint8),
                     bits.reshape(*bits.shape[:-1], nb, BLOCK).to(torch.uint8)], dim=-1)
    return grp.reshape(*scales.shape[:-1], nb * GROUP)


def unpack_payload(payload: torch.Tensor):
    """payload uint8 [..., nb*33] -> (scales [..., nb], bits [..., nb*32])."""
    nb = elems_len(payload.shape[-1]) // BLOCK
    grp = payload.reshape(*payload.shape[:-1], nb, GROUP)
    return grp[..., 0], grp[..., 1:].reshape(*payload.shape[:-1], nb * BLOCK)


def encode_payload(x: torch.Tensor, fmt, elem_encode=None) -> torch.Tensor:
    """f32 [..., n] (n % 32 == 0) -> interleaved payload uint8 [..., n/32*33]."""
    return pack_payload(*block_quantize(x, fmt, elem_encode))


def decode_payload(payload: torch.Tensor, fmt, elem_decode=None) -> torch.Tensor:
    """Interleaved payload [..., L] -> f32 [..., L/33*32]."""
    scales, bits = unpack_payload(payload)
    return block_dequantize(scales, bits, fmt, elem_decode)
