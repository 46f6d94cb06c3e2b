"""float64 numpy oracles of every registered wire format (counterpart of
``repro.core.formats.WireFormat.encode_np`` / ``decode_np``), what the
checkpoint manager packs and unpacks float leaves with.

``repro`` takes the IEEE and OFP8 oracles from ``ml_dtypes``, which the
port does not import; these are written out and held against
``ml_dtypes`` in ``tests/test_torch_ckpt.py``:

* OFP8 (E4M3 / E5M2): round to nearest even straight from float64,
  non-saturating (E4M3 overflow and Inf become NaN, E5M2 overflow becomes
  Inf), NaN keeps its sign (E4M3 ``S.1111.111``, E5M2 ``S.11111.10``),
  no DAZ;
* bf16: the float64 value rounded to f32, then RNE on the bits, subnormals
  kept, NaN ``sign | 0x7FC0`` (``ml_dtypes`` goes through f32 as well);
* f32: a cast; takum: :mod:`.takum_np`;
* the mx containers: ``repro.quant.blockscale.encode_payload_np`` /
  ``decode_payload_np``, f32-DAZ on the inputs and on the scaled elements.

Encoders return the codes in an unsigned numpy dtype, decoders float64.
"""

from __future__ import annotations

import numpy as np

from . import takum_np

_F32_MIN_NORMAL = 2.0 ** -126

#: (exponent bits, mantissa bits, bias, largest finite magnitude code,
#: NaN magnitude code, the magnitude code overflow and Inf map to)
_OFP8 = {"e4m3": (4, 3, 7, 0x7E, 0x7F, 0x7F), "e5m2": (5, 2, 15, 0x7B, 0x7E, 0x7C)}


def ofp8_encode(x, fmt: str) -> np.ndarray:
    """float64 -> OFP8 codes (uint8), RNE from float64."""
    _, mb, bias, max_mag, nan_mag, inf_mag = _OFP8[fmt]
    x = np.asarray(x, np.float64)
    a = np.abs(x)
    finite = np.isfinite(a)
    safe = np.where(finite & (a > 0), a, 1.0)
    emin = 1 - bias
    e = np.maximum(np.frexp(safe)[1] - 1, emin)  # the binade, floored at the subnormals'
    q = np.rint(safe / np.exp2(e - mb))  # quanta of 2**(e - mb), ties to even
    mag = ((e - emin) << mb) + q.astype(np.int64)  # a carry walks into the exponent
    mag = np.where(a == 0, 0, mag)
    mag = np.where(mag > max_mag, inf_mag, mag)
    mag = np.where(np.isinf(a), inf_mag, mag)
    mag = np.where(np.isnan(x), nan_mag, mag)
    return ((np.signbit(x).astype(np.int64) << 7) | mag).astype(np.uint8)


def ofp8_decode(bits, fmt: str) -> np.ndarray:
    """OFP8 codes -> float64."""
    eb, mb, bias, _, _, _ = _OFP8[fmt]
    b = np.asarray(bits).astype(np.int64)
    e = (b >> mb) & ((1 << eb) - 1)
    m = (b & ((1 << mb) - 1)).astype(np.float64)
    val = np.where(e == 0, m * 2.0 ** (1 - bias - mb),
                   (1.0 + m * 2.0 ** -mb) * np.exp2(e - bias))
    if fmt == "e5m2":
        top = e == (1 << eb) - 1
        val = np.where(top, np.where(m == 0, np.inf, np.nan), val)
    else:
        val = np.where((b & 0x7F) == 0x7F, np.nan, val)
    return np.where((b >> 7) & 1 == 1, -val, val)


def bf16_encode(x) -> np.ndarray:
    """float64 -> bf16 codes (uint16) through f32, RNE on the bits."""
    with np.errstate(over="ignore", invalid="ignore"):
        u = np.asarray(x, np.float64).astype(np.float32).view(np.uint32).astype(np.int64)
    is_nan = (u & 0x7FFFFFFF) > 0x7F800000
    rne = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return np.where(is_nan, ((u >> 16) & 0x8000) | 0x7FC0, rne).astype(np.uint16)


def bf16_decode(bits) -> np.ndarray:
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def f32_encode(x) -> np.ndarray:
    with np.errstate(over="ignore"):
        return np.asarray(x, np.float64).astype(np.float32).view(np.uint32)


def f32_decode(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32).astype(np.float64)


def takum_encode(x, n: int) -> np.ndarray:
    return takum_np.encode(x, n, "linear")


def takum_decode(bits, n: int) -> np.ndarray:
    with np.errstate(over="ignore"):  # the two's-complement negation of a 0-d uint64
        return takum_np.decode(np.asarray(bits).astype(np.uint64), n, "linear")


def _daz(x) -> np.ndarray:
    """f32 DAZ on float64 values: |x| < 2**-126 flushes to a zero of x's sign."""
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) < _F32_MIN_NORMAL, np.copysign(0.0, x), x)


def mx_encode(x, fmt) -> np.ndarray:
    """float64 [..., n] (n % 32 == 0) -> the mx payload (uint8): DAZ, the
    block absmax's biased f32 exponent less the element format's emax as
    the scale byte, the scaled elements rounded through f32 and DAZ'd
    again, saturated at the element cap and encoded."""
    from repro_torch.quant import blockscale as bs

    wf = bs._bs(fmt)
    x = _daz(x)
    n = x.shape[-1]
    if n % bs.BLOCK:
        raise ValueError(f"block-scaled last axis must be a multiple of {bs.BLOCK}, got {n}")
    xb = x.reshape(x.shape[:-1] + (n // bs.BLOCK, bs.BLOCK))
    with np.errstate(invalid="ignore", over="ignore"):
        eb = np.max(np.abs(xb), axis=-1).astype(np.float32).view(np.uint32)
    e = ((eb >> 23) & 0xFF).astype(np.int64)
    byte = np.clip(e - wf.elem_emax, 1, 254)
    byte = np.where(e == 0, bs.E8M0_ZERO_BLOCK, byte)
    byte = np.where(e == 255, bs.E8M0_NAN, byte).astype(np.uint8)
    with np.errstate(over="ignore", invalid="ignore"):
        xs = xb * np.exp2((bs.E8M0_BIAS - byte.astype(np.int64)).astype(np.float64))[..., None]
        xs = _daz(xs.astype(np.float32).astype(np.float64))
    cap = bs.elem_cap(wf)
    xs = np.clip(xs, -cap, cap)
    elem = wf.elem
    bits = takum_encode(_daz(xs), elem.nbits) if elem.family == "takum" else \
        ofp8_encode(xs, elem.name)
    bits = np.where(byte[..., None] == bs.E8M0_NAN, 0, bits.astype(np.uint64))
    grp = np.concatenate([byte[..., None], bits.astype(np.uint8)], axis=-1)
    return grp.reshape(x.shape[:-1] + ((n // bs.BLOCK) * bs.GROUP,))


def mx_decode(payload, fmt) -> np.ndarray:
    """The mx payload -> float64: each element's f32 decode (the decode
    table: takum elements flush and saturate as the kernels do) times its
    block's scale, exactly."""
    from repro_torch.core import tables
    from repro_torch.quant import blockscale as bs

    wf = bs._bs(fmt)
    payload = np.asarray(payload, np.uint8)
    nb = bs.elems_len(payload.shape[-1]) // bs.BLOCK
    grp = payload.reshape(payload.shape[:-1] + (nb, bs.GROUP))
    sb = grp[..., 0].astype(np.int64)
    vals = tables.decode_table_f32(wf.elem_name).numpy()[grp[..., 1:]].astype(np.float64)
    scale = np.exp2(np.clip(sb - bs.E8M0_BIAS, -126, 127).astype(np.float64))
    scale = np.where(sb == bs.E8M0_NAN, np.nan, scale)
    with np.errstate(invalid="ignore"):
        out = vals * scale[..., None]
    return out.reshape(payload.shape[:-1] + (nb * bs.BLOCK,))
