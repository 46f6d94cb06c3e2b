"""The port's OCP-MX container (``repro_torch.quant.blockscale``) and mx
``QTensor`` against ``repro``'s jnp functions, bit for bit.

The reference is ``repro.quant.blockscale``'s jnp path, which is what its
Pallas kernels compute: on XLA's CPU backend it flushes f32 subnormal inputs
and products to signed zero.  ``repro``'s float64 oracle
``decode_payload_np`` keeps subnormal products and so disagrees with the jnp
path there (ROADMAP.md R6); the port follows the jnp path, and the subnormal
cases below pin that.  NaN matches NaN; every other output carries identical
bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import lut as jlut
from repro.quant import blockscale as jbs
from repro.quant import qtensor as jqt
from repro_torch.kernels import lut
from repro_torch.quant import blockscale as bs
from repro_torch.quant import qtensor as qt

MX_FMTS = ("mxe4m3", "mxe5m2", "mxt8")
TINY_BELOW = np.float32(np.nextafter(np.float32(2.0 ** -26), np.float32(0)))  # (2 - ulp) 2^-27


def _same_f32(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    return np.array_equal(nan_g, nan_w) and np.array_equal(
        got[~nan_g].view(np.uint32), want[~nan_w].view(np.uint32))


def _sweep(seed=0):
    """[blocks, 32] f32: random binades per element, narrow blocks at random
    binades, and the special blocks: all zero, NaN, Inf, all subnormal,
    subnormal elements beside a tiny absmax, elements whose scaled value
    falls just below 2^-126, absmax near 2^-126 and near 2^127, values
    above every element cap."""
    rng = np.random.default_rng(seed)
    wide = rng.uniform(1, 2, (400, 32)) * 2.0 ** rng.integers(-140, 128, (400, 32))
    wide *= rng.choice([-1.0, 1.0], (400, 32))
    narrow = rng.standard_normal((200, 32)) * 2.0 ** rng.integers(-130, 125, (200, 1))
    with np.errstate(over="ignore"):
        x = np.concatenate([wide, narrow]).astype(np.float32)
    z = np.zeros((14, 32), np.float32)
    z[1, 3] = np.nan
    z[2, 5] = np.inf
    z[3] = 1e-39
    z[3, 0] = -1e-39
    z[4, :3] = [2.0 ** -120, 1e-39, -1e-39]
    z[5, :4] = [2.0 ** 100, TINY_BELOW, 1.5 * 2.0 ** -27, -(2.0 ** -27)]
    z[6] = 3.3e38
    z[6, 1] = -np.inf
    z[7] = rng.standard_normal(32).astype(np.float32) * 1e-37
    z[8] = 2.0 ** -126
    z[8, 1] = 1.9 * 2.0 ** -126
    z[9] = rng.uniform(-3.4e38, 3.4e38, 32).astype(np.float32)
    z[10] = 1.99
    z[11] = 1.9e-38
    z[12] = rng.standard_normal(32).astype(np.float32) * 1e6
    z[13, ::2] = -0.0
    return np.concatenate([x, z])


def _all_codes_payload():
    """[256, 256*33]: row b holds every element code under scale byte b."""
    p = np.zeros((256, 256, 33), np.uint8)
    p[:, :, 0] = np.arange(256)[:, None]
    p[:, :, 1:] = np.arange(256)[None, :, None]
    return p.reshape(256, -1)


def test_e8m0_decode_every_byte():
    b = np.arange(256, dtype=np.uint8)
    got = bs.e8m0_decode(torch.from_numpy(b)).numpy()
    assert _same_f32(got, np.asarray(jbs.e8m0_decode(jnp.asarray(b))))
    assert np.isnan(got[255]) and got[0] == got[1] == np.float32(2.0 ** -126)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_scale_bytes_every_exponent(fmt):
    emax = bs.wire_format(fmt).elem_emax
    e = np.arange(256, dtype=np.uint32)
    amax = np.concatenate([(e << 23).view(np.float32), ((e << 23) | 0x5A5A5).view(np.float32),
                           np.array([0.0, 1e-40, np.nan, np.inf], np.float32)])
    got = bs.scale_bytes(torch.from_numpy(amax), emax).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jbs.scale_bytes(jnp.asarray(amax), emax)))
    assert got[-4] == got[-3] == 127 and got[-2] == got[-1] == 255


@pytest.mark.parametrize("fmt,cap", [("mxe4m3", 448.0), ("mxe5m2", 57344.0), ("mxt8", 1.875)])
def test_elem_cap(fmt, cap):
    assert bs.elem_cap(fmt) == jbs.elem_cap(fmt) == cap


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_block_quantize_and_pack_bit_exact(fmt):
    x = _sweep(1)
    sb, bits = bs.block_quantize(torch.from_numpy(x), fmt)
    jsb, jbits = jbs.block_quantize(jnp.asarray(x), fmt)
    assert sb.dtype == bits.dtype == torch.uint8
    assert np.array_equal(sb.numpy(), np.asarray(jsb))
    assert np.array_equal(bits.numpy(), np.asarray(jbits))
    payload = bs.pack_payload(sb, bits)
    want = np.asarray(jbs.pack_payload(jsb, jbits))
    assert np.array_equal(payload.numpy(), want)
    assert np.array_equal(bs.encode_payload(torch.from_numpy(x), fmt).numpy(), want)
    assert np.array_equal(lut.encode_bits_fn(fmt)(torch.from_numpy(x)).numpy(),
                          np.asarray(jlut.encode_bits_fn(fmt)(jnp.asarray(x))))
    s2, b2 = bs.unpack_payload(payload)
    assert torch.equal(s2, sb) and torch.equal(b2, bits)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_decode_payload_every_code_under_every_scale(fmt):
    p = _all_codes_payload()
    got = bs.decode_payload(torch.from_numpy(p), fmt).numpy()
    assert got.shape == (256, 256 * 32)
    assert _same_f32(got, np.asarray(jbs.decode_payload(jnp.asarray(p), fmt)))
    assert _same_f32(lut.decode_bits_fn(fmt)(torch.from_numpy(p)).numpy(),
                     np.asarray(jlut.decode_bits_fn(fmt)(jnp.asarray(p))))
    # and a payload the encoder made, 3-D
    x = _sweep(2)[:612].reshape(-1, 2, 64)
    enc = np.asarray(jbs.encode_payload(jnp.asarray(x), fmt))
    got = bs.decode_payload(torch.from_numpy(enc), fmt).numpy()
    assert got.shape == x.shape
    assert _same_f32(got, np.asarray(jbs.decode_payload(jnp.asarray(enc), fmt)))


def test_subnormal_cases_follow_the_jnp_path():
    """Trouble spot of the container: XLA's CPU backend is DAZ/FTZ, torch is
    not; each case is pinned to its value and to repro's jnp result."""
    blk = np.zeros((1, 32), np.float32)
    blk[0, :3] = [2.0 ** -120, 1e-39, -1e-39]
    for fmt, want in (("mxe4m3", [1, 0x68, 0, 0x80]), ("mxt8", [7, 0x40, 0, 0])):
        got = bs.encode_payload(torch.from_numpy(blk), fmt).numpy()[0, :4]
        assert got.tolist() == want
        assert np.array_equal(got, np.asarray(jbs.encode_payload(jnp.asarray(blk), fmt))[0, :4])
    # scaled value just below 2^-126 flushes (tininess before rounding): not t8's 1 ulp
    blk[0, :3] = [2.0 ** 100, TINY_BELOW, 0.0]
    assert bs.encode_payload(torch.from_numpy(blk), "mxt8").numpy()[0, :3].tolist() == [227, 0x40, 0]
    # e4m3 code 0x01 (2^-9) under scale byte 1: the product 2^-135 flushes
    p = np.zeros((1, 33), np.uint8)
    p[0, 0], p[0, 1] = 1, 0x01
    got = bs.decode_payload(torch.from_numpy(p), "mxe4m3").numpy()[0, 0]
    assert got == 0.0 and np.asarray(jbs.decode_payload(jnp.asarray(p), "mxe4m3"))[0, 0] == 0.0
    assert jbs.decode_payload_np(p, "mxe4m3")[0, 0] > 0  # the f64 oracle keeps it (R6)


def test_payload_helpers():
    assert [bs.padded_len(n) for n in (1, 32, 33, 128)] == [32, 32, 64, 128]
    assert [bs.payload_len(n) for n in (16, 32, 80, 128)] == [33, 33, 99, 132]
    assert bs.elems_len(132) == 128
    with pytest.raises(ValueError):
        bs.elems_len(130)
    x = torch.ones(2, 3, 17)
    assert tuple(bs.pad_block(x).shape) == (2, 3, 32) and bs.pad_block(x)[..., 17:].eq(0).all()
    assert bs.pad_block(torch.ones(4, 64)).shape == (4, 64)
    with pytest.raises(ValueError):
        bs.block_quantize(torch.ones(2, 40), "mxe4m3")
    with pytest.raises(ValueError):
        bs.block_quantize(torch.ones(2, 32), "e4m3")


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_qtensor_matches_repro(fmt):
    """quantize/dequantize/wire_payload over a ragged last axis (n = 50)."""
    x = (np.random.default_rng(3).standard_normal((3, 4, 50)) * 3).astype(np.float32)
    x[0, 0, 7] = 1e-39
    jq = jqt.quantize(jnp.asarray(x), fmt, scaled=True)
    q = qt.quantize(torch.from_numpy(x), fmt, scaled=True)
    assert q.n == 50 and tuple(q.shape) == x.shape and q.block_scaled
    assert np.array_equal(q.scale.numpy(), np.asarray(jq.scale))
    assert np.array_equal(q.wire_payload().numpy(), np.asarray(jq.wire_payload()))
    assert np.array_equal(bs.unpack_payload(q.bits)[1][..., :50].numpy(), np.asarray(jq.bits))
    assert _same_f32(q.dequantize().numpy(), np.asarray(jqt.dequantize(jq)))
    row = q[1]
    assert tuple(row.shape) == (4, 50) and torch.equal(row.scale, q.scale[1])
    assert _same_f32(row.dequantize().numpy(), np.asarray(jqt.dequantize(jq))[1])
    with pytest.raises(ValueError):
        qt.quantize(torch.from_numpy(x), "t8").wire_payload()
