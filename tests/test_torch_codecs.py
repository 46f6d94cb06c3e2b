"""The port's plain codecs against ``repro``'s, bit for bit.

Exhaustive 2^8 / 2^16 decode and f32 encode sweeps (float32-exact bounds,
specials, subnormals under DAZ, saturation and overflow rails, ties between
neighbouring codes) for t8, t16, e4m3, e5m2 and bf16.  NaN matches NaN;
every other output must carry identical bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import formats as jformats
from repro.core import takum as jtakum
from repro.kernels import common as jcommon
from repro_torch.core import formats, ofp8, takum
from repro_torch.kernels import common, lut

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")


def _all_codes(fmt):
    wf = formats.wire_format(fmt)
    return np.arange(1 << wf.nbits, dtype=np.int64).astype(
        {8: np.uint8, 16: np.uint16}[wf.nbits]
    )


def _assert_same_f32(got, want):
    """Equal f32 bit patterns, except that any NaN matches any NaN."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    assert np.array_equal(nan_g, nan_w)
    assert np.array_equal(got[~nan_g].view(np.uint32), want[~nan_w].view(np.uint32))


def _sweep(seed=0):
    """f32 encode inputs: every binade at random, specials, DAZ subnormals,
    the f32 rails and float32-exact extremes."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, 20000)
    expo = rng.integers(-130, 128, 20000)
    x = (mant * 2.0 ** expo.astype(np.float64)) * rng.choice([-1.0, 1.0], 20000)
    with np.errstate(over="ignore"):
        x = x.astype(np.float32)
    f32 = np.finfo(np.float32)
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, f32.max, -f32.max,
         f32.tiny, -f32.tiny, f32.smallest_subnormal, -f32.smallest_subnormal,
         1e-40, -1e-40, f32.tiny * 0.5, 1.0, -1.0, 448.0, 464.0, 480.0,
         57344.0, 61440.0, 65536.0, 2.0 ** -9, 2.0 ** -10, 2.0 ** -17,
         2.0 ** -18, 3.4e38],
        np.float32,
    )
    bits = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([x, specials, bits.view(np.float32)])


def _ties(fmt):
    """Midpoints of neighbouring finite codes and their f32 neighbours: the
    inputs where round-to-nearest-even decides."""
    wf = jformats.wire_format(fmt)
    with np.errstate(invalid="ignore"):  # NaN codes; dropped below
        vals = np.asarray(wf.decode_jnp(jnp.asarray(_all_codes(fmt))), np.float64)
    vals = np.unique(vals[np.isfinite(vals) & (vals > 0)])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    up = np.nextafter(mids, np.float32(np.inf))
    dn = np.nextafter(mids, np.float32(0))
    pos = np.concatenate([mids, up, dn, vals.astype(np.float32)])
    return np.concatenate([pos, -pos])


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_exhaustive_matches_repro(fmt):
    codes = _all_codes(fmt)
    want = np.asarray(jformats.wire_format(fmt).decode_jnp(jnp.asarray(codes)))
    got = formats.wire_format(fmt).decode(torch.from_numpy(codes)).numpy()
    _assert_same_f32(got, want)
    _assert_same_f32(lut.decode_fast(torch.from_numpy(codes), fmt).numpy(), want)


@pytest.mark.parametrize("n", (8, 16))
def test_takum_decoders_agree_with_both_repro_decoders(n):
    """The kernel decoder (common.py) and the value decoder (core/takum.py)
    of ``repro`` agree on every t8/t16 code on XLA's CPU backend; the port
    has one decoder and equals both."""
    codes = _all_codes(f"t{n}")
    got = common.decode_takum_f32(torch.from_numpy(codes), n).numpy()
    _assert_same_f32(got, np.asarray(jcommon.decode_takum_f32(jnp.asarray(codes), n)))
    val = np.asarray(jtakum.takum_decode(jnp.asarray(codes), n))
    nan = np.isnan(val)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan], val[~nan])


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_sweep_matches_repro(fmt):
    x = np.concatenate([_sweep(), _ties(fmt)])
    jwf = jformats.wire_format(fmt)
    want = np.asarray(jwf.encode_jnp(jnp.asarray(x))).astype(np.int64)
    got = formats.wire_format(fmt).encode(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    fast = lut.encode_fast(torch.from_numpy(x), fmt)
    assert fast.dtype == formats.wire_format(fmt).storage
    assert np.array_equal(fast.to(torch.int64).numpy(), want)


@pytest.mark.parametrize("n", (8, 16))
def test_takum_kernel_encoder_matches_repro_kernel_encoder(n):
    x = np.concatenate([_sweep(1), _ties(f"t{n}")])
    want = np.asarray(jcommon.encode_takum_from_f32(jnp.asarray(x), n)).astype(np.int64)
    got = common.encode_takum_from_f32(torch.from_numpy(x), n).numpy()
    assert np.array_equal(got, want)


def test_takum_rails():
    """DAZ, saturation and NaR rails of the takum encoder, stated directly."""
    f32 = np.finfo(np.float32)
    x = torch.tensor([1e-40, -1e-40, f32.max, -f32.max, float("inf"), float("nan"), 0.0])
    for n in (8, 16):
        got = takum.takum_encode(x, n).tolist()
        top = (1 << (n - 1)) - 1
        assert got[0] == 0 and got[1] == 0 and got[6] == 0
        assert got[4] == got[5] == 1 << (n - 1)
        assert got[2] <= top and got[3] == (1 << n) - got[2]


def test_ofp8_overflow_rules():
    """e4m3 overflows to NaN (no Inf exists), e5m2 to Inf."""
    x = torch.tensor([1e6, -1e6, 480.0, 61440.0])
    e4 = ofp8.encode(x, "e4m3").tolist()
    e5 = ofp8.encode(x, "e5m2").tolist()
    assert e4[0] == 0x7F and e4[1] == 0xFF and e4[2] == 0x7F
    assert e5[0] == 0x7C and e5[1] == 0xFC and e5[3] == 0x7C


def test_wire_format_aliases():
    assert formats.wire_format(8) is formats.wire_format("t8")
    assert formats.wire_format("takum16").name == "t16"
    assert formats.wire_format("bfloat16").storage == torch.uint16
    assert set(formats.kernel_wire_names()) == set(FMTS) | {"mxe4m3", "mxe5m2", "mxt8"}
    assert formats.wire_format("mxfp8").name == "mxe4m3"
    assert formats.wire_format("mxfp8_e5m2").name == "mxe5m2"
    assert formats.wire_format("mxtakum8").name == "mxt8"
    with pytest.raises(KeyError):
        formats.wire_format("mxe2m1")
