"""The port's codec tables and table ("lut") codecs against ``repro``'s.

Every table of ``repro_torch.core.tables`` must equal ``repro.core.tables``'
array bit for bit (the port holds uint32 bit patterns in int32 tensors).
The plain lut codecs of ``repro_torch.kernels.lut`` must equal ``repro``'s
(``decode_wire_lut``, ``encode_wire_lut``, ``jnp_encode_fn(fmt, "lut")``)
over every code and over an f32 sweep with specials, subnormals, both rails
and every tie, and must equal the port's own bits codecs.  ``resolve_impl``
must give ``repro``'s answer, or raise where ``repro``'s raises, for every
registered format, impl and op.  Runs on the CPU:

    PYTHONPATH=src python -m pytest tests/test_torch_tables.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import formats as jformats
from repro.core import tables as jtables
from repro.core import takum_np as jtakum_np
from repro.kernels import lut as jlut
from repro.quant import blockscale as jbs
from repro_torch.core import formats, tables, takum_np
from repro_torch.kernels import lut
from repro_torch.kernels.mx_cases import mx_all_codes, mx_sweep

DEC_FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")
ENC_FMTS = ("t8", "e4m3", "e5m2", "t16")
MX_FMTS = ("mxe4m3", "mxe5m2", "mxt8")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _codes(fmt) -> np.ndarray:
    return np.arange(1 << formats.wire_format(fmt).nbits, dtype=np.int64)


def _same_f32(got, want) -> bool:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    return np.array_equal(nan_g, nan_w) and np.array_equal(
        got[~nan_g].view(np.uint32), want[~nan_w].view(np.uint32))


def _sweep(fmt, seed=0) -> np.ndarray:
    """f32 encode inputs: random binades (subnormals included), random bit
    patterns, specials and both f32 rails, and every tie between
    neighbouring codes of ``fmt`` with its two f32 neighbours."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 2.0, 20000) * 2.0 ** rng.integers(-150, 128, 20000)
    with np.errstate(over="ignore"):
        x = (x * rng.choice([-1.0, 1.0], 20000)).astype(np.float32)
    raw = rng.integers(0, 1 << 32, 8000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    f32 = np.finfo(np.float32)
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, f32.max, -f32.max, f32.tiny, -f32.tiny,
         f32.smallest_subnormal, -f32.smallest_subnormal, 1e-40, -1e-40, 448.0, 464.0, 480.0,
         57344.0, 61440.0, 65536.0, 2.0 ** 127, 3.4e38], np.float32)
    vals = np.asarray(tables.decode_table_f32(fmt), np.float64)
    vals = np.unique(vals[np.isfinite(vals) & (vals > 0)])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    ties = np.concatenate([mids, np.nextafter(mids, np.float32(np.inf)),
                           np.nextafter(mids, np.float32(0)), vals.astype(np.float32)])
    return np.concatenate([x, raw, specials, ties, -ties])


@pytest.mark.parametrize("fmt", DEC_FMTS)
def test_decode_table_matches_repro(fmt):
    got = tables.decode_table_bits(fmt)
    assert got.dtype == torch.int32 and got.numel() == 1 << formats.wire_format(fmt).nbits
    assert np.array_equal(_u32(got), jtables.decode_table_bits(fmt))
    assert np.array_equal(_u32(tables.decode_table_f32(fmt).view(torch.int32)),
                          jtables.decode_table_f32(fmt).view(np.uint32))
    assert tables.table_nbytes(fmt) == jtables.table_nbytes(fmt)


@pytest.mark.parametrize("fmt", ENC_FMTS)
def test_encode_tables_match_repro(fmt):
    got, want = tables.encode_tables(fmt), jtables.encode_tables(fmt)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert np.array_equal(g.numpy().view(w.dtype), w)
    pair = tables.encode8_tables(fmt) if fmt != "t16" else tables.encode16_tables(fmt)
    assert all(a is b for a, b in zip(pair, got))


def test_table_constructors_refuse_like_repro():
    for fn, arg in ((tables.decode_table_bits, "mxt8"), (tables.decode_table_bits, "f32"),
                    (tables.encode_tables, "bf16"), (tables.encode_tables, "mxe4m3"),
                    (tables.encode16_tables, "t8"), (tables.encode8_tables, "t16")):
        jfn = getattr(jtables, fn.__name__)
        with pytest.raises(ValueError):
            jfn(arg)
        with pytest.raises(ValueError):
            fn(arg)
    assert (tables.ENC8_THR_FLAG, tables.ENC8_THR_NEVER) == (jtables.ENC8_THR_FLAG,
                                                            jtables.ENC8_THR_NEVER)
    for name in ("e4m3", "e5m2"):
        assert tables.ofp8_overflow_code(name) == jtables.ofp8_overflow_code(name)


@pytest.mark.parametrize("n", (8, 9, 16, 17))
def test_takum_np_oracle_matches_repro(n):
    """The float64 oracle the encode tables take their boundaries from."""
    codes = np.arange(1 << n, dtype=np.uint64)
    want = jtakum_np.decode(codes, n)
    got = takum_np.decode(codes, n)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    x = np.random.default_rng(n).standard_normal(4000) * 2.0 ** np.random.default_rng(n).integers(
        -300, 300, 4000)
    x = np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-310, 1e300]])
    assert np.array_equal(takum_np.encode(x, n), jtakum_np.encode(x, n))


@pytest.mark.parametrize("fmt", DEC_FMTS)
def test_lut_decode_matches_repro_and_bits(fmt):
    codes = _codes(fmt)
    jcodes = jnp.asarray(codes.astype({8: np.uint8, 16: np.uint16}[formats.wire_format(fmt).nbits]))
    want = np.asarray(jlut.decode_wire_lut(jnp.asarray(jtables.decode_table_f32(fmt)), jcodes))
    tc = torch.from_numpy(codes)
    got = lut.decode_wire_lut(tables.decode_table_bits(fmt), tc).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(lut.decode_fn(fmt, "lut")(tc).numpy().view(np.uint32), got.view(np.uint32))
    assert np.array_equal(lut.decode_fn(fmt, "bits")(tc).numpy().view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("fmt", ENC_FMTS)
def test_lut_encode_matches_repro_and_bits(fmt):
    x = _sweep(fmt)
    tx = torch.from_numpy(x)
    want = np.asarray(jlut.encode_wire_lut(jnp.asarray(x), jlut.encode_table_operands(fmt), fmt))
    got = lut.encode_wire_lut(tx, tables.encode_tables(fmt), fmt).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(np.asarray(jlut.jnp_encode_fn(fmt, "lut")(jnp.asarray(x))), want)
    assert np.array_equal(lut.encode_fn(fmt, "lut")(tx).numpy(), got)
    assert np.array_equal(lut.encode_fn(fmt, "bits")(tx).numpy(), got)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_lut_codecs_match_repro_and_bits(fmt):
    """The container around the element tables: a block sweep (zero, NaN,
    Inf and subnormal blocks, absmax near 2^-126 and 2^127, values above the
    cap) encoded, and every element code under every scale byte decoded."""
    x = mx_sweep(torch.Generator().manual_seed(7), 64).reshape(-1, 64)
    want = np.asarray(jlut.jnp_encode_fn(fmt, "lut")(jnp.asarray(x.numpy())))
    got = lut.encode_fn(fmt, "lut")(x)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(lut.encode_fn(fmt, "bits")(x), got)
    codes = mx_all_codes()
    want = np.asarray(jlut.jnp_decode_fn(fmt, "lut")(jnp.asarray(codes.numpy())))
    got = lut.decode_fn(fmt, "lut")(codes).numpy()
    assert _same_f32(got, want)
    assert _same_f32(lut.decode_fn(fmt, "bits")(codes).numpy(), got)
    assert _same_f32(got, np.asarray(jbs.decode_payload(jnp.asarray(codes.numpy()), fmt)))


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


def test_resolve_impl_agrees_with_repro():
    """Every format of either registry (t32 is repro's alone, f32 both) under
    None, bits, lut and an unknown impl, for decode and encode: the same
    resolved impl, or ValueError on both sides."""
    names = sorted(set(jformats.WIRE_FORMATS) | set(formats.WIRE_FORMATS))
    assert "t32" in names and "mxt8" in names
    seen = set()
    for name in names:
        for impl in (None, "bits", "lut", "table"):
            for op in ("decode", "encode"):
                want = _outcome(lambda: jlut.resolve_impl(impl, name, op))
                got = _outcome(lambda: lut.resolve_impl(impl, name, op))
                assert got == want, (name, impl, op, got, want)
                seen.add(want)
    assert seen == {"bits", "lut", ValueError}
    with pytest.raises(ValueError):
        lut.resolve_impl(None, "t8", "matmul")


def test_tables_on_uploads_once_per_format_and_device():
    dec = lut.tables_on("mxt8", "decode", "cpu")
    assert dec is lut.tables_on("t8", "decode", torch.device("cpu"))
    assert torch.equal(dec[0], tables.decode_table_bits("t8"))
    enc = lut.tables_on("t16", "encode", "cpu")
    assert enc is lut.tables_on("takum16", "encode", "cpu") and len(enc) == 2


@pytest.mark.parametrize("fmt", DEC_FMTS + MX_FMTS)
def test_default_codecs_follow_the_tables_of_defaults(fmt):
    """``impl=None`` is the per-format default: the table codec where the
    default says lut, the registry's bits codec where it says bits."""
    wf = formats.wire_format(fmt)
    dec_lut = lut.resolve_impl(None, fmt) == "lut"
    enc_lut = lut.resolve_impl(None, fmt, "encode") == "lut"
    assert (lut.decode_fn(fmt) is not wf.decode) == dec_lut
    assert (lut.encode_fn(fmt) is not wf.encode) == enc_lut
    assert dec_lut == (jlut.resolve_impl(None, fmt) == "lut")
