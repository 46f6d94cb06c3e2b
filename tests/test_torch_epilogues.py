"""The port's producers with ``out_fmt`` (the fused encode epilogues of K3,
K4 and K6) and K4 (``dual_matmul``) against ``repro``.

Here on the CPU the wrappers run their plain versions: the plain producer,
then the plain encode (``ref.fused_*_ref``).  ``tests/test_torch_gpu.py``
holds the CUDA kernels against these on the card.

  * Exact sums: x is drawn from multiples of 2^-4 in [-4, 4], every operand
    is encoded from values each format holds exactly, and K <= 64, so every
    f32 partial sum is exact and every summation order gives the same f32
    output.  The fused output must then equal ``repro.kernels.ref``'s
    ``fused_matmul_ref`` / ``fused_dual_matmul_ref`` bit for bit, for every
    format x out format x encode codec, mx included, and ``repro``'s Pallas
    kernels (interpret mode) on a few single-K-tile cases.
  * Random inputs: the fused output equals the port's own encode of its
    unfused output; its codes lie within one out-format step of ``repro``'s
    (the f32 outputs differ in the last ulps, ROADMAP R1); K4's f32 output
    within rtol 2e-5, atol 1e-5 of ``takum_dual_matmul_ref``
    (tests/test_kernels.py:250-252); K6's decoded fused output within rtol
    0.1, atol 0.05 of ``decode_attention_ref`` (tests/test_kernels.py:340).
  * Loud errors, as in ``repro``: an mx out_fmt over N or d not a multiple
    of 32, and encode_impl="lut" for bf16.
  * out_fmt="t32" (no kernel encodes it, as no Pallas codec of ``repro``
    does): K3 / K4 / K6 run unfused and the plain t32 encode follows, equal
    bit for bit to the port's t32 encode of their own unfused output,
    specials included, on the kernel route and under ``ops.plain_path()``
    (``tests/test_special_propagation.py``'s t32 case, for the port).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops, ref

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8")
#: every (out format, encode codec): bf16 has no encode tables
OUT_CASES = [(o, i) for o in FMTS for i in ("bits", "lut")
             if i == "bits" or wire_format(o).supports_lut_encode]
#: values every format (mx: every element format under its block scale) holds
EXACT_W = np.array([0, 0.25, 0.5, 0.75, 1, 1.5, 2], np.float32)


def _exact(shape, seed, values=None):
    """Exactly representable operands: multiples of 2^-4 in [-4, 4], or
    signed draws from ``values``."""
    rng = np.random.default_rng(seed)
    if values is None:
        return (rng.integers(-64, 65, shape) / 16).astype(np.float32)
    return (rng.choice(values, shape) * rng.choice([-1, 1], shape)).astype(np.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _enc(x, fmt):
    """numpy f32 -> numpy bits (an mx payload) through repro's encode."""
    return np.array(jops.encode(jnp.asarray(x), fmt))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("out_fmt,encode_impl", OUT_CASES)
@pytest.mark.parametrize("fmt", FMTS)
def test_fused_matmul_exact_sums_equal_repro(fmt, out_fmt, encode_impl):
    x = _exact((5, 64), 1)
    wb = _enc(_exact((64, 64), 2, EXACT_W), fmt)
    got = ops.matmul(_t(x), _t(wb), fmt, out_fmt=out_fmt, encode_impl=encode_impl)
    want = np.asarray(jref.fused_matmul_ref(jnp.asarray(x), jnp.asarray(wb), fmt, out_fmt))
    assert got.dtype == wire_format(out_fmt).storage
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ref.fused_matmul_ref(_t(x), _t(wb), fmt, out_fmt,
                                                 encode_impl=encode_impl))


@pytest.mark.parametrize("out_fmt,encode_impl", OUT_CASES)
@pytest.mark.parametrize("fmt", FMTS)
def test_fused_dual_matmul_exact_sums_equal_repro(fmt, out_fmt, encode_impl):
    xb = _enc(_exact((5, 64), 3, EXACT_W), fmt)
    wb = _enc(_exact((64, 32), 4, EXACT_W), fmt)
    got = ops.dual_matmul(_t(xb), _t(wb), fmt, out_fmt=out_fmt, encode_impl=encode_impl)
    want = np.asarray(jref.fused_dual_matmul_ref(jnp.asarray(xb), jnp.asarray(wb), fmt, out_fmt))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt,out_fmt,encode_impl", [
    ("t8", "t16", "lut"), ("t16", "t8", "bits"), ("e4m3", "bf16", "bits"),
    ("mxt8", "mxt8", "lut"), ("e5m2", "mxe4m3", "bits"),
])
def test_fused_producers_equal_pallas_single_ktile(fmt, out_fmt, encode_impl):
    """A single K tile in repro's Pallas kernels (interpret mode): exact
    sums make both the matmul and the dual matmul equal bit for bit."""
    x = _exact((9, 64), 5)
    wb = _enc(_exact((64, 64), 6, EXACT_W), fmt)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(wb), fmt, out_fmt=out_fmt,
                                  encode_impl=encode_impl))
    got = ops.matmul(_t(x), _t(wb), fmt, out_fmt=out_fmt, encode_impl=encode_impl)
    assert np.array_equal(got.numpy(), want)
    xb = _enc(_exact((9, 64), 7, EXACT_W), fmt)
    want = np.asarray(jops.dual_matmul(jnp.asarray(xb), jnp.asarray(wb), fmt, out_fmt=out_fmt,
                                       encode_impl=encode_impl))
    got = ops.dual_matmul(_t(xb), _t(wb), fmt, out_fmt=out_fmt, encode_impl=encode_impl)
    assert np.array_equal(got.numpy(), want)


def _order_index(codes: np.ndarray, fmt: str) -> np.ndarray:
    """Codes of a flat format -> integers in value order (takum: two's
    complement; OFP8 and bf16: sign-magnitude)."""
    wf = wire_format(fmt)
    c = codes.astype(np.int64)
    if wf.family == "takum":
        return np.where(c >= 1 << (wf.nbits - 1), c - (1 << wf.nbits), c)
    mag = c & ((1 << (wf.nbits - 1)) - 1)
    return np.where(c >> (wf.nbits - 1), -mag, mag)


def _assert_within_one_step(a: np.ndarray, b: np.ndarray, fmt: str) -> None:
    """Two encodes of nearly equal f32 outputs: equal scale bytes (mx) and
    element codes at most one step apart."""
    wf = wire_format(fmt)
    if wf.is_block_scaled:
        ga, gb = a.reshape(-1, 33), b.reshape(-1, 33)
        assert np.array_equal(ga[:, 0], gb[:, 0])
        a, b, fmt = ga[:, 1:], gb[:, 1:], wf.elem_name
    assert np.abs(_order_index(a, fmt) - _order_index(b, fmt)).max() <= 1


@pytest.mark.parametrize("out_fmt,encode_impl", OUT_CASES)
def test_fused_matmul_random_within_one_step_of_repro(out_fmt, encode_impl):
    x = _rand((37, 130), 8)
    wb = _enc(_rand((130, 64), 9, 0.2), "t16")
    unfused = ops.matmul(_t(x), _t(wb), "t16")
    got = ops.matmul(_t(x), _t(wb), "t16", out_fmt=out_fmt, encode_impl=encode_impl)
    assert torch.equal(got, ops.encode(unfused, out_fmt, encode_impl))
    want = np.asarray(jref.fused_matmul_ref(jnp.asarray(x), jnp.asarray(wb), "t16", out_fmt))
    _assert_within_one_step(got.numpy(), want, out_fmt)


@pytest.mark.parametrize("fmt", FMTS)
def test_dual_matmul_random_matches_repro(fmt):
    xb = _enc(_rand((37, 96), 10), fmt)
    wb = _enc(_rand((96, 64), 11, 0.3), fmt)
    got = ops.dual_matmul(_t(xb), _t(wb), fmt)
    want = np.asarray(jref.takum_dual_matmul_ref(jnp.asarray(xb), jnp.asarray(wb), fmt))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    for out_fmt, encode_impl in (("t8", "lut"), ("mxe4m3", "bits")):
        fused = ops.dual_matmul(_t(xb), _t(wb), fmt, out_fmt=out_fmt, encode_impl=encode_impl)
        assert torch.equal(fused, ops.encode(got, out_fmt, encode_impl))
        want = np.asarray(jref.fused_dual_matmul_ref(jnp.asarray(xb), jnp.asarray(wb), fmt,
                                                     out_fmt))
        _assert_within_one_step(fused.numpy(), want, out_fmt)


@pytest.mark.parametrize("out_fmt,encode_impl", OUT_CASES)
@pytest.mark.parametrize("fmt", ("t8", "mxe4m3"))
def test_fused_decode_attention_matches_repro(fmt, out_fmt, encode_impl):
    B, H, Hkv, S, d = 1, 4, 2, 100, 64
    q = _rand((B, H, d), 12)
    kb = _enc(_rand((B, Hkv, S, d), 13), fmt)
    vb = _enc(_rand((B, Hkv, S, d), 14), fmt)
    unfused = ops.decode_attention(_t(q), _t(kb), _t(vb), fmt)
    got = ops.decode_attention(_t(q), _t(kb), _t(vb), fmt, out_fmt=out_fmt,
                               encode_impl=encode_impl)
    assert tuple(got.shape[:2]) == (B, H)
    assert torch.equal(got, ops.encode(unfused, out_fmt, encode_impl))
    dec = ops.decode(got, out_fmt).numpy()
    want = np.asarray(jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                                                fmt))
    assert np.all(np.isfinite(dec))
    np.testing.assert_allclose(dec, want, rtol=0.1, atol=0.05)


def test_fused_decode_attention_equals_pallas_on_codes_within_one_step():
    """repro's Pallas K6 with out_fmt (interpret mode): codes within one t16
    step (the two online softmaxes sum in other orders)."""
    q = _rand((1, 4, 64), 15)
    kb = _enc(_rand((1, 2, 40, 64), 16), "t8")
    vb = _enc(_rand((1, 2, 40, 64), 17), "t8")
    want = np.asarray(jops.decode_attention(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                                            "t8", out_fmt="t16"))
    got = ops.decode_attention(_t(q), _t(kb), _t(vb), "t8", out_fmt="t16")
    _assert_within_one_step(got.numpy(), want, "t16")


def _raises_like_repro(port_fn, repro_fn, exc):
    with pytest.raises(exc):
        repro_fn()
    with pytest.raises(exc):
        port_fn()


@pytest.mark.parametrize("out_fmt", ("mxe4m3", "mxe5m2", "mxt8"))
def test_mx_out_fmt_needs_whole_blocks_like_repro(out_fmt):
    x = _rand((4, 32), 18)
    wb = _enc(_rand((32, 40), 19), "t8")
    _raises_like_repro(lambda: ops.matmul(_t(x), _t(wb), "t8", out_fmt=out_fmt),
                       lambda: jops.matmul(jnp.asarray(x), jnp.asarray(wb), "t8", out_fmt=out_fmt),
                       ValueError)
    xb = _enc(x, "t8")
    _raises_like_repro(lambda: ops.dual_matmul(_t(xb), _t(wb), "t8", out_fmt=out_fmt),
                       lambda: jops.dual_matmul(jnp.asarray(xb), jnp.asarray(wb), "t8",
                                                out_fmt=out_fmt),
                       ValueError)
    q = _rand((1, 2, 48), 20)
    kv = _enc(_rand((1, 1, 8, 48), 21), "t8")
    _raises_like_repro(lambda: ops.decode_attention(_t(q), _t(kv), _t(kv), "t8", out_fmt=out_fmt),
                       lambda: jops.decode_attention(jnp.asarray(q), jnp.asarray(kv),
                                                     jnp.asarray(kv), "t8", out_fmt=out_fmt),
                       ValueError)


def test_lut_encode_for_bf16_raises_like_repro():
    x = _rand((4, 32), 22)
    wb = _enc(_rand((32, 32), 23), "t8")
    _raises_like_repro(
        lambda: ops.matmul(_t(x), _t(wb), "t8", out_fmt="bf16", encode_impl="lut"),
        lambda: jops.matmul(jnp.asarray(x), jnp.asarray(wb), "t8", out_fmt="bf16",
                            encode_impl="lut"),
        ValueError)
    with pytest.raises(ValueError):
        ops.dual_matmul(_t(_enc(x, "t8")), _t(wb), "t8", out_fmt="bf16", encode_impl="lut")
    kv = _t(wb.reshape(1, 1, 32, 32))
    with pytest.raises(ValueError):
        ops.decode_attention(_t(_rand((1, 2, 32), 24)), kv, kv, "t8", out_fmt="bf16",
                             encode_impl="lut")


def test_t32_out_fmt_raises_the_registry_error():
    """Kept under its old name: t32 is registered now and raises no more.
    K3, K4 and K6 with ``out_fmt="t32"`` equal the port's t32 encode of
    their own unfused output bit for bit, NaN rows (NaR) included, on the
    kernel route and the plain path; the unfused launch is what counts."""
    x = _rand((4, 32), 25)
    x[0, 0] = np.nan
    xt = _t(x)
    wb = _t(_enc(_rand((32, 32), 26), "t8"))
    xb = ops.encode(xt, "t8")
    kv = wb.reshape(1, 1, 32, 32)
    q = _rand((1, 2, 32), 27)
    q[0, 1, 0] = np.inf
    qt = _t(q)
    for plain in (False, True):
        with ops.plain_path() if plain else contextlib.nullcontext():
            cases = [
                (ops.matmul(xt, wb, "t8", out_fmt="t32"), ops.matmul(xt, wb, "t8")),
                (ops.dual_matmul(xb, wb, "t8", out_fmt="takum32"), ops.dual_matmul(xb, wb, "t8")),
                (ops.decode_attention(qt, kv, kv, "t8", out_fmt=32),
                 ops.decode_attention(qt, kv, kv, "t8")),
            ]
            for fused, unfused in cases:
                assert fused.dtype == torch.uint32 and fused.shape == unfused.shape
                assert torch.equal(fused.view(torch.int32), ops.encode(unfused, "t32").view(torch.int32))
                y = ops.decode(fused, "t32")
                assert torch.equal(torch.isnan(y), torch.isnan(unfused))
    y = ops.decode(ops.matmul(xt, wb, "t8", out_fmt="t32"), "t32")
    assert torch.isnan(y[0]).all() and torch.isfinite(y[1:]).all()
    # the t32 encode is repro's, so the route is repro's fallback's contract
    unfused = ops.matmul(xt, wb, "t8").numpy()
    want = np.asarray(jops.encode(jnp.asarray(unfused), "t32"))
    got = ops.matmul(xt, wb, "t8", out_fmt="t32")
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)


def test_fused_launches_take_no_unfused_count_on_cpu():
    """CPU tensors take the plain versions: no launch is counted, fused or
    not, and the counts keep only the unfused keys."""
    ops.reset_launch_counts()
    x = _t(_rand((4, 32), 28))
    wb = ops.encode(_t(_rand((32, 32), 29)), "t8")
    ops.matmul(x, wb, "t8", out_fmt="mxt8")
    ops.dual_matmul(ops.encode(x, "t8"), wb, "t8", out_fmt="t16")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_c_entries_match_their_ctypes_argtypes():
    """Every ``extern "C"`` entry of ``csrc/*.cu`` takes the arguments
    ``_build.ENTRIES`` declares for it, in order (a pointer as c_void_p, an
    int as c_int, a long long as c_longlong, a float as c_float): ctypes
    would pass a mismatched list without complaint."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    found = {}
    for src in sorted(Path(_build._CSRC).glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = []
            for p in params.split(","):
                decl = " ".join(p.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if decl.endswith("*") else kinds[decl])
            found[name] = (src.stem, types)
    assert found == {name: (lib, list(args)) for name, (lib, args) in _build.ENTRIES.items()}
