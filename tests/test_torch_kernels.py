"""The port's kernel entry points against ``repro``'s Pallas kernels.

Here on the CPU the wrappers run their plain PyTorch versions; ``repro``'s
kernels run in Pallas interpret mode.  Codecs (K1, K2) must match bit for
bit, the mx containers (mxe4m3, mxe5m2, mxt8) included.  Matmul (K3) and
attention (K6) are compared at a tolerance because accumulation order
differs between implementations (ROADMAP.md R1):

  * K3: |port - repro| <= 1e-5 * (|x| @ |decode(w)|) elementwise, i.e. a few
    f32 ulps of the magnitude the sum passes through;
  * K6: |port - repro| <= 1e-5 * max|v|, softmax weights summing to one.

``tests/test_torch_gpu.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import formats as jformats
from repro.kernels import ops as jops
from repro.quant import blockscale as jbs
from repro.kernels.takum_attention import takum_decode_attention as j_attention
from repro.kernels.takum_codec import takum_decode_2d as j_decode_2d
from repro.kernels.takum_codec import takum_encode_2d as j_encode_2d
from repro.kernels.takum_matmul import takum_matmul as j_matmul
from repro_torch.core.formats import wire_format
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mx_cases import mx_all_codes, mx_sweep
from repro_torch.kernels.takum_attention import takum_decode_attention
from repro_torch.kernels.takum_codec import takum_decode_2d, takum_encode_2d
from repro_torch.kernels.takum_matmul import takum_matmul
from repro_torch.quant import blockscale

FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16")
MX_FMTS = ("mxe4m3", "mxe5m2", "mxt8")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(x, fmt):
    """numpy f32 -> numpy packed bits via repro's registry encode."""
    return np.array(jformats.wire_format(fmt).encode_jnp(jnp.asarray(x)))


def _same_f32(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return np.array_equal(nan_a, nan_b) and np.array_equal(
        a[~nan_a].view(np.uint32), b[~nan_b].view(np.uint32))


@pytest.mark.parametrize("fmt", FMTS)
def test_codec_ops_match_pallas_bit_exact(fmt):
    x = _rand((257, 129), 1, 3.0)
    x.flat[0] = np.inf
    x.flat[-1] = -0.0
    want = np.array(j_encode_2d(jnp.asarray(x), fmt, encode_impl="bits"))
    got = ops.encode(torch.from_numpy(x), fmt)
    assert got.dtype == wire_format(fmt).storage
    assert np.array_equal(got.numpy(), want)
    want_d = np.asarray(j_decode_2d(jnp.asarray(want), fmt, decode_impl="bits"))
    assert _same_f32(ops.decode(got, fmt).numpy(), want_d)


@pytest.mark.parametrize("fmt", FMTS)
def test_codec_ops_flatten_nd(fmt):
    """1-D and 5-D inputs (the KV cache's [L, B, S, Kv, hd]) keep their shape
    and equal the 2-D kernel on the flattened view."""
    x = _rand((2, 3, 5, 2, 16), 2)
    want = np.array(j_encode_2d(jnp.asarray(x.reshape(-1, 16)), fmt, encode_impl="bits"))
    got = ops.encode(torch.from_numpy(x), fmt)
    assert tuple(got.shape) == x.shape
    assert np.array_equal(got.numpy().reshape(-1, 16), want)
    assert tuple(ops.decode(got, fmt).shape) == x.shape
    flat = ops.encode(torch.from_numpy(x.reshape(-1)), fmt)
    assert np.array_equal(flat.numpy(), want.reshape(-1))


@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "bf16"))
def test_ops_codec_nd_degenerate_shapes(fmt):
    """Twin of tests/test_kernels.py::test_ops_codec_nd_degenerate_2d_shapes,
    with a 0-d input and an empty [2, 3, 0] added: bit equality with
    ``repro``'s ops and the exact shape, both directions."""
    shapes = [(1, 7), (1, 513), (7, 1), (513, 1), (1, 1), (0, 5), (5, 0), (0, 0), (3, 0, 4),
              (0,), (), (2, 3, 0)]
    for i, shape in enumerate(shapes):
        x = np.asarray(_rand(shape, 23 + i))  # a 0-d draw comes back as a scalar
        want = np.array(jops.encode(jnp.asarray(x), fmt))
        enc = ops.encode(torch.from_numpy(x), fmt)
        assert tuple(enc.shape) == shape == want.shape, (fmt, shape)
        assert enc.dtype == wire_format(fmt).storage
        assert np.array_equal(enc.numpy(), want), (fmt, shape)
        dec = ops.decode(enc, fmt)
        assert tuple(dec.shape) == shape and dec.dtype == torch.float32, (fmt, shape)
        assert _same_f32(dec.numpy(), np.asarray(jops.decode(jnp.asarray(want), fmt))), shape


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_codec_ops_refuse_0d(fmt):
    """A 0-d tensor has no last axis of whole mx blocks: both ops raise
    ValueError (``repro`` has no answer there: it fails with IndexError)."""
    with pytest.raises(ValueError, match="0-d"):
        ops.encode(torch.tensor(1.5), fmt)
    with pytest.raises(ValueError, match="0-d"):
        ops.decode(torch.tensor(3, dtype=torch.uint8), fmt)


@pytest.mark.parametrize("M,K,N,x_dtype", [(4, 64, 48, "f32"), (37, 130, 70, "bf16")])
@pytest.mark.parametrize("fmt", FMTS)
def test_matmul_matches_pallas(fmt, M, K, N, x_dtype):
    x = _rand((M, K), 3)
    w_bits = _bits(_rand((K, N), 4, 0.5), fmt)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = np.array(j_matmul(jx, jnp.asarray(w_bits), fmt, bm=32, bn=128, bk=128,
                               decode_impl="bits"))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    got = ops.matmul(tx, torch.from_numpy(w_bits), fmt).numpy()
    assert got.shape == (M, N) and got.dtype == np.float32
    w = ref.codec_decode_ref(torch.from_numpy(w_bits), fmt).numpy()
    bound = 1e-5 * (np.abs(tx.float().numpy()) @ np.abs(w))
    assert (np.abs(got - want) <= bound).all()
    assert np.array_equal(got, ref.takum_matmul_ref(tx, torch.from_numpy(w_bits), fmt).numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_attention_matches_pallas(fmt):
    B, H, Hkv, S, d = 2, 6, 2, 37, 24  # ragged S tile, GQA g = 3, d off the lane width
    q = _rand((B, H, d), 5)
    k_bits = _bits(_rand((B, Hkv, S, d), 6), fmt)
    v_bits = _bits(_rand((B, Hkv, S, d), 7), fmt)
    want = np.array(j_attention(jnp.asarray(q), jnp.asarray(k_bits), jnp.asarray(v_bits),
                                  fmt, block_s=16, decode_impl="bits"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k_bits, v_bits))
    got = ops.decode_attention(tq, tk, tv, fmt).numpy()
    vmax = np.abs(ref.codec_decode_ref(tv, fmt).numpy()).max()
    assert np.abs(got - want).max() <= 1e-5 * vmax
    assert np.allclose(got, ref.decode_attention_ref(tq, tk, tv, fmt).numpy(), rtol=0, atol=1e-6 * vmax)


def _model_attention(q, k_cache, v_cache, fmt, pos, window, cap):
    """transformer.py:484-498 of repro, as jnp: q [B, 1, H, hd] f32,
    cache [B, S, Kv, hd] packed bits, decoded through repro's registry."""
    wf = jformats.wire_format(fmt)
    kf = wf.decode_jnp(jnp.asarray(k_cache))
    vf = wf.decode_jnp(jnp.asarray(v_cache))
    B, _, H, hd = q.shape
    S, Kv = kf.shape[1], kf.shape[2]
    kpos = jnp.arange(S)
    valid = kpos <= pos
    valid = jnp.where(window > 0, valid & ((pos - kpos) < window), valid)
    g = H // Kv
    kk = jnp.repeat(kf, g, axis=2)
    vv = jnp.repeat(vf, g, axis=2)
    logits = jnp.einsum("bqhd,bshd->bhqs", jnp.asarray(q), kk) * (hd ** -0.5)
    logits = cap * jnp.tanh(logits / cap) if cap > 0 else logits
    logits = jnp.where(valid[None, None, None, :], logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jnp.einsum("bhqs,bshd->bqhd", p, vv).reshape(B, H, hd))


@pytest.mark.parametrize("pos,window,cap", [(20, 0, 0.0), (0, 0, 0.0), (40, 33, 2.0)])
@pytest.mark.parametrize("fmt", FMTS)
def test_masked_decode_attention_matches_model_math(fmt, pos, window, cap):
    """length < S over a zero-filled preallocated cache, sliding window and
    softcap, read through the permuted [B, S, Kv, hd] cache view."""
    B, S, Kv, H, hd = 2, 45, 2, 4, 16
    q = _rand((B, 1, H, hd), 8)
    cache_k = _bits(_rand((B, S, Kv, hd), 9), fmt)
    cache_v = _bits(_rand((B, S, Kv, hd), 10), fmt)
    cache_k[:, pos + 1:] = 0  # never written: bits 0 decode to 0.0
    cache_v[:, pos + 1:] = 0
    want = _model_attention(q, cache_k, cache_v, fmt, pos, window, cap)
    tk = torch.from_numpy(cache_k).permute(0, 2, 1, 3)
    tv = torch.from_numpy(cache_v).permute(0, 2, 1, 3)
    got = ops.decode_attention(torch.from_numpy(q[:, 0]), tk, tv, fmt, length=pos + 1,
                               window=window, softcap=cap, scale=hd ** -0.5).numpy()
    vmax = np.abs(ref.codec_decode_ref(torch.from_numpy(cache_v), fmt).numpy()).max()
    assert np.abs(got - want).max() <= 1e-5 * vmax


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(KeyError):  # t32: not registered; repro's kernels refuse it too
        takum_encode_2d(x, "t32")
    with pytest.raises(TypeError):
        takum_decode_2d(torch.zeros(4, 8, dtype=torch.uint8), "t16")
    with pytest.raises(ValueError):
        takum_decode_2d(torch.zeros(8, dtype=torch.uint8), "t8")
    with pytest.raises(ValueError):
        takum_matmul(x, torch.zeros(4, 8, dtype=torch.uint8), "t8")
    with pytest.raises(TypeError):
        takum_matmul(x.to(torch.float16), torch.zeros(8, 4, dtype=torch.uint8), "t8")
    kv = torch.zeros(1, 2, 5, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        takum_decode_attention(torch.zeros(1, 4, 8), kv, kv, "t8", length=6)
    with pytest.raises(ValueError):
        takum_decode_attention(torch.zeros(1, 3, 8), kv, kv, "t8")


@pytest.mark.parametrize("fmt", ["t16", "mxt8"])
def test_plain_path_accumulates_in_the_dtype_asked(fmt):
    """``ops.plain_path(torch.float64)`` (the order control of chip_smoke.py)
    accumulates the plain matmul in f64, and the route is restored after
    the block, also when the block raises."""
    x = torch.from_numpy(_rand((5, 64), 41))
    w = torch.from_numpy(_rand((64, 40), 42))
    n = 40 if fmt == "mxt8" else None
    w = ops.encode(blockscale.pad_block(w) if n else w, fmt)
    wd = ref.codec_decode_ref(w, fmt)[:, :40]
    with ops.plain_path(torch.float64):
        got = ops.matmul(x, w, fmt, n=n)
    assert got.dtype == torch.float32
    assert torch.equal(got, (x.double() @ wd.double()).float())
    with pytest.raises(RuntimeError):
        with ops.plain_path(torch.float64):
            raise RuntimeError
    assert ops._PLAIN_ACC is None
    assert torch.equal(ops.matmul(x, w, fmt, n=n), x @ wd)


def test_plain_path_counts_no_launches():
    ops.reset_launch_counts()
    x = torch.from_numpy(_rand((4, 32), 11))
    bits = ops.encode(x, "t8")
    ops.decode(bits, "t8")
    ops.matmul(x, bits.t().contiguous(), "t8")
    kv = bits.reshape(1, 1, 4, 32)
    ops.decode_attention(torch.zeros(1, 2, 32), kv, kv, "t8")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# ---------------------------------------------------------------------------
# mx containers
# ---------------------------------------------------------------------------


def _mx_input(shape, seed):
    """f32 [..., 32k] with blocks at random binades, one NaN and one Inf
    block, an all-zero block, subnormal elements and elements whose scaled
    value falls below 2^-126."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 2.0 ** rng.integers(-60, 60, shape[:-1] + (1,))
    x = x.astype(np.float32).reshape(-1, 32)
    x[0, 3], x[1, 4], x[2] = np.nan, -np.inf, 0.0
    x[3, :3] = [2.0 ** -120, 1e-39, -1e-39]
    x[4, :2] = [2.0 ** 100, 1.5 * 2.0 ** -27]
    return x.reshape(shape)


def _payload(x, fmt):
    """numpy f32 [..., 32k] -> numpy payload via repro's jnp encode."""
    return np.array(jbs.encode_payload(jnp.asarray(x), fmt))


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_codec_ops_match_pallas_bit_exact(fmt):
    x = _mx_input((257, 128), 31)
    want = np.array(j_encode_2d(jnp.asarray(x), fmt, encode_impl="bits"))
    got = ops.encode(torch.from_numpy(x), fmt)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (257, 132)
    assert np.array_equal(got.numpy(), want)
    want_d = np.asarray(j_decode_2d(jnp.asarray(want), fmt, decode_impl="bits"))
    got_d = ops.decode(got, fmt).numpy()
    assert got_d.shape == (257, 128) and _same_f32(got_d, want_d)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_card_sweep_matches_repro_bit_exact(fmt):
    """The block sweep the card checks K2-mx with (zero, NaN, Inf and
    subnormal blocks, absmax near 2^-126 and 2^127, values above the cap)
    through the plain K2-mx and K1-mx, against repro's jnp container."""
    x = mx_sweep(torch.Generator().manual_seed(43), 64).reshape(-1, 64)
    got = ops.encode(x, fmt)
    assert np.array_equal(got.numpy(), _payload(x.numpy(), fmt))
    want_d = np.asarray(jbs.decode_payload(jnp.asarray(got.numpy()), fmt))
    assert _same_f32(ops.decode(got, fmt).numpy(), want_d)
    codes = mx_all_codes()
    want_d = np.asarray(jbs.decode_payload(jnp.asarray(codes.numpy()), fmt))
    assert _same_f32(ops.decode(codes, fmt).numpy(), want_d)


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_codec_ops_flatten_nd(fmt):
    """A 5-D KV block [L, B, S, Kv, 32] keeps its leading shape; the last axis
    becomes the 33-byte payload and decodes back to 32."""
    x = _mx_input((2, 3, 5, 2, 32), 32)
    want = np.array(j_encode_2d(jnp.asarray(x.reshape(-1, 32)), fmt, encode_impl="bits"))
    got = ops.encode(torch.from_numpy(x), fmt)
    assert tuple(got.shape) == (2, 3, 5, 2, 33)
    assert np.array_equal(got.numpy().reshape(-1, 33), want)
    assert tuple(ops.decode(got, fmt).shape) == x.shape


@pytest.mark.parametrize("M,K,N,x_dtype", [(4, 64, 100, "f32"), (37, 130, 64, "bf16")])
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_matmul_matches_pallas(fmt, M, K, N, x_dtype):
    """w is the payload [K, ceil(N/32)*33] blocked along N; with N = 100 the
    last group is padded and the port drops the padded columns."""
    x = _rand((M, K), 33)
    w = _payload(blockscale.pad_block(torch.from_numpy(_rand((K, N), 34, 0.5))).numpy(), fmt)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = np.array(j_matmul(jx, jnp.asarray(w), fmt, bm=32, bn=128, bk=128,
                             decode_impl="bits"))[:, :N]
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    got = ops.matmul(tx, torch.from_numpy(w), fmt, n=N).numpy()
    assert got.shape == (M, N) and got.dtype == np.float32
    wd = ref.codec_decode_ref(torch.from_numpy(w), fmt).numpy()[:, :N]
    bound = 1e-5 * (np.abs(tx.float().numpy()) @ np.abs(wd))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_decode_attention_matches_pallas(fmt):
    B, H, Hkv, S, d = 2, 6, 2, 37, 64  # ragged S tile, GQA g = 3; repro's kernel takes d % 32 == 0
    q = _rand((B, H, d), 35)
    k_bits = _payload(_rand((B, Hkv, S, d), 36), fmt)
    v_bits = _payload(_rand((B, Hkv, S, d), 37), fmt)
    want = np.array(j_attention(jnp.asarray(q), jnp.asarray(k_bits), jnp.asarray(v_bits),
                                fmt, block_s=16, decode_impl="bits"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k_bits, v_bits))
    got = ops.decode_attention(tq, tk, tv, fmt).numpy()
    vmax = np.abs(ref.codec_decode_ref(tv, fmt).numpy()).max()
    assert np.abs(got - want).max() <= 1e-5 * vmax


def _mx_model_attention(q, k_cache, v_cache, fmt, pos, window, cap):
    """transformer.py:484-498 of repro for an mx cache: the payload decoded
    by repro's jnp container and sliced back to hd (``_decode_cache``)."""
    hd = q.shape[-1]
    kf = np.asarray(jbs.decode_payload(jnp.asarray(k_cache), fmt))[..., :hd]
    vf = np.asarray(jbs.decode_payload(jnp.asarray(v_cache), fmt))[..., :hd]
    return _model_attention_f32(q, kf, vf, pos, window, cap)


def _model_attention_f32(q, kf, vf, pos, window, cap):
    B, _, H, hd = q.shape
    S, Kv = kf.shape[1], kf.shape[2]
    kpos = jnp.arange(S)
    valid = kpos <= pos
    valid = jnp.where(window > 0, valid & ((pos - kpos) < window), valid)
    g = H // Kv
    kk = jnp.repeat(jnp.asarray(kf), g, axis=2)
    vv = jnp.repeat(jnp.asarray(vf), g, axis=2)
    logits = jnp.einsum("bqhd,bshd->bhqs", jnp.asarray(q), kk) * (hd ** -0.5)
    logits = cap * jnp.tanh(logits / cap) if cap > 0 else logits
    logits = jnp.where(valid[None, None, None, :], logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jnp.einsum("bhqs,bshd->bqhd", p, vv).reshape(B, H, hd))


@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("pos,window,cap", [(20, 0, 0.0), (40, 33, 2.0)])
@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_masked_decode_attention_matches_model_math(fmt, pos, window, cap, hd):
    """Head dims off the 32-block (16: one group, 16 padded lanes; 80: three
    groups), length < S, window and softcap, through the permuted cache view."""
    B, S, Kv, H = 2, 45, 2, 4
    q = _rand((B, 1, H, hd), 38)
    pad = blockscale.padded_len(hd) - hd
    cache_k = _payload(np.pad(_rand((B, S, Kv, hd), 39), [(0, 0)] * 3 + [(0, pad)]), fmt)
    cache_v = _payload(np.pad(_rand((B, S, Kv, hd), 40), [(0, 0)] * 3 + [(0, pad)]), fmt)
    cache_k[:, pos + 1:] = 0  # never written: payload 0 decodes to 0.0
    cache_v[:, pos + 1:] = 0
    want = _mx_model_attention(q, cache_k, cache_v, fmt, pos, window, cap)
    tk = torch.from_numpy(cache_k).permute(0, 2, 1, 3)
    tv = torch.from_numpy(cache_v).permute(0, 2, 1, 3)
    got = ops.decode_attention(torch.from_numpy(q[:, 0]), tk, tv, fmt, length=pos + 1,
                               window=window, softcap=cap, scale=hd ** -0.5).numpy()
    vmax = np.abs(ref.codec_decode_ref(torch.from_numpy(cache_v), fmt).numpy()).max()
    assert got.shape == (B, H, hd)
    assert np.abs(got - want).max() <= 1e-5 * vmax


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("fmt", MX_FMTS)
def test_mx_shape_checks_raise_like_repro(fmt):
    """The loud payload checks: a last dim that is not whole 33-byte groups,
    and an encode input that is not whole 32-element blocks, raise
    ValueError in both packages."""
    cases = [
        ("decode", (np.zeros((4, 32), np.uint8),)),
        ("decode", (np.zeros((4, 0), np.uint8),)),
        ("encode", (np.zeros((4, 40), np.float32),)),
        ("encode", (np.zeros((4, 0), np.float32),)),
        ("matmul", (np.zeros((2, 8), np.float32), np.zeros((8, 34), np.uint8))),
        ("decode_attention", (np.zeros((1, 2, 32), np.float32), np.zeros((1, 1, 4, 32), np.uint8),
                              np.zeros((1, 1, 4, 32), np.uint8))),
    ]
    for op, args in cases:
        want = _raises(lambda: getattr(jops, op)(*(jnp.asarray(a) for a in args), fmt))
        got = _raises(lambda: getattr(ops, op)(*(torch.from_numpy(a) for a in args), fmt))
        assert want is ValueError and got is ValueError, (op, want, got)
    # the payload shapes the kernels take, and what they refuse
    with pytest.raises(ValueError):
        takum_encode_2d(torch.zeros(4, 40), fmt)
    with pytest.raises(ValueError):
        takum_decode_2d(torch.zeros(4, 34, dtype=torch.uint8), fmt)
    with pytest.raises(ValueError):
        takum_matmul(torch.zeros(2, 8), torch.zeros(8, 66, dtype=torch.uint8), fmt, n=20)
    kv = torch.zeros(1, 2, 5, 33, dtype=torch.uint8)
    with pytest.raises(ValueError):
        takum_decode_attention(torch.zeros(1, 4, 40), kv, kv, fmt)
    assert takum_decode_attention(torch.zeros(1, 4, 20), kv, kv, fmt).shape == (1, 4, 20)


# ---------------------------------------------------------------------------
# codec impls: "bits" and "lut" through every op
# ---------------------------------------------------------------------------


IMPLS = ("bits", "lut")


def _impl_input(fmt, shape, seed):
    return _mx_input(shape, seed) if fmt in MX_FMTS else _rand(shape, seed, 3.0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_codec_ops_by_impl_match_pallas_bit_exact(fmt, impl):
    """ops.encode/decode with an explicit impl against repro's kernels with
    the same impl; "lut" where a format has no tables (bf16 encode) raises
    ValueError in both packages before any kernel runs."""
    x = _impl_input(fmt, (67, 96), 51)
    x.flat[1], x.flat[-1] = np.inf, -0.0
    want = _raises(lambda: j_encode_2d(jnp.asarray(x), fmt, encode_impl=impl))
    if want is None:
        want = np.array(j_encode_2d(jnp.asarray(x), fmt, encode_impl=impl))
        got = ops.encode(torch.from_numpy(x), fmt, encode_impl=impl)
        assert np.array_equal(got.numpy(), want)
    else:
        assert want is ValueError and (fmt, impl) == ("bf16", "lut")
        assert _raises(lambda: ops.encode(torch.from_numpy(x), fmt, encode_impl=impl)) is ValueError
        want = np.array(j_encode_2d(jnp.asarray(x), fmt, encode_impl="bits"))
    want_d = np.asarray(j_decode_2d(jnp.asarray(want), fmt, decode_impl=impl))
    got_d = ops.decode(torch.from_numpy(want), fmt, decode_impl=impl).numpy()
    assert _same_f32(got_d, want_d)
    with pytest.raises(ValueError):
        ops.decode(torch.from_numpy(want), fmt, decode_impl="table")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_matmul_by_impl_matches_pallas(fmt, impl):
    """K3 with an explicit weight decode against repro's kernel with the same
    impl (1e-5 of |x| @ |w|), and bit for bit against the port's other impl."""
    M, K, N = 37, 130, 100
    x = _rand((M, K), 52)
    w = _rand((K, N), 53, 0.5)
    if fmt in MX_FMTS:
        w_bits = _payload(blockscale.pad_block(torch.from_numpy(w)).numpy(), fmt)
    else:
        w_bits = _bits(w, fmt)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.array(j_matmul(jx, jnp.asarray(w_bits), fmt, bm=32, bn=128, bk=128,
                             decode_impl=impl))[:, :N]
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    tw = torch.from_numpy(w_bits)
    got = ops.matmul(tx, tw, fmt, n=N if fmt in MX_FMTS else None, decode_impl=impl)
    wd = ref.codec_decode_ref(tw, fmt).numpy()[:, :N]
    assert (np.abs(got.numpy() - want) <= 1e-5 * (np.abs(tx.float().numpy()) @ np.abs(wd))).all()
    other = ops.matmul(tx, tw, fmt, n=N if fmt in MX_FMTS else None,
                       decode_impl="bits" if impl == "lut" else "lut")
    assert torch.equal(got, other)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FMTS + MX_FMTS)
def test_decode_attention_by_impl_matches_pallas(fmt, impl):
    """K6 with an explicit K/V decode against repro's kernel with the same
    impl (1e-5 max|v|), and bit for bit against the port's other impl."""
    B, H, Hkv, S, d = 2, 6, 2, 37, 32
    q = _rand((B, H, d), 54)
    if fmt in MX_FMTS:
        k_bits, v_bits = (_payload(_rand((B, Hkv, S, d), s), fmt) for s in (55, 56))
    else:
        k_bits, v_bits = (_bits(_rand((B, Hkv, S, d), s), fmt) for s in (55, 56))
    want = np.array(j_attention(jnp.asarray(q), jnp.asarray(k_bits), jnp.asarray(v_bits),
                                fmt, block_s=16, decode_impl=impl))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k_bits, v_bits))
    got = ops.decode_attention(tq, tk, tv, fmt, decode_impl=impl)
    vmax = np.abs(ref.codec_decode_ref(tv, fmt).numpy()).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * vmax
    other = ops.decode_attention(tq, tk, tv, fmt, decode_impl="bits" if impl == "lut" else "lut")
    assert torch.equal(got, other)


def test_table_pointers_refuse_a_wrong_table(monkeypatch):
    """The kernels read fixed table lengths, so the wrappers hand them only
    tables of the right size, type and device (bits passes null pointers)."""
    from repro_torch.kernels import common

    cpu = torch.device("cpu")
    assert common.table_ptrs(wire_format("t8"), "bits", "decode", cpu) == (0,)
    assert common.table_ptrs(wire_format("t16"), "bits", "encode", cpu) == (0, 0)
    assert all(common.table_ptrs(wire_format("mxt8"), "lut", "encode", cpu))
    assert all(common.table_ptrs(wire_format("t16"), "lut", "encode", cpu))
    good = common.tables_on("t8", "decode", cpu)
    for bad in ((good[0][:128],), (good[0].to(torch.int64),), (torch.zeros(512, dtype=torch.int32),)):
        monkeypatch.setattr(common, "tables_on", lambda *a, bad=bad: bad)
        with pytest.raises(ValueError):
            common.table_ptrs(wire_format("t8"), "lut", "decode", cpu)
