"""The f32 KV cache: the port against ``repro``.

``repro`` stores an f32 cache as the values themselves and its kernels move
f32 as raw IEEE bits (``bitcast_convert_type`` both ways); the port's K1,
K2 and K6 take ``fmt="f32"`` the same way (uint32 storage).

* K2 / K1 of f32 (``ops.encode`` / ``ops.decode`` on the CPU: their plain
  versions) bit for bit against ``repro``'s ``ops.encode`` / ``ops.decode``
  (Pallas, interpret mode) over random bit patterns with subnormals, +-0,
  +-Inf and NaN payloads among them: no DAZ, no NaN made canonical.
* K6's plain version over an f32 cache against ``repro``'s
  ``ops.decode_attention(..., "f32")``: 1e-5 of max |v|, the limit of
  ``tests/test_torch_kernels.py``'s K6 cases.
* ``repro``'s ``test_prefill_decode_consistency`` held in the port for all
  ten archs under f32, t16 and t8 caches, with ``repro``'s own rules
  (``tests/test_arch_smoke.py``: f32 within 2e-2; t16 argmax agreement
  above 0.8; t8 logit correlation above 0.98; moe at capacity factor E;
  the ssm family under f32 only), on ``repro``'s parameters (the vlm's
  gates drawn nonzero); the port's full-forward logits are also held
  against ``repro``'s at f32 activations (1e-3 of max |logit|).
* K6's shared memory under an f32 cache (4-byte rows) fits the card's
  227 KiB at every arch's decode shape.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro_torch import configs, convert
from repro_torch.core import formats
from repro_torch.kernels import ops
from repro_torch.kernels.takum_attention import SMEM_LIMIT, split_smem_bytes
from repro_torch.kernels.takum_codec import encode_into_plain
from repro_torch.models import transformer as T
from repro_torch.quant.policy import QuantPolicy

from _vlm import _np, gated_params

ARCHS = jconfigs.ARCHS
B, S, S0 = 2, 16, 8


def _f32_sweep(n: int, seed: int) -> np.ndarray:
    """uint32 bit patterns: random words, then every class by name (+-0,
    the subnormal extremes, +-Inf, quiet and signalling NaNs with payloads,
    the normal extremes)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    sub = rng.integers(1, 1 << 23, 64, dtype=np.uint64).astype(np.uint32)  # subnormals
    named = np.array([0, 0x80000000, 1, 0x807FFFFF, 0x007FFFFF, 0x80000001, 0x7F800000,
                      0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF, 0xFFC12345,
                      0x7FF00F0F, 0x00800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000], np.uint32)
    return np.concatenate([words, sub, sub | 0x80000000, named])


@pytest.mark.parametrize("shape", [(1000,), (37, 29), (3, 5, 64)])
def test_f32_codecs_equal_repro_bit_for_bit(shape):
    n = int(np.prod(shape))
    bits = _f32_sweep(n, n)[:n] if n >= 300 else np.resize(_f32_sweep(n, n), n)
    bits = bits.reshape(shape)
    x = bits.view(np.float32)
    got = ops.encode(torch.from_numpy(x.copy()), "f32")
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    want = np.asarray(jops.encode(jnp.asarray(x), "f32"))
    got_np = got.view(torch.int32).numpy().view(np.uint32)
    assert np.array_equal(got_np, want) and np.array_equal(got_np, bits)
    dec = ops.decode(got, "f32")
    wdec = np.asarray(jops.decode(jnp.asarray(bits), "f32"))
    assert np.array_equal(dec.numpy().view(np.uint32), wdec.view(np.uint32))
    assert np.array_equal(dec.numpy().view(np.uint32), bits)  # subnormals and payloads kept


def test_f32_append_writes_raw_bits():
    """``encode_into`` of an f32 and of a bf16 source into an f32 cache's
    slots: the bits of the source (a bf16 value widened exactly); the
    storage around the slots untouched."""
    bits = _f32_sweep(4 * 6 * 8, 3)[:192]
    src = torch.from_numpy(bits.view(np.float32).reshape(24, 8).copy())
    cache = torch.full((2, 4 * 10 * 8), 0x5A5A5A5A, dtype=torch.int32).view(torch.uint32)
    dst = [cache[i].view(4, 80)[:, 16:64] for i in range(2)]
    encode_into_plain(src, dst[0], "f32")
    encode_into_plain(src.to(torch.bfloat16), dst[1], "f32")
    c = cache.view(torch.int32).numpy().view(np.uint32).reshape(2, 4, 80)
    assert np.array_equal(c[0][:, 16:64].reshape(-1), bits)
    widened = src.to(torch.bfloat16).to(torch.float32).numpy().view(np.uint32).reshape(-1)
    nan = np.isnan(src.numpy().reshape(-1))
    assert np.array_equal(c[1][:, 16:64].reshape(-1)[~nan], widened[~nan])
    assert (c[:, :, :16] == 0x5A5A5A5A).all() and (c[:, :, 64:] == 0x5A5A5A5A).all()


@pytest.mark.parametrize("B_,H,Hkv,S_,d", [(2, 4, 2, 45, 16), (1, 8, 1, 130, 32)])
def test_decode_attention_over_an_f32_cache_equals_repro(B_, H, Hkv, S_, d):
    rng = np.random.default_rng(S_)
    q = rng.standard_normal((B_, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B_, Hkv, S_, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(jops.decode_attention(jnp.asarray(q), jops.encode(jnp.asarray(k), "f32"),
                                            jops.encode(jnp.asarray(v), "f32"), "f32"))
    kb, vb = (ops.encode(torch.from_numpy(t), "f32") for t in (k, v))
    got = ops.decode_attention(torch.from_numpy(q), kb, vb, "f32").numpy()
    assert got.shape == want.shape == (B_, H, d)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(v).max()


def test_f32_is_refused_where_no_kernel_takes_it():
    """K3 / K4 over f32 weight bits and an f32 out format are not ported
    (no path packs IEEE weights); the codec knob has no tables for f32."""
    x, w = torch.zeros(4, 8), torch.zeros(8, 4, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        ops.matmul(x, w, "f32")
    with pytest.raises(ValueError):
        ops.dual_matmul(w.T.contiguous(), w, "f32")
    with pytest.raises(ValueError):
        ops.matmul(x, torch.zeros(8, 4, dtype=torch.uint8), "t8", out_fmt="f32")
    with pytest.raises(ValueError):
        ops.decode(w, "f32", decode_impl="lut")
    assert formats.wire_format("f32").code == 8
    assert "f32" not in formats.kernel_wire_names() and "f32" not in ops.supported_wire_formats()


@pytest.mark.parametrize("kv_fmt", ["f32", "t16", "t8", "bf16", "mxt8"])
def test_k6_shared_memory_fits_at_every_arch(kv_fmt):
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        if cfg.family == "ssm":
            continue
        g, d = cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim
        for impl in ("bits", "lut") if kv_fmt in ("t8", "mxt8") else ("bits",):
            smem = split_smem_bytes(kv_fmt, impl, g, d)
            assert smem <= SMEM_LIMIT, (arch, kv_fmt, smem)
    # llama3-8b and the vlm at hd 128: two tiles of 32 K and V rows of 528
    # staged bytes, and the f32 regions
    assert split_smem_bytes("f32", "bits", 4, 128) == 4 * 32 * 528 + 4 * (
        2 * 4 * 128 + 32 * 129 + 32 * 128 + 4 * 32 + 12)


# ---------------------------------------------------------------------------
# repro's prefill-then-decode consistency, in the port
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(arch):
    """``repro``'s parameters of the smoke arch (``PRNGKey(2)``, its test's
    key) as numpy; the vlm's gates and cross norm gains drawn nonzero."""
    if configs.get_smoke(arch).family == "vlm":
        return gated_params(2)
    return _np(jax.jit(lambda k: JT.init_params(jconfigs.get_smoke(arch), k))(
        jax.random.PRNGKey(2)))


def _cfg(arch, kv_fmt, jax_side=False):
    get = jconfigs.get_smoke if jax_side else configs.get_smoke
    pol = (JQuantPolicy if jax_side else QuantPolicy)(kv_cache=kv_fmt, activations="f32")
    cfg = get(arch).with_(quant=pol)
    if cfg.family == "moe":  # repro's rule: the no-drop regime
        cfg = cfg.with_(moe_capacity_factor=float(cfg.num_experts))
    return cfg


def _batch(cfg):
    """``tests/test_arch_smoke.py``'s ``_batch(cfg, B, S, seed=3)``."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    media = None
    if cfg.family == "vlm":
        media = rng.standard_normal((B, cfg.num_media_tokens, cfg.media_d)).astype(np.float32)
    return tokens, media


@functools.lru_cache(maxsize=None)
def _repro_logits(arch):
    jcfg = _cfg(arch, "f32", jax_side=True)
    tokens, media = _batch(jcfg)
    fwd = jax.jit(lambda p, t, m: JT.forward(jcfg, p, t, media=m)[0])
    return np.asarray(fwd(jax.tree.map(jnp.asarray, _params(arch)), jnp.asarray(tokens),
                          None if media is None else jnp.asarray(media)))


@pytest.mark.parametrize("kv_fmt", ["f32", "t16", "t8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, kv_fmt):
    cfg = _cfg(arch, kv_fmt)
    if cfg.family == "ssm" and kv_fmt != "f32":
        pytest.skip("ssm has no KV cache (repro's rule: the f32 case only)")
    params = convert.params_from_numpy(_params(arch), cfg, device="cpu")
    tokens, media = _batch(cfg)
    tokens = torch.from_numpy(tokens.astype(np.int64))
    media = None if media is None else torch.from_numpy(media)
    full, _ = T.forward(cfg, params, tokens, media)
    if kv_fmt == "f32":
        want = _repro_logits(arch)
        assert np.abs(full.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    last, cache = T.prefill(cfg, params, tokens[:, :S0], media, cache_len=S)
    if cfg.family != "ssm":
        assert cache.k.dtype == (torch.float32 if kv_fmt == "f32" else
                                 formats.wire_format(kv_fmt).storage)
    np.testing.assert_allclose(last.numpy(), full[:, S0 - 1].numpy(), rtol=2e-2, atol=2e-2)
    steps = []
    for t in range(S0, S):
        lg, cache = T.decode_step(cfg, params, tokens[:, t], cache, media)
        steps.append(lg.numpy())
    got, want = np.stack(steps, 1), full[:, S0:].numpy()
    if kv_fmt == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        if cfg.family != "ssm":  # an exact cache: only the summation order differs
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    elif kv_fmt == "t16":
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree > 0.8, agree
    else:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert corr > 0.98, corr
