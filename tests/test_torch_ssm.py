"""The ssm and hybrid families (mamba2-780m, hymba-1.5b): configs, the
Mamba-2 mixer, packing and loading, against ``repro``.

* Configs field for field (published and smoke), aliases, ``repro``'s
  checks; ``_chunk_of`` and the mixer's width.
* The mixer alone at f32 on ``repro``'s ``init_mamba`` weights (conv_b and
  norm_g drawn non-zero so that they count): ``mamba_forward`` at S a
  multiple of the chunk (three chunks: the inter-chunk recurrence carries
  state) and at S where ``_chunk_of`` picks an odd divisor (30 -> 15), its
  output and its post-sequence cache (conv tail, SSM state); then 8
  ``mamba_decode_step`` steps from that cache.  Each within 1e-5 of its
  max|value| (measured 2e-7 to 1.2e-6: the order of the sums).  bf16 u
  follows jnp's promotion on both sides: the f32 weights make the
  projections, the gated norm and the output f32 (measured 9e-7 and
  4.9e-6 of max|y|, limit 1e-5).
* Packing: ``quantize_params`` equals ``repro``'s bit for bit on every
  leaf, the eight ``MambaParams`` leaves included, under takum, takum8 and
  mxt8 (scales by exponent where ``repro``'s exp2 is inexact, ROADMAP R5);
  ``load_params`` decodes exactly the gains and the six small mixer
  leaves, to ``repro``'s dequantized values, and leaves ``in_proj``,
  ``out_proj``, the embedding and the head packed.
* The mixer's K3 launches a layer and call (two: ``in_proj``, ``out_proj``)
  and hymba's nine, through monkeypatched wrappers on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.dist import step as dstep
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import configs, convert, serve
from repro_torch.kernels import ops
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as T
from repro_torch.quant import blockscale
from repro_torch.quant.qtensor import QTensor

from _ssm_serve import cfgs, jparams, np_tree, qparams  # noqa: E402

ARCHS = ("mamba2_780m", "hymba_1_5b")
MIX_TOL = 1e-5


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro_field_for_field(arch, smoke):
    get, jget = (configs.get_smoke, jconfigs.get_smoke) if smoke else (configs.get, jconfigs.get)
    tcfg, jcfg = get(arch), jget(arch)
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"quant"}
    assert {"ssm_state", "ssm_expand", "ssm_head_dim", "ssm_conv_width", "ssm_chunk"} <= tf
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(jcfg):
        if f.name not in tf | {"quant", "attn_chunk_q", "attn_chunk_kv"}:
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            assert getattr(jcfg, f.name) == default, f.name
    alias = next(k for k, v in jconfigs.ALIASES.items() if v == arch)
    assert get(alias) == tcfg and arch in configs.ARCHS
    assert T._ssm_d_in(tcfg) == JT._ssm_d_in(jcfg)


def test_ssm_configs_are_checked_as_repro_checks_them():
    for arch, bad in (("mamba2_780m", dict(ssm_state=0)), ("hymba_1_5b", dict(ssm_state=0)),
                      ("hymba_1_5b", dict(num_heads=0))):
        with pytest.raises(ValueError):
            configs.get_smoke(arch).with_(**bad)
        with pytest.raises(AssertionError):
            jconfigs.get_smoke(arch).with_(**bad)
    assert configs.get("mamba2_780m").num_heads == 0  # attention-free: no heads check
    with pytest.raises(ValueError):  # a vlm needs cross layers, as repro asserts
        configs.get_smoke("llama3_8b").with_(family="vlm")


def test_chunk_of_equals_repro():
    for S in range(1, 300):
        for want in (1, 7, 16, 256):
            assert T._chunk_of(S, want) == JT._chunk_of(S, want), (S, want)
    assert T._chunk_of(30, 16) == 15 and T._chunk_of(4096, 256) == 256


# ---------------------------------------------------------------------------
# the mixer alone
# ---------------------------------------------------------------------------

#: (d_model, d_in, N, hd, S, chunk): mamba2 smoke's widths at three chunks,
#: hymba smoke's at an odd chunk
MIXERS = ((64, 128, 16, 16, 48, 16), (64, 64, 8, 16, 30, 16))


@functools.lru_cache(maxsize=None)
def _mixer_params(d, d_in, N, hd):
    jp = JM.init_mamba(jax.random.PRNGKey(1), d, d_in, N, hd, 4)
    jp = jp._replace(conv_b=jax.random.normal(jax.random.PRNGKey(5), jp.conv_b.shape) * 0.1,
                     norm_g=jax.random.normal(jax.random.PRNGKey(6), jp.norm_g.shape) * 0.1)
    return jp, TM.MambaParams(*(torch.from_numpy(np.array(a)) for a in jp))


@functools.lru_cache(maxsize=None)
def _jforward(N, hd, chunk, state):
    return jax.jit(functools.partial(JM.mamba_forward, N=N, hd=hd, chunk=chunk,
                                     return_state=state))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", MIXERS)
def test_mixer_forward_and_decode_match_repro(case):
    d, d_in, N, hd, S, want_chunk = case
    chunk = T._chunk_of(S, want_chunk)
    assert S // chunk >= 2
    jp, tp = _mixer_params(d, d_in, N, hd)
    u = np.random.default_rng(0).standard_normal((2, S, d)).astype(np.float32)
    want, jc = _jforward(N, hd, chunk, True)(jp, jnp.asarray(u))
    got, tc = TM.mamba_forward(tp, torch.from_numpy(u), N=N, hd=hd, chunk=chunk,
                               return_state=True)
    alone = TM.mamba_forward(tp, torch.from_numpy(u), N=N, hd=hd, chunk=chunk)
    assert torch.equal(alone, got)
    assert tc.conv.shape == jc.conv.shape and tc.ssm.shape == jc.ssm.shape
    assert tc.conv.dtype == torch.float32 and tc.ssm.dtype == torch.float32
    errs = [_rel(got, want), _rel(tc.conv, jc.conv), _rel(tc.ssm, jc.ssm)]
    step = jax.jit(functools.partial(JM.mamba_decode_step, N=N, hd=hd))
    for i in range(8):
        x = np.random.default_rng(10 + i).standard_normal((2, d)).astype(np.float32)
        wy, jc = step(jp, jnp.asarray(x), jc)
        gy, tc = TM.mamba_decode_step(tp, torch.from_numpy(x), tc, N=N, hd=hd)
        errs += [_rel(gy, wy), _rel(tc.conv, jc.conv), _rel(tc.ssm, jc.ssm)]
    print(f"{case}: chunk {chunk}, forward / conv / ssm {errs[:3]}, decode worst {max(errs[3:])}")
    assert max(errs) <= MIX_TOL, errs


@pytest.mark.parametrize("case", MIXERS)
def test_mixer_bf16_input_promotes_as_jnp(case):
    """bf16 u: z, xbc, dt and the output are f32 (the weights are f32), the
    SSD's y rounded to bf16 before the gated norm, on both sides."""
    d, d_in, N, hd, S, want_chunk = case
    chunk = T._chunk_of(S, want_chunk)
    jp, tp = _mixer_params(d, d_in, N, hd)
    u = jnp.asarray(np.random.default_rng(2).standard_normal((2, S, d)), jnp.bfloat16)
    want = _jforward(N, hd, chunk, False)(jp, u)
    tu = torch.from_numpy(np.asarray(u.astype(jnp.float32))).to(torch.bfloat16)
    got = TM.mamba_forward(tp, tu, N=N, hd=hd, chunk=chunk)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    cache = TM.init_mamba_cache(2, d_in, N, hd, 4)
    y, mc = TM.mamba_decode_step(tp, tu[:, 0], cache, N=N, hd=hd)
    assert y.dtype == torch.float32 and mc.conv.dtype == torch.float32
    err = _rel(got, want)
    print(f"{case}: bf16 u, f32 output within {err:.3g} of max|y|")
    assert err <= MIX_TOL


# ---------------------------------------------------------------------------
# packing and loading
# ---------------------------------------------------------------------------


def _walk(p, r, path=""):
    """Hold a port tree's leaves to repro's numpy tree: packed leaves bit
    for bit (scales by exponent beyond |e| = 12, ROADMAP R5)."""
    if isinstance(r, tuple) and hasattr(r, "_fields"):
        assert isinstance(p, TM.MambaParams) and p._fields == r._fields, path
        return sum(_walk(getattr(p, k), getattr(r, k), f"{path}.{k}") for k in r._fields)
    if isinstance(r, dict) and set(r) != {"bits", "fmt", "scale"}:
        return sum(_walk(p[k], r[k], f"{path}.{k}") for k in r)
    if not isinstance(r, dict):
        assert np.array_equal(p.numpy(), r), path
        return 0
    assert isinstance(p, QTensor) and p.fmt == r["fmt"], path
    if p.block_scaled:
        assert np.array_equal(p.scale.numpy(), r["scale"]), path
        assert np.array_equal(blockscale.unpack_payload(p.bits)[1][..., :p.n].numpy(),
                              r["bits"]), path
        return 1
    assert np.array_equal(p.bits.numpy(), r["bits"]), path
    e = np.round(np.log2(np.float64(r["scale"])))
    assert p.scale.item() == 2.0 ** e, path
    if abs(e) <= 12:
        assert p.scale.item() == r["scale"].item(), path
    return 1


@pytest.mark.parametrize("policy", ["takum", "takum8", "mxt8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_packs_like_repro(arch, policy):
    _, tcfg = cfgs(arch, policy, "f32")
    f32 = convert.params_from_numpy(np_tree(jparams(arch)), tcfg, device="cpu")
    port = serve.quantize_params(tcfg, f32)
    assert isinstance(port["layers"]["ssm"], TM.MambaParams)
    packed = _walk(port, np_tree(qparams(arch, policy)))
    assert packed == (10 if arch == "mamba2_780m" else 19)
    assert all(isinstance(v, QTensor) for v in port["layers"]["ssm"])


@pytest.mark.parametrize("policy", ["takum", "mxt8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_load_params_decodes_the_gains_and_the_small_mixer_leaves(arch, policy):
    _, tcfg = cfgs(arch, policy, "f32")
    qp = qparams(arch, policy)
    port = convert.params_from_numpy(np_tree(qp), tcfg, device="cpu")
    loaded = serve.load_params(port)
    want = jax.jit(dstep.dequantize_params)(qp)["layers"]
    decoded = [("ln1",)] + ([("ln2",)] if tcfg.family == "hybrid" else [])
    decoded += [("ssm", k) for k in TM.SMALL_LEAVES]
    for path in decoded:
        got, ref, before = loaded["layers"], want, port["layers"]
        for k in path:
            get = getattr if k in TM.MambaParams._fields else (lambda t, n: t[n])
            got, ref, before = get(got, k), get(ref, k), get(before, k)
        assert isinstance(before, QTensor) and isinstance(got, torch.Tensor), path
        assert np.array_equal(got.numpy(), np.asarray(ref, np.float32)), path
    pr, pr0 = loaded["layers"]["ssm"], port["layers"]["ssm"]
    assert pr.in_proj is pr0.in_proj and pr.out_proj is pr0.out_proj
    for k in ("embed", "final_norm") + (("lm_head",) if "lm_head" in port else ()):
        assert loaded[k] is port[k]
    for k in ("attn", "mlp"):
        assert loaded["layers"].get(k) is port["layers"].get(k)


def _spy(monkeypatch, name):
    calls, real = [], getattr(ops, name)

    def rec(*a, **k):
        calls.append(tuple(a[1].shape))
        return real(*a, **k)

    monkeypatch.setattr(ops, name, rec)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_k3_launches_per_layer_and_call(monkeypatch, arch):
    """Per layer and call: the mixer's two K3 (in_proj, out_proj) and for
    hymba the four attention and three MLP linears; the head one K3
    (hymba) or one transposed K3 over the table (mamba2, tied)."""
    _, tcfg = cfgs(arch, "takum", "f32")
    qp = serve.load_params(serve.quantize_params(tcfg, T.init_params(tcfg, 0, device="cpu")))
    mm, mm_t = _spy(monkeypatch, "takum_matmul"), _spy(monkeypatch, "takum_matmul_t")
    logits, cache = serve.make_prefill_step(tcfg, 12)(qp, {"tokens": torch.arange(20).view(2, 10)})
    assert tcfg.family == "hybrid" or cache.k.numel() == 0
    calls = [len(mm)]
    serve.make_serve_step(tcfg)(qp, {"token": logits.argmax(-1)}, cache)
    calls.append(len(mm) - calls[0])
    per_layer = 2 if tcfg.family == "ssm" else 9
    head = 0 if tcfg.tie_embeddings else 1
    assert calls == [per_layer * tcfg.num_layers + head] * 2, calls
    assert len(mm_t) == (2 if tcfg.tie_embeddings else 0)
    d_in = T._ssm_d_in(tcfg)
    P = 2 * d_in + 2 * tcfg.ssm_state + d_in // tcfg.ssm_head_dim
    assert mm.count((tcfg.d_model, P)) == 2 * tcfg.num_layers
    assert mm.count((d_in, tcfg.d_model)) >= 2 * tcfg.num_layers
