"""llama3-8b (smoke size) serving: the port against ``repro``.

``repro`` initialises the parameters (jax PRNG) and packs them with
``dist.step.quantize_params``; the port receives them through
``convert.params_from_numpy``.  Both prefill the same B=4, S0=16 prompt and
then run 24 decode steps teacher-forced with ``repro``'s greedy tokens, under
the takum, takum8, ofp8, bf16 and mxfp8 policies and ``mxt8`` (takum8 inside
the MX container for weights and KV cache:
``QuantPolicy(weights="mxt8", kv_cache="mxt8")``).  At f32 activations the
port's greedy tokens must equal ``repro``'s at every step.

Tolerances, on max |logit difference| / max |repro logit| per step:
  * activations="f32": 1e-3 (measured 1e-6 to 3e-5; mxfp8 4.3e-4 at one
    step, mxt8 1.2e-6).  Both sides compute in f32 and differ only in
    accumulation order (ROADMAP.md R1) and in K/V codes that an ulp of
    difference moves across a rounding boundary (an mxe4m3 code step is
    1/8 to 1/16 of the value).
  * activations="bf16": 0.12 at any step and 0.04 in the median step
    (measured takum 0.084 / 0.028, takum8 0.030 / 0.016, ofp8 0.020 /
    0.014, bf16 0.015 / 0.011, mxfp8 0.022 / 0.014, mxt8 0.034 / 0.015;
    ``pytest -rP`` prints them).  ``repro`` rounds decoded weights to bf16
    before its dot (``layers.py:24``) while K3 keeps them in f32 (t16 values
    carry up to 11 fraction bits, hence takum's larger gap), and the two
    frameworks round bf16 intermediates at different places.  For scale:
    bf16 activations alone move this model's logits by up to 0.11 of
    max |logit| from its f32 logits.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.dist import step as dstep
from repro.models import transformer as JT
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro.quant.qtensor import QTensor as JQTensor
from repro_torch import configs, convert, serve
from repro_torch.kernels import lut
from repro_torch.models import transformer as T
from repro_torch.quant import blockscale
from repro_torch.quant.policy import POLICIES, QuantPolicy
from repro_torch.quant.qtensor import QTensor

B, S0, STEPS = 4, 16, 24
TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # (any step, median step)
POLICY_NAMES = ("takum", "takum8", "ofp8", "bf16", "mxfp8", "mxt8")
#: policies by name on each side; "mxt8" is not a named policy of repro
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jconfigs.get_smoke("llama3_8b"), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 256, (B, S0)).astype(np.int32)


def _cfgs(policy, act):
    jcfg = jconfigs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(JPOL[policy], activations=act))
    tcfg = configs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(TPOL[policy], activations=act))
    return jcfg, tcfg


def _to_numpy(tree):
    """repro parameter tree -> numpy leaves, QTensors as {bits, fmt, scale}."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        scale = None if tree.scale is None else np.asarray(tree.scale)
        return {"bits": np.asarray(tree.bits), "fmt": tree.fmt, "scale": scale}
    return np.asarray(tree)


def _run_repro(jcfg, qparams, prompt):
    """Prefill + greedy decode in repro; returns the list of logits and the
    tokens fed to each decode step."""
    pre = jax.jit(lambda p, t: JT.prefill(jcfg, dstep.dequantize_params(p), t,
                                          cache_len=S0 + STEPS))
    serve_step = jax.jit(dstep.make_serve_step(jcfg, None))
    logits, cache = pre(qparams, jnp.asarray(prompt))
    outs, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1)
        fed.append(np.asarray(tok))
        logits, cache = serve_step(qparams, {"token": tok}, cache)
        outs.append(np.asarray(logits))
    return outs, fed


def _run_port(tcfg, tparams, prompt, fed):
    prefill = serve.make_prefill_step(tcfg, cache_len=S0 + STEPS)
    step = serve.make_serve_step(tcfg)
    logits, cache = prefill(tparams, {"tokens": torch.from_numpy(prompt.astype(np.int64))})
    outs = [logits.numpy()]
    for tok in fed:
        logits, cache = step(tparams, {"token": torch.from_numpy(tok.astype(np.int64))}, cache)
        outs.append(logits.numpy())
    assert cache.pos == S0 + STEPS
    return outs


def _assert_leaves_equal(port, ref, path=""):
    if isinstance(ref, dict) and set(ref) != {"bits", "fmt", "scale"}:
        for k in ref:
            _assert_leaves_equal(port[k], ref[k], f"{path}.{k}")
        return
    if isinstance(ref, dict):
        assert isinstance(port, QTensor) and port.fmt == ref["fmt"], path
        if port.block_scaled:  # payload = repro's scale bytes beside its element bytes
            assert tuple(port.shape) == ref["bits"].shape, path
            assert np.array_equal(port.scale.numpy(), ref["scale"]), path
            elems = blockscale.unpack_payload(port.bits)[1][..., :port.n]
            assert np.array_equal(elems.numpy(), ref["bits"]), path
            return
        assert np.array_equal(port.bits.numpy(), ref["bits"]), path
        assert port.scale.item() == ref["scale"].item(), path
        return
    got = port.view(torch.int16).numpy().view(ref.dtype) if port.dtype == torch.bfloat16 else port.numpy()
    assert np.array_equal(got, ref), path


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_params_from_numpy_keeps_bits_and_scales(jparams, policy):
    jcfg, tcfg = _cfgs(policy, "f32")
    qparams = dstep.quantize_params(jcfg, jparams)
    ref = _to_numpy(qparams)
    port = convert.params_from_numpy(ref, tcfg, device="cpu")
    _assert_leaves_equal(port, ref)
    # dequantize_params: the same f32 values as repro's, leaf for leaf
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), dstep.dequantize_params(qparams))
    got = serve.dequantize_params(port)
    for path in (("embed",), ("layers", "ln1"), ("layers", "attn", "wq"), ("lm_head",)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert np.array_equal(g.float().numpy(), w), path


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_load_params_decodes_only_the_gains(jparams, policy):
    """load_params turns the packed norm gains into repro's dequantized
    values and passes every other leaf through untouched."""
    jcfg, tcfg = _cfgs(policy, "f32")
    qparams = dstep.quantize_params(jcfg, jparams)
    port = convert.params_from_numpy(_to_numpy(qparams), tcfg, device="cpu")
    loaded = serve.load_params(port)
    want = dstep.dequantize_params(qparams)["layers"]
    for k in ("ln1", "ln2"):
        assert isinstance(loaded["layers"][k], torch.Tensor), k
        assert np.array_equal(loaded["layers"][k].float().numpy(), np.asarray(want[k], np.float32)), k
    for k in ("attn", "mlp"):
        assert loaded["layers"][k] is port["layers"][k]
    for k in ("embed", "lm_head", "final_norm"):
        assert loaded[k] is port[k]


@pytest.mark.parametrize("policy", ("takum", "takum8", "mxt8"))
def test_quantize_params_packs_like_repro(jparams, policy):
    """Same leaves packed, same bits.  The scales are the same power of two;
    repro's is computed by XLA's exp2, which is inexact for |e| > 12 on the
    CPU backend (ROADMAP.md R5), so there it is compared by exponent.  mx
    leaves carry the same E8M0 scale bytes and element bytes."""
    jcfg, tcfg = _cfgs(policy, "f32")
    ref = _to_numpy(dstep.quantize_params(jcfg, jparams))
    f32 = convert.params_from_numpy(_to_numpy(jparams), tcfg, device="cpu")
    port = serve.quantize_params(tcfg, f32)

    def walk(p, r, path):
        if isinstance(r, dict) and set(r) != {"bits", "fmt", "scale"}:
            for k in r:
                walk(p[k], r[k], f"{path}.{k}")
            return
        if not isinstance(r, dict):
            assert np.array_equal(p.numpy(), r), path
            return
        assert isinstance(p, QTensor) and p.fmt == r["fmt"], path
        if p.block_scaled:
            assert np.array_equal(p.scale.numpy(), r["scale"]), path
            assert np.array_equal(blockscale.unpack_payload(p.bits)[1][..., :p.n].numpy(),
                                  r["bits"]), path
            return
        assert np.array_equal(p.bits.numpy(), r["bits"]), path
        e = np.round(np.log2(np.float64(r["scale"])))
        assert p.scale.item() == 2.0 ** e, path
        if abs(e) <= 12:
            assert p.scale.item() == r["scale"].item(), path

    walk(port, ref, "")


@pytest.mark.parametrize("act", ("f32", "bf16"))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_prefill_and_decode_match_repro(jparams, prompt, policy, act):
    jcfg, tcfg = _cfgs(policy, act)
    qparams = dstep.quantize_params(jcfg, jparams)
    want, fed = _run_repro(jcfg, qparams, prompt)
    tparams = serve.load_params(convert.params_from_numpy(_to_numpy(qparams), tcfg, device="cpu"))
    got = _run_port(tcfg, tparams, prompt, fed)
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 256)
        assert np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
        if act == "f32":  # the port's greedy tokens are repro's
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), (policy, len(errs))
    worst, median = TOL[act]
    print(f"{policy}/{act}: max {max(errs):.3g}, median {np.median(errs):.3g}")  # pytest -rP
    assert max(errs) <= worst and np.median(errs) <= median, (policy, act, errs)


def test_cache_append_matches_repro(jparams, prompt):
    """The prefill's packed KV cache equals repro's code for code, except
    codes an accumulation-order ulp moves across a rounding boundary."""
    _check_cache_append(jparams, prompt, "takum")


def test_takum8_cache_append_matches_repro(jparams, prompt, monkeypatch):
    """takum8 (t8 weights and KV cache): the same cache parity, and the CPU
    path goes through the plain table codecs, as the defaults say (t8 encode
    and decode are "lut"), for the KV append, the cache read and the weights."""
    calls = {"decode": 0, "encode": 0}

    def spy(op, fn):
        def counted(*a):
            calls[op] += 1
            return fn(*a)
        return counted

    monkeypatch.setattr(lut, "decode_wire_lut", spy("decode", lut.decode_wire_lut))
    monkeypatch.setattr(lut, "encode_wire_lut", spy("encode", lut.encode_wire_lut))
    _check_cache_append(jparams, prompt, "takum8")
    assert calls["decode"] > 0 and calls["encode"] > 0, calls


def _check_cache_append(jparams, prompt, policy):
    jcfg, tcfg = _cfgs(policy, "f32")
    qparams = dstep.quantize_params(jcfg, jparams)
    _, jcache = JT.prefill(jcfg, dstep.dequantize_params(qparams), jnp.asarray(prompt),
                           cache_len=S0 + 2)
    tparams = convert.params_from_numpy(_to_numpy(qparams), tcfg, device="cpu")
    _, cache = T.prefill(tcfg, tparams, torch.from_numpy(prompt.astype(np.int64)),
                         cache_len=S0 + 2)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        codes = got.numpy().astype(np.int64)
        want = np.asarray(want).astype(np.int64)
        assert codes.shape == want.shape
        assert (codes != want).mean() < 1e-3
        assert (codes[:, :, S0:] == 0).all()
        # _decode_cache reads the codes as repro's _decode_cache does
        want_f = np.asarray(JT._decode_cache(jcfg, jnp.asarray(got.numpy())))
        assert np.array_equal(T._decode_cache(tcfg, got).numpy(), want_f)
    assert cache.pos == S0


@pytest.mark.parametrize("policy", ("mxfp8", "mxt8"))
def test_mx_cache_append_matches_repro(jparams, prompt, policy):
    """An mx KV cache: [L, B, S, Kv, payload_len(hd)] uint8 (hd = 16: one
    33-byte group, 16 padded lanes), equal to repro's byte for byte except
    where an accumulation-order ulp moves a code, and read back by
    _decode_cache as repro reads it."""
    jcfg, tcfg = _cfgs(policy, "f32")
    qparams = dstep.quantize_params(jcfg, jparams)
    _, jcache = JT.prefill(jcfg, dstep.dequantize_params(qparams), jnp.asarray(prompt),
                           cache_len=S0 + 2)
    tparams = serve.load_params(convert.params_from_numpy(_to_numpy(qparams), tcfg, device="cpu"))
    _, cache = T.prefill(tcfg, tparams, torch.from_numpy(prompt.astype(np.int64)),
                         cache_len=S0 + 2)
    hd = tcfg.resolved_head_dim
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        assert got.dtype == torch.uint8 and got.shape[-1] == blockscale.payload_len(hd) == 33
        codes, want = got.numpy(), np.asarray(want)
        assert codes.shape == want.shape
        assert (codes != want).mean() < 1e-3
        assert (codes[:, :, S0:] == 0).all()
        want_f = np.asarray(JT._decode_cache(jcfg, jnp.asarray(codes), hd))
        assert np.array_equal(T._decode_cache(tcfg, got, hd).numpy(), want_f, equal_nan=True)


def test_mx_scale_bytes_survive_the_converter():
    """Every E8M0 byte, 0 and the NaN byte 255 included, crosses
    params_from_numpy unchanged, beside its element bytes (d = 50: a padded
    last block)."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 256, (6, 50)).astype(np.uint8)
    scale = rng.integers(0, 256, (6, 2)).astype(np.uint8)
    scale[0] = [0, 255]
    jq = JQTensor(jnp.asarray(bits), "mxt8", jnp.asarray(scale))
    cfg = configs.get_smoke("llama3_8b").with_(vocab_size=6, d_model=50, tie_embeddings=True)
    leaf = {"bits": bits, "fmt": "mxt8", "scale": scale}
    q = convert.params_from_numpy({"embed": leaf}, cfg, device="cpu")["embed"]
    assert isinstance(q, QTensor) and q.n == 50 and tuple(q.shape) == (6, 50)
    assert q.scale.dtype == torch.uint8 and np.array_equal(q.scale.numpy(), scale)
    assert np.array_equal(q.wire_payload().numpy(), np.asarray(jq.wire_payload()))
    with pytest.raises(TypeError):  # a scale cast to f32 would corrupt the bytes
        convert.params_from_numpy({"embed": {**leaf, "scale": scale.astype(np.float32)}},
                                  cfg, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("llama3_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({}, cfg)
    assert T.init_params(cfg, device="cpu")["embed"].device.type == "cpu"


def test_unported_families_raise():
    """Every family of repro is ported; a family it lacks still raises, and
    llama3-8b's config as a vlm (no cross layers) is refused as repro
    refuses it."""
    assert configs.get("llama3_2_vision_90b").family == "vlm"
    with pytest.raises(NotImplementedError):
        configs.get_smoke("llama3_8b").with_(family="encdec")
    with pytest.raises(ValueError):
        configs.get_smoke("llama3_8b").with_(family="vlm")


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, ``chip_smoke.py`` and the ISA / figure
    modules (``core/isa.py``, ``core/formats.py``, ``core/posit_np.py``)
    load without jax, ``repro`` or ``ml_dtypes``, which the card machine
    lacks; ``chip_smoke.py`` names none of them in an import either."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from repro_torch.core import formats, isa, posit_np\n"
        "assert len(isa.REGISTRY) == 15 and len(formats.FORMATS) == 15\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         env={**os.environ, "PYTHONPATH": f"{root / 'src'}{os.pathsep}{root}"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", (root / "chip_smoke.py").read_text(),
                         re.M)
    assert not [m for m in imports if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
