"""The other archs of the dense block (llama3.2-3b, gemma2-2b, granite-34b,
musicgen-large; smoke size): the port against ``repro``.

``repro`` draws each arch's parameters (``init_params(PRNGKey(0))``) and
packs them (``dist.step.quantize_params``); the port receives them through
``convert.params_from_numpy``.  Both prefill one B=4, S0=16 prompt and run
24 decode steps teacher-forced with ``repro``'s greedy tokens, as
``tests/test_torch_serve.py`` does for llama3-8b and with its limits
(``TOL``: 1e-3 of max|logit| at f32 activations, where the greedy tokens
must also agree; 0.12 at any step and 0.04 in the median step at bf16).
Positions run past gemma2 smoke's 16-key window, so its local layers drop
keys in the decode steps.  The tied head reads the packed table through
the transposed K3 (t16, t8) or K1-mx then one matmul (mxt8).

Other limits: gemma2's embedding scale bit for bit against ``repro``'s
``embed[tokens].astype(adt) * d**0.5``; ``loss_fn`` and its grads at f32
within 1e-5 relative on the loss and 1e-4 of max|grad| per leaf, as
``tests/test_torch_train.py`` holds llama3-8b's (both sides in f32; only
the accumulation order differs).  ``repro``'s steps are jitted once per
(arch, policy, activations), its packing once per (arch, policy) and its
``value_and_grad`` once per arch.
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
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro.quant.qtensor import QTensor as JQTensor
from repro_torch import configs, convert, serve, tree
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES, QuantPolicy
from repro_torch.quant.qtensor import QTensor, dequantize, quantize

ARCHS = ("llama3_2_3b", "gemma2_2b", "granite_34b", "musicgen_large")
B, S0, STEPS = 4, 16, 24
TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # (any step, median step)
#: the any-step limit at f32 where a policy's 8-bit mx KV cache lets an
#: accumulation-order ulp flip a code: chip_smoke.py's phase (e) limit for
#: mxt8.  llama3.2-3b reads 1.15e-3 from step 16 on: one V element of layer
#: 1 (batch row 2, position 31) sits near the midpoint of two t8 codes and
#: is stored as 0.6875 by the port, 0.625 by repro; every earlier step
#: reads under 1e-6.  Its share of differing cache bytes is checked too.
F32_ANY_STEP = {"mxt8": 2e-3}
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}
#: (arch, policy, activations) served against repro: every arch at f32 under
#: takum and takum8, the mx tied head, gemma2 at bf16
SERVE_CASES = ([(a, p, "f32") for a in ARCHS for p in ("takum", "takum8")]
               + [("llama3_2_3b", "mxt8", "f32"), ("gemma2_2b", "mxt8", "f32"),
                  ("gemma2_2b", "takum", "bf16")])


def _np(tree_):
    """repro tree -> numpy leaves, QTensors as {bits, fmt, scale}."""
    if isinstance(tree_, dict):
        return {k: _np(v) for k, v in tree_.items()}
    if isinstance(tree_, JQTensor):
        return {"bits": np.asarray(tree_.bits), "fmt": tree_.fmt,
                "scale": None if tree_.scale is None else np.asarray(tree_.scale)}
    return np.asarray(tree_)


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return JT.init_params(jconfigs.get_smoke(arch), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _qparams(arch, policy):
    """``repro``'s packed tree of ``arch`` under ``policy`` (jitted: one
    compile instead of many eager encodes)."""
    jcfg = _cfgs(arch, policy, "f32")[0]
    return jax.jit(functools.partial(dstep.quantize_params, jcfg))(_jparams(arch))


def _cfgs(arch, policy, act, **kw):
    jcfg = jconfigs.get_smoke(arch).with_(
        quant=dataclasses.replace(JPOL[policy], activations=act), **kw)
    tcfg = configs.get_smoke(arch).with_(
        quant=dataclasses.replace(TPOL[policy], activations=act), **kw)
    return jcfg, tcfg


def _prompt(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro_field_for_field(arch, smoke):
    """Every field of the port's config equals ``repro``'s, and every field
    the port lacks (MoE, SSM, vlm knobs) sits at ``repro``'s default, so
    nothing of the arch is dropped; the aliases resolve alike."""
    get, jget = (configs.get_smoke, jconfigs.get_smoke) if smoke else (configs.get, jconfigs.get)
    tcfg, jcfg = get(arch), jget(arch)
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"quant"}
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(jcfg):
        if f.name not in tf | {"quant", "attn_chunk_q", "attn_chunk_kv"}:
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            assert getattr(jcfg, f.name) == default, f.name
    alias = next(k for k, v in jconfigs.ALIASES.items() if v == arch)
    assert get(alias) == tcfg and tcfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("arch", ["llama3_2_vision_90b"])
def test_other_families_still_raise(arch):
    """The vlm, the last of repro's families, is ported: it loads, and what
    still raises is a vlm config repro refuses and a family it lacks."""
    assert configs.get(arch).family == configs.get_smoke(arch).family == "vlm"
    with pytest.raises(ValueError):
        configs.get_smoke(arch).with_(cross_attn_every=0)
    with pytest.raises(NotImplementedError):
        configs.get_smoke(arch).with_(family="encdec")


@pytest.mark.parametrize("arch", ARCHS + ("llama3_8b",))
def test_layer_windows_equal_repro(arch):
    for cfg, jcfg in ((configs.get(arch), jconfigs.get(arch)),
                      (configs.get_smoke(arch), jconfigs.get_smoke(arch))):
        assert T._layer_windows(cfg) == np.asarray(JT._layer_windows(jcfg)).tolist()
    if arch == "gemma2_2b":
        assert T._layer_windows(configs.get(arch))[:3] == [4096, 0, 4096]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _run_repro(jcfg, qparams, prompt):
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
    return outs, fed, cache


def _run_port(tcfg, tparams, prompt, fed):
    prefill = serve.make_prefill_step(tcfg, cache_len=S0 + STEPS)
    step = serve.make_serve_step(tcfg)
    logits, cache = prefill(tparams, {"tokens": torch.from_numpy(prompt.astype(np.int64))})
    outs = [logits.numpy()]
    for tok in fed:
        logits, cache = step(tparams, {"token": torch.from_numpy(tok.astype(np.int64))}, cache)
        outs.append(logits.numpy())
    assert cache.pos == S0 + STEPS
    return outs, cache


@pytest.mark.parametrize("arch,policy,act", SERVE_CASES)
def test_prefill_and_decode_match_repro(arch, policy, act):
    jcfg, tcfg = _cfgs(arch, policy, act)
    qparams = _qparams(arch, policy)
    prompt = _prompt(tcfg)
    want, fed, jcache = _run_repro(jcfg, qparams, prompt)
    tparams = serve.load_params(convert.params_from_numpy(_np(qparams), tcfg, device="cpu"))
    assert ("lm_head" in tparams) != tcfg.tie_embeddings
    got, cache = _run_port(tcfg, tparams, prompt, fed)
    for c, jc in ((cache.k, jcache.k), (cache.v, jcache.v)):  # codes an order ulp moved
        differ = (c.view(torch.uint8).numpy() != np.asarray(jc).view(np.uint8)).mean()
        assert act == "bf16" or differ < 1e-3, differ
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, tcfg.vocab_size)
        assert np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
        if act == "f32":
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), (arch, policy, len(errs))
    worst, median = TOL[act]
    if act == "f32":
        worst = F32_ANY_STEP.get(policy, worst)
    print(f"{arch} {policy}/{act}: max {max(errs):.3g}, median {np.median(errs):.3g}")
    assert max(errs) <= worst and np.median(errs) <= median, (arch, policy, act, errs)


def test_load_params_decodes_the_post_norm_gains():
    jcfg, tcfg = _cfgs("gemma2_2b", "takum", "f32")
    qparams = _qparams("gemma2_2b", "takum")
    port = convert.params_from_numpy(_np(qparams), tcfg, device="cpu")
    loaded = serve.load_params(port)
    want = dstep.dequantize_params(qparams)["layers"]
    for k in ("ln1", "ln2", "ln1_post", "ln2_post"):
        assert isinstance(port["layers"][k], QTensor), k
        assert isinstance(loaded["layers"][k], torch.Tensor), k
        assert np.array_equal(loaded["layers"][k].numpy(), np.asarray(want[k], np.float32)), k
    assert loaded["embed"] is port["embed"] and "lm_head" not in loaded


def _spy(monkeypatch, name):
    """Replace ``ops.<name>`` (a kernel wrapper ops imported) by a recorder
    that calls it; returns the list of its calls' arguments."""
    calls, real = [], getattr(ops, name)

    def rec(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(ops, name, rec)
    return calls


@pytest.mark.parametrize("policy", ["takum", "takum8", "mxt8"])
def test_tied_head_reads_the_packed_table(monkeypatch, policy):
    """Per prefill or decode call, a flat packed table goes through one
    transposed K3 over the embedding's own bits (no transposed copy), and
    an mx table through one K1-mx decode (with no transposed K3); the
    linears' K3 never sees the table."""
    _, tcfg = _cfgs("llama3_2_3b", policy, "f32")
    qp = serve.load_params(serve.quantize_params(tcfg, T.init_params(tcfg, 0, device="cpu")))
    emb = qp["embed"]
    mm_t, mm, dec = (_spy(monkeypatch, n) for n in
                     ("takum_matmul_t", "takum_matmul", "takum_decode_2d"))
    logits, cache = serve.make_prefill_step(tcfg, 8)(qp, {"tokens": torch.arange(12).view(2, 6)})
    serve.make_serve_step(tcfg)(qp, {"token": logits.argmax(-1)}, cache)
    assert all(a[1].data_ptr() != emb.bits.data_ptr() for a in mm)
    if emb.block_scaled:
        assert not mm_t and len(dec) == 2
        assert all(a[0].data_ptr() == emb.bits.data_ptr() for a in dec)
    else:
        assert len(mm_t) == 2 and not dec
        assert all(a[1] is emb.bits or a[1].data_ptr() == emb.bits.data_ptr() for a in mm_t)
        assert all(a[1].shape == (tcfg.vocab_size, tcfg.d_model) for a in mm_t)


# ---------------------------------------------------------------------------
# gemma2's embedding scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("act", ["bf16", "f32"])
@pytest.mark.parametrize("d", [144, 80])
def test_embedding_scale_bit_for_bit(d, act, packed):
    """The rows times sqrt(d) equal ``repro``'s ``embed[tokens].astype(adt) *
    d**0.5`` bit for bit, from a plain table and from a t16 table through
    K1's rows: sqrt(144) = 12 and sqrt(80) (irrational: the constant's own
    rounding to bf16 matters)."""
    cfg = configs.get_smoke("gemma2_2b").with_(
        d_model=d, quant=dataclasses.replace(POLICIES["takum"], activations=act))
    rng = np.random.default_rng(d)
    table = (rng.standard_normal((cfg.vocab_size, d)) * d ** -0.5).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (8, 125)).astype(np.int64)
    e = quantize(torch.from_numpy(table), "t16", scaled=True) if packed else torch.from_numpy(table)
    values = dequantize(e).numpy() if packed else table
    adt = jnp.bfloat16 if act == "bf16" else jnp.float32
    want = np.asarray((jnp.asarray(values)[jnp.asarray(tokens)].astype(adt) * d ** 0.5)
                      .astype(jnp.float32))
    tdt = torch.bfloat16 if act == "bf16" else torch.float32
    got = T._input_rows(cfg, {"embed": e}, torch.from_numpy(tokens), tdt)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), want)
    if d == 80 and act == "bf16":  # the test sees the trap: a Python float scalar
        naive = torch.from_numpy(values)[torch.from_numpy(tokens)].to(tdt) * d ** 0.5
        assert not np.array_equal(naive.float().numpy(), want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_S = 32  # > gemma2 smoke's window of 16: its local layers drop keys


@functools.lru_cache(maxsize=None)
def _repro_value_and_grad(arch):
    jcfg = _cfgs(arch, "bf16", "f32")[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))


@pytest.mark.parametrize("arch", ["gemma2_2b", "llama3_2_3b"])
def test_loss_and_grads_match_repro(arch):
    """The tied embedding's grad (rows plus head), the softcaps and the
    windows: loss within 1e-5 relative, each grad within 1e-4 of its max."""
    _, tcfg = _cfgs(arch, "bf16", "f32")
    jparams = _jparams(arch)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, TRAIN_S)).astype(np.int32)
    (want, _), wgrads = _repro_value_and_grad(arch)(jparams, {"tokens": jnp.asarray(tokens)})
    params = convert.params_from_numpy(_np(jparams), tcfg, device="cpu")
    leaves, spec = tree.flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    loss, _ = T.loss_fn(tcfg, tree.unflatten(spec, live), {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    wgrads = [np.asarray(g) for g in jax.tree.leaves(wgrads)]
    assert len(wgrads) == len(live) == (13 if arch == "gemma2_2b" else 11)
    rel = abs(loss.item() - float(want)) / abs(float(want))
    worst = max(float(np.max(np.abs(p.grad.numpy() - w))) / float(np.max(np.abs(w)))
                for p, w in zip(live, wgrads))
    print(f"{arch}: loss rel {rel:.2e}, worst grad {worst:.2e} of max|grad|")
    assert rel <= 1e-5 and worst <= 1e-4


def test_tree_order_of_gemma2_params_and_state_is_jax():
    jparams = _jparams("gemma2_2b")
    _, tcfg = _cfgs("gemma2_2b", "takum", "f32")
    opt = jax.jit(lambda p: jadamw_init(p, fmt="t16"))(jparams)
    jstate = dstep.TrainState(jparams, opt, jax.random.PRNGKey(1))
    st = {"params": _np(jstate.params),
          "opt": {"step": np.asarray(jstate.opt.step), "m": _np(jstate.opt.m),
                  "v": _np(jstate.opt.v)},
          "rng": np.asarray(jstate.rng)}
    tstate = convert.train_state_from_numpy(st, tcfg, device="cpu")
    for port, ref in ((tstate.params, jstate.params), (tstate, jstate)):
        got, want = tree.flatten(port)[0], [np.asarray(a) for a in jax.tree.leaves(ref)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and np.array_equal(g.numpy().astype(w.dtype), w)


def test_launcher_trains_gemma2(tmp_path, capsys):
    state, hist = launch.main(["--arch", "gemma2_2b", "--smoke", "--steps", "2", "--batch", "2",
                               "--seq", "24", "--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "ck")])
    assert state.opt.step.item() == 2 and "lm_head" not in state.params
    assert "arch=gemma2-2b" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the converter's refusals
# ---------------------------------------------------------------------------


def test_converter_refuses_a_tree_that_does_not_match():
    for arch, bad in (("gemma2_2b", "add lm_head"), ("granite_34b", "drop lm_head"),
                      ("gemma2_2b", "drop ln2_post"), ("granite_34b", "add ln1_post")):
        _, tcfg = _cfgs(arch, "bf16", "f32")
        tr = _np(_jparams(arch))
        d, V = tcfg.d_model, tcfg.vocab_size
        if bad == "add lm_head":
            tr["lm_head"] = np.zeros((d, V), np.float32)
        elif bad == "drop lm_head":
            del tr["lm_head"]
        elif bad == "drop ln2_post":
            del tr["layers"]["ln2_post"]
        else:
            tr["layers"]["ln1_post"] = np.zeros((tcfg.num_layers, d), np.float32)
        with pytest.raises(ValueError):
            convert.params_from_numpy(tr, tcfg, device="cpu")
        convert.params_from_numpy(_np(_jparams(arch)), tcfg, device="cpu")  # the real one loads
