"""Single-device training of llama3-8b (smoke size): the port against ``repro``.

``repro`` draws the parameters, the batches (``SyntheticLM``, jax threefry)
and the SR draws (``jax.random.bits``); the port receives them as numpy
(``convert.params_from_numpy`` / ``train_state_from_numpy``) and as its
optimizer's draw supplier.  Limits, each on the quantity named:

* Loss and gradients at f32 activations against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)``: 1e-5 relative
  on the loss, 1e-4 of max|grad| per leaf (both sides
  compute in f32 and differ in accumulation order only).
* ``flash_attention``'s backward against ``jax.vjp`` of ``repro``'s (one
  and two ``chunk_kv`` chunks): 1e-5 of max|d.| per cotangent.
* At bf16 activations: 2e-3 relative on the loss and 0.05 of max|grad| per
  leaf (measured 8.2e-5 and 0.024 at most over the leaves, with remat on
  and off alike; at f32 1e-7 and 1.2e-6; ``pytest -rP`` prints them).  The
  two frameworks round bf16 intermediates at different places.
* ``takum_encode_sr`` (t8, t16) and ``ofp8.encode_sr`` (e4m3, e5m2): bit
  for bit, fed the same ``rnd_bits``.
* Three AdamW steps from one converted state, ``repro``'s batches and SR
  draws fed in, at f32 activations, under the takum (t16 moments, SR),
  takum8 (t8 moments, SR) and bf16 (f32 moments) policies: the loss 1e-5
  relative per step; params within 5e-5 of ``repro``'s (measured 1.1e-6
  takum, 2.8e-6 takum8, 5.1e-6 bf16: a tenth of lr, where a gradient near
  zero taking the other sign would move a parameter by 2 lr); f32 moments
  within 1e-4 of their max; quantised moment codes counted where they
  differ, at most 1 % of them (measured 658 of 213632 t16 codes under
  takum, 1 of 213632 t8 codes under takum8: an ulp of difference in the f32
  moment moves a code across a rounding boundary, more often for t16's
  finer grid); moment scales by exponent (ROADMAP R5).
* F3: ``prefill`` and ``decode_step`` with int32 tokens equal int64, bit
  for bit, under every policy of ``tests/test_torch_serve.py``.  F4:
  ``decode_rows_plain`` and ``_embed`` on ids [-V, -1, 5, V, V+3] equal
  ``repro``'s ``params["embed"][tokens]``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import ofp8 as jofp8
from repro.core.takum import _encode_impl
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import step as dstep
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import is_takum as jis_takum
from repro.quant.qtensor import QTensor as JQTensor
from repro_torch import configs, convert, serve, tree
from repro_torch.core import ofp8, takum
from repro_torch.kernels.takum_codec import decode_rows_plain
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.quant import qtensor
from repro_torch.quant.policy import POLICIES, QuantPolicy
from repro_torch.quant.qtensor import QTensor
from repro_torch.train.step import make_train_step

B, S, LR = 4, 16, 3e-4


def _np(tree_):
    """repro tree -> numpy leaves, QTensors as {bits, fmt, scale}."""
    if isinstance(tree_, dict):
        return {k: _np(v) for k, v in tree_.items()}
    if isinstance(tree_, JQTensor):
        return {"bits": np.asarray(tree_.bits), "fmt": tree_.fmt,
                "scale": None if tree_.scale is None else np.asarray(tree_.scale)}
    return np.asarray(tree_)


def _cfgs(policy="bf16", act="f32", **kw):
    jcfg = jconfigs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(JPOLICIES[policy], activations=act), **kw)
    tcfg = configs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(POLICIES[policy], activations=act), **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jconfigs.get_smoke("llama3_8b"), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jbatches():
    pipe = JSyntheticLM(jconfigs.get_smoke("llama3_8b").vocab_size, S, B, seed=5)
    return [np.array(pipe.batch(i)["tokens"]) for i in range(3)]  # writable copies


def _port_grads(tcfg, jparams, tokens):
    params = convert.params_from_numpy(_np(jparams), tcfg, device="cpu")
    leaves, spec = tree.flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    loss, aux = T.loss_fn(tcfg, tree.unflatten(spec, live), {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    return loss.item(), aux, [p.grad.numpy() for p in live]


@functools.lru_cache(maxsize=None)
def _repro_value_and_grad(act, remat):
    """``repro``'s jitted ``value_and_grad`` of ``loss_fn``, compiled once per
    (activations, remat) for the module.  Its ``loss_fn`` reads no field of
    the policy but ``activations``, so every policy's step shares it."""
    jcfg = _cfgs(act=act, remat=remat)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))


def _repro_grads(act, remat, jparams, tokens):
    (loss, aux), grads = _repro_value_and_grad(act, remat)(jparams,
                                                           {"tokens": jnp.asarray(tokens)})
    return float(loss), aux, [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("act,remat", [("f32", "block"), ("f32", "none"), ("bf16", "block"),
                                       ("bf16", "none")])
def test_loss_and_grads_match_repro(jparams, jbatches, act, remat):
    jcfg, tcfg = _cfgs(act=act, remat=remat)
    lim_loss, lim_grad = (1e-5, 1e-4) if act == "f32" else (2e-3, 0.05)
    want, jaux, wgrads = _repro_grads(act, remat, jparams, jbatches[0])
    got, aux, grads = _port_grads(tcfg, jparams, jbatches[0])
    assert aux["aux"].item() == 0.0 and float(jaux["aux"]) == 0.0
    assert aux["ce"].item() == got
    rel = abs(got - want) / abs(want)
    worst = max(float(np.max(np.abs(g - w))) / float(np.max(np.abs(w)))
                for g, w in zip(grads, wgrads))
    print(f"{act} remat={remat}: loss rel {rel:.2e}, worst grad {worst:.2e} of max|grad|")
    assert len(grads) == len(wgrads) == 12
    assert rel <= lim_loss and worst <= lim_grad


def test_remat_only_where_a_parameter_needs_a_gradient(jparams, jbatches, monkeypatch):
    """A training forward sends each layer through ``checkpoint``; a serving
    prefill, with grad mode on but no parameter asking for a gradient,
    sends none."""
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum"])
    raw = convert.params_from_numpy(_np(jparams), cfg, device="cpu")
    tokens = torch.from_numpy(jbatches[0])
    assert torch.is_grad_enabled()
    T.prefill(cfg, serve.load_params(serve.quantize_params(cfg, raw)), tokens, cache_len=S + 1)
    assert not calls
    leaves, spec = tree.flatten(raw)
    T.loss_fn(cfg, tree.unflatten(spec, [p.requires_grad_(True) for p in leaves]),
              {"tokens": tokens})
    assert len(calls) == cfg.num_layers


ATTN_CASES = {  # name: (window, softcap, S); chunk_kv is 8 in repro
    "causal_one_chunk": (0, 0.0, 8),
    "causal_two_chunks": (0, 0.0, 16),
    "window4_one_chunk": (4, 0.0, 8),
    "window4_two_chunks": (4, 0.0, 16),
    "softcap30_one_chunk": (0, 30.0, 8),
    "softcap30_window4_two_chunks": (4, 30.0, 16),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_backward_matches_jax_vjp(case):
    window, cap, Sk = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    Bq, H, Hkv, D = 2, 4, 2, 16  # GQA g = 2
    q, k, v = (rng.standard_normal((Bq, Sk, h, D)).astype(np.float32) * 2
               for h in (H, Hkv, Hkv))
    dout = rng.standard_normal((Bq, Sk, H, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(a, b, c, window, True, cap, 8, 0),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = A.flash_attention(tq, tk, tv, window, True, cap)
    got.backward(torch.from_numpy(dout))
    assert float(np.max(np.abs(got.detach().numpy() - np.asarray(out)))) <= \
        1e-5 * float(np.max(np.abs(np.asarray(out))))
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        err = float(np.max(np.abs(g.numpy() - w))) / float(np.max(np.abs(w)))
        assert err <= 1e-5, (name, err)


# ---------------------------------------------------------------------------
# stochastic-rounding encoders
# ---------------------------------------------------------------------------


def _sr_sweep(n=40000, seed=0):
    """f32 sweep with the specials, DAZ subnormals and values past both
    saturation rails of t8 (2**+-255 lies beyond f32; t8's rails sit near
    2**+-60), and matching uint32 draws including the all-zero and all-one
    dithers."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0 ** rng.integers(-126, 127, n)).astype(np.float32)
    x[:14] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39, 1.17e-38,
              3.4e38, -3.4e38, 1.2e-38, 1.0, -1.5]
    x[14:1000] = np.float32(2.0) ** rng.integers(-126, 127, 986) * rng.choice([-1, 1], 986)
    rnd = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rnd[:40], rnd[40:80] = 0, 0xFFFFFFFF
    return x, rnd


@pytest.mark.parametrize("n", [8, 16])
def test_takum_encode_sr_matches_repro(n):
    x, rnd = _sr_sweep(seed=n)
    want = np.asarray(_encode_impl(jnp.asarray(x), n, "linear", rnd_bits=jnp.asarray(rnd)))
    got = takum.takum_encode_sr(torch.from_numpy(x), n,
                                torch.from_numpy(rnd.astype(np.int64))).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    # the int32 view of the draws gives the same codes
    got32 = takum.takum_encode_sr(torch.from_numpy(x), n, torch.from_numpy(rnd.view(np.int32)))
    assert np.array_equal(got32.numpy(), got)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_ofp8_encode_sr_matches_repro(fmt):
    x, rnd = _sr_sweep(seed=len(fmt) + ord(fmt[1]))
    want = np.asarray(jofp8.encode_sr_jnp(jnp.asarray(x), jnp.asarray(rnd), fmt))
    got = ofp8.encode_sr(torch.from_numpy(x), torch.from_numpy(rnd.astype(np.int64)), fmt)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("fmt", ["t8", "t16", "e4m3", "e5m2"])
def test_quantize_sr_slices_and_suppliers_agree(monkeypatch, fmt):
    """The SR encode in slices (``SR_CHUNK``), from a tensor or a supplier of
    draws, equals one whole encode; bf16 and mx ignore the draws (RNE)."""
    rng = np.random.default_rng(9)
    xt = torch.from_numpy(rng.standard_normal((49, 100)).astype(np.float32) * 1e-3)
    r = torch.from_numpy(rng.integers(0, 1 << 32, (49, 100), dtype=np.int64))
    whole = qtensor.quantize(xt, fmt, scaled=True, rnd_bits=r)
    monkeypatch.setattr(qtensor, "SR_CHUNK", 333)
    sliced = qtensor.quantize(xt, fmt, scaled=True,
                              rnd_bits=lambda s, c: r.reshape(-1)[s:s + c])
    assert torch.equal(whole.bits, sliced.bits) and torch.equal(whole.scale, sliced.scale)
    rne = qtensor.quantize(xt, fmt, scaled=True)
    assert (whole.bits != rne.bits).any()  # the draws did round differently
    for other in ("bf16", "mxt8"):
        assert torch.equal(qtensor.quantize(xt, other, rnd_bits=r).bits,
                           qtensor.quantize(xt, other).bits)


# ---------------------------------------------------------------------------
# three AdamW steps against repro
# ---------------------------------------------------------------------------


def _repro_step(jcfg):
    """``repro``'s single-device step (``dist.step``'s): the shared jitted
    loss and grads at f32 activations, then ``adamw_update`` jitted for the
    policy's moment format, SR keyed as the step keys it."""
    use_sr = jcfg.quant.stochastic_rounding and jis_takum(jcfg.quant.opt_state)
    value_and_grad = _repro_value_and_grad(jcfg.quant.activations, jcfg.remat)
    update = jax.jit(functools.partial(jadamw_update, lr=LR, fmt=jcfg.quant.opt_state))

    def step(state, batch):
        rng, sr_key, _ = jax.random.split(state.rng, 3)
        (loss, m), grads = value_and_grad(state.params, batch)
        params, opt = update(grads, state.opt, state.params, key=sr_key if use_sr else None)
        return dstep.TrainState(params, opt, rng), loss

    return step


@jax.jit
def _sr_bits(rng, params):
    """The uint32 draws ``repro``'s step takes for each moment leaf (m of
    leaf i is 2i, v is 2i + 1); one compile for every policy."""
    sr_key = jax.random.split(rng, 3)[1]
    leaves = jax.tree.leaves(params)
    keys = jax.random.split(sr_key, 2 * len(leaves))
    return [jax.random.bits(keys[j], leaves[j // 2].shape, jnp.uint32)
            for j in range(2 * len(leaves))]


def _repro_draws(rng, params):
    """``_sr_bits`` as the port's supplier ``rnd(j, start, count)``."""
    bits = [np.asarray(b).reshape(-1).astype(np.int64) for b in _sr_bits(rng, params)]
    return lambda j, start, count: torch.from_numpy(bits[j][start:start + count])


def _state_np(st):
    return {"params": _np(st.params),
            "opt": {"step": np.asarray(st.opt.step), "m": _np(st.opt.m), "v": _np(st.opt.v)},
            "rng": np.asarray(st.rng)}


#: largest share of a policy's moment codes that may differ after 3 steps
CODE_SHARE = 0.01


@pytest.mark.parametrize("policy", ["takum", "takum8", "bf16"])
def test_three_train_steps_match_repro(jparams, jbatches, policy):
    jcfg, tcfg = _cfgs(policy)
    opt = jax.jit(lambda p: jadamw_init(p, fmt=jcfg.quant.opt_state))(jparams)  # one compile
    jstate = dstep.TrainState(jparams, opt, jax.random.PRNGKey(1))
    tstate = convert.train_state_from_numpy(_state_np(jstate), tcfg, device="cpu")
    jstep, tstep = _repro_step(jcfg), make_train_step(tcfg, lr=LR)
    sr = jcfg.quant.stochastic_rounding and jis_takum(jcfg.quant.opt_state)
    for i, tokens in enumerate(jbatches):
        rnd = _repro_draws(jstate.rng, jstate.params) if sr else None
        jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, metrics = tstep(tstate, {"tokens": torch.from_numpy(tokens)}, rnd=rnd)
        assert abs(metrics["loss"].item() - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        assert metrics["grad_ok"].item() == 1.0
    assert tstate.opt.step.item() == int(jstate.opt.step) == 3
    tp, jp = tree.flatten(tstate.params)[0], jax.tree.leaves(jstate.params)
    worst = max(float(np.max(np.abs(a.numpy() - b))) for a, b in zip(tp, jp))
    assert worst <= 5e-5, worst
    differ = total = 0
    for tm, jm in ((tstate.opt.m, jstate.opt.m), (tstate.opt.v, jstate.opt.v)):
        for a, b in zip(tree.nodes(tm), jax.tree.leaves(jm, is_leaf=lambda x: isinstance(
                x, JQTensor))):
            if isinstance(a, QTensor):
                want = np.asarray(b.bits)
                assert a.fmt == b.fmt and str(a.bits.dtype) == f"torch.{want.dtype}"
                differ += int((takum.codes_of(a.bits).numpy() != want).sum())
                total += want.size
                # scales by exponent (R5: repro's exp2 is inexact off small
                # integers, e.g. a hair below 2**-13); the port's is exact
                e = np.round(np.log2(np.asarray(b.scale, np.float64)))
                assert a.scale.item() == 2.0 ** e, (a.scale.item(), float(b.scale))
            else:
                err = np.abs(a.numpy() - np.asarray(b))
                assert float(np.max(err)) <= 1e-4 * float(np.max(np.abs(np.asarray(b))))
    print(f"{policy}: params within {worst:.2e}; "
          f"{differ} of {total} moment codes differ")
    assert differ <= CODE_SHARE * max(total, 1)


def test_train_step_leaves_no_tensor_in_a_reference_cycle():
    """A step frees the state it replaces by reference counting: no tensor
    waits for the garbage collector (a recursive closure over a tree's
    leaves once kept a whole state alive, at full width 15 GB)."""
    import gc

    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum"])
    from repro_torch.train.step import init_state

    state = init_state(cfg, 0, device="cpu")
    step = make_train_step(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    state, _ = step(state, batch)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = step(state, batch)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not held, [tuple(t.shape) for t in held][:8]


# ---------------------------------------------------------------------------
# F3 / F4: token ids
# ---------------------------------------------------------------------------

SERVE_POLICIES = ("takum", "takum8", "ofp8", "bf16", "mxfp8", "mxt8")


@pytest.mark.parametrize("policy", SERVE_POLICIES)
def test_int32_tokens_serve_as_int64(jparams, policy):
    pol = QuantPolicy(weights="mxt8", kv_cache="mxt8") if policy == "mxt8" else POLICIES[policy]
    cfg = configs.get_smoke("llama3_8b").with_(quant=pol)
    params = serve.load_params(serve.quantize_params(
        cfg, convert.params_from_numpy(_np(jparams), cfg, device="cpu")))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    outs = []
    for dt in (torch.int32, torch.int64):
        logits, cache = T.prefill(cfg, params, torch.from_numpy(prompt).to(dt), cache_len=10)
        step_logits, _ = T.decode_step(cfg, params, torch.tensor([3, 250], dtype=dt), cache)
        outs.append((logits, step_logits))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_out_of_range_ids_read_what_repro_reads(jparams):
    V = jconfigs.get_smoke("llama3_8b").vocab_size
    ids = np.array([[-V, -1, 5, V, V + 3], [-V - 7, 0, V - 1, -2, 2 * V]])
    want = np.asarray(jparams["embed"][jnp.asarray(ids, jnp.int32)])
    cfg = configs.get_smoke("llama3_8b").with_(quant=dataclasses.replace(
        POLICIES["bf16"], activations="f32"))
    params = convert.params_from_numpy(_np(jparams), cfg, device="cpu")
    for dt in (torch.int32, torch.int64):
        tid = torch.from_numpy(ids).to(dt)
        assert np.array_equal(T._embed(params, tid, torch.float32).numpy(), want)
        # the packed table's rows (the kernel's plain version), and the model's path
        ref_ids = torch.from_numpy(np.where(ids < 0, ids + V, ids).clip(0, V - 1))
        for fmt in ("t16", "t8", "mxt8"):
            q = qtensor.quantize(params["embed"], fmt, scaled=True)
            rows = decode_rows_plain(q.bits, tid, fmt, scale=None if q.block_scaled else q.scale)
            assert torch.equal(rows, q.dequantize()[ref_ids])
            assert torch.equal(T._embed({"embed": q}, tid, torch.float32), rows)
