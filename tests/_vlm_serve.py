"""Serving llama-3.2-vision-90b (smoke size): the port against ``repro``,
the check that ``tests/test_torch_vlm_serve.py`` and
``tests/test_torch_vlm_serve_mx.py`` run (split so that each file holds
fewer tests, and runs later under xdist's file order, than the slow
reference files).

``repro`` draws the parameters and packs them (``dist.step.quantize_params``,
jitted); the cross layers' gates and norm gains are redrawn nonzero first
(``tests/_vlm.py``'s ``gated_params``), so the cross path moves
the logits.  Both prefill one B=2, S0=8 prompt with the same media (drawn
from ``np.random.default_rng``) and run 12 decode steps teacher-forced with
``repro``'s greedy tokens: ``repro``'s ``prefill`` over the dequantized
tree with room for the steps (its ``make_prefill_step`` sizes the cache to
the prompt), then its ``make_serve_step``; the port's
``serve.make_prefill_step`` / ``make_serve_step``.  Every decode step
projects the media and each cross layer's media K/V anew, on both sides.

The limits are ``tests/test_torch_serve.py``'s, on max |logit difference| /
max |repro logit| per step: at f32 activations 1e-3 at every step (measured
7e-7, but 5e-5 under bf16 where an accumulation-order ulp moves a bf16 K/V
value across a rounding boundary: under 1e-3 of the cache bytes, which is
checked too), and the greedy tokens equal; at bf16 0.12 at any step and
0.04 in the median step (measured 0.079 / 0.026 under takum).
"""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.dist import step as dstep
from repro.models import transformer as JT
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro_torch import configs, convert, serve
from repro_torch.core.formats import wire_format
from repro_torch.quant.policy import POLICIES, QuantPolicy
from repro_torch.quant.qtensor import QTensor
from _vlm import ARCH, _jtree, _np, gated_params, media_of

B, S0, STEPS = 2, 8, 12
TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # (any step, median step)
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}


def _cfgs(policy, act):
    jcfg = jconfigs.get_smoke(ARCH).with_(
        quant=dataclasses.replace(JPOL[policy], activations=act))
    tcfg = configs.get_smoke(ARCH).with_(
        quant=dataclasses.replace(TPOL[policy], activations=act))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _gated():
    return _jtree(gated_params())


@functools.lru_cache(maxsize=None)
def _qparams(policy):
    jcfg = _cfgs(policy, "f32")[0]
    return jax.jit(functools.partial(dstep.quantize_params, jcfg))(_gated())


def _run_repro(jcfg, qparams, prompt, media):
    m = jnp.asarray(media)
    pre = jax.jit(lambda p, t: JT.prefill(jcfg, dstep.dequantize_params(p), t, m,
                                          cache_len=S0 + STEPS))
    serve_step = jax.jit(dstep.make_serve_step(jcfg, None))
    logits, cache = pre(qparams, jnp.asarray(prompt))
    outs, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1)
        fed.append(np.asarray(tok))
        logits, cache = serve_step(qparams, {"token": tok, "media": m}, cache)
        outs.append(np.asarray(logits))
    return outs, fed, cache


def _run_port(tcfg, tparams, prompt, media, fed):
    m = torch.from_numpy(media)
    prefill = serve.make_prefill_step(tcfg, cache_len=S0 + STEPS)
    step = serve.make_serve_step(tcfg)
    logits, cache = prefill(tparams, {"tokens": torch.from_numpy(prompt.astype(np.int64)),
                                      "media": m})
    outs = [logits.numpy()]
    for tok in fed:
        logits, cache = step(tparams, {"token": torch.from_numpy(tok.astype(np.int64)),
                                       "media": m}, cache)
        outs.append(logits.numpy())
    assert cache.pos == S0 + STEPS and cache.k.shape[0] == tcfg.num_layers
    return outs, cache


def check_serving(policy, act):
    """Prefill and decode under ``policy`` at ``act`` activations, the
    port against ``repro`` within ``TOL``."""
    jcfg, tcfg = _cfgs(policy, act)
    qparams = _qparams(policy)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S0)).astype(np.int32)
    media = media_of(tcfg, B, 1)
    want, fed, jcache = _run_repro(jcfg, qparams, prompt, media)
    tparams = serve.load_params(convert.params_from_numpy(_np(qparams), tcfg, device="cpu"))
    packed = wire_format(tcfg.quant.weights).family != "ieee"  # else a plain cast
    assert isinstance(tparams["media_proj"], QTensor) == packed
    assert isinstance(tparams["cross_layers"]["wk"], QTensor) == packed
    got, cache = _run_port(tcfg, tparams, prompt, media, fed)
    for c, jc in ((cache.k, jcache.k), (cache.v, jcache.v)):  # codes an order ulp moved
        differ = (c.view(torch.uint8).numpy() != np.asarray(jc).view(np.uint8)).mean()
        assert act == "bf16" or differ < 1e-3, differ
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, tcfg.vocab_size)
        assert np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
        if act == "f32":  # the port's greedy tokens are repro's
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), (policy, len(errs))
    worst, median = TOL[act]
    print(f"{policy}/{act}: max {max(errs):.3g}, median {np.median(errs):.3g}")  # pytest -rP
    assert max(errs) <= worst and np.median(errs) <= median, (policy, act, errs)
