"""Serving the ssm and hybrid families (mamba2-780m, hymba-1.5b; smoke
size): the port against ``repro``, the check that
``tests/test_torch_ssm_serve_mamba2.py`` and
``tests/test_torch_ssm_serve_hymba.py`` run (one file per arch, each
inside its minute alone).

``repro`` draws each arch's parameters (``init_params(PRNGKey(0))``) and
packs them (``dist.step.quantize_params``: every ``MambaParams`` leaf too);
the port receives them through ``convert.params_from_numpy``.  Both prefill
one B=4, S0=24 prompt and run 24 decode steps teacher-forced with
``repro``'s greedy tokens, as ``tests/test_torch_archs.py`` does and with
its limits (``TOL``: 1e-3 of max|logit| at f32 activations, where the
greedy tokens must also agree; 0.12 at any step and 0.04 in the median step
at bf16).  Both sides run ``ssm_chunk = 8``, so the 24-token prefill is
three SSD chunks and the inter-chunk recurrence carries state; the prompt
also runs past hymba smoke's 16-key window.

The recurrent cache is held too, after the prefill and after the last
step: the conv tail (``cache.conv``) and the SSM state (``cache.ssm``) of
every layer, each within ``CACHE_TOL`` of its max|value| (f32: the
accumulation order only, limit 1e-5, measured up to 1.3e-6; bf16: the
activations' rounding, which the bf16 parity limits above allow, limit
0.04, the median logit limit, measured up to 8.3e-3 on hymba under takum),
and the conv tail in ``repro``'s dtype (f32: the projection's output
under packed weights, whatever the activations).
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
from repro.quant.qtensor import QTensor as JQTensor
from repro_torch import configs, convert, serve
from repro_torch.quant.policy import POLICIES, QuantPolicy

B, S0, STEPS, CHUNK = 4, 24, 24, 8
TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # test_torch_archs.py's (any, median step)
CACHE_TOL = {"f32": 1e-5, "bf16": 0.04}  # of max|value|, conv tail and SSM state
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}


def np_tree(tree_):
    """repro tree -> numpy leaves, QTensors as {bits, fmt, scale}, a
    NamedTuple (``MambaParams``) kept as one."""
    if isinstance(tree_, dict):
        return {k: np_tree(v) for k, v in tree_.items()}
    if isinstance(tree_, JQTensor):
        return {"bits": np.asarray(tree_.bits), "fmt": tree_.fmt,
                "scale": None if tree_.scale is None else np.asarray(tree_.scale)}
    if isinstance(tree_, tuple) and hasattr(tree_, "_fields"):
        return type(tree_)(*(np_tree(v) for v in tree_))
    return np.asarray(tree_)


def cfgs(arch, policy, act, **kw):
    """(repro's, the port's) smoke config of ``arch`` under ``policy`` at
    ``act`` activations, with ``kw`` on both."""
    jcfg = jconfigs.get_smoke(arch).with_(
        quant=dataclasses.replace(JPOL[policy], activations=act), **kw)
    tcfg = configs.get_smoke(arch).with_(
        quant=dataclasses.replace(TPOL[policy], activations=act), **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def jparams(arch):
    return jax.jit(lambda key: JT.init_params(jconfigs.get_smoke(arch), key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def qparams(arch, policy):
    jcfg = jconfigs.get_smoke(arch).with_(quant=JPOL[policy])
    return jax.jit(functools.partial(dstep.quantize_params, jcfg))(jparams(arch))


def _run_repro(jcfg, qp, prompt):
    pre = jax.jit(lambda p, t: JT.prefill(jcfg, dstep.dequantize_params(p), t,
                                          cache_len=S0 + STEPS))
    serve_step = jax.jit(dstep.make_serve_step(jcfg, None))
    logits, cache = pre(qp, jnp.asarray(prompt))
    caches = [cache]
    outs, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1)
        fed.append(np.asarray(tok))
        logits, cache = serve_step(qp, {"token": tok}, cache)
        outs.append(np.asarray(logits))
    return outs, fed, caches + [cache]


def _state(cache):
    """(conv, ssm) of a cache of either package, as numpy f32 (a copy: the
    port updates its cache in place)."""
    conv, ssm = cache.conv, cache.ssm
    if isinstance(conv, torch.Tensor):
        return conv.float().numpy().copy(), ssm.numpy().copy()
    return np.asarray(conv, np.float32), np.asarray(ssm)


def _run_port(tcfg, tparams, prompt, fed):
    prefill = serve.make_prefill_step(tcfg, cache_len=S0 + STEPS)
    step = serve.make_serve_step(tcfg)
    logits, cache = prefill(tparams, {"tokens": torch.from_numpy(prompt.astype(np.int64))})
    states = [_state(cache)]
    outs = [logits.numpy()]
    for tok in fed:
        logits, cache = step(tparams, {"token": torch.from_numpy(tok.astype(np.int64))}, cache)
        outs.append(logits.numpy())
    assert cache.pos == S0 + STEPS
    return outs, states + [_state(cache)], cache


def check_serving(arch, policy, act):
    """Serve ``arch`` under ``policy`` at ``act`` activations on both sides
    and hold the port's logits and recurrent caches to ``repro``'s."""
    jcfg, tcfg = cfgs(arch, policy, act, ssm_chunk=CHUNK)
    qp = qparams(arch, policy)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S0)).astype(np.int32)
    want, fed, jcaches = _run_repro(jcfg, qp, prompt)
    tparams = serve.load_params(convert.params_from_numpy(np_tree(qp), tcfg, device="cpu"))
    got, states, cache = _run_port(tcfg, tparams, prompt, fed)
    assert (tcfg.family == "ssm") == (cache.k.numel() == 0)
    assert str(cache.conv.dtype)[6:] == str(jcaches[-1].conv.dtype)
    cache_errs = []
    for (conv, ssm), jc in zip(states, jcaches):
        for g, w in zip((conv, ssm), _state(jc)):
            assert g.shape == w.shape
            cache_errs.append(float(np.abs(g - w).max() / np.abs(w).max()))
    errs = []
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, tcfg.vocab_size)
        assert np.isfinite(g).all()
        errs.append(np.abs(g - w).max() / np.abs(w).max())
        if act == "f32":
            assert np.array_equal(g.argmax(-1), w.argmax(-1)), (arch, policy, len(errs))
    worst, median = TOL[act]
    print(f"{arch} {policy}/{act}: max {max(errs):.3g}, median {np.median(errs):.3g}; "
          f"conv, ssm after prefill {cache_errs[:2]}, after the last step {cache_errs[2:]}")
    assert max(errs) <= worst and np.median(errs) <= median, (arch, policy, act, errs)
    assert max(cache_errs) <= CACHE_TOL[act], cache_errs
