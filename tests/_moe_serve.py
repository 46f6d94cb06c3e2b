"""Serving the MoE family (dbrx-132b, kimi-k2-1t-a32b; smoke size): the
port against ``repro``, the check that ``tests/test_torch_moe_serve_dbrx.py``
and ``tests/test_torch_moe_serve_kimi.py`` run (one file per arch, each
inside its minute alone).

``repro`` draws each arch's parameters (``init_params(PRNGKey(0))``) and
packs them (``dist.step.quantize_params``); the port receives them through
``convert.params_from_numpy``.  Both prefill one B=4, S0=16 prompt and run
24 decode steps teacher-forced with ``repro``'s greedy tokens, as
``tests/test_torch_archs.py`` does and with its limits (``TOL``: 1e-3 of
max|logit| at f32 activations, where the greedy tokens must also agree;
0.12 at any step and 0.04 in the median step at bf16): dbrx and kimi
under takum and takum8 at f32, kimi under mxt8 at f32, dbrx under takum at
bf16.

Routing is discontinuous: a token whose k-th and (k+1)-th router probs lie
closer than the two paths' probs differ can take another expert, and its
output then moves by O(1).  Both sides' router probs are recorded in every
layer of every call (``repro``'s through ``jax.debug.callback``).  A
routing that differs from ``repro``'s must be such a near tie: its margin
in ``repro``'s probs under twice the largest difference of the two paths'
probs for that token (the two probs that swap can each move by that
much); a larger margin fails.  From the call where a batch row's
routing first differs on, that row is left out of the logit comparison
(the flips, their margins and the share of rows left out are printed),
and every other row is held to ``TOL``.  At f32 the paths' probs differ by
about 1e-7 and no routing differs; at bf16 they differ by up to 3e-2,
because ``repro`` rounds the t16 weights of every dense linear to bf16 and
the port's K3 keeps them in f32 (ROADMAP Queue 3, differences by design).
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
from repro_torch.models import moe
from repro_torch.quant.policy import POLICIES, QuantPolicy

B, S0, STEPS = 4, 16, 24
TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # test_torch_archs.py's (any, median step)
F32_ANY_STEP = {"mxt8": 2e-3}  # test_torch_archs.py's: an 8-bit mx KV code an ulp moves
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}


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
    return jax.jit(lambda key: JT.init_params(jconfigs.get_smoke(arch), key))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _qparams(arch, policy):
    jcfg = jconfigs.get_smoke(arch).with_(quant=JPOL[policy])
    return jax.jit(functools.partial(dstep.quantize_params, jcfg))(_jparams(arch))


def _record_routing(monkeypatch):
    """Record each side's router probs [B, S, E] per layer and call, in
    order: ``repro``'s from inside its jitted steps, the port's through
    ``moe_block``'s trace."""
    jrec, trec = [], []
    jblock, tblock = JT.moe_block, moe.moe_block

    def jrecord(x, router_w, *a, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda p: jrec.append(np.asarray(p)), probs, ordered=True)
        return jblock(x, router_w, *a, **kw)

    def trecord(*a, **kw):
        tr = {}
        out = tblock(*a, trace=tr, **kw)
        trec.append(tr["probs"].numpy())
        return out

    monkeypatch.setattr(JT, "moe_block", jrecord)
    monkeypatch.setattr(moe, "moe_block", trecord)
    return jrec, trec


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
    jax.effects_barrier()
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


def _flips(jrec, trec, k, L):
    """(rows, flips): per call, the batch rows whose top-k expert set has
    differed from ``repro``'s in some layer of that call or an earlier one;
    each flip as (call, layer, row, margin in ``repro``'s probs, the
    largest difference of the two paths' probs for that token)."""
    assert len(jrec) == len(trec) == L * (1 + STEPS)
    rows, flips = [], []
    for c in range(1 + STEPS):
        bad = np.zeros(B, bool)
        for layer in range(L):
            jp, tp = jrec[c * L + layer], trec[c * L + layer]
            js = np.sort(np.argsort(-jp, axis=-1, kind="stable")[..., :k], -1)
            ts = np.sort(np.argsort(-tp, axis=-1, kind="stable")[..., :k], -1)
            srt = -np.sort(-jp, axis=-1)
            margin = srt[..., k - 1] - srt[..., k]
            diff = np.abs(jp - tp).max(-1)
            for b, s in zip(*np.nonzero((js != ts).any(-1))):
                flips.append((c, layer, int(b), float(margin[b, s]), float(diff[b, s])))
                bad[b] = True
        rows.append(bad)
    return np.logical_or.accumulate(np.array(rows), axis=0), flips


def check_serving(monkeypatch, arch, policy, act):
    """Serve ``arch`` under ``policy`` at ``act`` activations on both sides
    and hold the port to ``repro`` (the module docstring's rules)."""
    jcfg = jconfigs.get_smoke(arch).with_(quant=dataclasses.replace(JPOL[policy], activations=act))
    tcfg = configs.get_smoke(arch).with_(quant=dataclasses.replace(TPOL[policy], activations=act))
    qparams = _qparams(arch, policy)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, S0)).astype(np.int32)
    jrec, trec = _record_routing(monkeypatch)
    want, fed = _run_repro(jcfg, qparams, prompt)
    tparams = serve.load_params(convert.params_from_numpy(_np(qparams), tcfg, device="cpu"))
    got = _run_port(tcfg, tparams, prompt, fed)
    flipped, flips = _flips(jrec, trec, tcfg.experts_per_token, tcfg.num_layers)
    errs = []
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, tcfg.vocab_size) and np.isfinite(g).all()
        ok = ~flipped[c]
        if not ok.any():
            continue
        errs.append(np.abs(g[ok] - w[ok]).max() / np.abs(w[ok]).max())
        if act == "f32":
            assert np.array_equal(g[ok].argmax(-1), w[ok].argmax(-1)), (arch, policy, c)
    worst, median = TOL[act]
    if act == "f32":
        worst = F32_ANY_STEP.get(policy, worst)
    print(f"{arch} {policy}/{act}: max {max(errs):.3g}, median {np.median(errs):.3g} over "
          f"{len(errs)} calls; rows left out at the end {flipped[-1].mean():.0%}; flips "
          f"(call, layer, row, margin, probs diff) {flips}")
    assert all(margin < 2 * diff for *_, margin, diff in flips), flips
    assert flipped[0].mean() <= 0.25 and len(errs) > STEPS // 2, flips
    assert max(errs) <= worst and np.median(errs) <= median, (arch, policy, act, errs)
