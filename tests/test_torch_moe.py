"""The MoE family (dbrx-132b, kimi-k2-1t-a32b; smoke size): the port against
``repro``.

* ``configs.get`` / ``get_smoke`` equal ``repro``'s field for field; the
  ssm, hybrid and vlm archs load (ported since).
* ``models.moe.moe_block`` against ``repro.models.moe.moe_block`` on inputs
  drawn with numpy from a seed, x f32 and bf16, with and without a shared
  expert, without drops (``cf = E``, as ``tests/test_arch_smoke.py``) and
  at the default ``cf = 1.25``; weights packed t16, t8 and mxt8 (``repro``
  gets them dequantised to f32, as its serve step does; the port gets the
  packed QTensors: K3's plain version on the CPU), and plain f32 and bf16.
  The gate indices and the keep mask equal ``repro``'s (recomputed with
  ``repro``'s formulas) on every token whose top-k margin (k-th minus
  (k+1)-th prob of ``repro``'s probs) is at least 1e-6; the share of those
  near ties is printed and must stay under 1 %.  Outputs within 1e-5 of
  max|y| where the result is f32, within 4 bf16 steps (2^-6) of max|y|
  where it is bf16 (plain bf16 weights: each product is rounded to bf16 by
  XLA and by torch, in their own orders); aux within 1e-6.
* Exact ties route as ``jax.lax.top_k`` routes them (the lower index
  first), through ``lax_top_k`` and through a whole block.
* The converter refuses a tree without ``layers.moe``, with a
  ``layers.mlp``, with a shared leaf missing or extra, without a router,
  or with another number of experts.

``repro``'s ``moe_block`` runs eagerly (its ops compile once per shape),
its packing is jitted once per format.  Serving the two archs against
``repro`` is ``tests/test_torch_moe_serve_dbrx.py`` and
``tests/test_torch_moe_serve_kimi.py`` (``tests/_moe_serve.py``), training
``tests/test_torch_moe_train.py``: each file inside its minute alone.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro.quant.qtensor import QTensor as JQTensor
from repro.quant.qtensor import quantize as jquantize
from repro_torch import configs, convert
from repro_torch.models import moe
from repro_torch.quant.policy import POLICIES, QuantPolicy

ARCHS = ("dbrx_132b", "kimi_k2_1t_a32b")
JPOL = {**JPOLICIES, "mxt8": JQuantPolicy(weights="mxt8", kv_cache="mxt8")}
TPOL = {**POLICIES, "mxt8": QuantPolicy(weights="mxt8", kv_cache="mxt8")}
#: a token whose k-th and (k+1)-th probs differ by less is a near tie
NEAR_TIE = 1e-6


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


def _cfgs(arch, policy, act, **kw):
    jcfg = jconfigs.get_smoke(arch).with_(
        quant=dataclasses.replace(JPOL[policy], activations=act), **kw)
    tcfg = configs.get_smoke(arch).with_(
        quant=dataclasses.replace(TPOL[policy], activations=act), **kw)
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro_field_for_field(arch, smoke):
    get, jget = (configs.get_smoke, jconfigs.get_smoke) if smoke else (configs.get, jconfigs.get)
    tcfg, jcfg = get(arch), jget(arch)
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"quant"}
    assert {"num_experts", "experts_per_token", "num_shared_experts",
            "moe_capacity_factor"} <= tf
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(jcfg):
        if f.name not in tf | {"quant", "attn_chunk_q", "attn_chunk_kv"}:
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            assert getattr(jcfg, f.name) == default, f.name
    alias = next(k for k, v in jconfigs.ALIASES.items() if v == arch)
    assert get(alias) == tcfg and tcfg.family == "moe"


@pytest.mark.parametrize("arch", ["llama3_2_vision_90b"])
def test_ssm_hybrid_and_vlm_still_raise(arch):
    """The ssm, hybrid and vlm families are ported: the vlm arch loads, and
    a vlm config without media tokens raises where repro asserts."""
    assert configs.get(arch).family == "vlm"
    with pytest.raises(ValueError):
        configs.get_smoke(arch).with_(num_media_tokens=0)


def test_moe_config_is_checked_as_repro_checks_it():
    cfg = configs.get_smoke("dbrx_132b")
    for bad in (dict(num_experts=1), dict(experts_per_token=0)):
        with pytest.raises(ValueError):
            cfg.with_(**bad)
        with pytest.raises(AssertionError):
            jconfigs.get_smoke("dbrx_132b").with_(**bad)


# ---------------------------------------------------------------------------
# moe_block against repro's
# ---------------------------------------------------------------------------

#: (E, k, shared): dbrx's smoke routing, and kimi's with its shared expert
BLOCKS = {False: (4, 2, False), True: (8, 2, True)}
D, F_, BB, SS = 64, 96, 2, 24


@functools.lru_cache(maxsize=None)
def _pack(fmt):
    """repro's packing of a dict of arrays in ``fmt``, and its dequantised
    f32 values (what repro's serve step multiplies), in one jit."""
    def f(t):
        q = {n: jquantize(a, fmt, scaled=True) for n, a in t.items()}
        return q, {n: v.dequantize(jnp.float32) for n, v in q.items()}
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _weights(wfmt):
    """numpy draws of both blocks' weights, then per weight what repro takes
    (f32 after dequantize, or the plain array) and what the port takes;
    keys (shared, name)."""
    rng = np.random.default_rng(len(wfmt))
    arrays = {}
    for shared, (E, _, has_shared) in BLOCKS.items():
        shapes = {"router": (D, E), "wi": (E, D, F_), "wg": (E, D, F_), "wo": (E, F_, D)}
        if has_shared:
            shapes.update(wi_s=(D, F_), wg_s=(D, F_), wo_s=(F_, D))
        for n, shp in shapes.items():
            a = (rng.standard_normal(shp) * shp[-2] ** -0.5).astype(np.float32)
            arrays[f"{int(shared)}{n}"] = jnp.asarray(a)
    if wfmt in ("f32", "bf16"):
        jw = {n: a.astype(jnp.bfloat16 if wfmt == "bf16" else jnp.float32)
              for n, a in arrays.items()}
        tw = {n: convert._tensor(np.asarray(a), "cpu") for n, a in jw.items()}
    else:
        q, jw = _pack(wfmt)(arrays)  # one compile per format
        tw = {n: convert._leaf(_np(v), "cpu") for n, v in q.items()}
    return jw, tw


def _block_inputs(shared, wfmt):
    """x (numpy, from a seed) and the block's weights for repro and the port."""
    x = np.random.default_rng(int(shared)).standard_normal((BB, SS, D)).astype(np.float32)
    jw, tw = _weights(wfmt)
    pick = lambda w: {n[1:]: v for n, v in w.items() if n[0] == str(int(shared))}  # noqa: E731
    return x, pick(jw), pick(tw)


def _repro_routing(x, router, k, cf):
    """repro's probs, gate indices and keep mask, by its own formulas."""
    E = router.shape[-1]
    S = x.shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    C = max(int(cf * k * S / E), 1)
    sel = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32).reshape(x.shape[0], S * k, E)
    pos = (jnp.cumsum(sel, axis=1) * sel - 1).max(-1).reshape(x.shape[0], S, k)
    return np.asarray(probs), np.asarray(gate_idx), np.asarray((pos >= 0) & (pos < C))


def _margins(probs, k):
    s = -np.sort(-probs, axis=-1)
    return s[..., k - 1] - s[..., k]


@pytest.mark.parametrize("cf", ["no_drop", 1.25])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("wfmt", ["t16", "t8", "mxt8", "f32", "bf16"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_moe_block_matches_repro(act, wfmt, shared, cf):
    E, k, has_shared = BLOCKS[shared]
    cf = float(E) if cf == "no_drop" else cf
    x, jw, tw = _block_inputs(shared, wfmt)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if act == "bf16" else (jnp.float32, torch.float32)
    jx = jnp.asarray(x).astype(jdt)
    sh = tuple(jw[n] for n in ("wi_s", "wg_s", "wo_s")) if has_shared else ()
    want, jaux = jmoe.moe_block(jx, jw["router"], jw["wi"], jw["wg"], jw["wo"], sh or None,
                                top_k=k, capacity_factor=cf)
    probs, jidx, jkeep = _repro_routing(jx, jw["router"], k, cf)

    tx = convert._tensor(np.asarray(jx), "cpu")
    tsh = tuple(tw[n] for n in ("wi_s", "wg_s", "wo_s")) if has_shared else None
    trace = {}
    got, aux = moe.moe_block(tx, tw["router"], tw["wi"], tw["wg"], tw["wo"], tsh, top_k=k,
                             capacity_factor=cf, trace=trace)
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(want.dtype)]

    margin = _margins(probs, k)
    ok = margin >= NEAR_TIE  # [B, S]
    share = 1 - ok.mean()
    print(f"{act} {wfmt} shared={has_shared} cf={cf}: min margin {margin.min():.3g}, "
          f"near-tie share {share:.3%}, kept {jkeep.mean():.3f}")
    assert share < 0.01
    assert np.array_equal(trace["gate_idx"].numpy()[ok], jidx[ok])
    assert np.array_equal(trace["keep"].numpy()[ok], jkeep[ok])
    if cf == E:
        assert jkeep.all()
    g = got.float().numpy()[ok]
    w = np.asarray(want.astype(jnp.float32))[ok]
    tol = 1e-5 if got.dtype == torch.float32 else 2.0 ** -6
    err = np.abs(g - w).max() / np.abs(w).max()
    print(f"  y err {err:.3g} of max|y| (limit {tol}), aux {float(aux):.6f} vs {float(jaux):.6f}")
    assert err <= tol
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_lax_top_k_breaks_ties_as_jax_does():
    rng = np.random.default_rng(3)
    for E, k in ((4, 2), (8, 2), (16, 4), (384, 8)):
        p = rng.integers(0, 3, (64, E)).astype(np.float32) / 4  # a few values, many ties
        p[0] = 0.25  # one row all equal
        vals, idx = moe.lax_top_k(torch.from_numpy(p), k)
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        assert np.array_equal(idx.numpy(), np.asarray(ji)) and np.array_equal(vals.numpy(),
                                                                             np.asarray(jv))
        assert idx[0].tolist() == list(range(k))


@pytest.mark.parametrize("router", ["zero", "duplicate_columns"])
def test_exact_ties_route_as_repro(router):
    """A zero router (every prob 1/E) and one with duplicated columns over
    inputs whose logits are exact (multiples of 1/4), at k = 3 so that the
    third and fourth choices are twins: the gate indices, keep mask and
    output equal repro's."""
    E, k = 8, 3
    rng = np.random.default_rng(5)
    x = (rng.integers(-4, 5, (BB, SS, D)) / 4).astype(np.float32)
    if router == "zero":
        r = np.zeros((D, E), np.float32)
    else:
        base = rng.integers(-1, 2, (D, E // 2)).astype(np.float32)
        r = np.repeat(base, 2, axis=1)  # columns 2i and 2i + 1 equal
    wi, wg = ((rng.standard_normal((E, D, F_)) * D ** -0.5).astype(np.float32) for _ in "ig")
    wo = (rng.standard_normal((E, F_, D)) * F_ ** -0.5).astype(np.float32)
    want, jaux = jmoe.moe_block(*(jnp.asarray(a) for a in (x, r, wi, wg, wo)), None, top_k=k,
                                capacity_factor=1.25)
    probs, jidx, jkeep = _repro_routing(jnp.asarray(x), jnp.asarray(r), k, 1.25)
    assert (_margins(probs, k) == 0).mean() > 0.9  # the ties are there
    trace = {}
    got, aux = moe.moe_block(*(torch.from_numpy(a) for a in (x, r, wi, wg, wo)), None, top_k=k,
                             capacity_factor=1.25, trace=trace)
    assert np.array_equal(trace["gate_idx"].numpy(), jidx)
    assert np.array_equal(trace["keep"].numpy(), jkeep) and not jkeep.all()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_capacity_and_slots_are_repro_s():
    assert moe.capacity(1.25, 4, 256, 16) == 80 and moe.capacity(1.25, 8, 256, 384) == 6
    assert moe.capacity(1.25, 4, 1, 16) == 1 and moe.capacity(1.25, 8, 1, 384) == 1
    idx = torch.tensor([[[0, 1], [1, 0], [1, 2], [0, 1]]])  # [B=1, S=4, k=2]
    assert moe.slot_positions(idx, 3).tolist() == [[[0, 0], [1, 1], [2, 0], [2, 3]]]
    route = moe.Routing(idx, 3, 2)
    assert route.keep.tolist() == [[[True, True], [True, True], [False, True], [False, False]]]
    x = torch.arange(4.0)[None, :, None].expand(1, 4, 2)
    xe = route.dispatch(x)  # [E, B*C, d]: expert 0 holds tokens 0, 1; expert 2 token 2
    assert xe[:, :, 0].tolist() == [[0.0, 1.0], [0.0, 1.0], [2.0, 0.0]]


def test_dispatch_and_combine_gradients_are_the_scatter_s():
    """The gathers' own backward equals autograd's through index_select and
    index_add (the scatter-add the combine stands for)."""
    torch.manual_seed(0)
    idx = torch.randint(0, 4, (2, 6, 2))
    idx[..., 1] = (idx[..., 0] + 1 + torch.randint(0, 3, (2, 6))) % 4  # k distinct experts
    route = moe.Routing(idx, 4, 2)
    x = torch.randn(2, 6, 5, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 6, 2, dtype=torch.float64)
    ye = torch.randn(4, 4, 5, dtype=torch.float64, requires_grad=True)
    (route.dispatch(x).square().sum() + route.combine(ye, w).sin().sum()).backward()
    x2, ye2 = x.detach().clone().requires_grad_(), ye.detach().clone().requires_grad_()
    keep = route.keep.reshape(-1)
    tok = torch.arange(12).repeat_interleave(2)[keep]
    slots = route.pair_slot[keep]
    xe = torch.zeros(16, 5, dtype=torch.float64).index_add(0, slots, x2.reshape(12, 5)[tok])
    rows = ye2.reshape(16, 5)[slots] * w.reshape(-1, 1)[keep]
    y = torch.zeros(12, 5, dtype=torch.float64).index_add(0, tok, rows)
    (xe.square().sum() + y.sin().sum()).backward()
    assert torch.allclose(x.grad, x2.grad) and torch.allclose(ye.grad, ye2.grad)


# ---------------------------------------------------------------------------
# the converter's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["drop moe", "add mlp", "drop wo_s", "add wi_s", "drop router",
                                 "experts"])
def test_converter_refuses_a_moe_tree_that_does_not_match(bad):
    arch = "dbrx_132b" if bad == "add wi_s" else "kimi_k2_1t_a32b"
    _, tcfg = _cfgs(arch, "bf16", "f32")
    tr = _np(_jparams(arch))
    lay = tr["layers"]
    L, d, f = tcfg.num_layers, tcfg.d_model, tcfg.d_ff
    if bad == "drop moe":
        del lay["moe"]
    elif bad == "add mlp":
        lay["mlp"] = {"wi": np.zeros((L, d, f), np.float32)}
    elif bad == "drop wo_s":
        del lay["moe"]["wo_s"]
    elif bad == "add wi_s":
        lay["moe"]["wi_s"] = np.zeros((L, d, f), np.float32)
    elif bad == "drop router":
        del lay["moe"]["router"]
    else:
        lay["moe"]["router"] = lay["moe"]["router"][..., :-1]
    with pytest.raises(ValueError):
        convert.params_from_numpy(tr, tcfg, device="cpu")
    convert.params_from_numpy(_np(_jparams(arch)), tcfg, device="cpu")  # the real one loads
