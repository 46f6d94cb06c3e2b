"""The vlm family (llama-3.2-vision-90b; smoke size): the port against
``repro``, outside serving.

``repro`` draws the parameters (``init_params(PRNGKey(0))``); its zero
cross-attention gates and norm gains are then redrawn nonzero in the numpy
tree both packages take (``tanh(0) = 0`` would remove the whole cross path
from the logits, so a wrong cross-attention would pass).  Media is drawn
from ``np.random.default_rng``, as ``tests/test_arch_smoke.py`` draws it.

Limits, each on the quantity named:

* ``_cross_attn`` and ``forward``'s logits: ``TOL`` of
  ``tests/test_torch_archs.py`` on max |difference| / max |repro value|
  (f32 activations 1e-3 at any position; bf16 0.12 at any position and
  0.04 in the median one).
* ``loss_fn`` and its grads: at f32 1e-5 relative on the loss and 1e-4 of
  max|grad| per leaf, as ``tests/test_torch_train.py`` holds llama3-8b's;
  at bf16 2e-3 and 0.05, its bf16 limits.
* Three AdamW steps from one converted state (the same batches, and
  ``repro``'s SR draws fed in) under takum: the loss 1e-5 relative per step, params
  within 5e-5 and at most 1 % of the moment codes differing, the limits of
  ``tests/test_torch_train.py``.
* The non-causal attention over 4096 media keys against ``repro``'s
  chunked ``flash_attention`` (chunk 1024): 1e-5 of max |out|.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.dist import step as dstep
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.qtensor import QTensor as JQTensor
from repro.train import CheckpointManager as JCheckpointManager
from repro_torch import configs, convert, tree
from repro_torch.core import takum
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES
from repro_torch.quant.qtensor import QTensor
from repro_torch.train import CheckpointManager
from repro_torch.train.step import make_train_step

from _vlm import ARCH, _jparams, _jtree, _np, gated_params, media_of

TOL = {"f32": (1e-3, 1e-3), "bf16": (0.12, 0.04)}  # (any position, median position)
B, S, LR = 2, 16, 3e-4


@functools.lru_cache(maxsize=None)
def _gated_np():
    return gated_params()


def _cfgs(policy="bf16", act="f32", **kw):
    jcfg = jconfigs.get_smoke(ARCH).with_(
        quant=dataclasses.replace(JPOLICIES[policy], activations=act), **kw)
    tcfg = configs.get_smoke(ARCH).with_(
        quant=dataclasses.replace(POLICIES[policy], activations=act), **kw)
    return jcfg, tcfg


def _tokens(seed=1, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# configs and the tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_repro_field_for_field(smoke):
    get, jget = (configs.get_smoke, jconfigs.get_smoke) if smoke else (configs.get, jconfigs.get)
    tcfg, jcfg = get(ARCH), jget(ARCH)
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"quant"}
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(jcfg):
        if f.name not in tf | {"quant", "attn_chunk_q"}:
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            assert getattr(jcfg, f.name) == default, f.name
    assert get("llama-3.2-vision-90b") == tcfg and ARCH in configs.ARCHS
    assert tcfg.param_count() == jcfg.param_count()


def test_every_repro_arch_is_ported_and_counted_as_repro_counts():
    assert configs.ARCHS == jconfigs.ARCHS
    for arch in configs.ARCHS:
        assert configs.get(arch).param_count() == jconfigs.get(arch).param_count(), arch
        assert configs.get_smoke(arch).param_count() == jconfigs.get_smoke(arch).param_count()


@pytest.mark.parametrize("bad", [dict(cross_attn_every=0), dict(num_media_tokens=0),
                                 dict(num_layers=5)])
def test_vlm_config_is_checked(bad):
    """``repro`` asserts cross_attn_every > 0 and num_media_tokens > 0; a
    depth that is not whole groups breaks its ``(L / k, k)`` reshape."""
    with pytest.raises(ValueError):
        configs.get_smoke(ARCH).with_(**bad)
    if "num_layers" not in bad:
        with pytest.raises(AssertionError):
            jconfigs.get_smoke(ARCH).with_(**bad)


def test_param_specs_follow_jax_leaf_order():
    cfg = configs.get_smoke(ARCH)
    jparams = _jparams()
    want = [(jax.tree_util.keystr(p), np.shape(a))
            for p, a in jax.tree_util.tree_leaves_with_path(jparams)]
    port = T.init_params(cfg, 0, device="cpu")
    got = [tuple(t.shape) for t in tree.flatten(port)[0]]
    assert got == [s for _, s in want]
    names = [n for n, _ in want]
    assert names[-1] == "['media_proj']" and "['cross_layers']['gate']" in names
    assert {tuple(path) for path, _, _ in T.param_specs(cfg)} >= {
        ("cross_layers", k) for k in ("wq", "wk", "wv", "wo", "ln", "gate")}
    assert port["cross_layers"]["gate"].shape == (2,) and not port["cross_layers"]["gate"].any()
    assert np.isclose(port["media_proj"].std().item(), cfg.media_d ** -0.5, rtol=0.1)


def test_converter_holds_the_vlm_leaves():
    _, tcfg = _cfgs()
    good = _gated_np()
    convert.params_from_numpy(good, tcfg, device="cpu")
    for bad in ("drop media_proj", "drop gate", "short wk", "vlm tree as dense"):
        tr = _np(good)
        cfg = tcfg
        if bad == "drop media_proj":
            del tr["media_proj"]
        elif bad == "drop gate":
            del tr["cross_layers"]["gate"]
        elif bad == "short wk":
            tr["cross_layers"]["wk"] = tr["cross_layers"]["wk"][:1]
        else:
            cfg = configs.get_smoke("llama3_8b").with_(
                d_model=tcfg.d_model, num_layers=tcfg.num_layers, num_heads=tcfg.num_heads,
                num_kv_heads=tcfg.num_kv_heads, d_ff=tcfg.d_ff, head_dim=tcfg.head_dim)
        with pytest.raises(ValueError):
            convert.params_from_numpy(tr, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the cross-attention, the forward and the loss
# ---------------------------------------------------------------------------


def test_noncausal_attention_over_4096_media_keys_equals_repro_chunks():
    """The cross-attention's attention: every query over 4096 unmasked keys,
    the port's one-chunk softmax against ``repro``'s chunked online softmax
    (``_chunk_of(4096, attn_chunk_kv)`` = 1024)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 5, 8, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4096, 2, 32)).astype(np.float32) for _ in range(2))
    chunk = T._chunk_of(4096, configs.get(ARCH).attn_chunk_kv)
    assert chunk == 1024
    want = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0,
                                         False, 0.0, chunk, 0))
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0,
                            False, 0.0).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_cross_attn_matches_repro(act):
    jcfg, tcfg = _cfgs(act=act)
    p = _gated_np()
    cp = {k: p["cross_layers"][k][1] for k in ("wq", "wk", "wv", "wo")}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, tcfg.d_model)).astype(np.float32)
    m = rng.standard_normal((B, tcfg.num_media_tokens, tcfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if act == "bf16" else (jnp.float32, torch.float32)
    want = np.asarray(JT._cross_attn(jcfg, {k: jnp.asarray(v).astype(jdt) for k, v in cp.items()},
                                     jnp.asarray(x).astype(jdt), jnp.asarray(m).astype(jdt))
                      .astype(jnp.float32))
    got = T._cross_attn(tcfg, {k: torch.from_numpy(v).to(tdt) for k, v in cp.items()},
                        torch.from_numpy(x).to(tdt), torch.from_numpy(m).to(tdt))
    assert got.dtype == tdt
    assert _rel(got.float().numpy(), want) <= TOL[act][0]


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_forward_matches_repro(act):
    jcfg, tcfg = _cfgs(act=act)
    p, tokens, media = _gated_np(), _tokens(), media_of(tcfg, B, 3)
    want = np.asarray(JT.forward(jcfg, _jtree(p), jnp.asarray(tokens), media=jnp.asarray(media))[0])
    got, aux = T.forward(tcfg, convert.params_from_numpy(p, tcfg, device="cpu"),
                         torch.from_numpy(tokens), torch.from_numpy(media))
    assert aux is None and got.shape == want.shape == (B, S, tcfg.vocab_size)
    per_pos = [_rel(got[:, s].numpy(), want[:, s]) for s in range(S)]
    worst, median = TOL[act]
    print(f"forward/{act}: max {max(per_pos):.3g}, median {np.median(per_pos):.3g}")
    assert max(per_pos) <= worst and np.median(per_pos) <= median
    # the cross path is live: other media move the logits ten times further
    other = T.forward(tcfg, convert.params_from_numpy(p, tcfg, device="cpu"),
                      torch.from_numpy(tokens), torch.from_numpy(media_of(tcfg, B, 4)))[0]
    assert _rel(other.numpy(), want) > 10 * max(per_pos)
    with pytest.raises(ValueError, match="media"):
        T.forward(tcfg, convert.params_from_numpy(p, tcfg, device="cpu"),
                  torch.from_numpy(tokens))


@functools.lru_cache(maxsize=None)
def _repro_value_and_grad(act):
    jcfg = _cfgs(act=act)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))


@pytest.mark.parametrize("act,remat", [("f32", "block"), ("f32", "none"), ("bf16", "block")])
def test_loss_and_grads_match_repro(act, remat):
    _, tcfg = _cfgs(act=act, remat=remat)
    p, tokens, media = _gated_np(), _tokens(), media_of(tcfg, B, 5)
    (want, _), wgrads = _repro_value_and_grad(act)(
        _jtree(p), {"tokens": jnp.asarray(tokens), "media": jnp.asarray(media)})
    leaves, spec = tree.flatten(convert.params_from_numpy(p, tcfg, device="cpu"))
    live = [t.requires_grad_(True) for t in leaves]
    loss, _ = T.loss_fn(tcfg, tree.unflatten(spec, live),
                        {"tokens": torch.from_numpy(tokens), "media": torch.from_numpy(media)})
    loss.backward()
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(wgrads)]
    wg = [np.asarray(g) for g in jax.tree.leaves(wgrads)]
    assert len(wg) == len(live) == 19
    rel = abs(loss.item() - float(want)) / abs(float(want))
    errs = {n: float(np.max(np.abs(t.grad.float().numpy() - w))) / float(np.max(np.abs(w)))
            for n, t, w in zip(names, live, wg)}
    lim_loss, lim_grad = (1e-5, 1e-4) if act == "f32" else (2e-3, 0.05)
    print(f"loss/{act}/{remat}: rel {rel:.2e}, worst grad {max(errs.values()):.2e} "
          f"({max(errs, key=errs.get)})")
    assert rel <= lim_loss and max(errs.values()) <= lim_grad, errs
    assert all(np.abs(np.asarray(w)).max() > 0 for n, w in zip(names, wg) if "cross" in n)


# ---------------------------------------------------------------------------
# training: three steps, the checkpoint, the data, the launcher
# ---------------------------------------------------------------------------


def _state_np(st):
    return {"params": _np(st.params),
            "opt": {"step": np.asarray(st.opt.step), "m": _np(st.opt.m), "v": _np(st.opt.v)},
            "rng": np.asarray(st.rng)}


@jax.jit
def _sr_bits(rng, params):
    sr_key = jax.random.split(rng, 3)[1]
    leaves = jax.tree.leaves(params)
    keys = jax.random.split(sr_key, 2 * len(leaves))
    return [jax.random.bits(keys[j], leaves[j // 2].shape, jnp.uint32)
            for j in range(2 * len(leaves))]


def _repro_draws(rng, params):
    bits = [np.asarray(b).reshape(-1).astype(np.int64) for b in _sr_bits(rng, params)]
    return lambda j, start, count: torch.from_numpy(bits[j][start:start + count])


def _jstate(policy):
    jcfg = _cfgs(policy)[0]
    jparams = _jtree(_gated_np())
    opt = jax.jit(lambda q: jadamw_init(q, fmt=jcfg.quant.opt_state))(jparams)
    return dstep.TrainState(jparams, opt, jax.random.PRNGKey(1))


def test_three_train_steps_match_repro():
    jcfg, tcfg = _cfgs("takum")
    jstate = _jstate("takum")
    tstate = convert.train_state_from_numpy(_state_np(jstate), tcfg, device="cpu")
    tstep = make_train_step(tcfg, lr=LR)
    vg = _repro_value_and_grad("f32")
    update = jax.jit(functools.partial(jadamw_update, lr=LR, fmt=jcfg.quant.opt_state))
    for i in range(3):
        tokens, media = _tokens(10 + i), media_of(tcfg, B, 10 + i)
        rnd = _repro_draws(jstate.rng, jstate.params)
        rng, sr_key, _ = jax.random.split(jstate.rng, 3)
        (jloss, _), grads = vg(jstate.params, {"tokens": jnp.asarray(tokens),
                                               "media": jnp.asarray(media)})
        params, opt = update(grads, jstate.opt, jstate.params, key=sr_key)
        jstate = dstep.TrainState(params, opt, rng)
        tstate, metrics = tstep(tstate, {"tokens": torch.from_numpy(tokens),
                                         "media": torch.from_numpy(media)}, rnd=rnd)
        assert abs(metrics["loss"].item() - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        assert metrics["grad_ok"].item() == 1.0
    tp, jp = tree.flatten(tstate.params)[0], jax.tree.leaves(jstate.params)
    worst = max(float(np.max(np.abs(a.numpy() - b))) for a, b in zip(tp, jp))
    differ = total = 0
    for tm, jm in ((tstate.opt.m, jstate.opt.m), (tstate.opt.v, jstate.opt.v)):
        for a, b in zip(tree.nodes(tm), jax.tree.leaves(jm, is_leaf=lambda x: isinstance(
                x, JQTensor))):
            if isinstance(a, QTensor):
                differ += int((takum.codes_of(a.bits).numpy() != np.asarray(b.bits)).sum())
                total += np.asarray(b.bits).size
    print(f"three steps: params within {worst:.2e}; {differ} of {total} moment codes differ")
    assert worst <= 5e-5 and differ <= 0.01 * total
    g = tstate.params["cross_layers"]["gate"].numpy()
    assert not np.array_equal(g, _gated_np()["cross_layers"]["gate"])  # the gates train


def test_train_state_checkpoint_crosses(tmp_path):
    """The vlm's TrainState (t16 moments, the cross layers and media_proj
    among the leaves) saved by repro and by the port: equal bytes and CRCs,
    and repro's restores into the port leaf for leaf, in jax's order."""
    js = _jstate("takum")
    ts = convert.train_state_from_numpy(_state_np(js), _cfgs("takum")[1], device="cpu")
    JCheckpointManager(str(tmp_path / "j"), fmt="t16").save(1, js, blocking=True)
    CheckpointManager(str(tmp_path / "t"), fmt="t16").save(1, ts, blocking=True)
    metas, arrays = [], []
    for side in ("j", "t"):
        sd = tmp_path / side / f"step_{1:09d}"
        metas.append(json.loads((sd / "meta.json").read_text()))
        with np.load(sd / "arrays.npz") as z:
            arrays.append({k: z[k] for k in z.files})
    assert metas[0] == metas[1] and arrays[0].keys() == arrays[1].keys()
    assert all(np.array_equal(arrays[0][k], arrays[1][k]) for k in arrays[0])
    back = CheckpointManager(str(tmp_path / "j"), fmt="t16").restore(1, ts)
    want = JCheckpointManager(str(tmp_path / "j"), fmt="t16").restore(1, js)
    got_leaves, jleaves = tree.flatten(back)[0], jax.tree.leaves(want)
    assert len(got_leaves) == len(jleaves) == len(metas[0]["leaves"])
    for got, w in zip(got_leaves, jleaves):
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16)
                              if got.dtype == torch.uint16 else got.numpy(), np.asarray(w))


def test_media_stub_is_a_pure_function_of_seed_step_and_shard():
    pipe = SyntheticLM(256, 8, 4, seed=3)
    m = pipe.media_stub(2, 16, 32)
    assert m.shape == (4, 16, 32) and m.dtype == torch.float32
    assert torch.equal(m, SyntheticLM(256, 8, 4, seed=3).media_stub(2, 16, 32))
    for other in (pipe.media_stub(3, 16, 32), SyntheticLM(256, 8, 4, seed=4).media_stub(2, 16, 32),
                  pipe.media_stub(2, 16, 32, shard=1, num_shards=1)):
        assert not torch.equal(m, other)
    assert pipe.media_stub(2, 16, 32, shard=1, num_shards=2).shape == (2, 16, 32)
    assert abs(m.std().item() - 1.0) < 0.1
    with pytest.raises(ValueError):
        pipe.media_stub(0, 16, 32, num_shards=3)


def test_launcher_trains_the_vlm(tmp_path, capsys):
    state, hist = launch.main(["--arch", "llama-3.2-vision-90b", "--smoke", "--steps", "20",
                               "--batch", "4", "--seq", "32", "--lr", "3e-3", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path / "ck")])
    assert state.opt.step.item() == 20 and "cross_layers" in state.params
    assert hist[-1]["ce"] < hist[0]["ce"]
    text = capsys.readouterr().out
    assert "arch=llama-3.2-vision-90b" in text and "(improved)" in text
