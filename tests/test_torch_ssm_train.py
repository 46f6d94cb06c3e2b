"""The ssm and hybrid families (mamba2-780m, hymba-1.5b; smoke size):
training, the tree, the consistency of prefill and decode, and the
converter, against ``repro``.

* ``repro_torch.tree``'s leaf order of a converted smoke tree equals
  ``jax.tree.leaves`` of ``repro``'s, one for one by shape and value (the
  ``MambaParams`` leaves in their field order), and so does hymba's train
  state (params, t16 moments, rng).
* ``loss_fn`` and its grads at f32 against ``jax.value_and_grad`` of
  ``repro``'s (both sides ``ssm_chunk = 8`` over 32 tokens: four chunks):
  the loss within 1e-5 relative, each grad within 1e-4 of its max|grad|,
  every ``MambaParams`` leaf among them.
* ``repro``'s own consistency case (``tests/test_arch_smoke.py::
  test_prefill_decode_consistency``) on the port: its prefill of 8 tokens
  and 8 decode steps reproduce its own full forward, mamba2 under
  ``kv_cache="f32"`` (no K/V: the format is never resolved) within 2e-2,
  hymba under a bf16 and an f32 KV cache (K6 reading raw f32 bits)
  within 2e-2 and under t16 by argmax agreement above 0.8.
* The launcher trains both archs for 2 smoke steps on the CPU.
* The converter refuses a tree whose ``ssm`` / ``attn`` / ``mlp`` does not
  match the family, and takes ``MambaParams`` as a dict of its fields.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.dist import step as dstep
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs, convert, tree
from repro_torch.launch import train as launch
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as T
from repro_torch.quant.policy import QuantPolicy

from _ssm_serve import cfgs, jparams, np_tree  # noqa: E402

ARCHS = ("mamba2_780m", "hymba_1_5b")
TRAIN_S, CHUNK = 32, 8


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_order_is_jax(arch):
    jp = jparams(arch)
    _, tcfg = cfgs(arch, "takum", "f32")
    port = convert.params_from_numpy(np_tree(jp), tcfg, device="cpu")
    got, want = tree.flatten(port)[0], [np.asarray(a) for a in jax.tree.leaves(jp)]
    assert len(got) == len(want) == (11 if arch == "mamba2_780m" else 20)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and np.array_equal(g.numpy(), w)
    rebuilt = tree.unflatten(tree.flatten(port)[1], got)
    assert isinstance(rebuilt["layers"]["ssm"], TM.MambaParams)
    if arch == "hymba_1_5b":
        opt = jax.jit(lambda p: jadamw_init(p, fmt="t16"))(jp)
        js = dstep.TrainState(jp, opt, jax.random.PRNGKey(1))
        st = {"params": np_tree(js.params),
              "opt": {"step": np.asarray(js.opt.step), "m": np_tree(js.opt.m),
                      "v": np_tree(js.opt.v)},
              "rng": np.asarray(js.rng)}
        ts = convert.train_state_from_numpy(st, tcfg, device="cpu")
        got, want = tree.flatten(ts)[0], [np.asarray(a) for a in jax.tree.leaves(js)]
        assert len(got) == len(want) == 20 * 5 + 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and np.array_equal(g.numpy().astype(w.dtype), w)


@functools.lru_cache(maxsize=None)
def _repro_value_and_grad(arch):
    jcfg = cfgs(arch, "bf16", "f32", ssm_chunk=CHUNK)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch):
    _, tcfg = cfgs(arch, "bf16", "f32", ssm_chunk=CHUNK)
    jp = jparams(arch)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, TRAIN_S)).astype(np.int32)
    (want, _), wgrads = _repro_value_and_grad(arch)(jp, {"tokens": jnp.asarray(tokens)})
    params = convert.params_from_numpy(np_tree(jp), tcfg, device="cpu")
    leaves, spec = tree.flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    loss, _ = T.loss_fn(tcfg, tree.unflatten(spec, live), {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    wgrads = [np.asarray(g) for g in jax.tree.leaves(wgrads)]
    assert len(wgrads) == len(live)
    rel = abs(loss.item() - float(want)) / abs(float(want))
    errs = [float(np.max(np.abs(p.grad.numpy() - w))) / float(np.max(np.abs(w)))
            for p, w in zip(live, wgrads)]
    print(f"{arch}: loss rel {rel:.2e}, worst grad {max(errs):.2e} of max|grad|")
    assert rel <= 1e-5 and max(errs) <= 1e-4, errs


#: (arch, KV cache format): repro's consistency case on the port
CONSISTENCY = (("mamba2_780m", "f32"), ("hymba_1_5b", "bf16"), ("hymba_1_5b", "t16"),
               ("hymba_1_5b", "f32"))


@pytest.mark.parametrize("arch,kv_fmt", CONSISTENCY)
def test_prefill_decode_consistency(arch, kv_fmt):
    cfg = configs.get_smoke(arch).with_(quant=QuantPolicy(kv_cache=kv_fmt, activations="f32"))
    params = T.init_params(cfg, 2, device="cpu")
    B, S, S0 = 2, 16, 8
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    full, _ = T.forward(cfg, params, tokens)
    last, cache = T.prefill(cfg, params, tokens[:, :S0], cache_len=S)
    assert (cfg.family == "ssm") == (cache.k.numel() == 0)
    np.testing.assert_allclose(last.numpy(), full[:, S0 - 1].numpy(), rtol=2e-2, atol=2e-2)
    steps = []
    for t in range(S0, S):
        lg, cache = T.decode_step(cfg, params, tokens[:, t], cache)
        steps.append(lg.numpy())
    got, want = np.stack(steps, 1), full[:, S0:].numpy()
    if kv_fmt == "t16":
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree > 0.8, agree
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains(tmp_path, capsys, arch):
    state, hist = launch.main(["--arch", arch.replace("_", "-", 1), "--smoke", "--steps", "2",
                               "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "ck")])
    assert state.opt.step.item() == 2
    assert isinstance(state.params["layers"]["ssm"], TM.MambaParams)
    assert all(torch.isfinite(p).all() for p in tree.flatten(state.params)[0])
    assert f"arch={configs.get(arch).name}" in capsys.readouterr().out


def test_converter_refuses_a_tree_that_does_not_match_the_family():
    for arch, bad in (("mamba2_780m", "add attn"), ("mamba2_780m", "drop ssm"),
                      ("mamba2_780m", "add mlp"), ("hymba_1_5b", "drop ssm"),
                      ("hymba_1_5b", "drop attn"), ("hymba_1_5b", "drop mlp"),
                      ("hymba_1_5b", "ssm of mamba2"), ("llama3_8b", "add ssm")):
        _, tcfg = cfgs(arch, "bf16", "f32")
        tr = np_tree(jparams(arch))
        layers = tr["layers"]
        if bad == "add attn":
            layers["attn"] = np_tree(jparams("hymba_1_5b"))["layers"]["attn"]
        elif bad == "add mlp":
            layers["mlp"] = np_tree(jparams("hymba_1_5b"))["layers"]["mlp"]
        elif bad == "add ssm":
            layers["ssm"] = np_tree(jparams("hymba_1_5b"))["layers"]["ssm"]
        elif bad == "ssm of mamba2":
            layers["ssm"] = np_tree(jparams("mamba2_780m"))["layers"]["ssm"]
        else:
            del layers[bad.split()[1]]
        with pytest.raises(ValueError):
            convert.params_from_numpy(tr, tcfg, device="cpu")
    _, tcfg = cfgs("mamba2_780m", "bf16", "f32")
    tr = np_tree(jparams("mamba2_780m"))
    tr["layers"]["ssm"] = dict(tr["layers"]["ssm"]._asdict())  # a dict of the fields
    port = convert.params_from_numpy(tr, tcfg, device="cpu")
    assert isinstance(port["layers"]["ssm"], TM.MambaParams)
    assert port["layers"]["ssm"].in_proj.shape == (2, 64, 2 * 128 + 2 * 16 + 8)
