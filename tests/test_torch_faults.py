"""The port's special-code census, guard policy, fault hooks and guarded
train step (``repro_torch.core.formats``, ``quant.policy``, ``dist.faults``,
``models.transformer._append_kv``, ``train.step``) against ``repro``.

Held bit for bit or exactly:

* ``special_mask`` / ``special_mask_np`` / ``count_specials`` /
  ``special_fraction`` over every code of t8, t16, e4m3, e5m2 and bf16, f32
  specials, and random and NaN-scale mx payloads of mxe4m3, mxe5m2 and mxt8;
* ``GuardPolicy``'s validation and ``ladder_from`` (``repro`` asserts where
  the port raises ValueError);
* the fault mechanism: each hit flips one bit, identity outside ``inject``,
  the same seed the same bits, mx element flips never touch the scale byte,
  ``scale_nan_rate=1`` NaN-scales every block.  ``repro``'s draws (jax's
  PRNG) are not redrawn: its corrupted payload XOR its clean one is fed to
  the port's ``xor_bits``;
* the counters on the same inputs: ``quant.*`` on ``repro``'s NaN case,
  ``kv.*`` on its mx append case and over a smoke llama3-8b prefill and 4
  teacher-forced decode steps (a prefill counts ``repro``'s two appends, a
  decode step two a layer);
* the guarded step under ``takum_guarded`` against ``repro``'s
  single-device ``dist.step.make_train_step`` (``repro``'s SR draws fed in):
  a clean step within the train-parity limit 5e-5 on the params; a poisoned
  one (``grad_poison_rate=1``) skipped by both, the port's params and
  moment codes unchanged bit for bit, ``step.skipped`` 1 in both.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import formats as JF
from repro.core import telemetry as jtelemetry
from repro.dist import faults as jfaults
from repro.dist import step as dstep
from repro.launch.mesh import parse_mesh
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.policy import GuardPolicy as JGuardPolicy
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro.quant.qtensor import QTensor as JQTensor
from repro.quant.qtensor import quantize as jquantize
from repro_torch import configs, convert, tree
from repro_torch.core import formats as F
from repro_torch.core import telemetry
from repro_torch.core.takum import codes_of
from repro_torch.dist import faults
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES, GuardPolicy, QuantPolicy
from repro_torch.quant.qtensor import QTensor, quantize
from repro_torch.train.step import make_train_step

FLAT = ("t8", "t16", "e4m3", "e5m2", "bf16")
MX = ("mxe4m3", "mxe5m2", "mxt8")


def _all_codes_np(nbits):
    return np.arange(1 << nbits, dtype={8: np.uint8, 16: np.uint16}[nbits])


def _census(payload_np, payload_t, fmt):
    """Assert the port's census equals repro's on one payload."""
    want_mask = np.asarray(JF.special_mask_jnp(jnp.asarray(payload_np), fmt))
    assert np.array_equal(F.special_mask(payload_t, fmt).numpy(), want_mask)
    assert np.array_equal(F.special_mask_np(payload_np, fmt), JF.special_mask_np(payload_np, fmt))
    got = F.count_specials(payload_t, fmt)
    assert got.dim() == 0 and got.dtype == torch.int32
    assert got.item() == int(JF.count_specials(jnp.asarray(payload_np), fmt))
    frac = F.special_fraction(payload_t, fmt)
    assert frac.dtype == torch.float32
    assert frac.item() == float(JF.special_fraction(jnp.asarray(payload_np), fmt))
    return got.item()


@pytest.mark.parametrize("fmt", FLAT)
def test_census_of_every_code_matches_repro(fmt):
    wf = F.wire_format(fmt)
    codes = _all_codes_np(wf.nbits).reshape(-1, 64)
    t = torch.from_numpy(codes.view({8: np.uint8, 16: np.int16}[wf.nbits])).view(wf.storage)
    n = _census(codes, t, fmt)
    assert n == {"t8": 1, "t16": 1, "e4m3": 2, "e5m2": 8, "bf16": 256}[fmt]
    if fmt == "bf16":  # the bf16 tensor itself, as a bf16 QTensor or KV cache holds it
        vals = t.view(torch.bfloat16)
        assert torch.equal(F.special_mask(vals, fmt), F.special_mask(t, fmt))


def test_census_of_f32_specials_matches_repro():
    x = np.array([0.0, -0.0, 1.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, 1e-45, -1e-40],
                 np.float32)
    bits = x.view(np.uint32).copy()
    bits = np.concatenate([bits, np.array([0x7F800001, 0xFFFFFFFF, 0x7F7FFFFF], np.uint32)])
    t = torch.from_numpy(bits.view(np.int32)).view(torch.uint32)
    assert _census(bits, t, "f32") == 6
    assert torch.equal(F.special_mask(t.view(torch.float32), "f32"), F.special_mask(t, "f32"))


@pytest.mark.parametrize("fmt", MX)
def test_census_of_mx_payloads_matches_repro(fmt):
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (6, 4 * 33), dtype=np.uint8)
    payload[:, ::33] = rng.integers(100, 140, (6, 4), dtype=np.uint8)  # finite scales
    payload[1, 33] = payload[4, 0] = payload[5, 99] = 255  # NaN-scale blocks
    n = _census(payload, torch.from_numpy(payload), fmt)
    assert n >= 3 * 32
    nan_blocks = np.zeros((2, 3 * 33), np.uint8)
    nan_blocks[:, ::33] = 255
    assert _census(nan_blocks, torch.from_numpy(nan_blocks), fmt) == 2 * 3 * 32


def test_guard_policy_validates_and_ladders_as_repro():
    with pytest.raises(AssertionError):
        JGuardPolicy(ladder=("t16", "t8"))
    with pytest.raises(ValueError):
        GuardPolicy(ladder=("t16", "t8"))
    for ladder in (("t8", "nope"),):
        with pytest.raises(KeyError):
            JGuardPolicy(ladder=ladder)
        with pytest.raises(KeyError):
            GuardPolicy(ladder=ladder)
    for ladder in (("t8", "t16", "bf16", "f32"), ("e4m3", "mxt8", "f32"), ("t16",)):
        for base in ("t8", "t16", "e4m3", "e5m2", "bf16", "f32", "mxe4m3", "mxt8"):
            assert GuardPolicy(ladder=ladder).ladder_from(base) == \
                JGuardPolicy(ladder=ladder).ladder_from(base), (ladder, base)
    g, jg = POLICIES["takum_guarded"], JPOLICIES["takum_guarded"]
    assert dataclasses.asdict(g) == dataclasses.asdict(jg)


def _one_bit_per_hit(a: torch.Tensor, b: torch.Tensor):
    x = (faults._codes(a) ^ faults._codes(b)).reshape(-1)
    hits = x[x != 0]
    assert torch.equal(hits & (hits - 1), torch.zeros_like(hits)), "a hit flips exactly one bit"
    return hits.numel()


@pytest.mark.parametrize("dtype", (torch.uint8, torch.uint16, torch.bfloat16, torch.float32))
def test_flip_bits_flips_one_bit_per_hit_and_replays(dtype):
    if dtype == torch.float32:
        p = torch.linspace(-2, 2, 4096)
    elif dtype == torch.uint8:
        p = (torch.arange(4096) % 256).to(torch.uint8)
    else:
        p = torch.arange(-2048, 2048, dtype=torch.int16).view(dtype)
    a = faults.flip_bits(p, 3, 1.0)
    assert a.dtype == p.dtype and a.shape == p.shape
    assert _one_bit_per_hit(a, p) == p.numel()  # rate 1: every word hit
    assert torch.equal(faults._codes(faults.flip_bits(p, 3, 1.0)), faults._codes(a))
    assert not torch.equal(faults._codes(faults.flip_bits(p, 4, 1.0)), faults._codes(a))
    assert faults.flip_bits(p, 3, 0.0) is p
    n = _one_bit_per_hit(faults.flip_bits(p, 5, 0.25), p)
    assert 0.2 * p.numel() < n < 0.3 * p.numel()


def test_hooks_are_the_identity_outside_inject():
    p = torch.arange(66, dtype=torch.uint8)
    assert faults.active() is None
    assert faults.corrupt_payload(p, "t8") is p
    g = {"w": torch.ones(4)}
    assert faults.poison_grads(g, 0) is g
    with faults.inject(faults.FaultConfig(seed=1, grad_poison_rate=1.0)):
        assert faults.corrupt_payload(p, "t8") is p  # no wire faults configured
    assert faults.active() is None


def test_corrupt_payload_replays_per_scope():
    cfg = faults.FaultConfig(seed=11, bit_flip_rate=0.3)
    p = torch.arange(256, dtype=torch.uint8)
    with faults.inject(cfg):
        a = faults.corrupt_payload(p, "t8")
        a2 = faults.corrupt_payload(p, "t8")  # the next call site draws anew
    with faults.inject(cfg):
        b = faults.corrupt_payload(p, "t8")
    with faults.inject(faults.FaultConfig(seed=12, bit_flip_rate=0.3)):
        c = faults.corrupt_payload(p, "t8")
    assert torch.equal(a, b) and not torch.equal(a, a2) and not torch.equal(a, c)
    _one_bit_per_hit(a, p)


@pytest.mark.parametrize("fmt", MX)
def test_mx_scale_and_element_channels(fmt):
    payload = torch.zeros(8 * 33, dtype=torch.uint8)
    with faults.inject(faults.FaultConfig(seed=5, bit_flip_rate=1.0)):
        out = faults.corrupt_payload(payload, fmt).reshape(8, 33)
    assert (out[:, 0] == 0).all(), "scale bytes have their own fault channel"
    assert _one_bit_per_hit(out[:, 1:], payload.reshape(8, 33)[:, 1:]) == 8 * 32
    with faults.inject(faults.FaultConfig(seed=0, scale_nan_rate=1.0)):
        out = faults.corrupt_payload(payload.reshape(4, 66), fmt).reshape(8, 33)
    assert (out[:, 0] == 255).all() and (out[:, 1:] == 0).all()
    assert F.count_specials(out.reshape(-1), fmt).item() == 8 * 32
    with faults.inject(faults.FaultConfig(seed=0, scale_flip_rate=1.0)):
        out = faults.corrupt_payload(payload, fmt).reshape(8, 33)
    assert _one_bit_per_hit(out[:, 0], payload[:8]) == 8 and (out[:, 1:] == 0).all()


@pytest.mark.parametrize("fmt,shape", [("t8", (64, 64)), ("t16", (32, 48)), ("bf16", (32, 48)),
                                       ("mxe4m3", (8, 66)), ("mxt8", (4, 99))])
def test_repro_hit_patterns_through_the_port(fmt, shape):
    """``repro``'s corruption (its draws) XOR its clean payload, fed through
    the port's ``xor_bits``, gives ``repro``'s corrupted payload."""
    wf = F.wire_format(fmt)
    rng = np.random.default_rng(7)
    clean = rng.integers(0, 1 << min(wf.nbits, 16), shape).astype(wf.np_storage)
    cfg = jfaults.FaultConfig(seed=2, bit_flip_rate=0.2, scale_flip_rate=0.3, scale_nan_rate=0.2)
    with jfaults.inject(cfg):
        bad = np.asarray(jax.jit(lambda p: jfaults.corrupt_payload(p, fmt))(jnp.asarray(clean)))
    pattern = (bad ^ clean).astype(np.int64)
    t = torch.from_numpy(clean.view({8: np.uint8, 16: np.int16}[wf.nbits])).view(wf.storage)
    got = faults.xor_bits(t, torch.from_numpy(pattern))
    assert np.array_equal(codes_of(got).numpy(), bad.astype(np.int64))
    assert F.count_specials(got, fmt).item() == int(JF.count_specials(jnp.asarray(bad), fmt))


def test_poison_grads_rate_and_replay():
    cfg = faults.FaultConfig(seed=2, grad_poison_rate=1.0, poison_frac=0.25)
    g = {"a": torch.ones((64, 64)), "b": torch.ones(128)}
    with faults.inject(cfg):
        p1, p2 = faults.poison_grads(g, 9), faults.poison_grads(g, 9)
        p3 = faults.poison_grads(g, 10)
    assert 0.15 < torch.isnan(p1["a"]).float().mean().item() < 0.35
    assert torch.equal(torch.isnan(p1["a"]), torch.isnan(p2["a"]))
    assert not torch.equal(torch.isnan(p1["a"]), torch.isnan(p3["a"]))
    with faults.inject(dataclasses.replace(cfg, grad_poison_rate=0.0)):
        assert faults.poison_grads(g, 9) is g


# ---------------------------------------------------------------------------
# counters against repro on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ("t8", "bf16", "mxe4m3"))
def test_quantize_health_counters_match_repro(fmt):
    x = np.concatenate([np.ones(31, np.float32), [np.nan]]).astype(np.float32).reshape(1, 32)
    with jtelemetry.capture() as want:
        jax.block_until_ready(jax.jit(lambda a: jquantize(a, fmt).bits)(jnp.asarray(x)))
    with telemetry.capture() as got:
        quantize(torch.from_numpy(x), fmt)
    assert _only(got, "quant.") == _only(want, "quant.")
    assert got[f"quant.calls.{F.wire_format(fmt).name}"] == 1.0
    assert got[f"quant.specials.{F.wire_format(fmt).name}"] >= 1.0
    with telemetry.capture() as got:
        quantize(torch.from_numpy(x), "f32")
    assert dict(got) == {}


def _scope(mod, poisoned, **cfg):
    """``mod.inject(mod.FaultConfig(**cfg))`` (``mod``: either package's
    faults), or no scope."""
    return mod.inject(mod.FaultConfig(**cfg)) if poisoned else contextlib.nullcontext()


def _only(store, prefix):
    return {t: c for t, c in store.items() if t.startswith(prefix)}


def _kv_cfgs(kv):
    jcfg = jconfigs.get_smoke("llama3_8b").with_(quant=JQuantPolicy(kv_cache=kv))
    tcfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(kv_cache=kv))
    return jcfg, tcfg


@pytest.mark.parametrize("clean", (False, True))
def test_kv_append_counters_match_repro(clean):
    """``repro``'s mx append case: every block NaN-scaled under
    ``scale_nan_rate=1``; a prefill-shaped append of K and V of every layer."""
    jcfg, tcfg = _kv_cfgs("mxe4m3")
    L, B, S = tcfg.num_layers, 4, 8
    Kv, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((L, B, S, Kv, hd)).astype(np.float32) for _ in range(2))
    fcfg = dict(seed=1, scale_nan_rate=1.0)
    with jtelemetry.capture() as want, _scope(jfaults, not clean, **fcfg):
        enc = jax.jit(lambda a, b: (JT._encode_cache(jcfg, a), JT._encode_cache(jcfg, b)))
        jax.block_until_ready(enc(jnp.asarray(k), jnp.asarray(v)))
    cache = T.init_cache(tcfg, B, S, device="cpu")
    with telemetry.capture() as got, _scope(faults, not clean, **fcfg):
        for l in range(L):
            T._append_kv(tcfg, cache, l, torch.from_numpy(k[l]), torch.from_numpy(v[l]), 0,
                         appends=2 if l == 0 else 0)
    assert _only(got, "kv.") == _only(want, "kv.")
    assert got["kv.specials.mxe4m3"] == (0 if clean else 2 * L * B * S * Kv * 32)
    assert got["kv.appends.mxe4m3"] == 2.0


@pytest.mark.parametrize("kv", ("t8",))
def test_serving_kv_counters_match_repro(kv):
    """Smoke llama3-8b (f32 weights, one NaN column of layer 0's wk, so that
    layer 0's K and everything downstream carries specials), prefill of 16
    tokens and 4 teacher-forced decode steps under both captures."""
    jcfg0, tcfg0 = _kv_cfgs(kv)
    jcfg = jcfg0.with_(quant=dataclasses.replace(jcfg0.quant, weights="f32", activations="f32"))
    tcfg = tcfg0.with_(quant=dataclasses.replace(tcfg0.quant, weights="f32", activations="f32"))
    params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params["layers"]["attn"]["wk"][0, :, 0] = np.nan
    prompt = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    with jtelemetry.capture() as want:
        logits, cache = jax.jit(lambda p, t: JT.prefill(jcfg, p, t, cache_len=20))(jp, prompt)
        step = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c))
        fed = []
        for _ in range(4):
            fed.append(np.asarray(jnp.argmax(logits, -1)))
            logits, cache = step(jp, jnp.asarray(fed[-1]), cache)
        jax.block_until_ready(logits)
    tparams = convert.params_from_numpy(params, tcfg, device="cpu")
    with telemetry.capture() as got:
        logits, tcache = T.prefill(tcfg, tparams, torch.from_numpy(prompt.astype(np.int64)),
                                   cache_len=20)
        for tok in fed:
            logits, tcache = T.decode_step(tcfg, tparams, torch.from_numpy(tok.astype(np.int64)),
                                           tcache)
    kv_got = _only(got, "kv.")
    assert kv_got == _only(want, "kv.")
    name = F.wire_format(kv).name
    assert kv_got[f"kv.appends.{name}"] == 2 + 2 * tcfg.num_layers * 4
    assert kv_got[f"kv.specials.{name}"] > 0


# ---------------------------------------------------------------------------
# the guarded train step against repro's
# ---------------------------------------------------------------------------

B, S, LR = 2, 16, 3e-4


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, JQTensor):
        return {"bits": np.asarray(t.bits), "fmt": t.fmt,
                "scale": None if t.scale is None else np.asarray(t.scale)}
    return np.asarray(t)


@jax.jit
def _sr_bits(rng, params):
    """``repro``'s SR draws of one step for each moment leaf (m of leaf i is
    2i, v is 2i + 1)."""
    sr_key = jax.random.split(rng, 3)[1]
    leaves = jax.tree.leaves(params)
    keys = jax.random.split(sr_key, 2 * len(leaves))
    return [jax.random.bits(keys[j], leaves[j // 2].shape, jnp.uint32)
            for j in range(2 * len(leaves))]


def _moment_codes(opt):
    return [codes_of(q.bits).clone() for q in tree.nodes(opt.m) + tree.nodes(opt.v)
            if isinstance(q, QTensor)]


@pytest.fixture(scope="module")
def guarded():
    jcfg = jconfigs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(JPOLICIES["takum_guarded"], activations="f32"))
    tcfg = configs.get_smoke("llama3_8b").with_(
        quant=dataclasses.replace(POLICIES["takum_guarded"], activations="f32"))
    params = jax.jit(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))()
    opt = jax.jit(lambda p: jadamw_init(p, fmt="t16"))(params)
    jstate = dstep.TrainState(params, opt, jax.random.PRNGKey(1))
    tokens = np.random.default_rng(5).integers(0, 256, (B, S)).astype(np.int32)
    return jcfg, tcfg, jstate, tokens


def _port_state(jstate, tcfg):
    return convert.train_state_from_numpy(
        {"params": _np(jstate.params),
         "opt": {"step": np.asarray(jstate.opt.step), "m": _np(jstate.opt.m),
                 "v": _np(jstate.opt.v)},
         "rng": np.asarray(jstate.rng)}, tcfg, device="cpu")


@pytest.mark.parametrize("poisoned", (False, True))
def test_guarded_step_matches_repro(guarded, poisoned):
    jcfg, tcfg, jstate, tokens = guarded
    fcfg = dict(seed=3, grad_poison_rate=1.0)
    with _scope(jfaults, poisoned, **fcfg), jtelemetry.capture() as want:
        jstep = jax.jit(dstep.make_train_step(jcfg, parse_mesh("1x1"), lr=LR))
        new_j, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        jax.block_until_ready(new_j)
    tstate = _port_state(jstate, tcfg)
    before = [p.clone() for p in tree.flatten(tstate.params)[0]], _moment_codes(tstate.opt)
    rnd = None  # a skipped step draws nothing
    if not poisoned:
        bits = [np.asarray(b).reshape(-1).astype(np.int64)
                for b in _sr_bits(jstate.rng, jstate.params)]
        rnd = lambda j, start, count: torch.from_numpy(bits[j][start:start + count])  # noqa: E731
    with _scope(faults, poisoned, **fcfg), telemetry.capture() as got:
        new_t, tm = make_train_step(tcfg, lr=LR)(tstate, {"tokens": torch.from_numpy(tokens)},
                                                 rnd=rnd)
    assert got["step.skipped"] == want["step.skipped"] == (1.0 if poisoned else 0.0)
    assert got["step.calls"] == want["step.calls"] == 1.0
    assert got["step.tokens"] == want["step.tokens"] == float(B * S)
    assert telemetry.hists()["step.grad_norm"]["count"] == 1
    assert tm["grad_ok"].item() == float(jm["grad_ok"]) == (0.0 if poisoned else 1.0)
    if poisoned:
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in
                   zip(tree.flatten(new_t.params)[0], before[0]))
        assert all(torch.equal(a, b) for a, b in zip(_moment_codes(new_t.opt), before[1]))
        assert new_t.opt.step.item() == 0
        assert not torch.equal(new_t.rng.view(torch.int32), tstate.rng.view(torch.int32))
        return
    tp, jp = tree.flatten(new_t.params)[0], jax.tree.leaves(new_j.params)
    worst = max(float(np.max(np.abs(a.numpy() - np.asarray(b)))) for a, b in zip(tp, jp))
    assert worst <= 5e-5, worst
    assert new_t.opt.step.item() == int(new_j.opt.step) == 1
