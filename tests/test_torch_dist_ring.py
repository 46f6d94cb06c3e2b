"""The port's compressed ring, error feedback, guarded ladder, hop faults
and pod train step (``repro_torch.dist.collectives``, ``.error_feedback``,
``.faults.corrupt_hop``, ``.step``) on 4 gloo ranks, against ``repro``.

``repro``'s multi-device numbers come from one 4-device jax subprocess
(``_REF``, started with the module and bounded by ``REF_TIMEOUT_S``); the
port's ranks are one ``RankPool`` for the module (process-group timeout,
join deadline).  Held:

* ``compressed_psum`` for every format (f32, t16, t8, bf16, e4m3, e5m2,
  mxe4m3, mxe5m2, mxt8), both ``exact_local`` settings, ``compressed_pmean``,
  the 27-wide mx cases and the SR rings of t8 / e5m2 fed ``repro``'s
  per-pod draws, on [4, 64, 32]: **bit for bit** for every compressed
  wire (the port adds the decoded terms in source order from zero, as XLA
  reduces ``repro``'s stack); f32 is gloo's all-reduce, which adds in
  another order than XLA's psum (a sequential sum in rank order), so it is
  held within (P - 1) f32 eps of sum |x_i|; every rank's result equal to
  rank 0's where the ranks add the
  same terms; the ``wire.*`` counters of a captured ring, summed over the
  ranks, equal ``repro``'s; one K2 and P - 1 K1 a ring (one more K1 with
  ``exact_local=False``), per chunk when the payload is chunked.
* three unguarded error-feedback steps (t8, mxe4m3 on [64, 27]), reduced
  sums and residuals bit for bit.
* the pod step on (2, 2, 1), llama3-8b smoke, takum with f32 activations
  and ``stochastic_rounding=False`` (t16 ring): params within 5e-5, loss
  within 1e-5 relative.
* ``degraded_psum`` and the guarded EF, held to their definition
  (``repro``'s raise on this jax, ROADMAP R8): the rung taken is the first
  whose ``repro`` single-device health check passes on every rank's
  contained payload (the ranks' trips OR'd; in the cases with a scale per
  rank one rank's check alone trips, and every rank escalates), the output is the port's
  ``compressed_psum`` of the contained input at that rung, the EF residual
  is ``c - decode(encode(c))`` at the rung sent (zero at f32), and the
  ``wire.*`` / ``ef.*`` counters say so.
* ``corrupt_hop``: ``repro``'s garbled and dropped messages rebuilt by
  ``faults.apply_hop`` from ``repro``'s hit pattern; the port's draws (one
  bit a hit, the same seed the same bits); under hop faults the guarded
  ring's ``wire.contained`` equals the elements the arrivals' decodes put
  off the rail.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.formats import special_fraction as jspecial_fraction
from repro.dist import collectives as JC
from repro.dist import faults as jfaults
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.quant import blockscale as jblockscale
from repro.quant.policy import GuardPolicy as JGuardPolicy
from repro.quant.policy import QuantPolicy as JQuantPolicy
from repro.quant.qtensor import QTensor as JQTensor
from repro_torch.dist import faults
from repro_torch.dist.spawn import RankPool
from repro_torch.quant.policy import GuardPolicy

sys.path.insert(0, os.path.dirname(__file__))
import _dist_cases as D  # noqa: E402

P = 4
REF_TIMEOUT_S = 240
FMTS = ("f32", "t16", "t8", "bf16", "e4m3", "e5m2", "mxe4m3", "mxe5m2", "mxt8")
CASES = [(f"psum_{f}_{int(el)}", f, el, False) for f in FMTS for el in (True, False)] + \
        [(f"pmean_{f}", f, False, True) for f in FMTS]
SR_FMTS = ("t8", "e5m2")
MX27 = ("mxe4m3", "mxt8")
EF_FMTS = ("t8", "mxe4m3")
POD_POLICY = dict(weights="t16", kv_cache="t8", grad_comm="t16", opt_state="t16",
                  checkpoint="t16", pipe_act="t16", activations="f32",
                  stochastic_rounding=False)

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.core import telemetry as jtel
from repro.dist import step as dstep
from repro.dist.collectives import compressed_pmean, compressed_psum
from repro.dist.error_feedback import ef_compressed_psum
from repro.models import transformer as JT
from repro.optim import adamw_init
from repro.quant.policy import QuantPolicy

CASES, SR_FMTS, MX27, EF_FMTS, POLICY, out_path = eval(sys.argv[1]), eval(sys.argv[2]), \
    eval(sys.argv[3]), eval(sys.argv[4]), eval(sys.argv[5]), sys.argv[6]
out = {}
mesh = jax.make_mesh((4,), ("pod",))
x = np.random.default_rng(0).standard_normal((4, 64, 32)).astype(np.float32)
key = jax.random.PRNGKey(7)

def body(v):
    outs = [(compressed_pmean if mean else compressed_psum)(v[0], "pod", fmt, exact_local=el)[None]
            for _, fmt, el, mean in CASES]
    outs += [compressed_psum(v[0, ..., :27], "pod", fmt)[None] for fmt in MX27]
    k = jax.random.fold_in(key, jax.lax.axis_index("pod"))
    outs += [compressed_psum(v[0], "pod", fmt, sr_key=k)[None] for fmt in SR_FMTS]
    return tuple(outs)

n = len(CASES) + len(MX27) + len(SR_FMTS)
res = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("pod"),
                            out_specs=tuple(P("pod") for _ in range(n))))(x)
names = [c[0] for c in CASES] + [f"psum27_{f}" for f in MX27] + [f"psumsr_{f}" for f in SR_FMTS]
out.update({k: np.asarray(r) for k, r in zip(names, res)})
out["sr_bits"] = np.stack([np.asarray(jax.random.bits(jax.random.fold_in(key, p), (64, 32),
                                                      jnp.uint32)) for p in range(4)])
sm = jax.jit(jax.shard_map(lambda v: compressed_psum(v[0], "pod", "t8")[None], mesh=mesh,
                           in_specs=P("pod"), out_specs=P("pod")))
with jtel.capture():
    jax.block_until_ready(sm(x))
ctr = jtel.snapshot()["counters"]
out["tel_keys"] = np.array(sorted(ctr))
out["tel_vals"] = np.array([ctr[k] for k in sorted(ctr)])
for fmt in EF_FMTS:
    err = np.zeros((4, 64, 27), np.float32)
    f = jax.jit(jax.shard_map(
        lambda g, e, fmt=fmt: tuple(a[None] for a in ef_compressed_psum(g[0], e[0], "pod", fmt)),
        mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod"))))
    for s in range(3):
        g = np.random.default_rng(10 + s).standard_normal((4, 64, 27)).astype(np.float32)
        red, err = f(g, err)
        out[f"ef_{fmt}_{s}_red"], out[f"ef_{fmt}_{s}_err"] = np.asarray(red), np.asarray(err)
cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**POLICY))
pmesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
params = jax.jit(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))()
state = dstep.TrainState(params, jax.jit(lambda p: adamw_init(p, fmt="t16"))(params),
                         jax.random.PRNGKey(1))
tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
new, m = jax.jit(dstep.make_train_step(cfg, pmesh))(state, {"tokens": jnp.asarray(tokens)})
for i, leaf in enumerate(jax.tree.leaves(new.params)):
    out[f"pod_param{i}"] = np.asarray(leaf)
out["pod_loss"], out["pod_ce"] = np.asarray(m["loss"]), np.asarray(m["ce"])
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """``repro``'s 4-device outputs: the subprocess starts with the module
    and is waited for (at most ``REF_TIMEOUT_S``) at first use."""
    path = tmp_path_factory.mktemp("dist_ring") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF, repr(CASES), repr(SR_FMTS), repr(MX27), repr(EF_FMTS),
         repr(POD_POLICY), str(path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def load():
        if not got:
            try:
                _, err = proc.communicate(timeout=REF_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                pytest.fail(f"the jax reference took more than {REF_TIMEOUT_S} s")
            assert proc.returncode == 0, err[-3000:]
            got.update(np.load(path))
        return got

    yield load
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool():
    with RankPool(P, timeout_s=60) as p:
        yield p


X = np.random.default_rng(0).standard_normal((P, 64, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def rings(pool, ref):
    return pool.run(D.ring_cases, X, CASES, ref()["sr_bits"], SR_FMTS, MX27)


def _same(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("name", [c[0] for c in CASES] + [f"psum27_{f}" for f in MX27]
                         + [f"psumsr_{f}" for f in SR_FMTS])
def test_ring_bit_for_bit_against_repro(rings, ref, name):
    want = ref()[name]
    for r in range(P):
        if "f32" in name:  # gloo's all-reduce adds in another order than XLA's psum
            bound = (P - 1) * np.finfo(np.float32).eps * np.abs(X).sum(0)
            if name.startswith("pmean"):
                bound = bound / P
            assert np.all(np.abs(rings[r][name] - want[r]) <= bound), name
            continue
        assert _same(rings[r][name], want[r]), (name, r, np.abs(rings[r][name] - want[r]).max())
    if name.endswith("_0") or name.startswith("pmean") or "f32" in name:
        # every rank adds the same terms: the same bits
        assert all(_same(rings[r][name], rings[0][name]) for r in range(P))


def test_ring_counters_match_repro(rings, ref):
    want = dict(zip(ref()["tel_keys"].tolist(), ref()["tel_vals"].tolist()))
    want = {k: v for k, v in want.items() if k.startswith("wire.") and not k.startswith("wire.hop.")}
    got = {}
    for r in range(P):
        for k, v in rings[r]["counters"].items():
            got[k] = got.get(k, 0.0) + v
    assert got == want
    assert got["wire.hop_bytes"] == P * (P - 1) * 64 * 32  # t8: a byte an element


@pytest.mark.parametrize("fmt,exact_local,chunk", [("t8", True, 1 << 26), ("t16", False, 1 << 26),
                                                   ("mxt8", False, 256), ("e5m2", True, 512)])
def test_ring_launches_one_k2_and_p_minus_1_k1(pool, rings, fmt, exact_local, chunk):
    got = pool.run(D.ring_launches, X, fmt, exact_local, chunk)
    n_el = 64 * 32
    chunks = -(-n_el // chunk)
    for r in range(P):
        assert got[r]["encode"] == chunks
        assert got[r]["decode"] == chunks * (P - 1 + (0 if exact_local else 1))
        assert _same(got[r]["out"], rings[r][f"psum_{fmt}_{int(exact_local)}"])


@pytest.mark.parametrize("chunk", (None, 320))
@pytest.mark.parametrize("fmt", EF_FMTS)
def test_three_ef_steps_bit_for_bit(pool, ref, fmt, chunk):
    # chunk 320: the ring passes over the flat (mx-padded) payload in 7 parts
    got = pool.run(D.ef_steps, fmt, 3, (64, 27), chunk=chunk)
    for s in range(3):
        for part in ("red", "err"):
            want = ref()[f"ef_{fmt}_{s}_{part}"]
            for r in range(P):
                assert _same(got[r][f"{part}{s}"], want[r]), (fmt, s, part, r)
    assert got[0]["counters"]["ef.calls"] == 3.0


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, JQTensor):
        return {"bits": np.asarray(t.bits), "fmt": t.fmt,
                "scale": None if t.scale is None else np.asarray(t.scale)}
    return np.asarray(t)


def test_pod_step_matches_repro(pool, ref):
    jcfg = jconfigs.get_smoke("llama3_8b").with_(quant=JQuantPolicy(**POD_POLICY))
    params = jax.jit(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))()
    opt = jax.jit(lambda p: jadamw_init(p, fmt="t16"))(params)
    state = {"params": _np_tree(params),
             "opt": {"step": np.asarray(opt.step), "m": _np_tree(opt.m), "v": _np_tree(opt.v)},
             "rng": np.asarray(jax.random.PRNGKey(1))}
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    got = pool.run(D.pod_step_vs_repro, state, tokens, POD_POLICY)
    want = ref()
    worst = 0.0
    for i, leaf in enumerate(got[0]["params"]):
        worst = max(worst, float(np.abs(leaf - want[f"pod_param{i}"]).max()))
    assert worst <= 5e-5, worst
    assert abs(float(got[0]["loss"]) - float(want["pod_loss"])) <= 1e-5 * abs(float(want["pod_loss"]))
    for r in range(1, P):  # the ranks' params are the same bits
        assert all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                   for a, b in zip(got[r]["params"], got[0]["params"]))


# ---------------------------------------------------------------------------
# the guarded ring and guarded EF, held to their definition
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=1)
def _repro_health(xp, rung):
    """``repro``'s local health check at ``rung`` (the expression of its
    ``degraded_psum``, single device): (special fraction, relative rms
    error)."""
    if rung.startswith("mx"):
        xp = jblockscale.pad_block(jnp.atleast_1d(xp))
    enc, dec = JC.wire_codec(rung)
    wire = enc(xp)
    q = dec(wire)
    spec = jspecial_fraction(wire, rung)
    err = jnp.where(jnp.isfinite(q), q - xp, jnp.float32(0))
    rel = jnp.sqrt(jnp.mean(jnp.square(err))) / (jnp.sqrt(jnp.mean(jnp.square(xp))) + 1e-12)
    return spec, rel


def _repro_trips(x, rung, guard) -> bool:
    spec, rel = _repro_health(jnp.asarray(x), rung)
    return bool((spec > guard.max_special_frac) | (rel > guard.max_rel_err))


def _expected_rung(payloads, fmt, guard):
    rungs = guard.ladder_from(fmt)
    for i, name in enumerate(rungs[:-1]):
        if name == "f32" or not any(_repro_trips(x, name, guard) for x in payloads):
            return i, name
    return len(rungs) - 1, rungs[-1]


def _scaled(x, scale):
    """``x`` [P, ...] with rank r's slice times ``scale`` (a number, or one
    per rank)."""
    return x * np.asarray(scale, np.float32).reshape(-1, *[1] * (x.ndim - 1))


# A scale per rank makes one rank's payload alone trip the first rung
# (e4m3 overflows at 1000x; t8's relative error is about 0.2 at 1e-4x and
# 0.04 at 1x): every rank must still take the escalated rung.
ONE_TRIPS = [(1.0, 1000.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1e-4)]
DEGRADED = [("t8", {}, 1.0), ("t8", {"max_rel_err": 0.01}, 1.0),
            ("t8", {"max_rel_err": 1e-9}, 1.0), ("e4m3", {}, 1000.0),
            ("mxt8", {"max_rel_err": 0.01}, 1.0), ("e5m2", {"max_rel_err": 0.05}, 1.0),
            ("e4m3", {}, ONE_TRIPS[0]), ("t8", {"max_rel_err": 0.1}, ONE_TRIPS[1])]


def _local_trips(payloads, fmt, guard):
    return [_repro_trips(x, fmt, guard) for x in payloads]


@pytest.mark.parametrize("fmt,guard_kw,scale", DEGRADED)
def test_degraded_psum_takes_the_uniform_rung(pool, fmt, guard_kw, scale):
    got = pool.run(D.degraded, _scaled(X, scale), fmt, guard_kw, 2)
    guard = JGuardPolicy(**guard_kw)
    clean = [g["clean"] for g in got]
    if np.ndim(scale):  # the ranks' own checks disagree at the first rung
        assert sum(_local_trips(clean, fmt, guard)) == 1
    i, name = _expected_rung(clean, fmt, guard)
    for r in range(P):
        c = got[r]["counters"]
        assert c["wire.rung"] == float(i) and c["wire.escalated"] == float(i > 0), (r, c, name)
        assert c[f"wire.rung.{name}"] == 1.0 and c["wire.calls"] == 1.0
        assert c["wire.specials_in"] == (6.0 if r == 2 else 0.0)
        assert c["wire.contained"] == 0.0
        assert _same(got[r]["out"], got[r]["rungs"][name])


@pytest.mark.parametrize("fmt,guard_kw,scales", [
    ("t8", {}, None), ("t8", {"max_rel_err": 0.01}, None), ("t8", {"max_rel_err": 1e-9}, None),
    ("e4m3", {}, ONE_TRIPS[0]), ("t8", {"max_rel_err": 0.1}, ONE_TRIPS[1])])
def test_guarded_ef_residual_tracks_the_rung_sent(pool, fmt, guard_kw, scales):
    got = pool.run(D.ef_steps, fmt, 2, (64, 27), GuardPolicy(**guard_kw), 1, scales)
    guard = JGuardPolicy(**guard_kw)
    prev = [np.zeros((64, 27), np.float32)] * P
    rungs_taken = []
    for s in range(2):
        g = D.ef_gradients(s, P, (64, 27), scales)
        if s == 0:
            g[1, 0, :3] = np.nan
        c = [np.where(np.isfinite(g[r] + prev[r]), g[r] + prev[r], 0).astype(np.float32)
             for r in range(P)]
        if scales is not None:  # one rank's own check trips the first rung
            assert sum(_local_trips(c, fmt, guard)) == 1
        i, name = _expected_rung(c, fmt, guard)
        rungs_taken.append(i)
        if name == "f32":
            want_err = [np.zeros_like(x) for x in c]
            total = np.sum(np.stack(c).astype(np.float64), axis=0)
            for r in range(P):
                assert np.abs(got[r][f"red{s}"] - total).max() <= 1e-5
        else:
            enc, dec = JC.wire_codec(name)
            q = [np.asarray(dec(enc(jnp.asarray(x)))) for x in c]
            want_err = [x - qq for x, qq in zip(c, q)]
            acc = np.zeros_like(q[0])
            for qq in q:  # source order, from zero, in f32
                acc = acc + qq
            for r in range(P):
                assert _same(got[r][f"red{s}"], acc), (s, r, name)
        for r in range(P):
            assert _same(got[r][f"err{s}"], want_err[r]), (s, r, name)
            assert _same(got[r][f"red{s}"], got[0][f"red{s}"])
        prev = want_err
    for r in range(P):
        ctr = got[r]["counters"]
        assert ctr["ef.calls"] == 2.0 and ctr["ef.rung"] == float(sum(rungs_taken))
        assert ctr["ef.escalated"] == float(sum(i > 0 for i in rungs_taken))
        assert ctr["ef.specials_in"] == (3.0 if r == 1 else 0.0)


# ---------------------------------------------------------------------------
# hop faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16, np.float32))
def test_corrupt_hop_rebuilds_repros_hits(dtype):
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 1 << 16, (40, 24)).astype(np.uint32).astype(dtype) \
        if dtype != np.float32 else rng.standard_normal((40, 24)).astype(np.float32)
    tmsg = torch.from_numpy(msg.view(np.int16)).view(torch.uint16) if dtype == np.uint16 \
        else torch.from_numpy(msg)
    words = {1: np.uint8, 2: np.uint16, 4: np.uint32}[msg.itemsize]
    for kw, drop in (({"hop_garble_rate": 1.0}, False), ({"hop_garble_rate": 1.0,
                                                         "bit_flip_rate": 0.02}, False),
                     ({"hop_drop_rate": 1.0}, True)):
        with jfaults.inject(jfaults.FaultConfig(seed=4, **kw)):
            want = np.asarray(jfaults.corrupt_hop(jnp.asarray(msg)))
        pattern = want.view(words) ^ msg.view(words)
        got = faults.apply_hop(tmsg, drop, None if drop else torch.from_numpy(
            pattern.astype(np.int64)))
        got = got.view(torch.int16).numpy().view(np.uint16) if dtype == np.uint16 else got.numpy()
        assert np.array_equal(got.view(words), want.view(words))
        if not drop:  # one bit a hit word
            hits = pattern[pattern != 0]
            assert hits.size and np.all((hits & (hits - 1)) == 0)


def test_port_hop_draws_flip_one_bit_a_hit_and_replay():
    msg = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 4096).astype(np.uint8))
    assert faults.corrupt_hop(msg) is msg  # outside inject: untouched
    outs = []
    for seed in (5, 5, 6):
        with faults.inject(faults.FaultConfig(seed=seed, hop_garble_rate=1.0)):
            outs.append(faults.corrupt_hop(msg))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    x = (outs[0] ^ msg).numpy()
    assert np.all((x & (x - 1)) == 0) and 0.02 < np.mean(x != 0) < 0.08  # 0.05 a word
    with faults.inject(faults.FaultConfig(seed=5, hop_drop_rate=1.0)):
        assert not faults.corrupt_hop(msg).any()


def test_guarded_ring_contains_what_the_hops_garbled(pool):
    got = pool.run(D.hop_faults, X, "t16", dict(seed=2, hop_garble_rate=0.6, hop_drop_rate=0.2),
                   dict(contain_abs=8.0))
    for r in range(P):
        ctr = got[r]["counters"]
        assert ctr["wire.rung"] == 0.0  # the payload faults are off: t16 is healthy
        bad = 0
        for msg in got[r]["got"]:
            d = np.asarray(jax.jit(JC.wire_codec("t16")[1])(jnp.asarray(msg)))
            bad += int(np.sum(~np.isfinite(d) | (np.abs(d) > 8.0)))
        assert len(got[r]["got"]) == P - 1
        assert ctr["wire.contained"] == float(bad)
        assert np.all(np.isfinite(got[r]["out"]))
    assert sum(g["counters"]["wire.contained"] for g in got) > 0
