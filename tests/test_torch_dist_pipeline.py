"""The port's pipeline (``repro_torch.dist.pipeline.pipeline_apply``) on 4
gloo ranks, one stage a rank, ``tanh(h @ w)`` stages at d = 16 (so the mx
hops pad to 32 and slice), M = 6 microbatches of 3 rows.

* f32 hops: bit for bit against ``repro``'s ``pipeline_apply`` on a
  4-device mesh (one short jax subprocess, bounded by ``REF_TIMEOUT_S``),
  with linear stages whose every sum is exact (``h @ w``, each column of
  ``w`` two entries of +-1/2, ``x`` on a 2^-8 grid), since XLA's and torch's
  tanh and dot differ in the last bits.
* coded hops (t16, t8, bf16, e4m3, e5m2, mxe4m3, mxe5m2, mxt8): bit for bit
  against the composition stage -> ``repro``'s wire codec -> stage, the
  stages run by torch as the ranks run them (never ``repro``'s coded
  pipeline, which takes minutes on 8 fake devices).
* guarded hops: the whole M + P - 1 tick wavefront simulated in the test
  (bubble ticks included, every stage's output health-checked with
  ``repro``'s expression, the trips OR'd over the stages, a tripped hop
  one rung wider): the per-tick decisions are the same on every rank and
  equal the simulation's, the output equals it bit for bit, and the
  ``pipe.*`` counters count the ticks, hops, escalations and bytes.
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

from repro.dist import collectives as JC
from repro.quant import blockscale as jblockscale
from repro.quant.policy import GuardPolicy as JGuardPolicy
from repro_torch.core.formats import wire_format
from repro_torch.dist.spawn import RankPool

sys.path.insert(0, os.path.dirname(__file__))
import _dist_cases as D  # noqa: E402
from test_torch_dist_ring import _repro_trips  # noqa: E402

P, M, MB, DIM = 4, 6, 3, 16
REF_TIMEOUT_S = 120
WS = (np.random.default_rng(0).standard_normal((P, DIM, DIM)) * 0.5).astype(np.float32)
X = np.random.default_rng(1).standard_normal((M, MB, DIM)).astype(np.float32)


def _exact_weights():
    """Per stage: columns of two +-1/2 entries, so ``h @ w`` is exact."""
    rng = np.random.default_rng(2)
    ws = np.zeros((P, DIM, DIM), np.float32)
    for p in range(P):
        a, b = rng.permutation(DIM), rng.permutation(DIM)
        b = np.where(a == b, (b + 1) % DIM, b)
        for j in range(DIM):
            ws[p, a[j], j] += 0.5
            ws[p, b[j], j] += 0.5 * rng.choice([-1, 1])
    return ws


WS_EXACT = _exact_weights()
X_EXACT = (np.random.default_rng(3).integers(-512, 512, (M, MB, DIM)) / 256).astype(np.float32)

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.dist.pipeline import pipeline_apply
ws, x = np.load(sys.argv[1])["ws"], np.load(sys.argv[1])["x"]
mesh = jax.make_mesh((4,), ("pipe",))
out = pipeline_apply(lambda w, h: h @ w, jnp.asarray(ws), jnp.asarray(x), mesh=mesh)
np.save(sys.argv[2], np.asarray(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_pipe")
    np.savez(d / "in.npz", ws=WS_EXACT, x=X_EXACT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(d / "in.npz"), str(d / "out.npy")],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def load():
        try:
            _, err = proc.communicate(timeout=REF_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            pytest.fail(f"the jax reference took more than {REF_TIMEOUT_S} s")
        assert proc.returncode == 0, err[-3000:]
        return np.load(d / "out.npy")

    yield load
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool():
    with RankPool(P, timeout_s=60) as p:
        yield p


def _same(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _stage(p, h):
    return D._stage(torch.from_numpy(WS[p]), torch.from_numpy(h)).numpy()


@functools.partial(jax.jit, static_argnums=1)
def _codec(v, name):
    enc, dec = JC.wire_codec(name)
    n = v.shape[-1]
    if wire_format(name).is_block_scaled:
        v = jblockscale.pad_block(v)
    return dec(enc(v))[..., :n].astype(jnp.float32)


def _hop(h, name):
    """One hop through ``repro``'s wire codec (the mx padding and slice as
    ``repro``'s ``_hop_codec`` folds them in); f32 exact."""
    return h if name == "f32" else np.asarray(_codec(jnp.asarray(h), name))


def test_f32_hops_bit_for_bit_against_repro(pool, ref):
    got = pool.run(D.pipeline, WS_EXACT, X_EXACT, linear=True)
    want = ref()
    seq = X_EXACT
    for p in range(P):  # the sequential composition, exact in float64 too
        seq = seq.astype(np.float64) @ WS_EXACT[p]
    assert np.array_equal(want, seq.astype(np.float32))
    for r in range(P):
        assert _same(got[r]["out"], want), np.abs(got[r]["out"] - want).max()
        assert got[r]["counters"] == {"pipe.ticks": float(M + P - 1),
                                      "pipe.hop_bytes": float((M + P - 1) * MB * DIM * 4)}


CODED = ("t16", "t8", "bf16", "e4m3", "e5m2", "mxe4m3", "mxe5m2", "mxt8")


@pytest.mark.parametrize("fmt", CODED)
def test_coded_hops_are_the_codec_composition(pool, fmt):
    got = pool.run(D.pipeline, WS, X, fmt)
    want = np.empty_like(X)
    for m in range(M):
        h = X[m]
        for p in range(P):
            h = _stage(p, h)
            if p < P - 1:
                h = _hop(h, fmt)
        want[m] = h
    wf = wire_format(fmt)
    per_hop = MB * (33 if wf.is_block_scaled else DIM * wf.storage.itemsize)
    for r in range(P):
        assert _same(got[r]["out"], want), (fmt, r, np.abs(got[r]["out"] - want).max())
        assert got[r]["counters"] == {"pipe.ticks": float(M + P - 1),
                                      "pipe.hop_bytes": float((M + P - 1) * per_hop)}


def _simulate(fmt, guard):
    """The guarded wavefront, tick by tick: (output, per-tick trips)."""
    rungs = guard.ladder_from(fmt)
    esc = rungs[1] if len(rungs) > 1 else fmt
    recv = [np.zeros((MB, DIM), np.float32) for _ in range(P)]
    out = np.zeros_like(X)
    trips = []
    for t in range(M + P - 1):
        outs = [_stage(p, X[min(t, M - 1)] if p == 0 else recv[p]) for p in range(P)]
        if 0 <= t - (P - 1) < M:
            out[t - (P - 1)] = outs[-1]
        trip = any(_repro_trips(o, fmt, guard) for o in outs)
        trips.append(trip)
        for p in range(1, P):
            recv[p] = _hop(outs[p - 1], esc if trip else fmt)
    return out, trips


GUARDED = [("t8", {}), ("t8", {"max_rel_err": 0.02}), ("t8", {"max_rel_err": 1e-9}),
           ("e5m2", {"max_rel_err": 0.05}), ("mxt8", {"max_rel_err": 0.02}),
           ("bf16", {"max_rel_err": 1e-9}), ("e4m3", {"max_special_frac": 0.0})]


@pytest.mark.parametrize("fmt,guard_kw", GUARDED)
def test_guarded_hops_escalate_uniformly(pool, fmt, guard_kw):
    got = pool.run(D.pipeline, WS, X, fmt, guard_kw)
    want, trips = _simulate(fmt, JGuardPolicy(**guard_kw))
    wf = wire_format(fmt)
    per_hop = MB * (33 if wf.is_block_scaled else DIM * wf.storage.itemsize)
    ticks = M + P - 1
    for r in range(P):
        assert got[r]["trips"] == trips, (r, got[r]["trips"], trips)
        assert _same(got[r]["out"], want), (fmt, r, np.abs(got[r]["out"] - want).max())
        c = got[r]["counters"]
        assert c["pipe.ticks"] == c["pipe.hops"] == float(ticks)
        assert c["pipe.escalated"] == float(sum(trips))
        assert c["pipe.hop_bytes"] == float(ticks * per_hop)
        assert c.get("pipe.contained", 0.0) == 0.0


def test_a_lone_stage_is_the_stage(pool):
    # one rank: no hop, the stage applied to every microbatch
    from repro_torch.dist.pipeline import pipeline_apply

    out = pipeline_apply(D._stage, torch.from_numpy(WS[0]), torch.from_numpy(X))
    assert _same(out.numpy(), np.stack([_stage(0, X[m]) for m in range(M)]))
