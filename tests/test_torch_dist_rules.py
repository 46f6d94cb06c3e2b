"""The port's meshes, sharding rules, traffic model and wire codec
(``repro_torch.launch.mesh``, ``dist.sharding``, ``dist.step``'s spec
builders, ``dist.collectives.wire_codec`` / ``wire_bytes_per_element``)
against ``repro``, with no ranks: the specs come from process-less meshes
on both sides (``jax.sharding.AbstractMesh``, ``mesh.Mesh`` without ranks).

* ``parse_mesh`` / ``parse_dims``, ``data_axes`` and ``batch_dim_axes`` as
  ``repro``'s; a mesh larger than the world raises.
* ``param_specs``, ``train_state_specs`` (bf16 / takum policies: f32 and
  t16 QTensor moments), ``batch_specs`` (train / prefill / decode, batches
  that divide every, some and no data axes) and ``cache_specs``, leaf by
  leaf, for every arch's smoke config (hymba's 32001 vocab among them) on
  1x1, 2x4, 2x2x2 and 4x1x2.  A spec is the tuple of ``repro``'s
  ``PartitionSpec``.
* ``shard_params``' slices cover every element of a leaf once over a
  mesh's coordinates.
* ``wire_bytes_per_element`` for every format and P = 1..8.
* ``wire_codec`` bit for bit against ``repro``'s: decode over every code,
  encode over an f32 sweep with specials, and the stochastic-rounding
  encodes of t8, t16, e4m3 and e5m2 fed ``repro``'s draws.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as jconfigs
from repro.dist import collectives as JC
from repro.dist import sharding as JS
from repro.dist import step as jstep
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.quant.policy import POLICIES as JPOLICIES
from repro_torch import configs, tree
from repro_torch.core.formats import WIRE_FORMATS
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S
from repro_torch.dist import spawn
from repro_torch.dist import step as dstep
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES

MESHES = ((1, 1), (2, 4), (2, 2, 2), (4, 1, 2))
ARCHS = configs.ARCHS


def _meshes(dims):
    names = M.AXES_2D if len(dims) == 2 else M.AXES_3D
    return AbstractMesh(dims, names), M.Mesh(dims, names)


def _t(spec):
    """A PartitionSpec as the port's tuple."""
    return tuple(spec)


def _leaves(specs):
    return [_t(s) for s in jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, PartitionSpec))]


_SHAPES: dict = {}


def _cached(fn, *key):
    """``fn()`` once per key: ``repro``'s shape trees trace the model's
    init once per config, not once per mesh."""
    if key not in _SHAPES:
        _SHAPES[key] = fn()
    return _SHAPES[key]


@pytest.fixture(autouse=True)
def _repro_state_shapes_once(monkeypatch):
    real = jstep.state_shapes
    monkeypatch.setattr(jstep, "state_shapes", lambda cfg, **kw: _cached(
        lambda: real(cfg, **kw), "state", cfg.name, cfg.quant.opt_state))


# ---------------------------------------------------------------------------
# meshes and axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ("1x1", "2x4", "2x2x2", "4x1x2", "16x16", "2x16x16"))
def test_parse_dims_as_repro(spec):
    dims, names = M.parse_dims(spec)
    assert dims == tuple(int(d) for d in spec.split("x"))
    assert names == (("data", "model") if len(dims) == 2 else ("pod", "data", "model"))
    if spec == "1x1":  # repro's needs as many devices as the mesh: one here
        jm = jmesh.parse_mesh(spec)
        assert tuple(jm.axis_names) == names and tuple(jm.shape.values()) == dims
        m = M.parse_mesh(spec)
        assert m.device_mesh is None and m.size == 1 and m.group("data") is None
    else:
        with pytest.raises(ValueError, match=f"needs {np.prod(dims)} ranks, the world has 1"):
            M.parse_mesh(spec)


@pytest.mark.parametrize("spec", ("2", "2x2x2x2", "axb", ""))
def test_parse_mesh_refuses_what_repro_refuses(spec):
    with pytest.raises(ValueError, match="DxM or PxDxM"):
        M.parse_dims(spec)


def test_production_and_test_meshes_need_their_worlds():
    for fn, kw, n in ((M.make_production_mesh, {}, 256),
                      (M.make_production_mesh, {"multi_pod": True}, 512),
                      (M.make_test_mesh, {}, 8), (M.make_test_mesh, {"multi_pod": True}, 8)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            fn(**kw)


def test_a_rank_without_cuda_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn.rank_device()
    assert spawn.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("batch", (None, 1, 2, 3, 4, 8, 12))
def test_data_and_batch_axes_as_repro(dims, batch):
    jm, m = _meshes(dims)
    assert S.data_axes(m) == JS.data_axes(jm) == M.data_axes(m)
    assert S.batch_dim_axes(m, batch) == JS.batch_dim_axes(jm, batch)
    assert S._model(m) == JS._model(jm)


# ---------------------------------------------------------------------------
# the rule table, leaf by leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_repro(arch, dims):
    jm, m = _meshes(dims)
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jshapes = _cached(lambda: jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))),
                      "params", arch)
    want = _leaves(JS.param_specs(jcfg, jshapes, jm))
    got = S.param_specs(cfg, dstep.param_shapes(cfg), m)
    assert got == want
    assert [tuple(a.shape) for a in jax.tree.leaves(jshapes)] == \
        [tuple(a.shape) for a in tree.flatten(dstep.param_shapes(cfg))[0]]


@pytest.mark.parametrize("policy", ("bf16", "takum"))
@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_repro(arch, dims, policy):
    jm, m = _meshes(dims)
    jcfg = jconfigs.get_smoke(arch).with_(quant=JPOLICIES[policy])
    cfg = configs.get_smoke(arch).with_(quant=POLICIES[policy])
    want = _leaves(jstep.train_state_specs(jcfg, jm))
    assert dstep.train_state_specs(cfg, m) == want
    assert dstep.train_state_specs_nopod(cfg, m) == want
    assert not any("pod" in str(s) for s in want)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ("llama3_8b", "llama3_2_vision_90b"))
def test_batch_specs_match_repro(arch, dims):
    jm, m = _meshes(dims)
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    for kind, batch in itertools.product(("train", "prefill", "decode"), (None, 1, 2, 4, 6, 8)):
        want = {k: _t(v) for k, v in JS.batch_specs(jcfg, jm, kind=kind, batch=batch).items()}
        assert S.batch_specs(cfg, m, kind=kind, batch=batch) == want
    with pytest.raises(ValueError, match="unknown batch kind"):
        S.batch_specs(cfg, m, kind="serve")


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_repro(arch, dims):
    jm, m = _meshes(dims)
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    for B, Sq in ((4, 16), (3, 8)):
        jc = jax.eval_shape(lambda: JT.init_cache(jcfg, B, Sq))
        want = JS.cache_specs(jcfg, jc, jm)
        got = S.cache_specs(cfg, T.init_cache(cfg, B, Sq, device="meta"), m)
        for f in ("k", "v", "pos", "conv", "ssm"):
            assert getattr(got, f) == _t(getattr(want, f)), (f, getattr(got, f))


class _Coords:
    """A mesh shape at one coordinate (what ``local_slice`` reads)."""

    def __init__(self, mesh, coord):
        self.shape, self.axis_names, self.coord = mesh.shape, mesh.axis_names, coord

    def index(self, name):
        return self.coord[self.axis_names.index(name)]


@pytest.mark.parametrize("dims", MESHES)
def test_shard_params_cover_each_element_once(dims):
    m = M.Mesh(dims, M.AXES_2D if len(dims) == 2 else M.AXES_3D)
    cfg = configs.get_smoke("llama3_8b")
    params = T.init_params(cfg, 0, device="cpu")
    leaves = tree.flatten(params)[0]
    marks = [torch.zeros(a.shape, dtype=torch.int32) for a in leaves]
    for coord in itertools.product(*(range(d) for d in dims)):
        view = _Coords(m, coord)
        for mark, spec in zip(marks, S.param_specs(cfg, params, m)):
            S.local_slice(mark, spec, view).add_(1)
        got = tree.flatten(S.shard_params(params, view, config=cfg))[0]
        assert all(g.numel() * int(np.prod(dims)) >= a.numel() for g, a in zip(got, leaves))
    n = int(np.prod(dims))
    for mark, spec in zip(marks, S.param_specs(cfg, params, m)):
        copies = n // int(np.prod([m.shape[a] for e in spec
                                   for a in ((e,) if isinstance(e, str) else (e or ()))]))
        assert torch.all(mark == copies)


# ---------------------------------------------------------------------------
# the traffic model and the wire codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", sorted(WIRE_FORMATS))
def test_wire_bytes_per_element_as_repro(fmt):
    for pods in range(1, 9):
        assert C.wire_bytes_per_element(fmt, pods) == JC.wire_bytes_per_element(fmt, pods)


CODEC_FMTS = ("t8", "t16", "e4m3", "e5m2", "bf16", "mxe4m3", "mxe5m2", "mxt8")


def _sweep():
    """f32 values over the whole range, with the specials and edges."""
    rng = np.random.default_rng(0)
    mags = np.exp2(rng.uniform(-140, 128, 4096)).astype(np.float32)
    x = mags * rng.choice([-1, 1], 4096).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40, 3.4e38, -3.4e38,
                        1.0, -1.0, 0.5, 448.0, 57344.0, 65504.0, 1e-30] * 2, np.float32)
    return np.concatenate([x, special, rng.standard_normal(4096 - 32).astype(np.float32)])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("fmt", CODEC_FMTS)
def test_wire_codec_matches_repro(fmt):
    jenc, jdec = (jax.jit(f) for f in JC.wire_codec(fmt))
    enc, dec = C.wire_codec(fmt)
    x = _sweep().reshape(-1, 32 if fmt.startswith("mx") else 64)
    want = _bits(jenc(jnp.asarray(x)))
    got = enc(torch.from_numpy(x))
    assert got.dtype.itemsize == want.dtype.itemsize
    got_np = got.view({1: torch.uint8, 2: torch.int16}[got.element_size()]).numpy()
    assert np.array_equal(got_np.view(want.dtype), want)
    # decode over every code (mx: every element code under a few scales)
    if fmt.startswith("mx"):
        codes = np.arange(256, dtype=np.uint8).reshape(8, 32)
        scales = np.array([127, 0, 1, 120, 130, 200, 254, 255], np.uint8)[:, None]
        payload = np.concatenate([scales, codes], axis=1)
    else:
        n = 16 if fmt in ("t16", "bf16") else 8
        payload = np.arange(1 << n, dtype=np.uint32).astype(np.uint16 if n == 16 else np.uint8)
    jp = jnp.asarray(payload)
    if fmt == "bf16":
        jp = jax.lax.bitcast_convert_type(jp, jnp.bfloat16)
    want = np.asarray(jdec(jp))
    tp = torch.from_numpy(payload.view(np.int16)).view(torch.uint16) if payload.dtype == np.uint16 \
        else torch.from_numpy(payload)
    got = dec(tp).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt", ("t8", "t16", "e4m3", "e5m2"))
def test_wire_codec_sr_matches_repro_on_its_draws(fmt):
    key = jax.random.PRNGKey(11)
    x = _sweep().reshape(64, -1)
    want = _bits(jax.jit(lambda v: JC.wire_codec(fmt, sr_key=key)[0](v))(jnp.asarray(x)))
    draws = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)).astype(np.int64)
    enc, _ = C.wire_codec(fmt, sr_key=torch.from_numpy(draws))
    got = enc(torch.from_numpy(x))
    got_np = got.view({1: torch.uint8, 2: torch.int16}[got.element_size()]).numpy()
    assert np.array_equal(got_np.view(want.dtype), want)
    # the port's own draws: a seed gives the same bits twice, another seed others
    a, b = (C.wire_codec(fmt, sr_key=s)[0](torch.from_numpy(x)) for s in (5, 5))
    c = C.wire_codec(fmt, sr_key=6)[0](torch.from_numpy(x))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_wire_codec_refuses_f32():
    for mod in (JC, C):
        with pytest.raises(ValueError, match="accumulate format"):
            mod.wire_codec("f32")
