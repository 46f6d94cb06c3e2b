"""Checkpoints, the train loop and the launcher of the port, against ``repro``.

* A checkpoint written by ``repro.train.CheckpointManager`` restores in the
  port and one written by the port restores in ``repro``, at fmt f32 and
  t16, with equal stored bytes and CRC32s in both directions; so does a
  whole ``TrainState`` (t16 moments, the rng), whose leaf order is jax's.
* The refusals of ``tests/test_train.py`` (corrupted bytes, an
  unregistered format, a leaf-count mismatch, a missing meta key, a future
  schema, an unreadable meta, a missing step) raise the same errors with
  the same messages; a schema-1 checkpoint restores without CRCs; a save
  leaves no ``.tmp`` directory; old steps are collected.
* The numpy oracles the manager packs with (``WireFormat.encode_np`` /
  ``decode_np``, every registered format) equal ``repro``'s (``ml_dtypes``
  for bf16 and OFP8) on an f32 sweep with specials, bit for bit.
* ``TrainLoop``: a crash at step 7, a restart, and the final state equals
  an unbroken run bit for bit (the port's ``test_trainloop_resume_bitexact``);
  the same through ``launch.train`` under bf16 (whose checkpoint format is
  f32), and through ``TrainLoop`` over ``make_train_step`` under takum with
  an f32 checkpoint (the SR draws seeded from the restored rng).
* ``launch.train``'s ``main`` (``python -m repro_torch.launch.train``) at
  ``--smoke --steps 20 --device cpu`` (batch 4, sequence 32): the CE falls;
  a mesh larger than the world (8 ranks in one process) raises; ``lm_100m``
  (tied embeddings) builds.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core.formats import wire_format as jwire_format
from repro.dist import step as dstep
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.quant.policy import POLICIES as JPOLICIES
from repro.quant.qtensor import QTensor as JQTensor
from repro.train import CheckpointManager as JCheckpointManager
from repro_torch import configs, convert, tree
from repro_torch.core.formats import WIRE_FORMATS
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.quant.policy import POLICIES
from repro_torch.train import CheckpointManager, TrainLoop, TrainLoopConfig, reassign_shards
from repro_torch.train.checkpoint import CheckpointCorruptionError, CheckpointFormatError
from repro_torch.train.step import init_state, make_train_step


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32), "step": np.int32(7),
            "nested": {"b": np.ones((3,), np.float32), "s": np.float32(0.25)}}


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in t.items()}


def _stored(d, step):
    """(meta, {name: stored array}) of a checkpoint directory."""
    sd = os.path.join(str(d), f"step_{step:09d}")
    with open(os.path.join(sd, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(sd, "arrays.npz")) as z:
        return meta, {k: z[k] for k in z.files}


@pytest.mark.parametrize("fmt", ["f32", "t16"])
def test_checkpoints_cross_between_the_packages(tmp_path, fmt):
    host = _tree()
    JCheckpointManager(str(tmp_path / "j"), fmt=fmt).save(3, jax.tree.map(jnp.asarray, host),
                                                           blocking=True)
    CheckpointManager(str(tmp_path / "t"), fmt=fmt).save(3, _torch_tree(host), blocking=True)
    jmeta, jarr = _stored(tmp_path / "j", 3)
    tmeta, tarr = _stored(tmp_path / "t", 3)
    assert jmeta == tmeta  # schema, format, dtypes, CRC32s, stored shapes
    assert jarr.keys() == tarr.keys()
    for k in jarr:
        assert jarr[k].dtype == tarr[k].dtype and np.array_equal(jarr[k], tarr[k])
    # each restores the other's
    back = CheckpointManager(str(tmp_path / "j")).restore(3, _torch_tree(host))
    jback = JCheckpointManager(str(tmp_path / "t")).restore(3, jax.tree.map(jnp.asarray, host))
    for got, want in zip(tree.flatten(back)[0], jax.tree.leaves(jback)):
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
        assert np.array_equal(got.numpy(), np.asarray(want))
    if fmt == "f32":
        assert np.array_equal(back["w"].numpy(), host["w"])
    else:
        np.testing.assert_allclose(back["w"].numpy(), host["w"], rtol=2e-3)
    assert back["step"].item() == 7 and back["step"].dtype == torch.int32


def _jstate():
    cfg = jconfigs.get_smoke("llama3_8b").with_(quant=JPOLICIES["takum"])
    params = jax.jit(lambda key: JT.init_params(cfg, key))(jax.random.PRNGKey(0))
    opt = jax.jit(lambda p: jadamw_init(p, fmt="t16"))(params)  # one compile, not one per op
    return dstep.TrainState(params, opt, jax.random.PRNGKey(1))


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, JQTensor):
        return {"bits": np.asarray(t.bits), "fmt": t.fmt,
                "scale": None if t.scale is None else np.asarray(t.scale)}
    return np.asarray(t)


def test_train_state_checkpoint_crosses(tmp_path):
    """repro's TrainState (t16 moments) saved by repro restores into the
    port's state leaf for leaf, and the port's save of it equals repro's."""
    js = _jstate()
    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum"])
    ts = convert.train_state_from_numpy(
        {"params": _np(js.params), "rng": np.asarray(js.rng),
         "opt": {"step": np.asarray(js.opt.step), "m": _np(js.opt.m), "v": _np(js.opt.v)}},
        cfg, device="cpu")
    JCheckpointManager(str(tmp_path / "j"), fmt="t16").save(1, js, blocking=True)
    CheckpointManager(str(tmp_path / "t"), fmt="t16").save(1, ts, blocking=True)
    jmeta, jarr = _stored(tmp_path / "j", 1)
    tmeta, tarr = _stored(tmp_path / "t", 1)
    assert jmeta == tmeta and all(np.array_equal(jarr[k], tarr[k]) for k in jarr)
    back = CheckpointManager(str(tmp_path / "j"), fmt="t16").restore(1, ts)
    want = JCheckpointManager(str(tmp_path / "j"), fmt="t16").restore(1, js)
    got_leaves, jleaves = tree.flatten(back)[0], jax.tree.leaves(want)
    assert len(got_leaves) == len(jleaves) == len(jmeta["leaves"])
    for got, w in zip(got_leaves, jleaves):
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16)
                              if got.dtype == torch.uint16 else got.numpy(), np.asarray(w))
    assert back.rng.dtype == torch.uint32 and back.opt.m["embed"].fmt == "t16"


#: every format the port registers; ``repro`` also registers t32, which the
#: port does not (ROADMAP M1)
CKPT_FORMATS = ("f32", "bf16", "t8", "t16", "e4m3", "e5m2", "mxe4m3", "mxe5m2", "mxt8")


def test_every_registered_format_has_numpy_oracles():
    assert set(WIRE_FORMATS) == set(CKPT_FORMATS)
    assert all(wf.encode_np and wf.decode_np for wf in WIRE_FORMATS.values())


@pytest.mark.parametrize("name", CKPT_FORMATS)
def test_numpy_oracles_match_repro(name):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 2.0 ** rng.integers(-140, 130, 20000)) \
        .astype(np.float32).astype(np.float64)
    x[:12] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-45, 3.4e38, 448.0,
              464.0, 68813.0]
    x[64:96] = 0.0  # an all-zero block
    wf, jwf = WIRE_FORMATS[name], jwire_format(name)
    got, want = wf.encode_np(x), jwf.encode_np(x)
    assert np.array_equal(got.astype(np.uint64), want.astype(np.uint64))
    stored = want.astype(jwf.np_storage)
    raw = stored.astype(np.uint64) if jwf.family == "takum" else stored
    assert np.array_equal(wf.decode_np(stored), jwf.decode_np(raw), equal_nan=True)


# ---------------------------------------------------------------------------
# the refusals of tests/test_train.py, for the port
# ---------------------------------------------------------------------------


def _saved(tmp_path, fmt="t16"):
    mgr = CheckpointManager(str(tmp_path), fmt=fmt, keep=3)
    t = {"w": torch.from_numpy(np.random.default_rng(1).standard_normal((16, 16))
                               .astype(np.float32)), "b": torch.ones(5)}
    mgr.save(11, t, blocking=True)
    d = os.path.join(str(tmp_path), "step_000000011")
    meta_path = os.path.join(d, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    return mgr, t, d, meta_path, meta


def _rewrite(meta_path, meta):
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def test_corrupted_bytes_refused(tmp_path):
    mgr, t, d, _, _ = _saved(tmp_path)
    npz = os.path.join(d, "arrays.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    with open(npz, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(CheckpointCorruptionError, match="CRC|unreadable"):
        mgr.restore(11, t)


def test_format_refusals(tmp_path):
    mgr, t, d, meta_path, meta = _saved(tmp_path)
    with pytest.raises(CheckpointFormatError, match="2 leaves.*expects 3"):
        mgr.restore(11, {**t, "extra": torch.zeros(2)})
    _rewrite(meta_path, dict(meta, fmt="posit16"))
    with pytest.raises(CheckpointFormatError, match="posit16"):
        mgr.restore(11, t)
    _rewrite(meta_path, dict(meta, schema=99))
    with pytest.raises(CheckpointFormatError, match="schema 99"):
        mgr.restore(11, t)
    _rewrite(meta_path, {k: v for k, v in meta.items() if k != "fmt"})
    with pytest.raises(CheckpointFormatError, match="'fmt'"):
        mgr.restore(11, t)
    _rewrite(meta_path, dict(meta, leaves=[dict(meta["leaves"][0], wire="posit8"),
                                           meta["leaves"][1]]))
    with pytest.raises(CheckpointFormatError, match="posit8"):
        mgr.restore(11, t)


def test_unreadable_meta_refused(tmp_path):
    mgr, t, d, meta_path, _ = _saved(tmp_path)
    with open(meta_path, "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptionError, match="meta.json"):
        mgr.restore(11, t)
    with pytest.raises(CheckpointCorruptionError, match="no checkpoint"):
        mgr.restore(404, t)


def test_schema1_restores_without_crcs_and_no_tmp_left(tmp_path):
    mgr, t, d, meta_path, meta = _saved(tmp_path)
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".tmp")]
    assert mgr.latest_step() == 11 and os.path.isdir(d)
    meta.pop("schema")
    for leaf in meta["leaves"]:
        for k in ("crc", "stored_dtype", "stored_shape"):
            leaf.pop(k)
    _rewrite(meta_path, meta)
    back = mgr.restore(11, t)
    np.testing.assert_allclose(back["w"].numpy(), t["w"].numpy(), rtol=2e-3)


def test_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.ones(4)})
    mgr.wait()
    assert sorted(mgr.all_steps()) == [3, 4] and mgr.latest_step() == 4


# ---------------------------------------------------------------------------
# the loop and the launcher
# ---------------------------------------------------------------------------


def test_trainloop_resume_bitexact(tmp_path):
    """Crash at step 7, restart, and the final state equals an uninterrupted
    run (deterministic data and checkpointed state)."""

    def make_loop(d, fail_at=None):
        pipe = SyntheticLM(vocab_size=64, seq_len=8, global_batch=4, seed=3)

        def step_fn(state, batch):
            counts = torch.bincount(batch["tokens"].reshape(-1).long(), minlength=64)
            return ({"w": state["w"] + counts.float(), "n": state["n"] + 1},
                    {"sum": counts.sum()})

        def failure_hook(step):
            if step == fail_at:
                raise RuntimeError("injected failure")

        cfg = TrainLoopConfig(total_steps=12, ckpt_every=5, ckpt_dir=str(d), log_every=100)
        return TrainLoop(cfg, step_fn, pipe.batch,
                         lambda: {"w": torch.zeros(64), "n": torch.tensor(0, dtype=torch.int32)},
                         failure_hook)

    ref = make_loop(tmp_path / "a").run()
    with pytest.raises(RuntimeError, match="injected"):
        make_loop(tmp_path / "b", fail_at=7).run()
    resumed = make_loop(tmp_path / "b").run()
    assert torch.equal(ref["w"], resumed["w"]) and resumed["n"].item() == 12


def _crash_at_7(step):
    if step == 7:
        raise RuntimeError("injected failure")


def _same_states(ref, resumed, n_leaves):
    a, b = tree.flatten(ref)[0], tree.flatten(resumed)[0]
    assert len(a) == len(b) == n_leaves
    assert all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(a, b))


def test_launcher_restart_equals_an_unbroken_run(tmp_path):
    """Under bf16 the launcher checkpoints in f32, so a restart is exact."""
    args = ["--smoke", "--steps", "9", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "4", "--policy", "bf16"]
    ref, _ = launch.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="injected"):
        launch.main(args + ["--ckpt-dir", str(tmp_path / "b")], failure_hook=_crash_at_7)
    resumed, _ = launch.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    _same_states(ref, resumed, 38)  # 12 params, step, 12 + 12 f32 moments, rng


def test_takum_loop_restart_redraws_what_an_unbroken_run_draws(tmp_path):
    """``TrainLoop`` over the takum step with an f32 checkpoint: the restored
    rng seeds the SR draws an unbroken run takes, so the t16 moment codes
    and the params come back bit for bit."""
    cfg = configs.get_smoke("llama3_8b").with_(quant=POLICIES["takum"])
    pipe = SyntheticLM(cfg.vocab_size, 16, 2, seed=17)

    def run(d, hook=None):
        return TrainLoop(TrainLoopConfig(total_steps=9, ckpt_every=4, ckpt_dir=str(d),
                                         ckpt_fmt="f32", log_every=100),
                         make_train_step(cfg), pipe.batch,
                         lambda: init_state(cfg, 0, device="cpu"), hook).run()

    ref = run(tmp_path / "a")
    with pytest.raises(RuntimeError, match="injected"):
        run(tmp_path / "b", _crash_at_7)
    _same_states(ref, run(tmp_path / "b"), 62)  # the moments as (bits, scale)


def test_launcher_ce_falls(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    launch.main(["--arch", "llama3_8b", "--smoke", "--steps", "20", "--batch", "4", "--seq",
                 "32", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                 "--metrics-out", str(out)])
    hist = json.loads(out.read_text())
    assert [m["step"] for m in hist] == [10, 20]
    assert hist[-1]["ce"] < hist[0]["ce"] and "(improved)" in capsys.readouterr().out


def test_launcher_refuses_what_is_not_ported():
    # lm_100m ties its embeddings, which the port now serves and trains
    cfg, _ = launch.build("lm_100m", smoke=False, policy="takum", seq=8, batch=1)
    assert cfg.name == "lm-100m" and cfg.tie_embeddings
    with pytest.raises(ValueError, match="mesh .* needs 8 ranks, the world has 1"):
        launch.main(["--smoke", "--mesh", "2x4", "--device", "cpu"])


def test_reassign_shards():
    owners = reassign_shards(8, healthy=[0, 2, 3, 5, 6, 7])
    assert sorted(s for ss in owners.values() for s in ss) == list(range(8))
    assert all(h in ss for h, ss in owners.items())
    assert reassign_shards(4, healthy=[2]) == {2: [2, 0, 1, 3]}
