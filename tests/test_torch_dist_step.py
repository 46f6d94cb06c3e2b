"""The port's train and serve steps over a mesh of gloo ranks
(``repro_torch.dist.step``, ``launch.train --mesh``, ``dist.spawn``), held
to the port's own single-device steps (``repro``'s sharded-step test fails
on this jax, ROADMAP R4; its pod step is held in
``test_torch_dist_ring.py``).  One 4-rank pool for the module.

* the pod step on (2, 2, 1) under t16 (SR), t8 (SR), bf16, e4m3 and
  mxe5m2 ``grad_comm``: every rank's params the same bits after two steps
  on one batch, the CE falling;
* at f32 ``grad_comm`` (f32 activations and moments) the step on (2, 2, 1),
  on a pod-only (4, 1, 1), a data-only (1, 4, 1) and a replicated model
  axis (2, 1, 2) equals the single-device step on the whole batch within
  5e-5 on every param (only the order of the gradient sums differs);
* under ``takum_guarded`` a rank whose gradients are poisoned makes every
  rank skip (``grad_ok`` 0.75, ``step.skipped`` 1, params held), and a
  batch the pod axis does not divide raises before the backward;
* the prefill and 8 decode steps over a (2, 2) data x model mesh: each
  rank's logits rows equal the single-process run's rows within 1e-5 of
  the rows' largest logit (a matmul over 2 rows or 4 may add in another
  order);
* ``launch.train --mesh 2x1x1`` under ``torchrun`` (2 CPU ranks, 20 steps
  of batch 8, sequence 64, learning rate 1e-2): the CE falls from step 10 to 20, each rank
  checkpoints apart; a mesh of another size than the world raises on every
  rank;
* the spawner: a rank that raises fails the call with its traceback, a
  rank that blocks fails it at the deadline.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, serve, tree
from repro_torch.dist.spawn import RankError, RankPool
from repro_torch.models import transformer as T
from repro_torch.quant.policy import POLICIES, QuantPolicy
from repro_torch.train.step import init_state, make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import _dist_cases as D  # noqa: E402

P = 4
POD = ((2, 2, 1), ("pod", "data", "model"))
TOKENS = np.random.default_rng(5).integers(0, 256, (4, 32)).astype(np.int64)
F32 = dict(activations="f32")
POD_POLICIES = {
    "t16": dict(weights="t16", grad_comm="t16", opt_state="t16", activations="f32"),
    "t8": dict(weights="t8", grad_comm="t8", opt_state="t8", activations="f32"),
    "bf16": dict(grad_comm="bf16"),
    "e4m3": dict(grad_comm="e4m3", activations="f32"),
    "mxe5m2": dict(grad_comm="mxe5m2", kv_cache="mxe4m3"),
}


@pytest.fixture(scope="module")
def pool():
    with RankPool(P, timeout_s=60) as p:
        yield p


def _same_bits(a, b) -> bool:
    return np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("grad_comm", list(POD_POLICIES))
def test_pod_ranks_stay_bit_identical(pool, grad_comm):
    got = pool.run(D.train_steps, *POD, POD_POLICIES[grad_comm], TOKENS, 2)
    for r in range(1, P):
        assert all(_same_bits(a, b) for a, b in zip(got[r]["params"], got[0]["params"]))
        assert got[r]["ce"] == got[0]["ce"]
    assert got[0]["ce"][1] < got[0]["ce"][0]
    assert got[0]["opt_step"] == 2 and got[0]["ok"] == [1.0, 1.0]


@pytest.fixture(scope="module")
def single_f32():
    """The port's single-device step on the whole batch, from the same init."""
    cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**F32))
    st, m = make_train_step(cfg)(init_state(cfg, 0, device="cpu"),
                                 {"tokens": torch.from_numpy(TOKENS)})
    return [p.numpy() for p in tree.flatten(st.params)[0]], float(m["ce"])


@pytest.mark.parametrize("dims", ((2, 2, 1), (4, 1, 1), (1, 4, 1), (2, 1, 2)))
def test_f32_mesh_step_agrees_with_single_device(pool, single_f32, dims):
    got = pool.run(D.train_steps, dims, POD[1], F32, TOKENS, 1)
    want, ce = single_f32
    worst = max(float(np.abs(a - b).max()) for a, b in zip(got[0]["params"], want))
    assert worst <= 5e-5, worst
    assert abs(got[0]["ce"][0] - ce) <= 1e-5 * abs(ce)
    for r in range(1, P):
        assert all(_same_bits(a, b) for a, b in zip(got[r]["params"], got[0]["params"]))


@pytest.mark.parametrize("poison_rank", (None, 0, 3))
def test_guarded_skip_is_uniform(pool, poison_rank):
    policy = {k: getattr(POLICIES["takum_guarded"], k)
              for k in ("weights", "kv_cache", "grad_comm", "opt_state", "checkpoint",
                        "pipe_act", "guard")}
    got = pool.run(D.train_steps, *POD, dict(policy, activations="f32"), TOKENS, 1,
                   poison_rank=poison_rank)
    init = [p.numpy() for p in tree.flatten(init_state(configs.get_smoke("llama3_8b"), 0,
                                                       device="cpu").params)[0]]
    for r in range(P):
        if poison_rank is None:
            assert got[r]["ok"] == [1.0] and got[r]["skipped"] == 0.0 and got[r]["opt_step"] == 1
        else:
            assert got[r]["ok"] == [0.75] and got[r]["skipped"] == 1.0 and got[r]["opt_step"] == 0
            assert all(_same_bits(a, b) for a, b in zip(got[r]["params"], init))
        assert all(_same_bits(a, b) for a, b in zip(got[r]["params"], got[0]["params"]))


def test_a_batch_the_pods_do_not_divide_raises(pool):
    for msg in pool.run(D.pod_batch_refused, 3):
        assert "must divide by the pod axis" in msg


@pytest.mark.parametrize("policy", ("takum", "takum8", "mxfp8"))
def test_serve_rows_over_data_ranks(pool, policy):
    kw = {k: getattr(POLICIES[policy], k) for k in ("weights", "kv_cache")}
    kw["activations"] = "f32"
    steps = 8
    got = pool.run(D.serve_rows, (2, 2), ("data", "model"), kw, TOKENS, steps)
    cfg = configs.get_smoke("llama3_8b").with_(quant=QuantPolicy(**kw))
    qp = serve.load_params(serve.quantize_params(cfg, T.init_params(cfg, 0, device="cpu")))
    logits, cache = serve.make_prefill_step(cfg, TOKENS.shape[1] + steps)(
        qp, {"tokens": torch.from_numpy(TOKENS)})
    want = [logits]
    tok = torch.from_numpy(TOKENS[:, -1])
    for s in range(steps):
        logits, cache = serve.make_serve_step(cfg)(qp, {"token": tok}, cache)
        want.append(logits)
        tok = torch.from_numpy((np.arange(TOKENS.shape[0]) * 7 + s) % cfg.vocab_size)
    want = torch.stack(want).numpy()
    for r in range(P):
        rows = got[r]["rows"]
        assert rows == slice(2 * (r // 2), 2 * (r // 2) + 2)
        w = want[:, rows]
        err = np.abs(got[r]["logits"] - w).max() / np.abs(w).max()
        assert err <= 1e-5, (r, err)


def test_launcher_refuses_a_mesh_of_another_world(pool):
    for got in pool.run(D.launcher, ["--smoke", "--mesh", "2x1x1", "--device", "cpu"]):
        assert got["error"].startswith("mesh {'pod': 2, 'data': 1, 'model': 1} needs 2 ranks, "
                                       "the world has 4")


def test_launcher_runs_a_pod_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "metrics.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "repro_torch.launch.train", "--arch", "llama3_8b", "--smoke", "--steps", "20",
         "--batch", "8", "--seq", "64", "--mesh", "2x1x1", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "ck"), "--metrics-out", str(out), "--policy",
         "takum", "--lr", "1e-2"], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    hist = json.loads(out.read_text())
    assert [m["step"] for m in hist] == [10, 20]  # the launcher records every 10th step
    assert hist[-1]["ce"] < hist[0]["ce"] and "(improved)" in res.stdout
    assert "mesh={'pod': 2, 'data': 1, 'model': 1}" in res.stdout
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["rank0", "rank1"]


def test_a_failing_rank_fails_the_call_with_its_traceback():
    with RankPool(2, timeout_s=30) as p:
        with pytest.raises(RankError, match="(?s)rank 1 raised:.*Traceback.*rank 1 fails on "
                                            "purpose"):
            p.run(D.fails, "raise")
        with pytest.raises(RankError, match="rank 0 gave no result"):
            p.run(D.fails, "block", timeout_s=5)
        assert p.run(D.fails, "none") == [0, 1]  # a fresh pool after a failure
