"""Training launcher of the port (counterpart of ``repro.launch.train``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --smoke \\
        --steps 20 --batch 8 --seq 64 --policy takum --device cpu

Drives the synthetic Markov data (``data.SyntheticLM``, seed 17), the
single-device train step (AdamW, quantised moments per policy) and the
checkpointed loop (``train.TrainLoop``), and prints the cross-entropy from
the first logged step to the last.  It runs on the card unless
``--device cpu``.  Checkpoints are stored in the policy's checkpoint
format (``f32`` under bf16, so a restarted run equals an unbroken one bit
for bit; ``t16`` under takum).  ``--arch`` takes every ported architecture
of the registry (``configs.ARCHS``: llama3_8b, llama3_2_3b, gemma2_2b,
granite_34b, musicgen_large, dbrx_132b, kimi_k2_1t_a32b, mamba2_780m,
hymba_1_5b, llama3_2_vision_90b, or their aliases such as ``gemma2-2b``)
and ``lm_100m``, the launcher's own tied-embedding config (``repro``'s).
A vlm's batches carry ``media`` from ``SyntheticLM.media_stub``, as
``repro``'s launcher adds it.

``--mesh`` takes ``repro``'s specs: "DxM" (data x model) or "PxDxM" (pod x
data x model; a pod axis above 1 reduces the gradients through the
compressed ring in the policy's ``grad_comm``), run as one process a rank
under ``torchrun``, whose world must be the mesh's size::

    torchrun --nproc-per-node=2 -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 20 --batch 8 --seq 64 --mesh 2x1x1 --device cpu

Every rank builds the same batches and initial state and runs
``dist.step.make_train_step``; its checkpoints go to ``<ckpt-dir>/rank<r>``
and rank 0 alone prints and writes ``--metrics-out``.  ``--backend`` is
gloo (CPU ranks, or ranks that share one card) unless ``nccl`` is asked
for (a card per rank).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.dist import step as dstep
from repro_torch.dist.spawn import rank_device
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.quant.policy import POLICIES
from repro_torch.train import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state


def lm_100m() -> ModelConfig:
    """~100M-parameter llama-style config for the end-to-end example
    (``repro.launch.train.lm_100m``)."""
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        head_dim=64, rope_theta=10000.0, tie_embeddings=True,
    )


def batch_fn(cfg: ModelConfig, pipe: SyntheticLM):
    """``step -> batch``: the pipeline's tokens, and for a vlm its stub
    media [batch, num_media_tokens, media_d]."""

    def make(step: int) -> dict:
        b = pipe.batch(step)
        if cfg.family == "vlm":
            b["media"] = pipe.media_stub(step, cfg.num_media_tokens, cfg.media_d)
        return b

    return make


def build(arch: str, *, smoke: bool, policy: str, seq: int, batch: int):
    if arch == "lm_100m":
        cfg = lm_100m()
    else:
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    return cfg.with_(quant=POLICIES[policy]), SyntheticLM(cfg.vocab_size, seq, batch, seed=17)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="takum", choices=list(POLICIES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="repro_torch_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--mesh", default="1x1",
                    help="rank mesh, e.g. 2x4 (data x model) or 2x2x2 (pod x data x model); "
                         "pod meshes use the compressed gradient ring")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of a multi-rank mesh")
    ap.add_argument("--device", default=None, help="'cpu' for the host (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, failure_hook=None):
    """Run the launcher; returns the loop's final state and its metrics
    history.  ``failure_hook(step)`` is the loop's (a drill may raise)."""
    args = parse_args(argv)
    cfg, pipe = build(args.arch, smoke=args.smoke, policy=args.policy, seq=args.seq,
                      batch=args.batch)
    mesh = parse_mesh(args.mesh, backend=args.backend)
    ckpt_dir, rank0 = args.ckpt_dir, True
    if mesh.size > 1:
        import torch.distributed as dist

        dev = rank_device(args.device, args.backend)
        ckpt_dir = os.path.join(args.ckpt_dir, f"rank{dist.get_rank()}")
        rank0 = dist.get_rank() == 0
    else:
        dev = resolve_device(args.device)
    say = print if rank0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} policy={args.policy} device={dev} mesh={mesh.shape}")
    loop = TrainLoop(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=ckpt_dir, ckpt_fmt=cfg.quant.checkpoint,
                        log_every=10),
        dstep.make_train_step(cfg, mesh, lr=args.lr), batch_fn(cfg, pipe),
        lambda: init_state(cfg, 0, device=dev),
        failure_hook)
    t0 = time.time()
    state = loop.run()
    hist = loop.metrics_history
    say(f"done {args.steps} steps in {time.time() - t0:.1f}s")
    for m in hist[:3] + hist[-3:]:
        say("  ", {k: round(v, 4) for k, v in m.items()})
    if hist:
        first, last = hist[0]["ce"], hist[-1]["ce"]
        say(f"CE {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    return state, hist


if __name__ == "__main__":
    main()
