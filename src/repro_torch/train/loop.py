"""Training loop with checkpoint/restart, failure drills and straggler work
reassignment (counterpart of ``repro.train.loop``; telemetry comes with M8,
sharded placement with dist).

``TrainLoop.run`` restores the latest checkpoint of ``cfg.ckpt_dir`` (or
builds the initial state), then drives ``step_fn(state, batch) -> (state,
metrics)`` over ``batch_fn(step)`` to ``total_steps``, saving every
``ckpt_every`` steps and at the last.  ``failure_hook(step)`` lets a test or
a drill raise mid-run to exercise the restart.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree

from .checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.train")


def reassign_shards(num_shards: int, healthy: list[int]) -> dict[int, list[int]]:
    """Deterministic straggler/failure mitigation: every data shard is owned
    by a healthy worker; a healthy worker keeps its own shard and orphaned
    shards go round-robin in shard order, so every worker computes the same
    map without coordination."""
    if not healthy:
        raise ValueError("no healthy workers")
    healthy = sorted(healthy)
    owners: dict[int, list[int]] = {h: [] for h in healthy}
    for s in range(num_shards):
        if s in owners:
            owners[s].append(s)
    orphans = [s for s in range(num_shards) if s not in healthy]
    for i, s in enumerate(orphans):
        owners[healthy[i % len(healthy)]].append(s)
    return owners


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "repro_torch_ckpt"
    ckpt_fmt: str = "f32"
    keep: int = 3
    log_every: int = 10
    step_timeout_s: float = 0.0  # 0 = watchdog off
    resume: bool = True


def _place(host: torch.Tensor, like) -> torch.Tensor:
    """A restored host leaf onto the device of the initial state's leaf
    (16- and 32-bit unsigned bits through their signed view)."""
    if not isinstance(like, torch.Tensor) or like.device == host.device:
        return host
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32}.get(host.dtype)
    if signed is None:
        return host.to(like.device)
    return host.view(signed).to(like.device).view(host.dtype)


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable, batch_fn: Callable[[int], Any],
                 init_state: Callable[[], Any],
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state = init_state
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, fmt=cfg.ckpt_fmt, keep=cfg.keep)
        self.metrics_history: list[dict] = []

    def _restore_or_init(self):
        state = self.init_state()
        latest = self.ckpt.latest_step() if self.cfg.resume else None
        if latest is None:
            return state, 0
        host = self.ckpt.restore(latest, state)
        log.info("resumed from step %d", latest)
        return tree.map_leaves(_place, host, state), latest

    def run(self) -> Any:
        state, start = self._restore_or_init()
        try:
            for step in range(start, self.cfg.total_steps):
                if self.failure_hook is not None:
                    self.failure_hook(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, self.batch_fn(step))
                dt = time.monotonic() - t0
                if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
                    log.warning("step %d exceeded watchdog (%.2fs > %.2fs): straggler "
                                "suspected", step, dt, self.cfg.step_timeout_s)
                if (step + 1) % self.cfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"], m["dt"] = step + 1, dt
                    self.metrics_history.append(m)
                if (step + 1) % self.cfg.ckpt_every == 0 or step + 1 == self.cfg.total_steps:
                    self.ckpt.save(step + 1, state)
        finally:
            # a failure leaves no write in flight behind it: a restart in this
            # process would otherwise race the old writer for the same step
            self.ckpt.wait()
        return state
