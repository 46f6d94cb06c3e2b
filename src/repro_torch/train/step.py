"""The single-device train step (counterpart of the single-device branch of
``repro.dist.step.make_train_step``): the loss and its gradients by
autograd, the gradients' finiteness product, then AdamW with stochastic
rounding iff ``cfg.quant.stochastic_rounding`` and the moments are takum.

``TrainState.rng`` is a uint32[2] tensor on the host, the shape of
``repro``'s key, so the state's leaf list (and a checkpoint's) matches
``repro``'s.  Each step seeds a host generator from it, which gives the
next ``rng`` and the seed of the SR draws' generator on the params' device
(``optim.generator_draws``); a run restored from a checkpoint therefore
draws what an unbroken run draws.

As in ``repro``: inside ``faults.inject`` the gradients take
``faults.poison_grads`` after the backward (keyed by the step's rng); under
a ``cfg.quant.guard`` with ``skip_nonfinite_update`` a step whose gradients
are not all finite leaves the params and the optimizer state (moment codes,
scales and step count) as they were and counts ``step.skipped``, while the
rng advances.  The skip reads ``grad_ok`` on the host: one sync a guarded
step (``torch.amp.GradScaler``'s idiom), which also spares the update's work
on a skipped step; an unguarded step takes no sync.  Under a telemetry
capture the step is a ``step.train`` span (category ``step``) and counts
``step.calls`` and ``step.tokens`` and the ``step.grad_norm`` histogram.
The multi-rank steps, the pod branch with its compressed gradient ring
among them, are :func:`repro_torch.dist.step.make_train_step`: they run
this step with the two hooks of :func:`make_train_step` (each rank's rows
of the batch, and the gradients' reduction over the ranks).
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core import telemetry
from repro_torch.device import resolve_device
from repro_torch.dist import faults
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, generator_draws
from repro_torch.quant.policy import is_takum


class TrainState(NamedTuple):
    params: Any
    opt: Any  # AdamWState
    rng: Any  # uint32[2] on the host


def rng_key(seed: int) -> torch.Tensor:
    """uint32[2] ``[0, seed]``, the layout of ``jax.random.PRNGKey(seed)``."""
    return _pack_u32(torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.int64))


def _pack_u32(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(torch.uint32)


def _rng_int(rng: torch.Tensor) -> int:
    """The uint32[2] key as one 64-bit integer."""
    hi, lo = (rng.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist()
    return (hi << 32) | lo


def _advance(rng: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(the next rng, the seed of this step's SR generator), drawn from a
    host generator seeded by ``rng``."""
    gen = torch.Generator()
    gen.manual_seed(_rng_int(rng))
    d = torch.randint(0, 1 << 32, (4,), generator=gen, dtype=torch.int64)
    return _pack_u32(d[:2]), (int(d[2]) << 32) | int(d[3])


def init_state(cfg, seed: int = 0, *, device=None) -> TrainState:
    """Random parameters from ``seed`` (``T.init_params``), zero moments in
    ``cfg.quant.opt_state`` and ``rng_key(seed + 1)``, on ``device`` (the
    card unless 'cpu')."""
    params = T.init_params(cfg, seed, device=resolve_device(device))
    return TrainState(params, adamw_init(params, fmt=cfg.quant.opt_state), rng_key(seed + 1))


def make_train_step(cfg, *, lr=3e-4, aux_weight: float = 0.01, local_batch=None, sync=None):
    """``step(state, batch, rnd=None) -> (state, metrics)``; ``batch``
    holds ``tokens`` (and a vlm's ``media``), moved to the params' device;
    metrics ``loss`` (ce + aux), ``ce``, ``aux`` and ``grad_ok`` (1.0 when
    every gradient is finite), 0-d tensors on the params' device.  ``rnd``
    replaces the SR draws (``optim.adamw``'s supplier), as the tests do
    with ``repro``'s.

    The hooks of a multi-rank step: ``local_batch(batch)`` gives the rows
    this rank computes the loss on (default: all of them), and ``sync(grads,
    metrics, key)`` reduces the gradient list and the metrics dict (``loss``,
    ``ce``, ``aux``) over the ranks after the fault hook, ``key`` being the
    step's rng as an integer; it returns ``(grads, metrics, grad_ok)`` and
    may empty the list it was given, to free the gradients early."""
    fmt = cfg.quant.opt_state
    use_sr = cfg.quant.stochastic_rounding and is_takum(fmt)
    guard = cfg.quant.guard
    skip_nonfinite = guard is not None and guard.skip_nonfinite_update

    def step(state: TrainState, batch, rnd=None):
        leaves, spec = tree.flatten(state.params)
        dev = leaves[0].device
        span = (telemetry.trace_span("step.train", cat="step", device=dev)
                if telemetry.enabled() else contextlib.nullcontext())
        with span:
            live = [p.detach().requires_grad_(True) for p in leaves]
            tokens = batch["tokens"]
            local = batch if local_batch is None else local_batch(batch)
            with torch.enable_grad():
                loss, metrics = T.loss_fn(cfg, tree.unflatten(spec, live),
                                          {k: local[k].to(dev) for k in ("tokens", "media")
                                           if k in local}, aux_weight=aux_weight)
                loss.backward()
            grads = [p.grad for p in live]
            for p in live:
                p.grad = None  # the list holds them: a sync may free them early
            with torch.no_grad():
                key, sr_seed = _advance(state.rng)
                if faults.active() is not None:
                    grads = faults.poison_grads(grads, _rng_int(state.rng))
                if sync is None:
                    ok = torch.ones((), dtype=torch.float32, device=dev)
                    for g in grads:
                        ok = ok * torch.isfinite(g).all().to(torch.float32)
                else:
                    metrics = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
                               "aux": metrics["aux"].detach()}
                    grads, metrics, ok = sync(grads, metrics, _rng_int(state.rng))
                    loss = metrics["loss"]
                if telemetry.enabled():
                    telemetry.emit("step.calls", 1.0)
                    telemetry.emit("step.tokens", float(tokens.shape[0] * tokens.shape[1]))
                    telemetry.emit_hist("step.grad_norm", torch.sqrt(sum(
                        torch.sum(torch.square(g.to(torch.float32))) for g in grads)))
                if skip_nonfinite and ok.item() < 0.999:
                    params, opt = state.params, state.opt
                    if telemetry.enabled():
                        telemetry.emit("step.skipped", 1.0)
                else:
                    if skip_nonfinite and telemetry.enabled():
                        telemetry.emit("step.skipped", 0.0)
                    if use_sr and rnd is None:
                        gen = torch.Generator(device=dev)
                        gen.manual_seed(sr_seed)
                        rnd = generator_draws(gen)
                    params, opt = adamw_update(tree.unflatten(spec, grads), state.opt,
                                               state.params, lr=lr, fmt=fmt,
                                               rnd=rnd if use_sr else None)
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "grad_ok": ok}
        return TrainState(params, opt, key), out

    return step
