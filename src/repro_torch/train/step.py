"""The single-device train step (counterpart of the single-device branch of
``repro.dist.step.make_train_step``): the loss and its gradients by
autograd, the gradients' finiteness product, then AdamW with stochastic
rounding iff ``cfg.quant.stochastic_rounding`` and the moments are takum.

``TrainState.rng`` is a uint32[2] tensor on the host, the shape of
``repro``'s key, so the state's leaf list (and a checkpoint's) matches
``repro``'s.  Each step seeds a host generator from it, which gives the
next ``rng`` and the seed of the SR draws' generator on the params' device
(``optim.generator_draws``); a run restored from a checkpoint therefore
draws what an unbroken run draws.  The pod branch (the compressed gradient
ring), ``poison_grads`` and the guard's skip come with dist (M7) and the
fault guards (M8).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
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


def _advance(rng: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(the next rng, the seed of this step's SR generator), drawn from a
    host generator seeded by ``rng``."""
    hi, lo = (rng.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist()
    gen = torch.Generator()
    gen.manual_seed((hi << 32) | lo)
    d = torch.randint(0, 1 << 32, (4,), generator=gen, dtype=torch.int64)
    return _pack_u32(d[:2]), (int(d[2]) << 32) | int(d[3])


def init_state(cfg, seed: int = 0, *, device=None) -> TrainState:
    """Random parameters from ``seed`` (``T.init_params``), zero moments in
    ``cfg.quant.opt_state`` and ``rng_key(seed + 1)``, on ``device`` (the
    card unless 'cpu')."""
    params = T.init_params(cfg, seed, device=resolve_device(device))
    return TrainState(params, adamw_init(params, fmt=cfg.quant.opt_state), rng_key(seed + 1))


def make_train_step(cfg, *, lr=3e-4, aux_weight: float = 0.01):
    """``step(state, batch, rnd=None) -> (state, metrics)``; ``batch``
    holds ``tokens`` (and a vlm's ``media``), moved to the params' device;
    metrics
    ``loss`` (ce + aux), ``ce``, ``aux`` and ``grad_ok`` (1.0 when every
    gradient is finite), 0-d tensors on the params' device.  ``rnd``
    replaces the SR draws (``optim.adamw``'s supplier), as the tests do
    with ``repro``'s."""
    if getattr(cfg.quant, "guard", None) is not None:
        raise NotImplementedError("the guarded step (skip of non-finite updates) comes with "
                                  "the fault guards")
    fmt = cfg.quant.opt_state
    use_sr = cfg.quant.stochastic_rounding and is_takum(fmt)

    def step(state: TrainState, batch, rnd=None):
        leaves, spec = tree.flatten(state.params)
        dev = leaves[0].device
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = T.loss_fn(cfg, tree.unflatten(spec, live),
                                      {k: batch[k].to(dev) for k in ("tokens", "media")
                                       if k in batch}, aux_weight=aux_weight)
            loss.backward()
        grads = [p.grad for p in live]
        with torch.no_grad():
            ok = torch.ones((), dtype=torch.float32, device=dev)
            for g in grads:
                ok = ok * torch.isfinite(g).all().to(torch.float32)
            rng, sr_seed = _advance(state.rng)
            if use_sr and rnd is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(sr_seed)
                rnd = generator_draws(gen)
            params, opt = adamw_update(tree.unflatten(spec, grads), state.opt, state.params,
                                       lr=lr, fmt=fmt, rnd=rnd if use_sr else None)
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "grad_ok": ok}
        return TrainState(params, opt, rng), out

    return step
