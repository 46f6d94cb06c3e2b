"""AdamW with optionally quantised moments (counterpart of
``repro.optim.adamw``).

The moments are f32, bf16 or a :class:`~repro_torch.quant.qtensor.QTensor`
with a per-tensor pow2 scale (``scaled=True``, as ``repro`` keeps the
structure of its state from init on).  On the card a quantised moment is
decoded by K1 (``ops.decode``), two launches per parameter leaf a step, and
re-encoded either by K2 (round to nearest even) or, with stochastic
rounding, by the plain PyTorch SR encoders (``repro``'s are jnp).

The SR draws are separate from the encode: ``rnd(j, start, count)`` gives
the uint32 values (in an int64 tensor) for flat elements [start, start +
count) of moment leaf j, m of parameter leaf i being 2i and v 2i + 1, in
``repro.tree``'s (jax's) leaf order.  The port's own supplier is
:func:`generator_draws`, an explicit ``torch.Generator`` on the params'
device; the tests pass ``repro``'s ``jax.random.bits`` draws instead.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.core.formats import wire_format
from repro_torch.quant.qtensor import QTensor, dequantize, quantize, requantize


class AdamWState(NamedTuple):
    step: Any  # int32 0-d tensor on the params' device
    m: Any  # tree of f32 / bf16 tensors or QTensors
    v: Any


def generator_draws(gen: torch.Generator) -> Callable:
    """SR draws from ``gen``, in the order the encodes ask for them."""

    def rnd(j: int, start: int, count: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (count,), generator=gen, device=gen.device,
                             dtype=torch.int64)

    return rnd


def _zero(p: torch.Tensor, fmt: str):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if fmt == "f32":
        return z
    if fmt == "bf16":
        return z.to(torch.bfloat16)
    return quantize(z, fmt, scaled=True)


def adamw_init(params, *, fmt: str = "f32") -> AdamWState:
    """Zero moments in ``fmt`` (a quantised format packs them through K2)."""
    fmt = wire_format(fmt).name
    leaves, spec = tree.flatten(params)
    dev = leaves[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.unflatten(spec, [_zero(p, fmt) for p in leaves]),
                      v=tree.unflatten(spec, [_zero(p, fmt) for p in leaves]))


def _dq(x) -> torch.Tensor:
    return dequantize(x) if isinstance(x, QTensor) else x.to(torch.float32)


def _q(x: torch.Tensor, prev, fmt: str, rnd_bits):
    if fmt == "f32":
        return x.to(torch.float32)
    if fmt == "bf16":
        return x.to(torch.bfloat16)
    if not (isinstance(prev, QTensor) and prev.fmt == fmt):
        raise ValueError(f"moment format {fmt!r} does not match the state's "
                         f"{getattr(prev, 'fmt', type(prev).__name__)!r}")
    return requantize(prev, x, rnd_bits)


def adamw_update(grads, state: AdamWState, params, *, lr, fmt: str = "f32", b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 rnd: Optional[Callable] = None):
    """Returns (new_params, new_state).  ``fmt``: the moments' format;
    ``rnd`` (see the module docstring) switches a takum or OFP8 refresh to
    stochastic rounding.  Bias corrections and update order are
    ``repro``'s: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
    ``p -= lr (m / c1 / (sqrt(v / c2) + eps) + wd p)`` in f32."""
    fmt = wire_format(fmt).name
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=sf.device), sf)

    leaves_g, spec = tree.flatten(grads)
    leaves_p = tree.flatten(params)[0]
    leaves_m, leaves_v = tree.nodes(state.m), tree.nodes(state.v)
    use_sr = rnd is not None and wire_format(fmt).supports_sr

    new_p, new_m, new_v = [], [], []
    for i, (g, m, v, p) in enumerate(zip(leaves_g, leaves_m, leaves_v, leaves_p)):
        gf = g.to(torch.float32)
        mf = b1 * _dq(m) + (1 - b1) * gf
        vf = b2 * _dq(v) + (1 - b2) * gf * gf
        update = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (update + weight_decay * pf)
        new_p.append(pf.to(p.dtype))
        new_m.append(_q(mf, m, fmt, _leaf_draws(rnd, 2 * i) if use_sr else None))
        new_v.append(_q(vf, v, fmt, _leaf_draws(rnd, 2 * i + 1) if use_sr else None))
    return (tree.unflatten(spec, new_p),
            AdamWState(step=step, m=tree.unflatten(spec, new_m), v=tree.unflatten(spec, new_v)))


def _leaf_draws(rnd: Callable, j: int) -> Callable:
    return lambda start, count: rnd(j, start, count)
