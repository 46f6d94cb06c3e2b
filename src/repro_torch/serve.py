"""Single-device serving steps (counterpart of ``repro.dist.step``'s
``quantize_params`` / ``dequantize_params`` / ``make_prefill_step`` /
``make_serve_step``).

``repro``'s steps dequantize every packed weight before the jnp model runs;
here the model consumes the packed weights directly (K3 reads the bits), so
the steps pass the packed tree through.  ``load_params`` decodes, once, the
few packed leaves that no kernel reads packed.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import wire_format
from repro_torch.models import transformer as T
from repro_torch.models.mamba2 import SMALL_LEAVES, MambaParams
from repro_torch.quant.qtensor import QTensor, dequantize, quantize


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts and :class:`MambaParams`."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, MambaParams):
        return MambaParams(*(_map(fn, v) for v in tree))
    return fn(tree)


def quantize_params(cfg, params: dict) -> dict:
    """Pack weights into ``cfg.quant.weights``.  IEEE formats are a plain
    cast of every leaf.  Otherwise every leaf with ndim >= 2 (the embedding,
    the stacked norm gains, every weight and the head, every stacked
    :class:`MambaParams` leaf, and a vlm's ``media_proj`` and
    ``cross_layers`` leaves but its gates) becomes a QTensor with
    one pow2 scale per leaf, over all layers of a stacked leaf (an mx
    format: one E8M0 scale per 32-block of the last axis); 1-D leaves stay
    f32 (a vlm's ``cross_layers.gate`` [Lc] among them).  Each leaf is
    packed through K2 on the card."""
    wf = wire_format(cfg.quant.weights)
    if wf.family == "ieee":
        dt = torch.bfloat16 if wf.name == "bf16" else torch.float32
        return _map(lambda a: a.to(dt), params)

    def q(a):
        if a.dim() >= 2:
            return quantize(a.to(torch.float32), wf.name, scaled=True)
        return a.to(torch.float32)

    return _map(q, params)


def dequantize_params(params: dict) -> dict:
    """Inverse of :func:`quantize_params` (QTensor -> f32, rest unchanged)."""
    return _map(lambda a: dequantize(a) if isinstance(a, QTensor) else a, params)


def _decoded(v):
    return dequantize(v) if isinstance(v, QTensor) else v


def load_params(params: dict) -> dict:
    """Make a packed tree ready to serve: decode, once and through K1, the
    packed leaves that no matmul reads (the stacked norm gains
    ``layers.ln1``/``ln2``, gemma2's ``ln1_post``/``ln2_post``, and the
    mixer's ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``D`` and
    ``norm_g``, and a vlm's cross-layer gains ``cross_layers.ln``).  Every
    other leaf is passed through as it is, so the weights (the mixer's
    ``in_proj`` and ``out_proj``, the cross layers' and ``media_proj``
    too) and the embedding (a tied head's table too) stay packed."""
    layers = {k: _decoded(v) if k in T.GAINS else v for k, v in params["layers"].items()}
    if "ssm" in layers:
        pr = layers["ssm"]
        layers["ssm"] = pr._replace(**{k: _decoded(getattr(pr, k)) for k in SMALL_LEAVES})
    out = {**params, "layers": layers}
    if "cross_layers" in params:
        cross = params["cross_layers"]
        out["cross_layers"] = {**cross, T.CROSS_GAIN: _decoded(cross[T.CROSS_GAIN])}
    return out


def make_prefill_step(cfg, cache_len: int | None = None):
    """``step(params, batch) -> (last_logits [B, V], cache)``; ``batch`` holds
    ``tokens`` [B, S] (and a vlm's ``media`` [B, M, media_d]).  ``cache_len``
    sizes the cache for later decode steps."""

    def step(params, batch):
        return T.prefill(cfg, params, batch["tokens"], batch.get("media"), cache_len=cache_len)

    return step


def make_serve_step(cfg):
    """``step(params, batch, cache) -> (logits [B, V], cache)`` for one token
    (``batch["token"]`` [B]; a vlm's ``batch["media"]`` [B, M, media_d],
    projected anew every step); the cache is updated in place."""

    def step(params, batch, cache):
        return T.decode_step(cfg, params, batch["token"], cache, batch.get("media"))

    return step
