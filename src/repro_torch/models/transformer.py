"""Decoder with packed weights and a packed KV cache (counterpart of
``repro.models.transformer``: the "dense" and "audio" families, llama3-8b,
llama3.2-3b, gemma2-2b, granite-34b, musicgen-large, the "moe" family,
dbrx-132b and kimi-k2-1t-a32b, the "ssm" family, mamba2-780m, the
"hybrid" family, hymba-1.5b, and the "vlm" family,
llama-3.2-vision-90b).

Parameters keep ``repro``'s stacked layout: ``layers.attn.wq`` is
``[L, d, H*hd]`` and so on, each packed leaf a :class:`QTensor` with one
per-tensor pow2 scale over all layers.  The layers run as a Python loop over
L (``repro`` scans them).

On the card the serving path goes through the port's kernels: every linear
over a packed weight is K3; the embedding rows of the token ids are one K1
launch per call (``ops.decode_rows``: the row gather, the decode, the pow2
scale and the cast to the activation dtype in one kernel; the packed norm
gains are decoded by K1 once, at load); each layer's KV append is one K2
launch (``ops.encode_into``: K and V as a pair, the activations widened in
registers, written straight into their cache slots); and the decode step
reads the cache through K6.  A "moe" layer replaces the MLP by
``moe.moe_block`` (``layers.moe``: the f32 router ``[L, d, E]``, the
experts ``wi`` / ``wg`` ``[L, E, d, f]`` and ``wo`` ``[L, E, f, d]``, and
kimi's shared expert ``wi_s`` / ``wg_s`` / ``wo_s``): per layer and call
one K3 over the router, three per expert (every expert) and three for the
shared expert; the decode step passes ``[B, 1, d]``, as ``repro`` does,
so each expert's capacity is one slot a row.  Each layer's balance loss
adds into ``forward``'s ``aux``.  No call names a codec, so each kernel
takes its format's default (``kernels/lut.py``, as in ``repro``): the table
("lut") codec for t8 weights and caches (and mxt8's elements), the e4m3 /
e5m2 cache read and the t16 weight packing; the bits codec elsewhere.  An mx KV cache (``mxe4m3``, ``mxe5m2``,
``mxt8``) stores per (position, kv head) the payload of the head dim
zero-padded to a multiple of 32: ``payload_len(hd)`` bytes, appended
through K2-mx and read through K6-mx (a head dim that is not whole blocks
is padded before the append, an extra launch that no served config needs:
llama3-8b's is 128).  The KV cache is updated IN PLACE
(``repro`` is functional and returns a new cache): ``prefill`` fills a fresh
cache and ``decode_step`` writes its slot into the cache it is given.

The ssm and hybrid layers run ``models/mamba2.py``'s mixer over the layer's
``layers.ssm`` (a :class:`~.mamba2.MambaParams` of stacked leaves): an
"ssm" layer is ``x + mixer(norm(x))`` (no attention, no MLP, no K/V), added
in f32 (the mixer's output is f32, jnp's promotion over the dequantized
weights) and cast back to the input dtype; a "hybrid" layer adds ``0.5 *
(attention + mixer)`` over one shared norm, which makes x f32 under bf16
activations, so its MLP runs on f32 x (K3's f32-x paths) and the cast
back comes at the end of the layer, as in ``repro``.  Per layer and call
the mixer launches two K3 (``in_proj``, ``out_proj``); the SSD, the conv,
the recurrence and the norms are plain PyTorch (``repro``'s are jnp).  The
cache carries each layer's conv tail ``conv`` [L, B, w-1, F] (the dtype of
the prefill's projection) and SSM state ``ssm`` [L, B, nh, N, hd] (f32),
written in place like K/V; an "ssm" config allocates no K/V.

What the archs add to llama3-8b's block, as in ``repro``: a tied head
(``tie_embeddings``: no ``lm_head``, the logits are ``x @ embed.T`` through
``layers.linear_t``, the transposed K3 over the packed table); and under
``alt_local_global`` (gemma2) per-layer windows (:func:`_layer_windows`:
even layers ``sliding_window``, odd layers global, passed to the prefill's
attention and to K6), the post-norms ``ln1_post`` / ``ln2_post`` on the
attention and MLP outputs before each residual add, and the embedding rows
times ``sqrt(d_model)`` rounded to the activation dtype, a second rounding
after K1's cast, as ``repro`` multiplies after ``.astype``.

A "vlm" model adds ``repro``'s gated cross-attention onto media: the
batch's ``media`` [B, M, media_d] (a stub encoder's output) is projected
once per call, ``media_emb = media.to(adt) @ media_proj`` (K3 at M = B *
num_media_tokens), and after every ``cross_attn_every``-th layer ``x = x +
tanh(gate[c]) * cross_attn(rms_norm(x, ln[c]), media_emb)`` over the
``cross_layers`` leaves of cross layer c: q from the text, k and v from
``media_emb`` through K3, no rope, a non-causal attention over every media
token, then ``wo``.  The media K/V stay in the activation dtype (``repro``
does not quantise them) and are recomputed in every decode step, as
``repro`` recomputes them; the KV cache holds the self-attention layers
only.

A KV cache in "f32" stores the values themselves (``repro``'s
``_encode_cache`` keeps them), read by K6 and appended by K2 as raw f32
bits: it is exact.

Training runs :func:`loss_fn` over raw f32 (or bf16) parameters with
autograd: every linear is ``torch.matmul`` (``repro`` trains its f32
masters through the plain dot of ``layers.linear``), the attention's
backward is :class:`~.attention.FlashAttention`, and under ``cfg.remat ==
"block"`` each layer is recomputed in the backward.  Token ids are int32
or int64 everywhere; an id off the table reads what ``repro``'s gather
reads (wrapped, then clamped: ``takum_codec.table_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import telemetry
from repro_torch.core.formats import count_specials, wire_format
from repro_torch.device import resolve_device
from repro_torch.dist import faults
from repro_torch.kernels import ops
from repro_torch.kernels.takum_codec import table_rows
from repro_torch.quant import blockscale
from repro_torch.quant.qtensor import QTensor
from .attention import flash_attention
from . import moe
from .config import ModelConfig
from .layers import linear, linear_t, rms_norm, rope, softcap, swiglu
from .mamba2 import MambaCache, MambaParams, mamba_decode_step, mamba_forward


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.quant.activations == "bf16" else torch.float32


def _chunk_of(S: int, want: int) -> int:
    """``repro``'s chunk length: the largest divisor of S not above ``want``."""
    c = min(S, want)
    while S % c:
        c -= 1
    return c


def _ssm_d_in(cfg: ModelConfig) -> int:
    """The mixer's inner width: ``ssm_expand * d_model`` for "ssm",
    ``d_model`` for "hybrid"."""
    return cfg.ssm_expand * cfg.d_model if cfg.family == "ssm" else cfg.d_model


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig) -> list:
    """Every parameter leaf of ``cfg`` in ``repro``'s layout, as (path,
    shape, std) in the order :func:`init_params` draws them; std 0 for the
    norm gains, which start at zero.  A moe layer's ``layers.moe`` holds
    the router ``[L, d, E]`` (drawn in f32 whatever the dtype, as in
    ``repro``), the experts ``wi`` / ``wg`` ``[L, E, d, f]`` and ``wo``
    ``[L, E, f, d]``, and with ``num_shared_experts`` the shared expert's
    ``wi_s`` / ``wg_s`` ``[L, d, fs]`` and ``wo_s`` ``[L, fs, d]``, fs =
    ``d_ff * num_shared_experts``; the dense and hybrid families'
    ``layers.mlp`` the SwiGLU ``wi`` / ``wg`` / ``wo``.  An "ssm" layer
    holds ``ln1`` and ``layers.ssm`` only; a "hybrid" layer the attention,
    the MLP and ``layers.ssm``.  ``layers.ssm`` holds :class:`MambaParams`'
    leaves (``conv_w`` drawn at std 0.2; std None for the constants that
    ``repro``'s ``init_mamba`` fills: ``a_log = log(linspace(1, 16, nh))``,
    ``dt_bias = -4.6``, ``D = 1``).  A "vlm" tree adds, after the head
    (``repro`` draws them last), ``cross_layers`` (``wq`` / ``wk`` /
    ``wv`` / ``wo`` over ``Lc = L / cross_attn_every`` cross layers, their
    norm gains ``ln`` [Lc, d] and gates ``gate`` [Lc], both zero) and
    ``media_proj`` [media_d, d] at std ``media_d ** -0.5``."""
    d, L, V, f = cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.d_ff
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    specs = [(("embed",), (V, d), d ** -0.5), (("layers", "ln1"), (L, d), 0.0)]
    if cfg.family != "ssm":
        specs += [(("layers", "ln2"), (L, d), 0.0),
                  (("layers", "attn", "wq"), (L, d, H * hd), d ** -0.5),
                  (("layers", "attn", "wk"), (L, d, Kv * hd), d ** -0.5),
                  (("layers", "attn", "wv"), (L, d, Kv * hd), d ** -0.5),
                  (("layers", "attn", "wo"), (L, H * hd, d), (H * hd) ** -0.5)]
    if cfg.family == "moe":
        E = cfg.num_experts
        specs += [(("layers", "moe", "router"), (L, d, E), d ** -0.5),
                  (("layers", "moe", "wi"), (L, E, d, f), d ** -0.5),
                  (("layers", "moe", "wg"), (L, E, d, f), d ** -0.5),
                  (("layers", "moe", "wo"), (L, E, f, d), f ** -0.5)]
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            specs += [(("layers", "moe", "wi_s"), (L, d, fs), d ** -0.5),
                      (("layers", "moe", "wg_s"), (L, d, fs), d ** -0.5),
                      (("layers", "moe", "wo_s"), (L, fs, d), fs ** -0.5)]
    elif cfg.family != "ssm":
        specs += [(("layers", "mlp", "wi"), (L, d, f), d ** -0.5),
                  (("layers", "mlp", "wg"), (L, d, f), d ** -0.5),
                  (("layers", "mlp", "wo"), (L, f, d), f ** -0.5)]
    if cfg.family in ("ssm", "hybrid"):
        d_in, N, w = _ssm_d_in(cfg), cfg.ssm_state, cfg.ssm_conv_width
        nh, F = d_in // cfg.ssm_head_dim, d_in + 2 * cfg.ssm_state
        ssm = (("in_proj", (L, d, 2 * d_in + 2 * N + nh), d ** -0.5), ("conv_w", (L, w, F), 0.2),
               ("conv_b", (L, F), 0.0), ("a_log", (L, nh), None), ("dt_bias", (L, nh), None),
               ("D", (L, nh), None), ("norm_g", (L, d_in), 0.0),
               ("out_proj", (L, d_in, d), d_in ** -0.5))
        specs += [(("layers", "ssm", name), shape, std) for name, shape, std in ssm]
    if cfg.alt_local_global:  # gemma2 post-norms
        specs += [(("layers", "ln1_post"), (L, d), 0.0), (("layers", "ln2_post"), (L, d), 0.0)]
    specs.append((("final_norm",), (d,), 0.0))
    if not cfg.tie_embeddings:
        specs.append((("lm_head",), (d, V), d ** -0.5))
    if cfg.family == "vlm":
        Lc, md = L // cfg.cross_attn_every, cfg.media_d
        specs += [(("cross_layers", "wq"), (Lc, d, H * hd), d ** -0.5),
                  (("cross_layers", "wk"), (Lc, d, Kv * hd), d ** -0.5),
                  (("cross_layers", "wv"), (Lc, d, Kv * hd), d ** -0.5),
                  (("cross_layers", "wo"), (Lc, H * hd, d), (H * hd) ** -0.5),
                  (("cross_layers", "ln"), (Lc, d), 0.0),
                  (("cross_layers", "gate"), (Lc,), 0.0),
                  (("media_proj",), (md, d), md ** -0.5)]
    return specs


def set_path(tree: dict, path: tuple, leaf) -> None:
    """``tree[path[0]][path[1]]... = leaf``, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _constant(name: str, shape, dtype, device) -> torch.Tensor:
    """``repro``'s ``init_mamba`` constants, stacked over layers."""
    if name == "a_log":
        nh = shape[-1]
        row = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32).to(dtype))
        return row.to(device).expand(shape).clone()
    return torch.full(shape, -4.6 if name == "dt_bias" else 1.0, dtype=dtype, device=device)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters in ``repro``'s layout (:func:`param_specs`), drawn
    in order from a seeded ``torch.Generator`` on ``device`` (the card
    unless ``device='cpu'``).  The draws differ from ``repro``'s jax PRNG;
    tests feed ``repro``'s parameters through
    :func:`repro_torch.convert.params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: dict = {}
    for path, shape, std in param_specs(cfg):
        if std is None:
            leaf = _constant(path[-1], shape, dtype, dev)
        elif not std:
            leaf = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            dt = torch.float32 if path[-1] == "router" else dtype
            leaf = torch.randn(shape, generator=gen, device=dev, dtype=dt) * std
        set_path(p, path, leaf)
    if "ssm" in p["layers"]:
        p["layers"]["ssm"] = MambaParams(**p["layers"]["ssm"])
    return p


#: the stacked norm gains of a layer, in the order ``_block`` takes them
GAINS = ("ln1", "ln2", "ln1_post", "ln2_post")
#: the stacked norm gain of a vlm's cross layers (``cross_layers.ln``)
CROSS_GAIN = "ln"


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Each layer's attention window (0: global), ``repro``'s
    ``_layer_windows``: under ``alt_local_global`` even layers take
    ``sliding_window`` and odd layers none; otherwise every layer takes
    ``sliding_window``."""
    if cfg.alt_local_global:
        return [cfg.sliding_window if l % 2 == 0 else 0 for l in range(cfg.num_layers)]
    return [cfg.sliding_window] * cfg.num_layers


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views, no copies); a
    :class:`MambaParams` is a node, each of its leaves sliced."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, MambaParams):
        return MambaParams(*(_layer(v, l) for v in tree))
    return tree[l]


def _needs_grad(tree) -> bool:
    """Whether a tensor of a parameter tree asks autograd for a gradient
    (packed QTensors never do)."""
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, MambaParams):
        return any(_needs_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _gain(g) -> torch.Tensor:
    """Norm gains as a tensor.  Packed gains decode through K1 on every
    call; ``serve.load_params`` decodes them once when the weights load."""
    return g.dequantize() if isinstance(g, QTensor) else g


def _gains(layers) -> dict:
    """The stacked norm gains present in ``layers`` (:data:`GAINS`), as
    tensors."""
    return {k: _gain(layers[k]) for k in GAINS if k in layers}


# ---------------------------------------------------------------------------
# forward (prefill, training)
# ---------------------------------------------------------------------------


def _embed(params, tokens: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    """The embedding rows of int32 or int64 ``tokens`` in ``adt``: a packed
    table through one K1 launch over the gathered rows (scaled and cast in
    the kernel), a plain table through ``F.embedding`` (whose backward sums
    the rows' grads deterministically).  Either way an id off the table is
    wrapped, then clamped (``takum_codec.table_rows``), as in ``repro``."""
    e = params["embed"]
    if isinstance(e, QTensor) and e.fmt not in ("bf16", "f32"):
        # K1 reads the ids in place: a sliced prompt (tokens[:, :S0]) is
        # made contiguous first
        x = ops.decode_rows(e.bits, tokens.contiguous(), e.fmt,
                            scale=None if e.block_scaled else e.scale, out_dtype=adt)
        return x[..., :e.n] if e.block_scaled else x
    table = e.bits if isinstance(e, QTensor) else e
    return F.embedding(table_rows(tokens, table.shape[0]), table).to(adt)


def _input_rows(cfg: ModelConfig, params, tokens: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    """What the first layer takes: :func:`_embed`'s rows, and under
    ``alt_local_global`` those rows times ``sqrt(d_model)`` first rounded to
    ``adt`` (``repro``'s ``x * d**0.5`` on an ``adt`` array): a rounding of
    its own after the cast, never folded into K1's scale."""
    x = _embed(params, tokens, adt)
    if cfg.alt_local_global:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)
    return x


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32, softcapped: ``x @ lm_head``, or ``x @ embed.T`` when
    tied (``linear_t``: the transposed K3 over a flat packed table)."""
    y = linear_t(x, params["embed"]) if cfg.tie_embeddings else linear(x, params["lm_head"])
    return softcap(y.to(torch.float32), cfg.logit_softcap)


def _mlp_or_moe(cfg: ModelConfig, lp, h2):
    """The layer's MLP over [B, S, d]: SwiGLU, or for "moe" the routed
    experts (``moe.moe_block``).  Returns (out, aux): the balance loss, None
    for the dense block."""
    if cfg.family == "moe":
        mp = lp["moe"]
        shared = (mp["wi_s"], mp["wg_s"], mp["wo_s"]) if cfg.num_shared_experts else None
        return moe.moe_block(h2, mp["router"], mp["wi"], mp["wg"], mp["wo"], shared,
                             top_k=cfg.experts_per_token,
                             capacity_factor=cfg.moe_capacity_factor)
    m = lp["mlp"]
    return swiglu(h2, m["wi"], m["wg"], m["wo"]), None


def _mixer(cfg: ModelConfig, pr, h, collect: bool):
    """The Mamba-2 mixer over h [B, S, d]: (y f32-promoted [B, S, d], the
    post-sequence :class:`MambaCache` when ``collect``, else None)."""
    out = mamba_forward(pr, h, N=cfg.ssm_state, hd=cfg.ssm_head_dim,
                        chunk=_chunk_of(h.shape[1], cfg.ssm_chunk), return_state=collect)
    return out if collect else (out, None)


def _block(cfg: ModelConfig, lp, gains, window, x, positions, collect: bool = False):
    """One decoder layer over [B, S, d] with layer ``l``'s gains (``gains``:
    name -> [d], those of :data:`GAINS` the config has) and attention
    ``window``.  Returns (x, k, v, aux, mc), k/v roped [B, S, Kv, hd] in the
    activation dtype (None for "ssm"), aux the layer's balance loss (f32;
    None but for moe), mc the mixer's post-sequence cache (ssm and hybrid,
    when ``collect``; else None)."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    in_dtype = x.dtype
    h = rms_norm(x, gains["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, mc = _mixer(cfg, lp["ssm"], h, collect)
        return (x + y).to(in_dtype), None, None, None, mc
    a = lp["attn"]
    q = rope(linear(h, a["wq"]).reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(linear(h, a["wk"]).reshape(B, S, Kv, hd), positions, cfg.rope_theta)
    v = linear(h, a["wv"]).reshape(B, S, Kv, hd)
    out = flash_attention(q, k, v, window, True, cfg.attn_softcap)
    attn_out = linear(out.reshape(B, S, H * hd), a["wo"])
    mc = None
    if cfg.family == "hybrid":
        y, mc = _mixer(cfg, lp["ssm"], h, collect)
        attn_out = 0.5 * (attn_out + y)
    x = _residual(cfg, x, attn_out, gains, "ln1_post")
    h2 = rms_norm(x, gains["ln2"], cfg.norm_eps)
    out, aux = _mlp_or_moe(cfg, lp, h2)
    x = _residual(cfg, x, out, gains, "ln2_post")
    return x.to(in_dtype), k, v, aux, mc


def _residual(cfg: ModelConfig, x, out, gains, post: str):
    """``x + out``, ``out`` first normed by the post-norm gain ``post`` under
    ``alt_local_global``."""
    if cfg.alt_local_global:
        out = rms_norm(out, gains[post], cfg.norm_eps)
    return x + out


def _media_emb(cfg: ModelConfig, params, media, adt: torch.dtype):
    """A vlm's projected media [B, M, d] in ``adt`` (``media.to(adt) @
    media_proj``: K3 over a packed ``media_proj`` at M = B * M_media), or
    None for the other families."""
    if cfg.family != "vlm":
        return None
    if media is None:
        raise ValueError(f"{cfg.name}: a vlm needs the batch's media embeddings")
    return linear(media.to(adt), params["media_proj"])


def _cross_attn(cfg: ModelConfig, cp, x, media_emb):
    """``repro``'s ``_cross_attn``: x [B, S, d] attends, without a mask or
    rope, to the M media tokens; k and v are the media embeddings through
    ``wk`` / ``wv`` (K3), in the activation dtype.  Returns [B, S, d]."""
    B, S, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    M = media_emb.shape[1]
    q = linear(x, cp["wq"]).reshape(B, S, H, hd)
    k = linear(media_emb, cp["wk"]).reshape(B, M, Kv, hd)
    v = linear(media_emb, cp["wv"]).reshape(B, M, Kv, hd)
    out = flash_attention(q, k, v, 0, False, 0.0)
    return linear(out.reshape(B, S, H * hd), cp["wo"])


def _cross_block(cfg: ModelConfig, cp, gain, gate, x, media_emb):
    """The gated cross-attention after a group of ``cross_attn_every``
    layers: ``x + tanh(gate).to(x.dtype) * cross_attn(rms_norm(x, gain))``,
    in x's dtype (``repro``'s ``vlm_block``).  The tanh is taken in f32 even
    of a bf16 gate (the bf16 policy's): XLA keeps that excess precision in
    ``repro``'s ``jnp.tanh(gate).astype(x.dtype)``, and a gate rounded to
    bf16 in between moves the logits by 1e-4 of their size."""
    h = rms_norm(x, gain, cfg.norm_eps)
    g = torch.tanh(gate.to(torch.float32)).to(x.dtype)
    return (x + g * _cross_attn(cfg, cp, h, media_emb)).to(h.dtype)


def _cross_params(params):
    """The vlm's cross layers as (leaves of ``wq``/``wk``/``wv``/``wo``,
    their norm gains as a tensor, their gates): gains and gates stacked over
    the cross layers."""
    cross = params["cross_layers"]
    attn = {k: cross[k] for k in ("wq", "wk", "wv", "wo")}
    return attn, _gain(cross[CROSS_GAIN]), cross["gate"]


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, media=None, *,
            last_only: bool = False, on_layer=None):
    """tokens [B, S] -> (logits [B, S, V] f32, aux) (``last_only``: logits
    [B, 1, V], the head applied to the last position only); aux is the sum
    of the layers' MoE balance losses (f32; None for the dense block).
    ``media`` [B, M, media_d]: a vlm's media embeddings (required there,
    ignored elsewhere); a cross layer follows every ``cross_attn_every``-th
    layer.
    ``on_layer(l, k, v, mc)`` receives each layer's roped K and V [B, S,
    Kv, hd] (None for "ssm") and the mixer's post-sequence
    :class:`MambaCache` (None but for ssm / hybrid): the prefill's cache
    fill.
    Where autograd records and a parameter needs a gradient, each layer runs
    under ``checkpoint`` when ``cfg.remat == "block"`` (``repro``'s
    ``jax.checkpoint`` of the layer); serving never does."""
    B, S = tokens.shape
    adt = _act_dtype(cfg)
    x = _input_rows(cfg, params, tokens, adt)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    layers = params["layers"]
    gains = _gains(layers)
    windows = _layer_windows(cfg)
    remat = cfg.remat == "block" and torch.is_grad_enabled() and _needs_grad(params)
    media_emb = _media_emb(cfg, params, media, adt)
    if media_emb is not None:
        cross, cross_gains, gates = _cross_params(params)
    aux = None
    for l in range(cfg.num_layers):
        args = (cfg, _layer(layers, l), _layer(gains, l), windows[l], x, positions,
                on_layer is not None)
        x, k, v, aux_l, mc = (checkpoint(_block, *args, use_reentrant=False) if remat
                              else _block(*args))
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        if on_layer is not None:
            on_layer(l, k, v, mc)
        if media_emb is not None and (l + 1) % cfg.cross_attn_every == 0:
            c = l // cfg.cross_attn_every
            args = (cfg, _layer(cross, c), cross_gains[c], gates[c], x, media_emb)
            x = (checkpoint(_cross_block, *args, use_reentrant=False) if remat
                 else _cross_block(*args))
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, _gain(params["final_norm"]), cfg.norm_eps)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, aux_weight: float = 0.01):
    """Next-token cross-entropy (counterpart of ``repro``'s ``loss_fn``):
    ``(ce + aux_weight * aux, {"ce": ce, "aux": aux})``.  ``batch["tokens"]``
    [B, S] int32 or int64; a vlm's ``batch["media"]`` [B, M, media_d].  The
    gold logit is ``torch.gather``, which is exactly ``repro``'s one-hot
    contraction for finite logits.  ``aux`` (the MoE balance loss summed
    over the layers) is 0 for the dense family."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, batch.get("media"))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tokens[:, 1:, None].to(torch.int64))[..., 0]
    ce = (logz - gold).mean()
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: packed KV cache, prefill + decode
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """k, v: [L, B, S, Kv, feat] in the cache format's storage (takum/OFP8
    bits, bf16 as torch.bfloat16, f32 as torch.float32, mx payload bytes);
    ``feat`` is hd, or ``payload_len(hd)`` for an mx format; an "ssm"
    config's are empty [L, B, 0, 1, 1] (f32).  pos: the next position to
    write.  conv, ssm
    (ssm and hybrid; else None): each layer's conv tail [L, B, w-1, F] and
    SSM state [L, B, nh, N, hd] (f32)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    conv: torch.Tensor | None = None
    ssm: torch.Tensor | None = None


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """The cache tensor's dtype: the IEEE formats as their float dtype (the
    values themselves, as ``repro`` stores them), the others as their wire
    storage."""
    wf = wire_format(cfg.quant.kv_cache)
    return {"bf16": torch.bfloat16, "f32": torch.float32}.get(wf.name, wf.storage)


def _cache_feat(cfg: ModelConfig, hd: int) -> int:
    """Stored width of one KV entry: the head dim, or its mx payload width."""
    if wire_format(cfg.quant.kv_cache).is_block_scaled:
        return blockscale.payload_len(hd)
    return hd


def _cache_bits(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """The cache tensor as wire bits (a bf16 cache as a 16-bit view, an f32
    one as a 32-bit view)."""
    return t.view(wire_format(cfg.quant.kv_cache).storage)


def init_cache(cfg: ModelConfig, B: int, S: int, device=None,
               conv_dtype: torch.dtype = torch.float32) -> KVCache:
    """A zero cache of S positions; ssm / hybrid configs also get zero conv
    tails (in ``conv_dtype``, ``repro``'s f32 by default; the prefill uses
    its projection's dtype, :func:`_conv_dtype`) and SSM states."""
    dev = resolve_device(device)
    L = cfg.num_layers
    conv = ssm = None
    if cfg.family in ("ssm", "hybrid"):
        d_in, N, hd = _ssm_d_in(cfg), cfg.ssm_state, cfg.ssm_head_dim
        conv = torch.zeros((L, B, cfg.ssm_conv_width - 1, d_in + 2 * N), dtype=conv_dtype,
                           device=dev)
        ssm = torch.zeros((L, B, d_in // hd, N, hd), dtype=torch.float32, device=dev)
    if cfg.family == "ssm":  # no K/V, and no KV format to resolve
        k = v = torch.zeros((L, B, 0, 1, 1), dtype=torch.float32, device=dev)
        return KVCache(k=k, v=v, pos=0, conv=conv, ssm=ssm)
    shape = (L, B, S, cfg.num_kv_heads, _cache_feat(cfg, cfg.resolved_head_dim))
    dt = _cache_dtype(cfg)
    alloc = torch.int16 if dt == torch.uint16 else dt  # zero-fill the 16-bit bits signed
    k = torch.zeros(shape, dtype=alloc, device=dev).view(dt)
    v = torch.zeros(shape, dtype=alloc, device=dev).view(dt)
    return KVCache(k=k, v=v, pos=0, conv=conv, ssm=ssm)


def _conv_dtype(cfg: ModelConfig, params) -> torch.dtype:
    """The dtype of the mixer's ``xbc`` (and so of the conv tail the prefill
    stores): the activation dtype promoted with ``in_proj``'s, f32 for a
    packed weight (K3's output)."""
    w = params["layers"]["ssm"].in_proj
    if isinstance(w, QTensor):
        wdt = w.bits.dtype if w.fmt in ("bf16", "f32") else torch.float32
    else:
        wdt = w.dtype
    return torch.promote_types(_act_dtype(cfg), wdt)


def _append_kv(cfg: ModelConfig, cache: KVCache, l: int, k: torch.Tensor, v: torch.Tensor,
               start: int, appends: int = 2) -> None:
    """Write layer ``l``'s K and V [B, S, Kv, hd] (activation dtype) into
    cache positions ``start .. start + S`` in place: one K2 launch for the
    pair (``ops.encode_into``), each batch row a run of ``S * Kv * feat``
    storage elements at a pitch of ``cache_len * Kv * feat``.

    The append is a fault surface, as ``repro``'s ``_encode_cache``: inside
    ``faults.inject`` the slots just written take ``faults.corrupt_payload``
    (an mx cache whole 33-byte groups), and under a telemetry capture the
    append counts ``kv.appends.<fmt>`` (``appends`` of them: ``repro``
    encodes a prefill's K, then its V, of all layers in one call each, a
    decode step's per layer), ``kv.specials.<fmt>`` and ``kv.bytes.<fmt>``
    over those slots.  An f32 cache is exact storage: nothing to corrupt or
    count."""
    wf = wire_format(cfg.quant.kv_cache)
    B, S, Kv, _ = k.shape
    if wf.is_block_scaled:
        k, v = blockscale.pad_block(k), blockscale.pad_block(v)

    def slots(t):
        feat = t.shape[-1]
        rows = _cache_bits(cfg, t[l]).view(B, t.shape[2] * Kv * feat)
        return rows[:, start * Kv * feat:(start + S) * Kv * feat]

    dsts = (slots(cache.k), slots(cache.v))
    ops.encode_into((k.view(B * S * Kv, -1), v.view(B * S * Kv, -1)), dsts, wf)
    if wf.name == "f32":
        return
    fc = faults.active()
    if fc is not None and fc.corrupts_wire:
        signed = wf.signed_storage  # CUDA builds of torch copy no uint16
        for d in dsts:
            d.view(signed).copy_(faults.corrupt_payload(d, wf).view(signed))
    if telemetry.enabled():
        if appends:
            telemetry.emit(f"kv.appends.{wf.name}", float(appends))
        for d in dsts:
            telemetry.emit(f"kv.specials.{wf.name}", count_specials(d, wf))
            telemetry.emit(f"kv.bytes.{wf.name}", float(d.numel() * d.element_size()))


def _decode_cache(cfg: ModelConfig, t: torch.Tensor, hd: int | None = None) -> torch.Tensor:
    """Cache storage -> f32 through K1 (the model reads the cache via K6;
    this is for inspection).  ``hd`` slices an mx payload's padding off."""
    out = ops.decode(_cache_bits(cfg, t).contiguous(), cfg.quant.kv_cache)
    return out if hd is None else out[..., :hd]


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, media=None, *,
            cache_len: int | None = None):
    """Forward over the prompt, filling a fresh packed KV cache (and the
    conv tails and SSM states).  Returns (logits [B, V] of the last
    position, cache).  ``cache_len`` > S leaves room for decode steps;
    ``media``: a vlm's media embeddings [B, M, media_d]."""
    B, S = tokens.shape
    mixer = cfg.family in ("ssm", "hybrid")
    cache = init_cache(cfg, B, cache_len or S, tokens.device,
                       _conv_dtype(cfg, params) if mixer else torch.float32)

    def on_layer(l, k, v, mc):
        if k is not None:  # the prefill's appends count as repro's two calls
            _append_kv(cfg, cache, l, k, v, 0, appends=2 if l == 0 else 0)
        if mc is not None:
            cache.conv[l].copy_(mc.conv)
            cache.ssm[l].copy_(mc.ssm)

    logits, _ = forward(cfg, params, tokens, media, last_only=True, on_layer=on_layer)
    cache.pos = S
    return logits[:, 0], cache


def _mixer_step(cfg: ModelConfig, pr, h, cache: KVCache, l: int):
    """The mixer's decode step over h [B, d] on layer ``l``'s conv tail and
    SSM state, both updated in place; returns y [B, d] (f32-promoted)."""
    y, mc = mamba_decode_step(pr, h, MambaCache(cache.conv[l], cache.ssm[l]),
                              N=cfg.ssm_state, hd=cfg.ssm_head_dim)
    cache.conv[l].copy_(mc.conv)
    cache.ssm[l].copy_(mc.ssm)
    return y


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: KVCache, media=None):
    """One decode step: token [B] -> (logits [B, V], cache).  Appends this
    position's K/V to ``cache`` in place (before attention reads it, as
    ``repro`` does), steps each layer's conv tail and SSM state in place,
    and advances ``cache.pos``.  An "ssm" cache has no positions to fill.
    A vlm projects ``media`` [B, M, media_d] and each cross layer's media
    K/V anew in this step, as ``repro`` does."""
    B = token.shape[0]
    S = cache.k.shape[2]
    pos = cache.pos
    if cfg.family != "ssm" and pos >= S:
        raise ValueError(f"KV cache is full ({S} positions)")
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    adt = _act_dtype(cfg)
    x = _input_rows(cfg, params, token, adt)
    positions = torch.full((B, 1), pos, device=token.device)
    layers = params["layers"]
    gains = _gains(layers)
    windows = _layer_windows(cfg)
    media_emb = _media_emb(cfg, params, media, adt)
    if media_emb is not None:
        cross, cross_gains, gates = _cross_params(params)
    for l in range(cfg.num_layers):
        lp, gl = _layer(layers, l), _layer(gains, l)
        in_dtype = x.dtype
        if cfg.family == "ssm":
            y = _mixer_step(cfg, lp["ssm"], rms_norm(x, gl["ln1"], cfg.norm_eps), cache, l)
            x = (x + y).to(in_dtype)
            continue
        a = lp["attn"]
        h = rms_norm(x, gl["ln1"], cfg.norm_eps)[:, None]  # [B, 1, d]
        q = rope(linear(h, a["wq"]).reshape(B, 1, H, hd), positions, cfg.rope_theta)
        k_new = rope(linear(h, a["wk"]).reshape(B, 1, Kv, hd), positions, cfg.rope_theta)
        v_new = linear(h, a["wv"]).reshape(B, 1, Kv, hd)
        _append_kv(cfg, cache, l, k_new, v_new, pos)
        o = ops.decode_attention(
            q[:, 0].to(torch.float32),
            _cache_bits(cfg, cache.k[l]).permute(0, 2, 1, 3),  # [B, Kv, S, feat] view
            _cache_bits(cfg, cache.v[l]).permute(0, 2, 1, 3),
            cfg.quant.kv_cache, length=pos + 1, window=windows[l],
            softcap=cfg.attn_softcap, scale=hd ** -0.5,
        )
        attn_out = linear(o.reshape(B, 1, H * hd).to(h.dtype), a["wo"])[:, 0]
        if cfg.family == "hybrid":
            attn_out = 0.5 * (attn_out + _mixer_step(cfg, lp["ssm"], h[:, 0], cache, l))
        x = _residual(cfg, x, attn_out, gl, "ln1_post")
        h2 = rms_norm(x, gl["ln2"], cfg.norm_eps)
        if cfg.family == "moe":  # [B, 1, d], as repro passes it
            out = _mlp_or_moe(cfg, lp, h2[:, None])[0][:, 0]
        else:
            out = _mlp_or_moe(cfg, lp, h2)[0]
        x = _residual(cfg, x, out, gl, "ln2_post").to(in_dtype)
        if media_emb is not None and (l + 1) % cfg.cross_attn_every == 0:
            c = l // cfg.cross_attn_every
            x = _cross_block(cfg, _layer(cross, c), cross_gains[c], gates[c], x[:, None],
                             media_emb)[:, 0]
    cache.pos = pos + 1
    x = rms_norm(x, _gain(params["final_norm"]), cfg.norm_eps)
    return _head(cfg, params, x), cache
