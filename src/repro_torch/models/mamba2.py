"""Mamba-2 mixer (SSD, state-space duality, arXiv:2405.21060): counterpart
of ``repro.models.mamba2``, plain PyTorch as ``repro``'s is plain jnp.

Prefill and training run the chunked SSD: within each chunk of ``chunk``
positions a quadratic, attention-like term masked by ``tril``, and across
chunks a state recurrence (``repro``'s ``lax.scan``; here a Python loop over
the chunks that keeps the state *entering* each chunk).  Decode carries a
constant-size recurrent state per layer: the SSM state ``[B, nh, N, hd]``
(f32) and the conv tail ``[B, w - 1, d_in + 2N]``, the last ``w - 1``
*pre-conv* features.  Scalar-identity A per head, one group of B / C, a
causal depthwise conv over ``[x | B | C]``.

The two projections follow jnp's type promotion, as ``repro``'s serve step
multiplies against dequantized f32 weights: ``u @ in_proj`` and
``y @ out_proj`` are :func:`~.layers.promoted_linear` (K3 over a packed
weight, its f32 output kept in f32), so under bf16 activations ``z``,
``xbc`` and ``dt`` are f32, the gated norm's ``y * silu(z)`` is f32 after
``y`` was rounded to u's dtype, and the mixer's output is f32.  The small
leaves (``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``D``, ``norm_g``)
are read as tensors; a packed one is decoded where it is read
(``serve.load_params`` decodes them once).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.quant.qtensor import QTensor
from .layers import promoted_linear


class MambaParams(NamedTuple):
    """One mixer's parameters, in ``repro``'s field order (which is also
    ``repro_torch.tree``'s and jax's leaf order).  Stacked over layers in a
    model tree: every leaf gains a leading L axis."""

    in_proj: Any  # [d_model, 2*d_in + 2*N + nh]  (z, x, B, C, dt)
    conv_w: Any  # [w, d_in + 2*N] depthwise
    conv_b: Any  # [d_in + 2*N]
    a_log: Any  # [nh]
    dt_bias: Any  # [nh]
    D: Any  # [nh]
    norm_g: Any  # [d_in] gated RMSNorm weight
    out_proj: Any  # [d_in, d_model]


#: the leaves no matmul reads: decoded once by ``serve.load_params``
SMALL_LEAVES = ("conv_w", "conv_b", "a_log", "dt_bias", "D", "norm_g")


class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, w-1, d_in + 2N], the dtype of the projection's xbc
    ssm: torch.Tensor  # [B, nh, N, hd] float32


def init_mamba_cache(B: int, d_in: int, N: int, hd: int, w: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    nh = d_in // hd
    return MambaCache(conv=torch.zeros((B, w - 1, d_in + 2 * N), dtype=dtype, device=device),
                      ssm=torch.zeros((B, nh, N, hd), dtype=torch.float32, device=device))


def _plain(t) -> torch.Tensor:
    return t.dequantize() if isinstance(t, QTensor) else t


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split(pr: MambaParams, u: torch.Tensor, d_in: int, N: int):
    zxbcdt = promoted_linear(u, pr.in_proj)
    return zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N], zxbcdt[..., 2 * d_in + 2 * N:]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor, eps: float = 1e-5):
    y = y * _silu(z)
    yf = y.to(torch.float32)
    s = torch.rsqrt(torch.mean(torch.square(yf), -1, keepdim=True) + eps)
    return (yf * s * (1.0 + g.to(torch.float32))).to(y.dtype)


def mamba_forward(pr: MambaParams, u: torch.Tensor, *, N: int, hd: int, chunk: int,
                  return_state: bool = False):
    """u [B, S, d_model] -> [B, S, d_model] (prefill / training, chunked
    SSD; S a multiple of ``chunk``).  ``return_state=True`` also returns the
    exact post-sequence :class:`MambaCache` (the conv tail: the last
    ``w - 1`` pre-conv features, zero rows where S < w - 1; the final SSM
    state), so a prefill needs no replay."""
    B, S, _ = u.shape
    d_in = pr.out_proj.shape[0]
    nh = d_in // hd
    conv_w, conv_b = _plain(pr.conv_w), _plain(pr.conv_b)
    w = conv_w.shape[0]

    z, xbc, dt = _split(pr, u, d_in, N)
    # causal depthwise conv over the feature-grouped [x | B | C]
    xp = torch.cat([xbc.new_zeros((B, w - 1, xbc.shape[-1])), xbc], dim=1)
    xc = xp[:, 0:S] * conv_w[0]
    for i in range(1, w):
        xc = xc + xp[:, i:i + S] * conv_w[i]
    xc = _silu(xc + conv_b)
    x, Bm, Cm = xc[..., :d_in], xc[..., d_in:d_in + N], xc[..., d_in + N:]

    a = -torch.exp(_plain(pr.a_log).to(torch.float32))  # [nh], negative
    dt = _softplus(dt.to(torch.float32) + _plain(pr.dt_bias))  # [B, S, nh]

    nc, Q = S // chunk, chunk
    xh = x.reshape(B, nc, Q, nh, hd).to(torch.float32)
    Bc = Bm.reshape(B, nc, Q, N).to(torch.float32)
    Cc = Cm.reshape(B, nc, Q, N).to(torch.float32)
    dtc = dt.reshape(B, nc, Q, nh)
    cum = torch.cumsum(a * dtc, dim=2)  # within-chunk cumulative log-decay

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # [B, nc, Qi, Qj, nh]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    gate = scores[..., None] * decay * dtc[:, :, None, :, :]  # [B, nc, Qi, Qj, nh]
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", gate, xh)

    # chunk summaries: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    last = cum[:, :, -1:, :]  # [B, nc, 1, nh]
    w_j = torch.exp(last - cum) * dtc  # [B, nc, Q, nh]
    S_c = torch.einsum("bcjn,bcjhd->bchnd", Bc, w_j[..., None] * xh)  # [B, nc, nh, N, hd]

    # inter-chunk recurrence H_c = exp(sum adt_c) H_{c-1} + S_c, keeping the
    # state *before* each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])  # [B, nc, nh]
    H = torch.zeros((B, nh, N, hd), dtype=torch.float32, device=u.device)
    prev = []
    for c in range(nc):
        prev.append(H)
        H = H * chunk_decay[:, c, :, None, None] + S_c[:, c]
    H_prev = torch.stack(prev, dim=1)  # [B, nc, nh, N, hd]

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) H_prev)
    y_inter = torch.einsum("bcin,bchnd->bcihd", Cc, H_prev) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    y = y + _plain(pr.D)[None, None, :, None] * x.reshape(B, S, nh, hd).to(torch.float32)
    y = _gated_norm(y.reshape(B, S, d_in).to(u.dtype), z, _plain(pr.norm_g))
    out = promoted_linear(y, pr.out_proj)
    if not return_state:
        return out
    return out, MambaCache(conv=xp[:, S:], ssm=H)


def mamba_decode_step(pr: MambaParams, u: torch.Tensor, cache: MambaCache, *, N: int, hd: int):
    """u [B, d_model], one token -> (y [B, d_model], the new cache).  O(1)
    in S.  ``cache`` is read, not written."""
    B = u.shape[0]
    d_in = pr.out_proj.shape[0]
    nh = d_in // hd

    z, xbc, dt = _split(pr, u, d_in, N)
    cdt = torch.promote_types(cache.conv.dtype, xbc.dtype)  # jnp.concatenate's promotion
    conv_in = torch.cat([cache.conv.to(cdt), xbc[:, None, :].to(cdt)], dim=1)  # [B, w, F]
    conv_w = _plain(pr.conv_w)
    edt = torch.promote_types(cdt, conv_w.dtype)  # jnp.einsum's promotion
    xc = _silu(torch.einsum("bwf,wf->bf", conv_in.to(edt), conv_w.to(edt)) + _plain(pr.conv_b))
    x, Bm, Cm = xc[..., :d_in], xc[..., d_in:d_in + N], xc[..., d_in + N:]

    a = -torch.exp(_plain(pr.a_log).to(torch.float32))
    dtv = _softplus(dt.to(torch.float32) + _plain(pr.dt_bias))  # [B, nh]
    dec = torch.exp(a * dtv)

    xhead = x.reshape(B, nh, hd).to(torch.float32)
    upd = Bm.to(torch.float32)[:, None, :, None] * (dtv[:, :, None] * xhead)[:, :, None, :]
    ssm = cache.ssm * dec[..., None, None] + upd  # [B, nh, N, hd]
    y = torch.einsum("bn,bhnd->bhd", Cm.to(torch.float32), ssm)
    y = y + _plain(pr.D)[None, :, None] * xhead
    y = _gated_norm(y.reshape(B, d_in).to(u.dtype), z, _plain(pr.norm_g))
    return promoted_linear(y, pr.out_proj), MambaCache(conv=conv_in[:, 1:], ssm=ssm)
