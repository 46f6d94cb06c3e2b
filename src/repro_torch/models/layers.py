"""Common model layers (counterpart of ``repro.models.layers``): RMSNorm,
RoPE, SwiGLU, ``linear`` over packed or plain weights, ``linear_t`` (the
tied head's ``x @ embed.T`` of ``repro.models.transformer``) and
``promoted_linear`` (the ``x @ w`` that ``repro``'s MoE and Mamba-2 blocks
write with jnp's type promotion)."""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.quant.qtensor import QTensor


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w [K, N] in x's dtype with f32 accumulation.

    A packed ``QTensor`` weight goes through K3 (``ops.matmul``; an mx
    weight's payload is blocked along N), whose f32 output takes the pow2
    scale (exact) and is then cast to x's dtype; K3
    keeps the decoded weights in f32, where ``repro`` rounds them to x's
    dtype first.  A plain (bf16/f32) weight is one ``torch.matmul`` in x's
    dtype, as XLA does it in ``repro``.
    """
    if isinstance(w, QTensor) and w.fmt not in ("bf16", "f32"):
        y = w.apply_scale(ops.matmul(x.reshape(-1, x.shape[-1]), w.bits, w.fmt, n=w.n))
        return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])
    if isinstance(w, QTensor):
        w = w.bits
    return torch.matmul(x, w.to(x.dtype))


def promoted_linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` under jnp's type promotion: a packed
    ``QTensor`` through K3 on x as given (f32 or bf16), its f32 output times
    the pow2 scale and kept in f32 (``repro`` dequantizes the weight to f32
    before its ``@`` or einsum); a plain weight (a tensor, or a bf16 / f32
    QTensor) through one ``torch.matmul`` in the promoted dtype of x and
    w."""
    if isinstance(w, QTensor) and w.fmt not in ("bf16", "f32"):
        y = w.apply_scale(ops.matmul(x.reshape(-1, x.shape[-1]), w.bits, w.fmt, n=w.n))
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if isinstance(w, QTensor):
        w = w.bits
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def linear_t(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w.T for w [N, K] (a tied head over the embedding
    table), in x's dtype with f32 accumulation, under ``linear``'s contract.

    A flat packed ``QTensor`` goes through the transposed K3
    (``ops.matmul_t``) on x cast to f32 (exact), which reads the stored
    bits in place: no transposed copy.  Its f32 output takes the pow2 scale,
    then the cast to x's dtype (``repro`` rounds the head's product to x's
    dtype before widening the logits).  An mx weight's payload is blocked
    along K, which the transposed K3 cannot read, so the table is decoded
    through K1-mx (``ops.decode``) and multiplied by one ``torch.matmul``:
    ``repro``'s own ``x @ head`` over the decoded table, one K1-mx launch a
    call.  A plain (bf16/f32) weight is one ``torch.matmul`` in x's dtype.
    """
    if isinstance(w, QTensor) and w.fmt not in ("bf16", "f32"):
        if w.block_scaled:
            table = ops.decode(w.bits, w.fmt)[..., :w.n]
            return torch.matmul(x, table.T.to(x.dtype))
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        y = w.apply_scale(ops.matmul_t(x2, w.bits, w.fmt))
        return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])
    if isinstance(w, QTensor):
        w = w.bits
    return torch.matmul(x, w.T.to(x.dtype))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    s = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return ((xf * s) * (1.0 + gamma.to(torch.float32))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x [..., S, H, D] (D even), positions [..., S].

    The frequencies are ``exp(-log(theta) * i / half)`` in f32, the formula
    of ``repro`` (not ``theta ** x``)."""
    D = x.shape[-1]
    half = D // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(-log_theta * (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, wi, wg, wo) -> torch.Tensor:
    g = linear(x, wg)
    return linear(g * torch.sigmoid(g) * linear(x, wi), wo)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap and cap > 0 else x
