"""Causal self-attention for the prefill and for training (counterpart of
``repro.models.attention.flash_attention`` and its custom VJP).

``repro`` runs an online softmax over KV chunks of ``chunk_kv`` keys inside
a ``lax.scan``; with one chunk that is exactly the masked softmax below, and
with more chunks it differs in rounding only.  Its backward
(``_flash_bwd``) rebuilds the probabilities from the saved row logsumexp,
with ``delta = sum(dO * O)``; :class:`FlashAttention` is that backward over
the whole key range at once (one chunk).  This is plain PyTorch, not a
kernel: the reference is jnp, not Pallas.  Serving calls the forward alone
(no input needs a gradient there).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(Sq: int, Sk: int, window: int, causal: bool, q_offset: int, device) -> torch.Tensor:
    """[Sq, Sk] bool, True where query i attends key j."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> f32 [B, Hkv * g, S, D], kv head h // g for query head h."""
    return t.to(torch.float32).transpose(1, 2).repeat_interleave(g, dim=1)


def _forward(q, k, v, window, causal, softcap, q_offset):
    """(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = (q * D ** -0.5).to(torch.float32).transpose(1, 2)  # [B, H, Sq, D]
    logits = torch.matmul(qf, _heads(k, g).transpose(-1, -2))  # [B, H, Sq, Sk]
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _mask(Sq, Sk, window, causal, q_offset, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(logits - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, _heads(v, g)) / l
    lse = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is ``repro``'s ``_flash_bwd`` over one chunk:
    p rebuilt from the saved lse, ``delta = sum(dO * O)``, the softcap's
    derivative ``1 - tanh^2`` at the raw logits, the masked entries' grads
    zeroed, and dk / dv folded over the query groups onto the kv heads."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, softcap, q_offset):
        out, lse = _forward(q, k, v, window, causal, softcap, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, causal, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, causal, softcap, q_offset = ctx.args
        B, Sq, H, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        g = H // Hkv
        scale = D ** -0.5
        qf = q.to(torch.float32).transpose(1, 2)  # [B, H, Sq, D], unscaled
        do = dout.to(torch.float32).transpose(1, 2)
        delta = torch.sum(do * out.to(torch.float32).transpose(1, 2), dim=-1)  # [B, H, Sq]
        kf, vf = _heads(k, g), _heads(v, g)  # [B, H, Sk, D]
        raw = torch.matmul(qf * scale, kf.transpose(-1, -2))
        capped = softcap * torch.tanh(raw / softcap) if softcap > 0 else raw
        mask = _mask(Sq, Sk, window, causal, q_offset, q.device)
        p = torch.exp(torch.where(mask, capped, torch.full_like(capped, NEG_INF))
                      - lse[..., None])
        dv = torch.matmul(p.transpose(-1, -2), do)  # [B, H, Sk, D]
        dp = torch.matmul(do, vf.transpose(-1, -2))
        dcap = p * (dp - delta[..., None])
        if softcap > 0:
            t = torch.tanh(raw / softcap)
            dcap = dcap * (1.0 - t * t)
        draw = torch.where(mask, dcap * scale, torch.zeros_like(dcap))
        dq = torch.matmul(draw, kf)
        dk = torch.matmul(draw.transpose(-1, -2), qf)

        def fold(t):  # [B, H, Sk, D] -> [B, Sk, Hkv, D], summed over the group
            return t.reshape(B, Hkv, g, Sk, D).sum(2).transpose(1, 2)

        return (dq.transpose(1, 2).to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype),
                None, None, None, None)


def flash_attention(q, k, v, window: int = 0, causal: bool = True, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's dtype.

    Query head h attends kv head h // (H // Hkv).  ``window`` > 0 limits
    each query to the ``window`` most recent keys; ``q_offset`` is the
    absolute position of q[:, 0].  Differentiable (:class:`FlashAttention`)
    where autograd records and an input needs a gradient.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, window, causal, softcap, q_offset)
    return _forward(q, k, v, window, causal, softcap, q_offset)[0]
