"""Causal self-attention forward for the prefill (counterpart of the
forward of ``repro.models.attention.flash_attention``).

``repro`` runs an online softmax over KV chunks of ``chunk_kv`` keys inside
a ``lax.scan``; with one chunk that is exactly the masked softmax below, and
with more chunks it differs in rounding only.  This is plain PyTorch, not a
kernel: the reference is jnp, not Pallas.  The backward waits for the
training slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, window: int = 0, causal: bool = True, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's dtype.

    Query head h attends kv head h // (H // Hkv).  ``window`` > 0 limits
    each query to the ``window`` most recent keys; ``q_offset`` is the
    absolute position of q[:, 0].
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = (q * D ** -0.5).to(torch.float32).transpose(1, 2)  # [B, H, Sq, D]
    kf = k.to(torch.float32).transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.to(torch.float32).transpose(1, 2).repeat_interleave(g, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2))  # [B, H, Sq, Sk]
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(logits - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, vf) / l
    return out.transpose(1, 2).to(q.dtype)
