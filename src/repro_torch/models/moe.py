"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): top-k
token-choice routing with per-group capacity, always-on shared experts and
the switch balance loss.

``repro`` dispatches through one-hot einsums (the shardable TPU form).  The
port computes the same function with gathers:

- **Router.** ``x.f32 @ router.f32``: K3 with f32 x over a packed ``[d, E]``
  router, else one ``torch.matmul`` in f32; then the softmax in f32.
- **Top-k** of the probs by a stable descending sort: among equal probs the
  lower expert index comes first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` promises no order on CUDA).  The gates are the top-k probs
  over ``max(sum, 1e-9)``.
- **Capacity.** One group per batch row; ``C = max(int(cf * k * S / E), 1)``
  with S the call's own sequence length (1 in a decode step).  The slot of a
  (token, j) pair is its rank among the earlier claims on its expert in the
  group's s-major (s, j) order (``repro``'s cumsum); a pair whose rank is
  C or more is dropped.
- **Dispatch** gathers each kept pair's token row into a capacity buffer
  ``[E, B*C, d]`` in the activation dtype: each expert's rows are one
  contiguous operand, empty slots zero rows.  For finite inputs the rows
  equal ``repro``'s one-hot contraction exactly.
- **Experts.** Each expert is three launches over ``w[e]``, a contiguous
  ``[d, f]`` (``[f, d]``) slice of the stacked leaf, its per-leaf scale
  kept: ``h = silu(xe @ wg) * (xe @ wi)``, ``ye = h @ wo``.  Every expert
  runs, the empty ones too (no host sync finds them), as ``repro``'s dense
  dispatch does.
- **Combine.** Each token's output is the sum over its k pairs of the
  gate, rounded to the activation dtype as ``repro`` rounds it, times the
  pair's expert row (zero for a dropped pair), in j's order: a weighted
  scatter-add written as a gather, so no two writes race.
- **Shared experts** (kimi): ``(silu(x @ wg_s) * (x @ wi_s)) @ wo_s``, added
  after the routed sum.
- **Balance loss** ``E * sum(mean(probs) * routed_fraction)``, the routed
  fraction counting every top-k choice, kept or dropped.

The products follow jnp's type promotion (``layers.promoted_linear``), as
``repro``'s einsums over its serve step's dequantised f32 weights do, not
``layers.linear``: a packed
weight's K3 output stays in f32 (x's dtype as given: bf16 x is exact in
K3's f32 products), so under bf16 activations ``h``, ``ye`` and the sum are
f32 and the ``wo`` launch takes f32 x; a plain weight multiplies in the
promoted dtype of x and w (bf16 x bf16 stays bf16, as in ``repro``).

The dispatch's and combine's gathers carry their own backward
(:class:`_Gather`): the transposed gather through the inverse index and a
sum in a fixed order, with no scatter, so a training step gives the same
bits on every run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import promoted_linear


def _silu(g: torch.Tensor) -> torch.Tensor:
    return g * torch.sigmoid(g)


def lax_top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, largest first, equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(capacity_factor: float, k: int, S: int, E: int) -> int:
    """Slots per expert and group: ``repro``'s ``max(int(cf * k * S / E), 1)``."""
    return max(int(capacity_factor * k * S / E), 1)


def slot_positions(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """gate_idx [B, S, k] -> the rank of each (s, j) pair among the earlier
    claims of its group (batch row) on the same expert, in s-major (s, j)
    order ([B, S, k], int64)."""
    B, S, k = gate_idx.shape
    sel = F.one_hot(gate_idx.reshape(B, S * k), E)  # [B, S*k, E]
    return ((torch.cumsum(sel, 1) * sel).sum(-1) - 1).reshape(B, S, k)


def _take(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``src[index]``, a zero row where ``index == len(src)``."""
    n = src.shape[0]
    rows = src.index_select(0, index.clamp(max=max(n - 1, 0)))
    return rows.masked_fill((index == n)[:, None], 0)


class _Gather(torch.autograd.Function):
    """``rows = src[index]`` (a zero row where ``index == len(src)``), whose
    backward is a gather too: ``grad_src[r] = sum_j grad_rows[inverse[r, j]]``
    over the rows that read r (``inverse [len(src), m]``, ``len(rows)``
    where fewer than m do), summed in j's order."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _take(src, index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        n, m = inverse.shape
        return _take(g.contiguous(), inverse.reshape(-1)).reshape(n, m, -1).sum(1), None, None


class Routing:
    """The routing of one call over ``B`` groups of ``S`` tokens: the kept
    pairs' slots in the ``[E, B*C]`` capacity buffer, and the inverse maps
    the dispatch and combine gather through.  ``gate_idx`` and ``keep``
    (the pairs inside capacity) are [B, S, k]."""

    def __init__(self, gate_idx: torch.Tensor, E: int, C: int):
        B, S, k = gate_idx.shape
        self.E, self.C, self.B, self.S, self.k = E, C, B, S, k
        pos = slot_positions(gate_idx, E)
        self.keep = pos < C
        rows, pairs = E * B * C, B * S * k
        b = torch.arange(B, device=gate_idx.device)[:, None, None]
        slot = gate_idx * (B * C) + b * C + pos
        #: each pair's row of the buffer, ``rows`` where dropped
        self.pair_slot = torch.where(self.keep, slot, rows).reshape(-1)
        # each buffer row's pair (``pairs`` where empty): dropped pairs all
        # write the extra entry, which is cut off
        slot_pair = torch.full((rows + 1,), pairs, dtype=torch.int64, device=gate_idx.device)
        slot_pair.scatter_(0, self.pair_slot, torch.arange(pairs, device=gate_idx.device))
        self.slot_pair = slot_pair[:rows]
        #: each buffer row's token (``B*S`` where empty)
        self.slot_token = torch.where(self.slot_pair < pairs, self.slot_pair // k, B * S)

    def dispatch(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, d] -> the capacity buffer [E, B*C, d] in x's dtype."""
        d = x.shape[-1]
        xe = _Gather.apply(x.reshape(-1, d), self.slot_token, self.pair_slot.view(-1, self.k))
        return xe.view(self.E, self.B * self.C, d)

    def combine(self, ye: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
        """ye [E, B*C, d], gates [B, S, k] -> [B, S, d]: each token's gated sum
        of its pairs' rows (products and sum in f32, as a dot of ``repro``'s
        accumulates), in the promoted dtype of ye and gates."""
        d = ye.shape[-1]
        rows = _Gather.apply(ye.reshape(-1, d), self.pair_slot, self.slot_pair.view(-1, 1))
        rows = rows.view(self.B * self.S, self.k, d).to(torch.float32)
        w = gates.reshape(self.B * self.S, self.k, 1).to(torch.float32)
        y = (rows * w).sum(1).to(torch.promote_types(ye.dtype, gates.dtype))
        return y.view(self.B, self.S, d)


def moe_block(x: torch.Tensor, router_w, wi, wg, wo, shared, *, top_k: int,
              capacity_factor: float, trace=None):
    """x [B, S, d] -> (y [B, S, d], aux), ``repro``'s ``moe_block``.

    router_w [d, E]; wi / wg [E, d, f]; wo [E, f, d] (packed QTensors or
    tensors); shared None or (wi_s [d, fs], wg_s [d, fs], wo_s [fs, d]).
    ``trace``, a dict, receives the routing (``gate_idx``, ``keep``,
    ``probs``) for inspection."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    k = top_k
    logits = promoted_linear(x.to(torch.float32), router_w).to(torch.float32)  # [B, S, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = lax_top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    route = Routing(gate_idx, E, capacity(capacity_factor, k, S, E))
    xe = route.dispatch(x)
    ye = []
    for e in range(E):
        h = _silu(promoted_linear(xe[e], wg[e])) * promoted_linear(xe[e], wi[e])
        ye.append(promoted_linear(h, wo[e]))
    y = route.combine(torch.stack(ye), gate_vals.to(x.dtype))

    if shared is not None:
        wi_s, wg_s, wo_s = shared
        y = y + promoted_linear(_silu(promoted_linear(x, wg_s)) * promoted_linear(x, wi_s), wo_s)

    aux = load_balance_loss(probs.reshape(-1, E), gate_idx.reshape(-1, k), E, k)
    if trace is not None:
        trace.update(gate_idx=gate_idx, keep=route.keep, probs=probs)
    return y, aux


def load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor, E: int, top_k: int):
    """Switch-style auxiliary load-balancing loss, ``repro``'s
    ``_load_balance_loss``: probs [N, E], gate_idx [N, k]."""
    me = probs.mean(0)  # [E] mean router prob
    ce = F.one_hot(gate_idx, E).sum(1).to(torch.float32).mean(0) / top_k  # [E] routed fraction
    return E * torch.sum(me * ce)
