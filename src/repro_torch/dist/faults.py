"""Deterministic, seedable numeric-fault injection (counterpart of the
single-device half of ``repro.dist.faults``): a context manager under which
the port's fault surfaces run corrupted, with no change at the call sites.

Fault classes (rates are probabilities):

* **payload bit flips**: each word of an encoded payload (a byte of an
  8-bit or mx payload, a 16- or 32-bit word otherwise) is hit with
  ``bit_flip_rate``; a hit XORs one uniformly chosen bit.
* **E8M0 scale-byte corruption**: each 33-byte mx group's scale byte is hit
  with ``scale_flip_rate`` (one bit flipped) and with ``scale_nan_rate``
  forced to 255, the NaN scale (the whole block decodes NaN).  Element
  flips never touch the scale byte.
* **NaN / Inf poisoning**: :func:`poison_grads` hits a step's gradients with
  probability ``grad_poison_rate`` (a ``poison_frac`` share of each leaf's
  elements becomes ``poison_value``); :func:`poison` poisons any tensor.

The surfaces: the KV append (``models/transformer.py``: the slots just
written, after the K2 launch) and the train step (``train/step.py``: the
gradients after the backward).  Each hook reads :func:`active` first, so
outside :func:`inject` it returns its input untouched and adds no op.

Determinism: draws come from explicit ``torch.Generator`` objects on the
payload's device, seeded from (``FaultConfig.seed``, the call site's
number within the :func:`inject` scope, a hash of the payload's content);
:func:`poison_grads` seeds from the seed and the step's key instead.  The
same seed and data give the same faults on one device; the draws differ
from ``repro``'s (jax's PRNG) and from another device type's.  The content
hash is read back to the host, a sync that happens inside :func:`inject`
only.  Where a test holds this mechanism against ``repro``'s, it feeds
``repro``'s hit pattern through :func:`xor_bits`.

Not here yet: ``corrupt_hop`` (dropped and garbled ring hops) waits for
the port's collectives (dist, M7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch

from repro_torch import tree
from repro_torch.core.formats import wire_format


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    seed: int = 0
    bit_flip_rate: float = 0.0  # per payload byte/word: XOR one random bit
    scale_flip_rate: float = 0.0  # per mx scale byte: XOR one random bit
    scale_nan_rate: float = 0.0  # per mx scale byte: force 255 (NaN scale)
    hop_drop_rate: float = 0.0  # per ring/pipe hop: message zeroed (dist)
    hop_garble_rate: float = 0.0  # per hop: payload bytes garbled (dist)
    grad_poison_rate: float = 0.0  # per step: gradient payload poisoned
    poison_frac: float = 1e-3  # fraction of elements hit when poisoned
    poison_value: float = float("nan")  # NaN or +-Inf

    @property
    def corrupts_wire(self) -> bool:
        return self.bit_flip_rate > 0 or self.scale_flip_rate > 0 or self.scale_nan_rate > 0

    @property
    def corrupts_hops(self) -> bool:
        return self.hop_drop_rate > 0 or self.hop_garble_rate > 0


_ACTIVE: FaultConfig | None = None
_SITE = itertools.count()


def active() -> FaultConfig | None:
    """The FaultConfig of the innermost :func:`inject` scope, or None."""
    return _ACTIVE


@contextlib.contextmanager
def inject(cfg: FaultConfig):
    """Activate fault injection for the code run within the scope."""
    global _ACTIVE, _SITE
    prev = _ACTIVE
    _ACTIVE = cfg
    _SITE = itertools.count()  # fresh site streams per scope: reproducible
    try:
        yield cfg
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# randomness plumbing
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each part in turn)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & _M64)) * 0xBF58476D1CE4E5B9 & _M64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _M64
        h ^= h >> 31
    return h >> 1


def _codes(payload: torch.Tensor) -> torch.Tensor:
    """The payload's words as non-negative int64 (any 1-, 2- or 4-byte
    dtype: unsigned storage, its signed view, bf16 or f32)."""
    signed = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[payload.element_size()]
    return payload.view(signed).to(torch.int64) & ((1 << (8 * payload.element_size())) - 1)


def content_hash(payload: torch.Tensor) -> int:
    """``sum(word * 2654435761) mod 2**32`` over the payload (``repro``'s
    content hash; integer wraparound makes it independent of the sum's
    order), read back to the host."""
    return int((_codes(payload) * 2654435761).sum().item()) & 0xFFFFFFFF


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _site_seed(cfg: FaultConfig) -> int:
    """A fresh per-call-site seed."""
    return mix(cfg.seed, next(_SITE))


# ---------------------------------------------------------------------------
# corruption ops (shape- and dtype-preserving; new tensors, never in place)
# ---------------------------------------------------------------------------


def xor_bits(payload: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """``payload`` XOR ``pattern`` (non-negative integer words of the
    payload's width, e.g. one set bit per hit), in the payload's dtype."""
    nbits = 8 * payload.element_size()
    signed = {8: torch.uint8, 16: torch.int16, 32: torch.int32}[nbits]
    p = pattern.to(device=payload.device, dtype=torch.int64) & ((1 << nbits) - 1)
    if nbits > 8:  # wrap into the signed view's range
        p = torch.where(p >= 1 << (nbits - 1), p - (1 << nbits), p)
    return (payload.view(signed) ^ p.to(signed)).view(payload.dtype)


def flip_bits(payload: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Hit each word with probability ``rate``; a hit XORs one random bit.
    The draws are keyed by ``seed`` and the payload's content."""
    if rate <= 0:
        return payload
    g = _generator(mix(seed, content_hash(payload)), payload.device)
    hit = torch.rand(payload.shape, generator=g, device=payload.device) < rate
    idx = torch.randint(0, 8 * payload.element_size(), payload.shape, generator=g,
                        device=payload.device)
    return xor_bits(payload, torch.where(hit, torch.ones_like(idx) << idx, 0))


def _groups(payload: torch.Tensor) -> torch.Tensor:
    L = payload.shape[-1]
    if L % 33:
        raise ValueError(f"mx payload last dim {L} is not a multiple of 33")
    return payload.reshape(*payload.shape[:-1], L // 33, 33)


def _corrupt_scale_bytes(payload: torch.Tensor, seed: int, cfg: FaultConfig) -> torch.Tensor:
    """mx payloads only: hit the leading byte of each 33-byte group."""
    grp = _groups(payload)
    scales, elems = grp[..., 0], grp[..., 1:]
    k = mix(seed, content_hash(payload))
    scales = flip_bits(scales, mix(k, 1), cfg.scale_flip_rate)
    if cfg.scale_nan_rate > 0:
        g = _generator(mix(k, 2), payload.device)
        hit = torch.rand(scales.shape, generator=g, device=payload.device) < cfg.scale_nan_rate
        scales = torch.where(hit, scales.new_full((), 255), scales)
    return torch.cat([scales[..., None], elems], dim=-1).reshape(payload.shape)


def corrupt_payload(payload: torch.Tensor, fmt) -> torch.Tensor:
    """The active config's payload faults applied to an encoded wire payload
    of format ``fmt`` (an mx payload also takes the scale-byte faults on
    the leading byte of each 33-byte group; its element flips skip that
    byte).  Returns ``payload`` itself outside :func:`inject`."""
    cfg = _ACTIVE
    if cfg is None or not cfg.corrupts_wire:
        return payload
    seed = _site_seed(cfg)
    if not wire_format(fmt).is_block_scaled:
        return flip_bits(payload, seed, cfg.bit_flip_rate)
    out = payload
    if cfg.bit_flip_rate > 0:
        grp = _groups(payload)
        elems = flip_bits(grp[..., 1:].contiguous(), mix(seed, 1), cfg.bit_flip_rate)
        out = torch.cat([grp[..., :1], elems], dim=-1).reshape(payload.shape)
    return _corrupt_scale_bytes(out, mix(seed, 2), cfg)


def poison(x: torch.Tensor, key: int, rate: float, value=float("nan")) -> torch.Tensor:
    """Set a ``rate`` share of the elements of ``x`` to ``value`` (NaN / Inf
    poisoning of an activation or a gradient), drawn from ``key``."""
    if rate <= 0:
        return x
    hit = torch.rand(x.shape, generator=_generator(mix(key), x.device), device=x.device) < rate
    return torch.where(hit, x.new_full((), value), x)


def poison_grads(grads, key: int):
    """Per-step gradient poisoning: with probability ``grad_poison_rate``
    (one draw on the host) this step's gradient tree gets a ``poison_frac``
    share of each leaf's elements set to ``poison_value``.  ``key`` must
    advance per step (the train step passes its rng).  Returns ``grads``
    itself outside :func:`inject` and on a step the draw spares."""
    cfg = _ACTIVE
    if cfg is None or cfg.grad_poison_rate <= 0:
        return grads
    step_draw = torch.rand((), generator=_generator(mix(key, cfg.seed), "cpu"))
    if step_draw.item() >= cfg.grad_poison_rate:
        return grads
    leaves, spec = tree.flatten(grads)
    return tree.unflatten(spec, [poison(g, mix(key, cfg.seed, i), cfg.poison_frac,
                                        cfg.poison_value) for i, g in enumerate(leaves)])
