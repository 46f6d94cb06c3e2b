"""Per-surface numeric-format policy (counterpart of ``repro.quant.policy``).

``QuantPolicy`` assigns a wire format to each surface of the stack.  Serving
reads ``weights``, ``kv_cache`` and ``activations``, training ``opt_state``
and ``stochastic_rounding`` too; the other surfaces are kept so the named
policies read exactly as in ``repro``.  ``guard`` holds a
:class:`GuardPolicy`: on a single device the train step reads its
``skip_nonfinite_update`` (``train/step.py``); its ladder and hop
containment are for the guarded collectives, which come with dist.
Invalid values raise ValueError (``repro`` asserts), an unregistered format
KeyError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.formats import WIRE_FORMATS, wire_format

#: format name -> wire bits per element (8.25 for the mx containers: the
#: shared scale byte is charged to its 32 elements)
FORMAT_BITS = {name: wf.wire_bits_per_el for name, wf in WIRE_FORMATS.items()}


def is_takum(fmt: str) -> bool:
    """True iff ``fmt`` resolves to a takum-family wire format."""
    try:
        return wire_format(fmt).family == "takum"
    except KeyError:
        return False


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Numeric-fault guards and the format-degradation ladder (``repro``'s).

    A guarded wire hop whose health check trips (the encoded payload's
    special fraction above ``max_special_frac``, or the local encode's
    relative rms error above ``max_rel_err``) escalates along ``ladder``
    (from the hop's format, each rung strictly wider, f32 the exact last
    refuge); ``contain_hops`` zeroes arriving non-finite elements and those
    above ``contain_abs``; ``skip_nonfinite_update`` makes the train step
    drop a step whose gradients are not all finite (params and optimizer
    state held, ``step.skipped`` counted)."""

    ladder: tuple[str, ...] = ("t8", "t16", "bf16", "f32")
    max_special_frac: float = 1e-3  # encoded-payload special fraction bound
    max_rel_err: float = 0.25  # local encode relative rms error bound
    contain_hops: bool = True  # zero non-finite elements of arriving terms
    contain_abs: float = 1e30  # arriving |element| above this is corruption
    skip_nonfinite_update: bool = True  # drop poisoned-grad steps

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("the degradation ladder needs at least one rung")
        widths = [wire_format(f).wire_bits_per_el for f in self.ladder]  # KeyError: unknown
        if widths != sorted(widths):
            raise ValueError(f"degradation ladder must widen monotonically: {self.ladder}")

    def ladder_from(self, fmt) -> tuple[str, ...]:
        """The escalation rungs of a hop configured at ``fmt``: ``fmt``
        itself, then every ladder rung strictly wider than it."""
        base = wire_format(fmt)
        tail = tuple(f for f in self.ladder
                     if f != base.name and wire_format(f).wire_bits_per_el > base.wire_bits_per_el)
        return (base.name,) + tail


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    weights: str = "bf16"  # storage format for linear/embedding weights
    kv_cache: str = "bf16"  # serving KV cache
    grad_comm: str = "f32"
    opt_state: str = "f32"
    checkpoint: str = "f32"
    activations: str = "bf16"  # compute dtype: "bf16" | "f32"
    scale_tensors: bool = True
    stochastic_rounding: bool = True
    pipe_act: str = "f32"
    guard: Optional[GuardPolicy] = None  # fault guards + degradation ladder

    _SURFACES = ("weights", "kv_cache", "grad_comm", "opt_state", "checkpoint", "pipe_act")

    def __post_init__(self):
        for s in self._SURFACES:
            f = getattr(self, s)
            if f not in FORMAT_BITS:
                raise ValueError(f"{s}={f!r} is not a registered wire format")
        if self.activations not in ("bf16", "f32"):
            raise ValueError(f"activations must be 'bf16' or 'f32', got {self.activations!r}")
        if self.guard is not None and not isinstance(self.guard, GuardPolicy):
            raise ValueError(f"guard must be a GuardPolicy or None, got {self.guard!r}")

    def bytes_per_el(self, surface: str) -> float:
        return FORMAT_BITS[getattr(self, surface)] / 8


BF16_BASELINE = QuantPolicy()
OFP8_BASELINE = QuantPolicy(weights="bf16", kv_cache="e4m3", grad_comm="e5m2", pipe_act="e4m3")
TAKUM_UNIFORM = QuantPolicy(
    weights="t16", kv_cache="t8", grad_comm="t16", opt_state="t16",
    checkpoint="t16", pipe_act="t16",
)
TAKUM_AGGRESSIVE = QuantPolicy(
    weights="t8", kv_cache="t8", grad_comm="t8", opt_state="t8",
    checkpoint="t16", pipe_act="t8",
)
MXFP8_BASELINE = QuantPolicy(  # the OCP Microscaling evolution of the FP8 zoo
    weights="bf16", kv_cache="mxe4m3", grad_comm="mxe5m2", pipe_act="mxe4m3",
)
TAKUM_GUARDED = QuantPolicy(  # the aggressive wire config hardened by the fault guards
    weights="t16", kv_cache="t8", grad_comm="t8", opt_state="t16",
    checkpoint="t16", pipe_act="t8", guard=GuardPolicy(),
)
POLICIES = {
    "bf16": BF16_BASELINE,
    "ofp8": OFP8_BASELINE,
    "mxfp8": MXFP8_BASELINE,
    "takum": TAKUM_UNIFORM,
    "takum8": TAKUM_AGGRESSIVE,
    "takum_guarded": TAKUM_GUARDED,
}
