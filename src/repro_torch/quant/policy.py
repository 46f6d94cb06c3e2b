"""Per-surface numeric-format policy (counterpart of ``repro.quant.policy``).

``QuantPolicy`` assigns a wire format to each surface of the stack.  The
serving slice reads ``weights``, ``kv_cache`` and ``activations``; the other
surfaces are kept so the named policies read exactly as in ``repro``.  The
guard policy and ``takum_guarded`` come with a later slice.
"""

from __future__ import annotations

import dataclasses

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

    _SURFACES = ("weights", "kv_cache", "grad_comm", "opt_state", "checkpoint", "pipe_act")

    def __post_init__(self):
        for s in self._SURFACES:
            f = getattr(self, s)
            if f not in FORMAT_BITS:
                raise ValueError(f"{s}={f!r} is not a registered wire format")
        if self.activations not in ("bf16", "f32"):
            raise ValueError(f"activations must be 'bf16' or 'f32', got {self.activations!r}")

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
POLICIES = {
    "bf16": BF16_BASELINE,
    "ofp8": OFP8_BASELINE,
    "mxfp8": MXFP8_BASELINE,
    "takum": TAKUM_UNIFORM,
    "takum8": TAKUM_AGGRESSIVE,
}
