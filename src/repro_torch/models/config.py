"""Model configuration (counterpart of ``repro.models.config``).

This slice ports the dense decoder with an untied head only: any other
family raises ``NotImplementedError``, and the fields are those the dense
path reads (tied embeddings come with the families that use them).
``remat`` is ``repro``'s knob: ``"block"`` (the default) recomputes each
layer in the backward (``torch.utils.checkpoint``), ``"none"`` keeps every
activation.
"""

from __future__ import annotations

import dataclasses

from repro_torch.quant.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    sliding_window: int = 0  # 0 = full attention
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)

    remat: str = "block"  # none | block (checkpoint each layer)

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet; only 'dense' is"
            )
        if self.num_heads <= 0 or self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a positive multiple of num_kv_heads")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got {self.remat!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
