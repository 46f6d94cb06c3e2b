"""Model configuration (counterpart of ``repro.models.config``).

The port runs the decoder block of three families: "dense" (llama3-8b,
llama3.2-3b, gemma2-2b, granite-34b), "audio" (musicgen-large, whose
stubbed EnCodec frontend leaves a decoder over token ids, the dense block
in ``repro`` too) and "moe" (dbrx-132b, kimi-k2-1t-a32b: the MLP replaced
by ``models/moe.py``'s routed experts); any other family raises
``NotImplementedError``.  The fields are those these blocks read, with
``repro``'s defaults: the MoE knobs ``num_experts``, ``experts_per_token``,
``num_shared_experts`` (always-on experts of ``d_ff * num_shared_experts``
together) and ``moe_capacity_factor``, held as ``repro`` holds them
(``num_experts > 1``, ``experts_per_token >= 1`` for "moe");
``tie_embeddings`` (the head is ``embed.T``) and ``alt_local_global``
(gemma2: even layers attend through ``sliding_window``, odd layers
globally, with post-norms after attention and MLP and the embedding rows
scaled by ``sqrt(d_model)``).  ``remat`` is ``repro``'s knob: ``"block"``
(the default) recomputes each layer in the backward
(``torch.utils.checkpoint``), ``"none"`` keeps every activation.
"""

from __future__ import annotations

import dataclasses

from repro_torch.quant.policy import QuantPolicy

#: the families the port runs: the dense decoder block, and its MoE variant
PORTED_FAMILIES = ("dense", "audio", "moe")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of PORTED_FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    sliding_window: int = 0  # 0 = full attention
    alt_local_global: bool = False  # gemma2: even layers local SWA, odd global
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)

    remat: str = "block"  # none | block (checkpoint each layer)

    def __post_init__(self):
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet; only {PORTED_FAMILIES} are"
            )
        if self.num_heads <= 0 or self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a positive multiple of num_kv_heads")
        if self.family == "moe" and not (self.num_experts > 1 and self.experts_per_token >= 1):
            raise ValueError("a moe config needs num_experts > 1 and experts_per_token >= 1")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got {self.remat!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
