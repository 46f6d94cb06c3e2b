"""Model configuration (counterpart of ``repro.models.config``).

The port runs the decoder block of five families: "dense" (llama3-8b,
llama3.2-3b, gemma2-2b, granite-34b), "audio" (musicgen-large, whose
stubbed EnCodec frontend leaves a decoder over token ids, the dense block
in ``repro`` too), "moe" (dbrx-132b, kimi-k2-1t-a32b: the MLP replaced
by ``models/moe.py``'s routed experts), "ssm" (mamba2-780m: each layer
the Mamba-2 mixer of ``models/mamba2.py`` alone, no attention, no MLP)
and "hybrid" (hymba-1.5b: the attention and the mixer in parallel over
one norm, then the MLP); "vlm" raises ``NotImplementedError``.  The
fields are those these blocks read, with ``repro``'s defaults: the MoE
knobs ``num_experts``, ``experts_per_token``, ``num_shared_experts``
(always-on experts of ``d_ff * num_shared_experts`` together) and
``moe_capacity_factor``, held as ``repro`` holds them (``num_experts >
1``, ``experts_per_token >= 1`` for "moe"); the SSM knobs ``ssm_state``
(N, > 0 for "ssm" and "hybrid"), ``ssm_expand`` (the mixer's width is
``ssm_expand * d_model`` for "ssm", ``d_model`` for "hybrid"),
``ssm_head_dim``, ``ssm_conv_width`` and ``ssm_chunk`` (the SSD's chunk
length); an "ssm" config has no attention heads (``num_heads = 0``);
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

#: the families the port runs: the dense decoder block, its MoE variant,
#: the attention-free Mamba-2 stack and the parallel attention + mamba layer
PORTED_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of PORTED_FAMILIES
    num_layers: int
    d_model: int
    num_heads: int  # 0 for attention-free (mamba2)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

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
        if self.family != "ssm" and (self.num_heads <= 0
                                     or self.num_heads % max(self.num_kv_heads, 1)):
            raise ValueError("num_heads must be a positive multiple of num_kv_heads")
        if self.family == "moe" and not (self.num_experts > 1 and self.experts_per_token >= 1):
            raise ValueError("a moe config needs num_experts > 1 and experts_per_token >= 1")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"a {self.family} config needs ssm_state > 0")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got {self.remat!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
