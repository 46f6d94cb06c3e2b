"""Model configuration (counterpart of ``repro.models.config``).

The port runs the decoder block of five families: "dense" (llama3-8b,
llama3.2-3b, gemma2-2b, granite-34b), "audio" (musicgen-large, whose
stubbed EnCodec frontend leaves a decoder over token ids, the dense block
in ``repro`` too), "moe" (dbrx-132b, kimi-k2-1t-a32b: the MLP replaced
by ``models/moe.py``'s routed experts), "ssm" (mamba2-780m: each layer
the Mamba-2 mixer of ``models/mamba2.py`` alone, no attention, no MLP)
"hybrid" (hymba-1.5b: the attention and the mixer in parallel over
one norm, then the MLP) and "vlm" (llama-3.2-vision-90b: the dense block,
with a gated cross-attention onto projected media embeddings after every
``cross_attn_every``-th layer).  The fields are those these blocks read,
with ``repro``'s defaults: the MoE
knobs ``num_experts``, ``experts_per_token``, ``num_shared_experts``
(always-on experts of ``d_ff * num_shared_experts`` together) and
``moe_capacity_factor``, held as ``repro`` holds them (``num_experts >
1``, ``experts_per_token >= 1`` for "moe"); the SSM knobs ``ssm_state``
(N, > 0 for "ssm" and "hybrid"), ``ssm_expand`` (the mixer's width is
``ssm_expand * d_model`` for "ssm", ``d_model`` for "hybrid"),
``ssm_head_dim``, ``ssm_conv_width`` and ``ssm_chunk`` (the SSD's chunk
length); an "ssm" config has no attention heads (``num_heads = 0``);
the vlm knobs ``cross_attn_every`` (> 0 for "vlm", and dividing
``num_layers``: ``repro`` reshapes the layers into ``(L / k, k)`` groups),
``num_media_tokens`` (> 0 for "vlm"), ``media_d`` (the stub encoder's
width) and ``attn_chunk_kv`` (``repro``'s KV chunk of the attention's
online softmax, which the port computes in one chunk);
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
#: the attention-free Mamba-2 stack, the parallel attention + mamba layer
#: and the dense block with cross-attention onto media (every family of
#: ``repro``)
PORTED_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")


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

    # vlm: cross-attention onto stub media embeddings every k-th layer
    cross_attn_every: int = 0
    num_media_tokens: int = 0
    media_d: int = 1408

    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)

    attn_chunk_kv: int = 1024
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
        if self.family == "vlm":
            if not (self.cross_attn_every > 0 and self.num_media_tokens > 0):
                raise ValueError("a vlm config needs cross_attn_every > 0 and "
                                 "num_media_tokens > 0")
            if self.num_layers % self.cross_attn_every:
                raise ValueError(f"num_layers {self.num_layers} is not a multiple of "
                                 f"cross_attn_every {self.cross_attn_every}")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got {self.remat!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameters of the config, counted as ``repro``'s ``param_count``
        counts them (the norm gains left out; a vlm's cross layers counted
        as attention blocks, ``media_proj`` left out)."""
        d, dff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim if self.num_heads else 0
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.num_heads:
            attn = (d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                    + (self.num_heads * hd) * d)
        per_layer = attn + 3 * d * dff  # SwiGLU
        if self.family == "moe":
            per_layer = (attn + (self.num_experts + self.num_shared_experts) * 3 * d * dff
                         + d * self.num_experts)
        if self.family in ("ssm", "hybrid"):
            din = self.ssm_expand * d if self.family == "ssm" else d
            nh = din // self.ssm_head_dim
            ssm = d * (2 * din + 2 * self.ssm_state + nh) + din * d + 2 * nh
            per_layer = ssm if self.family == "ssm" else attn + ssm + 3 * d * dff
        total = emb + L * per_layer
        if self.family == "vlm":
            total += (L // self.cross_attn_every) * attn
        return int(total)
