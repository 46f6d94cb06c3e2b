"""Llama-3.2 Vision 90B [hf:meta-llama/Llama-3.2-90B-Vision]: 100L d=8192
64H (GQA kv=8) d_ff=28672 vocab=128256; gated cross-attention onto vision
patch embeddings every 5th layer.  The ViT frontend is a stub: the batch
carries precomputed patch embeddings [B, 4096, 1408].
Counterpart of ``repro.configs.llama3_2_vision_90b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128, rope_theta=500000.0,
    cross_attn_every=5, num_media_tokens=4096, media_d=1408,
)

SMOKE = CONFIG.with_(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=128, vocab_size=256, head_dim=16,
                     cross_attn_every=2, num_media_tokens=16, media_d=32)
