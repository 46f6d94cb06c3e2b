"""Llama-3.2 3B [hf:meta-llama/Llama-3.2-3B]: 28L d=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256, tied embeddings.
Counterpart of ``repro.configs.llama3_2_3b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=128, rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
                     d_ff=96, vocab_size=256, head_dim=16)
