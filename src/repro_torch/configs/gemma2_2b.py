"""Gemma-2 2B [arXiv:2408.00118; hf]: 26L d=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; alternating local(SWA-4096)/global attention, logit softcaps,
pre+post norms, tied embeddings, head_dim=256.
Counterpart of ``repro.configs.gemma2_2b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    alt_local_global=True, sliding_window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    tie_embeddings=True, rope_theta=10000.0,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=128, vocab_size=256, head_dim=16, sliding_window=16)
