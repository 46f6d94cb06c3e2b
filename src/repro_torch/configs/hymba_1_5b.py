"""Hymba 1.5B [arXiv:2411.13676; hf]: 32L d=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, parallel attention + mamba heads (ssm_state=16), SWA-1024 on
the attention branch (meta-tokens omitted, as in ``repro``).
Counterpart of ``repro.configs.hymba_1_5b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_head_dim=64, sliding_window=1024, rope_theta=10000.0,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=128, vocab_size=256, head_dim=16,
                     ssm_state=8, ssm_head_dim=16, sliding_window=16)
