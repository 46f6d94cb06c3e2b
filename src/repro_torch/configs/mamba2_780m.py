"""Mamba-2 780M [arXiv:2405.21060]: 48L d=1536 attention-free SSD,
ssm_state=128, expand=2 (d_inner=3072, 48 heads of 64), vocab=50280,
tied embeddings.
Counterpart of ``repro.configs.mamba2_780m``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=1,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, tie_embeddings=True,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, vocab_size=256,
                     ssm_state=16, ssm_head_dim=16)
