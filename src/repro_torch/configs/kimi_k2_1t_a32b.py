"""Kimi K2: trillion-parameter MoE [arXiv:2501.kimi2; paper-table].
61L d=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, 384 experts top-8
+ 1 shared expert (DeepSeek-V3 lineage), head_dim=128.
Counterpart of ``repro.configs.kimi_k2_1t_a32b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    num_experts=384, experts_per_token=8, num_shared_experts=1,
    moe_capacity_factor=1.25,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=64, vocab_size=256, head_dim=16,
                     num_experts=8, experts_per_token=2, num_shared_experts=1)
