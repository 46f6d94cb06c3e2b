"""DBRX: 132B fine-grained MoE [hf:databricks/dbrx-base].
40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, 16 experts top-4.
Counterpart of ``repro.configs.dbrx_132b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    num_experts=16, experts_per_token=4, moe_capacity_factor=1.25,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     d_ff=96, vocab_size=256, head_dim=16,
                     num_experts=4, experts_per_token=2)
