"""Granite 34B Code [arXiv:2405.04324; hf]: 88L d=6144 48H MQA (kv=1)
d_ff=24576 vocab=49152 — deep-narrow code model.
Counterpart of ``repro.configs.granite_34b``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, rope_theta=10000.0,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
                     d_ff=128, vocab_size=256, head_dim=16)
