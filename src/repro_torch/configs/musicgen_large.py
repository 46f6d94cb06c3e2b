"""MusicGen-Large: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf].  48L d=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a stub per the task spec: the decoder consumes token
ids; the 4-codebook structure is abstracted to a single stream (DESIGN.md).
Counterpart of ``repro.configs.musicgen_large``, field for field."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64, rope_theta=10000.0,
)

SMOKE = CONFIG.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                     d_ff=128, vocab_size=128, head_dim=16)
