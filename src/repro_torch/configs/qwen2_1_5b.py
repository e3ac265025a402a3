"""qwen2-1.5b [dense] — GQA, QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
[arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    optimizer="adamw",
    remat="full",
    source="arXiv:2407.10671; hf",
)
