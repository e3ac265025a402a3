"""granite-3-2b [dense] — GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
    optimizer="adamw",
    remat="full",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
