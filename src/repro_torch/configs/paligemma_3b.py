"""paligemma-3b [vlm] — SigLIP + gemma backbone.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
[arXiv:2407.07726; hf]

The SigLIP vision frontend is a STUB: ``input_specs()`` supplies
precomputed patch embeddings [B, n_patches, d_model]; the backbone
prepends them (prefix-LM style) to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=10000.0,
    tie_embeddings=True,
    optimizer="adamw",
    remat="full",
    source="arXiv:2407.07726; hf",
)
