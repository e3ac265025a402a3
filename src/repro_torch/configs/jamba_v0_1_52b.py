"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf]

Period of 8 layers: attention at position 3 (1 attn : 7 mamba), MoE MLP on
every second layer (every_k_layers=2).  For long_500k the attention layers
use a sliding window; the Mamba layers carry the long context in O(1)
state — this arch RUNS the long-context cell.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=14336, every_k_layers=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk=256),
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    sliding_window=4096,
    rope_theta=10000.0,
    optimizer="adafactor",
    remat="full",
    source="arXiv:2403.19887; hf",
)
