"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=163840,
MoE 64e top-6.  [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408, n_shared=2),
    rope_theta=50000.0,
    optimizer="adamw",
    remat="full",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
