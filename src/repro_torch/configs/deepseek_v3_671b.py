"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H (GQA kv=128) d_ff=2048(expert) vocab=129280,
MoE 256e top-8.  [arXiv:2412.19437; hf]

Memory plan: adafactor (factored moments) + bf16 params — full fp32 Adam
state for 671B does not fit a 256-chip v5e pod (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=2048,
    vocab_size=129280,
    attn_kind="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert_ff=2048, n_shared=1),
    mtp=True,
    rope_theta=10000.0,
    optimizer="adafactor",
    remat="full",
    source="arXiv:2412.19437; hf",
)
