"""Architecture + shape configuration system (copy of ``repro.configs.base``).

Every assigned architecture is a frozen ``ArchConfig``; every workload cell
is an (arch, ShapeSpec) pair.  ``reduced()`` produces the CPU-smoke variant
of any config (same family/topology, tiny dims).  The configs are pure data,
kept here so that the port imports nothing of the JAX package; ``get_config``
loads ``repro_torch.configs.<arch>``.  The port builds the attention
decoders, GQA or MLA, dense or MoE (``models.registry``); the CPU tests use
reduced configs, the card runs the full ones.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0           # shared (always-on) experts
    every_k_layers: int = 1     # MoE replaces the MLP on layers where (idx % every_k == every_k-1)
    router_noise: float = 0.0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba (jamba) / xLSTM parameters."""
    kind: str = "mamba"        # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256           # chunkwise-parallel scan chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    attn_kind: str = "gqa"     # gqa | mla
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # layer pattern, as a repeating period of block kinds; None = all "attn".
    # e.g. jamba: ("mamba",)*3 + ("attn",) + ("mamba",)*4 with MoE every 2.
    block_pattern: Optional[tuple] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    mtp: bool = False          # multi-token-prediction auxiliary head (deepseek)
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None       # None | "vision" | "audio"
    n_frontend_tokens: int = 256         # patch/frame count supplied by the stub
    sliding_window: Optional[int] = None # attention window for long-context cells
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"             # adamw | adafactor (memory plan)
    remat: str = "full"                  # full | dots | none
    source: str = ""                     # provenance tag from the brief

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 so it shards over the model
        axis (16) and aligns with the 128-lane MXU (Megatron-style)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def layer_pattern(self) -> tuple:
        if self.block_pattern is None:
            return ("attn",)
        return self.block_pattern

    @property
    def n_periods(self) -> int:
        p = len(self.layer_pattern)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    def is_moe_layer(self, idx_in_period: int) -> bool:
        if self.moe is None:
            return False
        k = self.moe.every_k_layers
        return idx_in_period % k == k - 1

    def supports_long_context(self) -> bool:
        """True iff the arch has a sub-quadratic path for 500k decode."""
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True  # none of the assigned archs is encoder-only

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        period = len(self.layer_pattern)
        moe = None
        if self.moe is not None:
            # capacity_factor = n_experts ⇒ C = T·k: no token ever drops, so
            # reduced-config decode exactly matches batched prefill (capacity
            # dropping is batch-dependent by design in the full configs).
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert_ff=64,
                n_shared=min(self.moe.n_shared, 1), capacity_factor=4.0)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_head_dim=8, qk_rope_head_dim=8,
                            v_head_dim=8)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=4, chunk=8)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 * period,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            moe=moe,
            mla=mla,
            ssm=ssm,
            n_enc_layers=2 if self.enc_dec else 0,
            n_frontend_tokens=16 if self.frontend else 0,
            sliding_window=None if self.sliding_window is None else 32,
            act_dtype="float32",
            param_dtype="float32",
        )


# ---------------------------------------------------------------------------
# Workload shapes (LM-family: identical 4-shape set for every arch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "deepseek_v3_671b",
    "moonshot_v1_16b_a3b",
    "llama3_2_3b",
    "llama3_2_1b",
    "qwen2_1_5b",
    "granite_3_2b",
    "xlstm_1_3b",
    "paligemma_3b",
    "seamless_m4t_large_v2",
    "jamba_v0_1_52b",
)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(include_skipped: bool = False):
    """The 40 (arch × shape) baseline cells; yields (arch_id, shape, skipped?)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            skip = s.name == "long_500k" and not cfg.supports_long_context()
            if include_skipped or not skip:
                yield a, s, skip
