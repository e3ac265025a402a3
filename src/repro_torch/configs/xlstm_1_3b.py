"""xlstm-1.3b [ssm] — alternating sLSTM + mLSTM blocks.

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.
[arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections; there is no
separate MLP.  The mLSTM matrix-memory update C += v kᵀ is literally the
paper's "factorizable (rank-1) update" — see DESIGN.md §5.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(kind="xlstm", d_state=0, expand=2, chunk=256),
    block_pattern=("mlstm", "slstm"),
    optimizer="adamw",
    remat="full",
    source="arXiv:2405.04517; unverified",
)
