"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
[arXiv:2308.11596; hf]

Enc-dec: 24 encoder + 24 decoder layers over the same width.  The audio
frontend (w2v-BERT conformer feature extractor) is a STUB: ``input_specs()``
supplies precomputed frame embeddings [B, n_frames, d_model] to the encoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    enc_dec=True,
    n_enc_layers=24,
    frontend="audio",
    n_frontend_tokens=1024,
    rope_theta=10000.0,
    optimizer="adamw",
    remat="full",
    source="arXiv:2308.11596; hf",
)
