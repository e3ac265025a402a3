"""Deterministic synthetic LM data pipeline (port of ``repro.data.lm_data``).

Reproducible token streams keyed by (seed, step), so a restarted job resumes
mid-stream (``start_step``) without replaying or skipping data.  Batches
are drawn on the host with the reference's numpy generator, so the tokens
and labels are bitwise the reference's, and go to ``device`` as int32
tensors.  A batch is ``{"tokens", "labels"}``; a VLM's also carries
``patches`` and an encoder-decoder's ``frames``, each [B,
n_frontend_tokens, d_model], float32 standard normal draws of the same
generator after the tokens (the stub front-end's embeddings, bitwise the
reference's).  A VLM's cell of ``seq_len`` S holds S − n_frontend_tokens
text tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device


def _batch_for_step(cfg: ArchConfig, shape: ShapeSpec, seed: int, step: int,
                    device="cuda") -> dict:
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step))
    B, S = shape.global_batch, shape.seq_len
    text = S - (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    # Markov-ish stream: correlated tokens so the loss actually decreases
    base = rng.integers(0, cfg.vocab_size, size=(B, 1), dtype=np.int64)
    drift = rng.integers(0, 17, size=(B, text + 1), dtype=np.int64)
    toks = ((base + np.cumsum(drift, axis=1)) % cfg.vocab_size).astype(np.int32)
    batch = {"tokens": toks[:, :text], "labels": toks[:, 1:text + 1]}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model),
                                               dtype=np.float32)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model),
                                              dtype=np.float32)
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def synthetic_lm_batches(cfg: ArchConfig, shape: ShapeSpec, *, seed: int = 0,
                         start_step: int = 0, device="cuda"):
    """Infinite iterator of training batches, deterministic per step."""
    step = start_step
    while True:
        yield _batch_for_step(cfg, shape, seed, step, device)
        step += 1


def serving_requests(cfg: ArchConfig, *, batch: int, prompt_len: int, seed: int = 0,
                     n_requests: int = 16, device="cuda"):
    """Batched serving workload: prompt tokens [batch, prompt_len] (int32)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    for _ in range(n_requests):
        toks = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len))
        yield torch.from_numpy(toks.astype(np.int32)).to(dev)
