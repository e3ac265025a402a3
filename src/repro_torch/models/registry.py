"""Model registry (port of ``repro.models.registry``): one API over the
architectures the port builds: the decoder-only LMs (the dense GQA family
llama3.2-1b, llama3.2-3b, qwen2-1.5b, granite-3-2b; the MoE GQA
moonshot-v1-16b-a3b; deepseek-v3-671b with MLA attention, MoE and the MTP
head; the SSM xlstm-1.3b with mLSTM and sLSTM blocks; the hybrid
jamba-v0.1-52b with Mamba blocks, a GQA layer a period with a
sliding-window decode cache and the MoE MLP; the VLM paligemma-3b, its
vision front-end a stub: the batch carries patch embeddings, a prefix of
the text) and the encoder-decoder seamless-m4t-large-v2
(``models/encdec.py``, its audio front-end a stub: the batch carries frame
embeddings).

``ModelAPI.loss`` is ``lm.lm_loss`` or ``encdec.encdec_loss``;
``batch_spec`` and ``real_batch`` give a workload cell's inputs, an
encoder-decoder's ``frames`` or a VLM's ``patches`` among them (a VLM cell
of ``seq_len`` S holds S − n_frontend_tokens text tokens).  The dry run's
abstract inputs (the reference's ``abstract_batch``) wait for ROADMAP
Queue 1 item 20's ``launch/`` part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from . import encdec, lm
from .layers import P, count_params, iter_specs


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    specs: Any                     # param spec tree (P leaves), reference layout
    init: Callable                 # (seed=0, device="cuda", dtype=None, generator=None) -> tree
    loss: Callable                 # (params, batch) -> (loss, metrics)
    prefill: Callable              # (params, batch, cache_len=None) -> (logits, cache)
    decode_step: Callable          # (params, token, pos, cache) -> (logits, cache)
    init_cache: Callable           # (batch, seq, dtype, device="cuda") -> cache

    def n_params(self) -> int:
        return count_params(self.specs)

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts only):
        the reference's count, whose routed tensors are the leaves under a
        "moe" key of at least 3 dims with n_experts among them (the stacked
        router too), each counted at top_k / n_experts."""
        m = self.cfg.moe
        if m is None:
            return self.n_params()
        total, routed = 0, 0
        for path, spec in iter_specs(self.specs):
            n = math.prod(spec.shape)
            total += n
            if "moe" in path and m.n_experts in spec.shape and len(spec.shape) >= 3:
                routed += n
        return total - routed + int(routed * m.top_k / m.n_experts)


def build(cfg: ArchConfig) -> ModelAPI:
    specs = encdec.encdec_specs(cfg) if cfg.enc_dec else lm.lm_specs(cfg)
    init_fn, loss, prefill, decode, init_cache = (
        (encdec.encdec_init, encdec.encdec_loss, encdec.encdec_prefill,
         encdec.encdec_decode, encdec.encdec_init_cache) if cfg.enc_dec else
        (lm.lm_init, lm.lm_loss, lm.lm_prefill, lm.lm_decode, lm.lm_init_cache))

    def init(seed: int = 0, device="cuda", dtype=None, generator=None):
        if generator is None:
            generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return init_fn(cfg, generator, dtype)

    return ModelAPI(
        cfg=cfg,
        specs=specs,
        init=init,
        loss=lambda p, b: loss(cfg, p, b),
        prefill=lambda p, b, cache_len=None: prefill(cfg, p, b, cache_len),
        decode_step=lambda p, t, pos, c: decode(cfg, p, t, pos, c),
        init_cache=lambda batch, seq, dtype, device="cuda": init_cache(
            cfg, batch, seq, dtype, resolve_device(device)),
    )


# ---------------------------------------------------------------------------
# Batch input specs per workload shape
# ---------------------------------------------------------------------------
def batch_spec(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Logical-axis specs for every model input of this workload cell: the
    train and prefill batches of a VLM carry ``patches`` and an
    encoder-decoder's ``frames``, each [B, n_frontend_tokens, d_model] (the
    stub front-end's embeddings); a VLM's tokens are the ``_text_len`` of
    the cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        # one token + position; the cache is specced separately
        return {"token": P((B,), ("batch",), "zeros"), "pos": P((), (), "zeros")}
    out = {"tokens": P((B, _text_len(cfg, S)), ("batch", "seq"), "zeros")}
    if shape.kind == "train":
        out["labels"] = P((B, _text_len(cfg, S)), ("batch", "seq"), "zeros")
    front = P((B, cfg.n_frontend_tokens, cfg.d_model), ("batch", "seq", None), "zeros")
    if cfg.frontend == "vision":
        out["patches"] = front
    if cfg.enc_dec:
        out["frames"] = front
    return out


def _text_len(cfg: ArchConfig, seq_len: int) -> int:
    """VLM cells split seq_len into patch-prefix + text."""
    if cfg.frontend == "vision":
        return seq_len - cfg.n_frontend_tokens
    return seq_len


def real_batch(cfg: ArchConfig, shape: ShapeSpec, generator: torch.Generator) -> dict:
    """A random batch on the generator's device, drawn in the specs' order:
    token ids uniform in [0, vocab_size) as int32, ``pos`` 0, ``frames``
    and ``patches`` standard normal in float32 cast to ``act_dtype``."""
    out = {}
    dev = generator.device
    for name, s in batch_spec(cfg, shape).items():
        if name == "pos":
            out[name] = torch.zeros((), dtype=torch.int32, device=dev)
        elif name in ("frames", "patches"):
            out[name] = torch.randn(s.shape, generator=generator, device=dev).to(
                getattr(torch, cfg.act_dtype))
        else:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                                      dtype=torch.int32, device=dev)
    return out
