"""Model registry (port of ``repro.models.registry``): one API over the
architectures the port builds, the decoder-only LMs: the dense GQA family
(llama3.2-1b, llama3.2-3b, qwen2-1.5b, granite-3-2b), the MoE GQA
moonshot-v1-16b-a3b, deepseek-v3-671b (MLA attention, MoE, the MTP head),
the SSM xlstm-1.3b (mLSTM and sLSTM blocks) and the hybrid jamba-v0.1-52b
(Mamba blocks, a GQA layer a period with a sliding-window decode cache,
the MoE MLP).

``build(cfg)`` raises ``NotImplementedError`` for encoder-decoder and
front-end (vision, audio) configs (ROADMAP Queue 1 item 20).  ``ModelAPI.loss``
is ``lm.lm_loss``; ``batch_spec`` and ``real_batch`` give a workload cell's
inputs.  The dry run's abstract inputs (the reference's ``abstract_batch``)
wait for item 20's ``launch/`` part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from . import lm
from .attention import UNPORTED
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


def _unsupported(cfg: ArchConfig) -> str | None:
    for what, yes in (("encoder-decoder", cfg.enc_dec),
                      (f"{cfg.frontend} front-end", cfg.frontend is not None)):
        if yes:
            return what
    return None


def build(cfg: ArchConfig) -> ModelAPI:
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} models are not ported yet; the port builds the "
            f"decoder-only LMs (attention, SSM and hybrid) only ({UNPORTED})")
    specs = lm.lm_specs(cfg)

    def init(seed: int = 0, device="cuda", dtype=None, generator=None):
        if generator is None:
            generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return lm.lm_init(cfg, generator, dtype)

    return ModelAPI(
        cfg=cfg,
        specs=specs,
        init=init,
        loss=lambda p, b: lm.lm_loss(cfg, p, b),
        prefill=lambda p, b, cache_len=None: lm.lm_prefill(cfg, p, b, cache_len),
        decode_step=lambda p, t, pos, c: lm.lm_decode(cfg, p, t, pos, c),
        init_cache=lambda batch, seq, dtype, device="cuda": lm.lm_init_cache(
            cfg, batch, seq, dtype, resolve_device(device)),
    )


# ---------------------------------------------------------------------------
# Batch input specs per workload shape
# ---------------------------------------------------------------------------
def batch_spec(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Logical-axis specs for every model input of this workload cell (the
    decoder-only LMs have no vision or audio front-end)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": P((B, S), ("batch", "seq"), "zeros"),
                "labels": P((B, S), ("batch", "seq"), "zeros")}
    if shape.kind == "prefill":
        return {"tokens": P((B, S), ("batch", "seq"), "zeros")}
    # decode: one token + position; the cache is specced separately
    return {"token": P((B,), ("batch",), "zeros"), "pos": P((), (), "zeros")}


def real_batch(cfg: ArchConfig, shape: ShapeSpec, generator: torch.Generator) -> dict:
    """A random batch on the generator's device: token ids uniform in
    [0, vocab_size) as int32, ``pos`` 0, drawn in the specs' order."""
    out = {}
    for name, s in batch_spec(cfg, shape).items():
        if name == "pos":
            out[name] = torch.zeros((), dtype=torch.int32, device=generator.device)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                                      dtype=torch.int32, device=generator.device)
    return out
