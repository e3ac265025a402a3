"""LM serving: batched greedy generation with a fixed-capacity KV cache
(port of ``examples/serve_lm.py``).

``Server`` builds a decoder-only LM, attention (GQA or MLA, dense or MoE),
SSM or hybrid, or the encoder-decoder (``models.registry``), on ``device``
(default ``"cuda"``; a host without CUDA raises unless the caller passes
``device="cpu"``), with weights drawn from an explicit ``torch.Generator``
seeded with ``seed`` unless ``params`` are given.  ``generate`` hands the
prefill the whole batch (an encoder-decoder's ``frames`` or a VLM's
``patches`` beside the prompt's ``tokens``; the hand-written
flash-attention kernel on the card in every attention layer) and then runs
one decode step per new token, the first at the prompt's length (frames
are not decoder positions; a VLM's patches are, so its first is P + T),
each
token the argmax over the padded vocab, under ``torch.inference_mode()``;
times end with ``torch.cuda.synchronize()``.  The cache (KV entries, SSM
states, the encoder frames' cross-attention keys and values) is updated
in place.

``swap_adapter_rank_r`` applies a rank-1 adapter delta W += u vᵀ to a 2-D
weight in place (the factorized update of F-IVM integration point #2,
DESIGN.md §5), without re-merging a dense product.

Run on the card:  PYTHONPATH=src python -m repro_torch.serve_lm
(add ``--device cpu`` to run the reduced config on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .configs.base import get_config
from .device import resolve_device
from .models import registry


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, n_new] int32
    prefill_s: float
    decode_s: float
    tokens_per_s: float         # tokens.size / decode_s, as the reference


class Server:
    """Greedy batched generation with a fixed-capacity KV cache."""

    def __init__(self, cfg, params=None, cache_len: int = 256, seed: int = 0,
                 device="cuda", generator: torch.Generator | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = registry.build(cfg)
        if params is None:
            params = self.api.init(seed=seed, device=self.device,
                                   generator=generator)
        self.params = params
        self.cache_len = cache_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch: dict, n_new: int) -> GenerationResult:
        inputs = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        tokens = inputs["tokens"]
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, inputs, cache_len=self.cache_len)
        tok = logits.argmax(dim=-1)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        pos = tokens.shape[1]
        if self.cfg.frontend == "vision":
            pos += inputs["patches"].shape[1]
        for i in range(n_new - 1):
            logits, cache = self.api.decode_step(self.params, tok, pos + i, cache)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        self._sync()
        t2 = time.perf_counter()
        toks = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        return GenerationResult(tokens=toks, prefill_s=t1 - t0, decode_s=t2 - t1,
                                tokens_per_s=toks.size / max(t2 - t1, 1e-9))

    # -- F-IVM adapter maintenance (lock #2 on the serving path) -----------
    @torch.inference_mode()
    def swap_adapter_rank_r(self, path: tuple, u, v) -> None:
        """Apply a rank-1 adapter delta W += u vᵀ, in place, to the 2-D
        parameter at ``path`` (the reference's pytree path, e.g.
        ``("embed",)``)."""
        w = self.params
        for name in path:
            w = w[name]
        if not isinstance(w, torch.Tensor) or w.dim() != 2:
            raise ValueError("rank-r swap targets 2-D weights")
        u = torch.as_tensor(u, device=w.device).float()
        v = torch.as_tensor(v, device=w.device).float()
        w.add_(torch.outer(u, v).to(w.dtype))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("llama3_2_1b").reduced()
    server = Server(cfg, cache_len=64, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 24)).astype(np.int32)
    res = server.generate({"tokens": prompts}, 24)
    print(f"base model : prefill {res.prefill_s * 1e3:.0f}ms, "
          f"{res.tokens_per_s:.0f} tok/s")
    print("completions:", res.tokens[:2, :10])

    # rank-1 adapter delta on the embedding (O(p²), no re-merge)
    u = np.zeros(cfg.padded_vocab, np.float32)
    u[:64] = 0.3
    v = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    server.swap_adapter_rank_r(("embed",), u, v)
    res2 = server.generate({"tokens": prompts}, 24)
    print(f"after swap : prefill {res2.prefill_s * 1e3:.0f}ms, "
          f"{res2.tokens_per_s:.0f} tok/s")
    print("fraction of generated tokens changed by adapter: "
          f"{(res.tokens != res2.tokens).mean():.2f}")


if __name__ == "__main__":
    main()
