"""End-to-end LM training with F-IVM-maintained data statistics (the port's
counterpart of ``examples/train_lm.py``).

Trains a ~100M-parameter llama-family model on the synthetic stream
(``--tiny``: a 2-layer, width-64 model that trains in seconds), with:
  * checkpoint and restart (``--ckpt DIR``: kill it mid-run and a rerun
    with the same ``DIR`` resumes; without it each run checkpoints into a
    fresh temporary directory, removed at the end),
  * straggler surfacing,
  * streaming (c, s, Q) statistics over token features with the degree-m
    ring (``data.stats.RunningCofactor``: the ``cofactor_update`` kernel on
    the card), the data-quality monitor.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny [--device cpu]
      PYTHONPATH=src python -m repro_torch.examples.train_lm          # ~100M config
      PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --ckpt DIR
"""
import argparse
import dataclasses
import shutil
import tempfile

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.data.stats import RunningCofactor
from repro_torch.device import resolve_device
from repro_torch.launch.train import run_training
from repro_torch.models import registry


def lm_100m() -> ArchConfig:
    return ArchConfig(
        name="llama-100m", family="dense", n_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
        rope_theta=10000.0, tie_embeddings=True, optimizer="adamw",
        remat="full", act_dtype="float32", param_dtype="float32")


def lm_tiny() -> ArchConfig:
    return dataclasses.replace(lm_100m(), name="llama-tiny", n_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab_size=512)


def token_features(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[position_frac, token_id_frac, is_rare, bigram_delta] of each token
    of tokens [B, S], float32 rows [B·S, 4] on the tokens' device."""
    toks = tokens.to(torch.float32)
    B, S = toks.shape
    pos = (torch.arange(S, device=toks.device) / S).expand(B, S)
    delta = torch.diff(toks, dim=1, append=toks[:, -1:]).abs()
    return torch.stack([pos.reshape(-1), (toks / vocab_size).reshape(-1),
                        (toks > 0.9 * vocab_size).to(torch.float32).reshape(-1),
                        delta.reshape(-1) / vocab_size], dim=1)


def main(argv=None):
    """Train, print the run's summary and return its history."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to resume from and save to "
                         "(default: a fresh temporary one, removed at the end)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = lm_tiny() if args.tiny else lm_100m()
    steps = args.steps or (60 if args.tiny else 300)
    seq = 32 if args.tiny else 512
    batch = 4 if args.tiny else 8

    api = registry.build(cfg)
    print(f"training {cfg.name}: {api.n_params()/1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}")

    # streaming data statistics (F-IVM degree-m ring) over token features
    stats = RunningCofactor.init(4, device=dev)
    base_iter = synthetic_lm_batches(cfg, ShapeSpec("train", seq, batch, "train"),
                                     seed=0, device=dev)

    def monitored():
        nonlocal stats
        for b in base_iter:
            stats = stats.update(token_features(b["tokens"], cfg.vocab_size))
            yield b

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="repro_train_lm_")
    try:
        _, history = run_training(
            cfg, steps=steps, batch_size=batch, seq_len=seq,
            checkpoint_dir=ckpt, checkpoint_every=50,
            log_every=10 if args.tiny else 20, data_iter=monitored(),
            step_deadline_s=60.0, device=dev)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    if not history:
        print(f"nothing to train: the checkpoint in {ckpt} is at step {steps}")
        return history

    print(f"\nfinal loss: {history[-1]['loss']:.4f} "
          f"(start {history[0]['loss']:.4f})")
    print(f"stream stats after {float(stats.c):.0f} token-rows: "
          f"feature means {stats.mean().cpu().numpy().round(3)}")
    corr = stats.correlation().cpu().numpy().round(2)
    print(f"token feature correlations (from maintained Q):\n{corr}")
    return history


if __name__ == "__main__":
    main()
