"""Training step construction and the end-to-end training driver (port of
``repro.launch.train``), on one card.

``make_train_step(cfg, api, optimizer, plan)`` returns

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

which splits the global batch (every input along its leading axis: an
encoder-decoder's ``frames`` and a VLM's ``patches`` with the tokens) into
``plan.n_microbatches`` microbatches and takes ``torch.autograd.grad`` of ``api.loss`` on each (gradient
accumulation), so activation memory is bounded by one microbatch.  The
gradients add into ``plan.accum_dtype`` buffers (float32, bf16 for the
adafactor configs), are divided by the microbatch count and handed to
``optimizer.update``.  ``metrics`` holds ``loss`` and ``grad_norm`` as 0-d
device tensors; nothing in a step reads the device from the host.

``run_training`` is the production loop: checkpoint and restart (the port's
``Checkpointer``, saving the reference's tree of (params, opt_state); bf16
leaves are written as float32, exactly, and restored in their dtype),
per-step deadlines (straggler surfacing) and metric logging.  Gradient
compression (``runtime/compression.py``) composes by wrapping the
optimizer with ``compressed_optimizer``.

    python -m repro_torch.launch.train --arch llama3_2_1b --full   # on the card

The dry run's abstract arguments (the reference's ``abstract_train_args``)
wait for item 20's ``launch/`` part (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ArchConfig, ShapeSpec, get_config
from ..device import resolve_device
from ..models import registry
from ..optim import linear_warmup_cosine
from ..optim.optimizers import Optimizer, global_norm, make_optimizer
from .mesh import dp_size, make_smoke_mesh


# ---------------------------------------------------------------------------
# Train plan: per-(arch, shape, mesh) microbatching + dtype policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainPlan:
    n_microbatches: int
    accum_dtype: Any
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000


def make_train_plan(cfg: ArchConfig, shape: ShapeSpec, mesh) -> TrainPlan:
    dp = dp_size(mesh)
    # sequences per device per microbatch, by activation footprint
    if cfg.d_model >= 4096:
        seqs = 1
    elif cfg.d_model >= 3072:
        seqs = 2
    else:
        seqs = 4
    n_micro = max(1, shape.global_batch // max(dp * seqs, 1))
    while (shape.global_batch % n_micro
           or (shape.global_batch // n_micro) % min(dp, shape.global_batch)):
        n_micro -= 1  # keep microbatch divisible by dp
    # the adafactor configs (the >= 50B models) accumulate in bf16
    accum = torch.bfloat16 if cfg.optimizer == "adafactor" else torch.float32
    return TrainPlan(n_microbatches=max(n_micro, 1), accum_dtype=accum)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, api: registry.ModelAPI, optimizer: Optimizer,
                    plan: TrainPlan):
    """The step of ``api.loss`` under ``optimizer`` with ``plan``'s
    microbatching; ``batch`` values (numpy or tensors, leading dim the
    global batch) go to the parameters' device."""
    n_micro = plan.n_microbatches

    def train_step(params, opt_state, batch):
        leaves, spec = pytree.tree_flatten(params)
        dev = leaves[0].device
        micro = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                 for k, v in micro.items()}
        acc = [torch.zeros(p.shape, dtype=plan.accum_dtype, device=dev) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            xs = [p.detach().requires_grad_() for p in leaves]
            loss, _ = api.loss(pytree.tree_unflatten(xs, spec),
                               {k: v[i] for k, v in micro.items()})
            grads = torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True)
            for a, g in zip(acc, grads):
                a.add_(g.to(a.dtype))
            loss_sum = loss_sum + loss.detach()
            del xs, loss, grads
        for a in acc:
            a.div_(n_micro)
        grads = pytree.tree_unflatten(acc, spec)
        new_params, new_opt = optimizer.update(params, opt_state, grads)
        metrics = {"loss": loss_sum / n_micro, "grad_norm": global_norm(grads)}
        return new_params, new_opt, metrics

    return train_step


def _host_form(tree):
    """The tree as the checkpointer writes it: bf16 leaves as float32
    (exact; numpy has no bf16), every other leaf as it is."""
    return pytree.tree_map(
        lambda t: t.float() if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        else t, tree)


# ---------------------------------------------------------------------------
# The training driver
# ---------------------------------------------------------------------------
def run_training(cfg: ArchConfig, *, steps: int = 100, batch_size: int = 8,
                 seq_len: int = 64, seed: int = 0, mesh=None,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 50,
                 log_every: int = 10, data_iter=None, resume: bool = True,
                 step_deadline_s: float | None = None,
                 schedule_steps: int | None = None, device="cuda"):
    """The end-to-end trainer of ``examples/train_lm.py`` and the tests:
    parameters from ``torch.Generator`` seed ``seed`` on ``device``, data
    from ``data.lm_data`` (unless ``data_iter`` is given).  Returns (params,
    history), history a dict per step: ``step``, ``loss``, ``time_s`` (host
    wall of the step, ended by reading its loss)."""
    from ..checkpoint.checkpointer import Checkpointer
    from ..data.lm_data import synthetic_lm_batches

    dev = resolve_device(device)
    api = registry.build(cfg)
    mesh = mesh or make_smoke_mesh()
    shape = ShapeSpec("adhoc", seq_len, batch_size, "train")
    plan = make_train_plan(cfg, shape, mesh)
    # The LR schedule is a function of the total intended run length
    # (schedule_steps), which must stay fixed across checkpoint resumes for
    # bit-consistent continuation.  Short runs scale warmup to the horizon
    # and reduced (smoke-sized) configs use a livelier LR.
    horizon = schedule_steps or steps
    warmup = min(plan.warmup_steps, max(horizon // 10, 1))
    base_lr = 3e-3 if cfg.d_model <= 256 else plan.learning_rate
    lr = linear_warmup_cosine(base_lr, warmup, max(horizon, warmup + 1))
    optimizer = make_optimizer(cfg.optimizer, lr)
    params = api.init(seed=seed, device=dev)
    opt_state = optimizer.init(params)
    start_step = 0
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = Checkpointer(checkpoint_dir)
        if resume:
            restored = ckpt.restore_latest((params, opt_state))
            if restored is not None:
                (params, opt_state), start_step = restored

    step_fn = make_train_step(cfg, api, optimizer, plan)
    if data_iter is None:
        data_iter = synthetic_lm_batches(cfg, shape, seed=seed, start_step=start_step,
                                         device=dev)
    history = []
    for step in range(start_step, steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if step_deadline_s is not None and dt > step_deadline_s:
            print(f"[straggler] step {step} took {dt:.2f}s > {step_deadline_s}s")
        history.append({"step": step, "loss": loss, "time_s": dt})
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f}ms")
        if ckpt is not None and checkpoint_every and (step + 1) % checkpoint_every == 0:
            ckpt.save(_host_form((params, opt_state)), step + 1)
    if ckpt is not None:
        ckpt.save(_host_form((params, opt_state)), steps)
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    run_training(cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
                 checkpoint_dir=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
