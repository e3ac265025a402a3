"""Fault tolerance: supervised checkpoint-restart, straggler mitigation,
and elastic cluster membership (PyTorch port of
``repro.runtime.fault_tolerance``; pure Python but ``_check_finite``).

What runs where:
  * ``Supervisor.run`` — the outer restart loop a real launcher wraps
    around the trainer: a step function that raises (preempted host, XLA
    error, NaN guard) triggers restore-from-latest-checkpoint and
    continuation, with exponential backoff and a restart budget.
  * ``StreamSupervisor.run`` — the same restart discipline specialized to
    the IVM stream executor: each attempt is ``executor.resume(stream)``
    (restore newest committed snapshot, replay from its offset), failures
    back off exponentially against a restart budget, and a non-finite
    guard rejects runs whose float view payloads picked up NaN/Inf
    (a poisoned ring value scatter-propagates through every later
    boundary snapshot — better to fail the run than persist it).
  * ``StragglerMonitor`` — per-step deadline tracking with EWMA baseline;
    on a real cluster the action is re-dispatching the slow host's shard /
    alerting; here it records and exposes the decision.  The stream
    executor feeds it each segment's admit + dispatch *host* wall: on the
    card that is the time to enqueue the segment's graph replays, not the
    device's time (no device timer, which would synchronise).
  * ``ClusterState`` — heartbeat registry for elastic membership: nodes
    join/leave; ``plan_mesh`` recomputes the largest (data, model) mesh
    that fits the healthy node set (a snapshot restores onto that group
    through ``StreamExecutor.resume``, which re-plans the shards).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


# ---------------------------------------------------------------------------
# Checkpoint-restart supervisor
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Supervisor:
    max_restarts: int = 3
    backoff_s: float = 0.1
    nan_is_failure: bool = True

    def run(self, *, n_steps: int, step_fn: Callable[[int], float],
            save_fn: Callable[[int], None], restore_fn: Callable[[], int],
            checkpoint_every: int = 10):
        """Drive ``step_fn(step) -> loss`` for n_steps with restart-on-
        failure.  ``restore_fn() -> step`` reloads the latest checkpoint.
        Returns (completed_steps, restarts, log)."""
        restarts = 0
        log: list[dict] = []
        step = restore_fn()
        while step < n_steps:
            try:
                loss = step_fn(step)
                if self.nan_is_failure and (loss != loss or math.isinf(loss)):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                log.append({"step": step, "loss": float(loss)})
                step += 1
                if step % checkpoint_every == 0:
                    save_fn(step)
            except Exception as e:  # noqa: BLE001 — restart path
                restarts += 1
                log.append({"step": step, "failure": repr(e)})
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted after {restarts - 1} restarts"
                    ) from e
                time.sleep(self.backoff_s * (2 ** (restarts - 1)))
                step = restore_fn()
        save_fn(step)
        return step, restarts, log


# ---------------------------------------------------------------------------
# Stream-level supervision (DESIGN.md §10)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StreamSupervisor:
    """Restart loop over ``StreamExecutor.resume``.

    Every attempt — including the first — goes through ``resume``: it
    establishes the offset-0 baseline snapshot before any update runs,
    so a failure at *any* later point (mid-segment, mid-admit,
    mid-checkpoint-write) restarts from a committed snapshot, never from
    a partially-advanced live engine.  Exceptions back off exponentially
    (``backoff_s * 2**(restarts-1)``) against ``max_restarts``; budget
    exhaustion re-raises chained to the last failure.  With
    ``nan_is_failure`` (default), a completed run whose float view
    payloads contain NaN/Inf is treated as failed *before* its final
    snapshot can be trusted.

    With ``escalate`` (default), repeated failures climb an escalation
    ladder instead of blindly retrying the same resume (DESIGN.md §11):

    1. **restart** — plain resume from the newest committed snapshot
       (handles transient faults: preemption, injected kills).  The
       same executor is resumed: its restore installs new state tensors,
       so no CUDA graph replays onto the tensors it was bound to before.
    2. **restore_previous_snapshot** — quarantine the newest snapshot
       and resume from the one before it (handles a *committed but
       poisoned* snapshot the checksum cannot catch, e.g. NaN payloads
       that were valid bytes when written).
    3. **quarantine_batch** — if the executor has an
       :class:`~repro_torch.runtime.integrity.IntegrityConfig`, downgrade
       ``policy="strict"`` to ``"quarantine"`` so the offending updates
       are masked to dead letters instead of failing the run.
    4. **reevaluate_from_base** — restore the newest snapshot, recompute
       every view from stored base relations via the ``Reevaluate``
       interpreter (ground truth), re-commit the healed snapshot at the
       same offset, and resume.

    A rung that is not applicable (no checkpoint, only one snapshot, no
    integrity config, no stored base) falls back down the ladder; each
    log entry records the ``action`` taken."""

    max_restarts: int = 3
    backoff_s: float = 0.1
    nan_is_failure: bool = True
    escalate: bool = True

    #: escalation rungs, climbed on consecutive failures
    LADDER = ("restart", "restore_previous_snapshot", "quarantine_batch",
              "reevaluate_from_base")

    def run(self, executor, stream):
        """Drive ``executor.resume(stream)`` to completion.
        Returns (final_state, restarts, log)."""
        stream = list(stream)
        restarts = 0
        log: list[dict] = []
        while True:
            try:
                state = executor.resume(stream)
                if self.nan_is_failure:
                    self._check_finite(executor.engine)
                log.append({"restarts": restarts, "ok": True})
                return state, restarts, log
            except Exception as e:  # noqa: BLE001 — restart path
                restarts += 1
                if restarts > self.max_restarts:
                    log.append({"restarts": restarts, "failure": repr(e)})
                    raise RuntimeError(
                        f"restart budget exhausted after {restarts - 1} "
                        "restarts") from e
                action = (self._escalation(executor, e, restarts)
                          if self.escalate else "restart")
                log.append({"restarts": restarts, "failure": repr(e),
                            "action": action})
                time.sleep(self.backoff_s * (2 ** (restarts - 1)))

    # -------------------------------------------------------- escalation
    def _escalation(self, executor, error, restarts: int) -> str:
        """Pick and *apply* the recovery rung for this failure; the next
        loop iteration's ``resume`` then runs against the mutated state
        (quarantined snapshot, relaxed policy, healed checkpoint)."""
        from . import integrity as integrity_mod

        cfg = getattr(executor, "integrity", None)
        if isinstance(error, integrity_mod.StreamIntegrityError):
            # an integrity failure will deterministically recur on plain
            # restart — jump straight to a rung that changes something
            if cfg is not None and cfg.policy == "strict":
                cfg.policy = "quarantine"
                return "quarantine_batch"
            return self._reevaluate(executor)
        rung = self.LADDER[min(restarts - 1, len(self.LADDER) - 1)]
        if rung == "restore_previous_snapshot":
            ck = getattr(executor, "checkpoint", None)
            steps = ck.ckpt.all_steps() if ck is not None else []
            if len(steps) > 1:
                ck.ckpt.discard_pending()
                ck.ckpt.quarantine_step(steps[-1])
                return "restore_previous_snapshot"
            return "restart"  # nothing older to fall back to
        if rung == "quarantine_batch":
            if cfg is not None and cfg.policy == "strict":
                cfg.policy = "quarantine"
                return "quarantine_batch"
            return self._reevaluate(executor)
        if rung == "reevaluate_from_base":
            return self._reevaluate(executor)
        return "restart"

    @staticmethod
    def _reevaluate(executor) -> str:
        """Last rung: heal the newest snapshot by recomputing every view
        from stored base relations, re-commit it at the same offset, and
        let the next resume pick it up.  Falls back to plain restart when
        the executor has no checkpoint or no stored base."""
        from . import integrity as integrity_mod

        ck = getattr(executor, "checkpoint", None)
        engine = getattr(executor, "engine", None)
        if ck is None or engine is None:
            return "restart"
        try:
            ck.ckpt.discard_pending()
            meta = ck.restore_into(engine)
            if meta is None:
                return "restart"
            integrity_mod.reevaluate_from_base(engine)
            ck.save_boundary(engine, offset=int(meta["offset"]),
                             segment=int(meta.get("segment", -1)),
                             blocking=True)
            return "reevaluate_from_base"
        except integrity_mod.StreamIntegrityError:
            return "restart"  # no stored base relations to recompute from

    @staticmethod
    def _check_finite(engine) -> None:
        """Raise FloatingPointError if any float view payload is
        non-finite (the float-ring analogue of the trainer's NaN-loss
        guard; integer rings vacuously pass).  One host read a view."""
        import torch
        from torch.utils import _pytree as pytree

        for name, view in engine.views.items():
            flags = [torch.isfinite(leaf).all()
                     for leaf in pytree.tree_leaves(view)
                     if leaf.is_floating_point()]
            if flags and not bool(torch.stack(flags).all()):
                raise FloatingPointError(
                    f"non-finite payload in view {name!r}")


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time baseline; flags steps slower than factor× baseline.
    On a cluster the mitigation is re-dispatch / hot-spare swap of the slow
    host; the monitor's verdicts drive that decision."""

    factor: float = 3.0
    alpha: float = 0.1
    _ewma: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self._ewma is not None and dt > self.factor * self._ewma:
            is_straggler = True
            self.events.append({"step": step, "dt": dt, "baseline": self._ewma})
        else:
            # stragglers are excluded from the baseline update
            self._ewma = dt if self._ewma is None else (
                (1 - self.alpha) * self._ewma + self.alpha * dt)
        return is_straggler

    @property
    def baseline(self) -> float | None:
        return self._ewma


# ---------------------------------------------------------------------------
# Elastic membership
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Node:
    node_id: str
    n_chips: int
    last_heartbeat: float


class ClusterState:
    """Heartbeat registry + elastic mesh planning."""

    def __init__(self, heartbeat_timeout_s: float = 30.0):
        self.timeout = heartbeat_timeout_s
        self.nodes: dict[str, Node] = {}

    def heartbeat(self, node_id: str, n_chips: int = 4,
                  now: float | None = None) -> None:
        now = time.time() if now is None else now
        self.nodes[node_id] = Node(node_id, n_chips, now)

    def healthy(self, now: float | None = None) -> list[Node]:
        now = time.time() if now is None else now
        return [n for n in self.nodes.values()
                if now - n.last_heartbeat <= self.timeout]

    def healthy_chips(self, now: float | None = None) -> int:
        return sum(n.n_chips for n in self.healthy(now))

    def plan_mesh(self, *, model_parallel: int = 16,
                  now: float | None = None) -> tuple[int, int]:
        """Largest (data, model) mesh shape over healthy chips: model axis
        fixed (TP degree is a model property), data axis = largest power of
        two of remaining chips.  Returns (data, model)."""
        chips = self.healthy_chips(now)
        data = chips // model_parallel
        if data < 1:
            raise RuntimeError(
                f"{chips} healthy chips cannot host model_parallel={model_parallel}")
        data_pow2 = 2 ** int(math.floor(math.log2(data)))
        return (data_pow2, model_parallel)
