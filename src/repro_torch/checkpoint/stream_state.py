"""Durable IVM engine snapshots for the stream executor (PyTorch port of
``repro.checkpoint.stream_state``).

A snapshot is the engine's *canonical state* — every dense view plane,
every hashed-COO key table and payload (zombie slots and all, so
occupancy budgets survive the round-trip), stored base relations, and
indicator counts and planes — plus a manifest ``meta`` carrying what leaf
arrays alone cannot reconstruct:

* ``offset``   — how many stream updates the snapshot has fully applied
  (the replay cursor: ``StreamExecutor.resume`` skips exactly this many),
* ``segment``  — the boundary index that produced the save (telemetry),
* ``layouts``  — per-view physical layout (``storage.export_layout``);
  sparse capacities are leaf *shapes*, so the restore template is rebuilt
  to the checkpointed capacity (``storage.layout_template``),
* ``storage_sig`` — the ``plan.storage_signature`` fingerprint of the
  snapshot; restoring changes the engine's storage signature, which is
  the plan-cache key component that makes stale plans unreachable.

The leaves are the reference's, in its order (dicts by sorted key; a sparse
view's table, then its payload components), so one state gives the same
manifest ``leaves`` — shapes, dtypes and CRC32s — in both packages.

Boundary saves are asynchronous and never synchronise the host.  From the
second segment on the stream executor runs each segment's graph replays on
the state's own tensors, in place, so the writer cannot read those: the
save issues a ``clone()`` of each leaf on the current stream — after the
finished segment's replays, before the next segment's — so stream order
alone makes the copy exact.  The checkpointer records an event after the
clones; its writer thread waits on that event on a side stream, copies
into pinned host buffers and commits (see
``repro_torch.checkpoint.checkpointer``).

Restores install new tensors (so the executor's next run on them captures
its graphs anew).  A torn or corrupt newest step falls back to the
previous committed one.

A sharded engine (``repro_torch.core.shard``) saves the same logical
arrays: each sharded view is gathered to rank 0 (or the serving plane's
logical copies are reused), rank 0 alone writes and commits, and every
rank waits for it at a barrier in :meth:`StreamCheckpointer.wait`.  A
restore reads the logical arrays on every rank;
``StreamExecutor.resume`` then re-plans for the current group and places
each rank's slice.
"""
from __future__ import annotations

import logging
import time

from torch.utils import _pytree as pytree

from ..core import collectives
from ..core import plan as plan_mod
from ..core import storage as storage_mod
from ..core.ivm import canonical_state
from ..core.relations import is_sharded
from .checkpointer import CORRUPTION_ERRORS, Checkpointer

log = logging.getLogger("repro_torch.checkpoint")


def _sorted_state(state):
    """A ``(views, base, indicators)`` state with each dict in sorted key
    order: the reference's (JAX's) flattening order."""
    return tuple(dict(sorted(part.items())) for part in state)


class StreamCheckpointer:
    """Segment-boundary engine snapshots over a :class:`Checkpointer`.

    ``segment_updates`` additionally caps how many stream updates run
    between boundaries: capacity segmentation only splits where a sparse
    table must grow, which on a dense-only or generously-sized engine is
    *never* — a durability knob must not depend on storage pressure.
    ``None`` checkpoints only at capacity boundaries (plus the final
    state)."""

    def __init__(self, directory: str, keep: int = 3,
                 segment_updates: int | None = None):
        self.ckpt = Checkpointer(directory, keep=keep)
        if segment_updates is not None and segment_updates < 1:
            raise ValueError("segment_updates must be >= 1")
        self.segment_updates = segment_updates
        #: host seconds spent *dispatching* the last boundary save (the
        #: stall the executor's loop pays; the write itself runs on the
        #: writer thread — see ``write_seconds``)
        self.last_dispatch_seconds: float = 0.0
        #: the group of the last sharded save (its ranks meet in :meth:`wait`)
        self._group = None

    # ------------------------------------------------------------------ save
    def save_boundary(self, engine, offset: int, segment: int,
                      blocking: bool = False,
                      view_copies: dict | None = None) -> None:
        """Snapshot ``engine`` as having applied ``offset`` stream updates.

        Async by default: hands the writer thread device clones of every
        leaf and returns without a host synchronise.

        ``view_copies`` are already-issued device copies of (some of) the
        engine's views — the serving plane's registry (ROADMAP Queue 1
        item 17) publishes copies at the same boundary, and a boundary that
        both publishes and checkpoints must not copy each view twice: only
        the remaining leaves (unserved views, base relations, indicators)
        are cloned here."""
        t0 = time.perf_counter()
        state = _sorted_state(engine.canonical_state())
        grp = next((v.shard.grp for v in engine.views.values()
                    if is_sharded(v)), None)
        if grp is not None:
            # logical arrays: each sharded view gathered to rank 0 (a
            # collective every rank makes), or the publish's logical copies
            have = dict(view_copies or {})
            for name, v in state[0].items():
                if is_sharded(v) and name not in have:
                    have[name] = v.logical(dst=0)
            state = ({n: have.get(n, v) for n, v in state[0].items()},
                     state[1], state[2])
            view_copies = {n: have[n] for n in state[0] if n in have}
            self._group = grp
            if grp.rank != 0:  # rank 0 alone writes and commits
                self.last_dispatch_seconds = time.perf_counter() - t0
                return
        meta = {
            "offset": int(offset),
            "segment": int(segment),
            "layouts": {name: storage_mod.export_layout(v)
                        for name, v in engine.views.items()},
            "storage_sig": [list(entry) for entry in
                            plan_mod.storage_signature(engine.views)],
        }
        if blocking:
            self.ckpt.save(state, step=int(offset), blocking=True,
                           meta=meta, sync_copy=True)
        else:
            given = (view_copies or {}, {}, {})
            copies = []
            for part, have in zip(state, given):
                for name, rel in part.items():
                    if name in have:
                        copies.extend(pytree.tree_leaves(have[name]))
                    else:
                        copies.extend(x.clone() for x in pytree.tree_leaves(rel))
            self.ckpt.save_leaves(copies, str(pytree.tree_structure(state)),
                                  step=int(offset), blocking=False, meta=meta,
                                  sync_copy=False)
        self.last_dispatch_seconds = time.perf_counter() - t0

    def wait(self) -> None:
        """Block until the pending boundary save committed (re-raising a
        writer failure — see ``Checkpointer.wait``); after a sharded save,
        every rank of its group waits here for rank 0's commit."""
        self.ckpt.wait()
        if self._group is not None:
            collectives.barrier(self._group)

    # -------------------------------------------------------------- telemetry
    @property
    def write_seconds(self) -> float:
        """Cumulative writer wall seconds across committed saves."""
        return self.ckpt.total_write_seconds

    @property
    def saves_committed(self) -> int:
        return self.ckpt.saves_committed

    # --------------------------------------------------------------- restore
    def latest_offset(self) -> int | None:
        """Stream offset of the newest committed snapshot, or None."""
        steps = self.ckpt.all_steps()
        return steps[-1] if steps else None

    def restore_into(self, engine) -> dict | None:
        """Restore the newest *readable* snapshot into ``engine``.

        The restore template is rebuilt per step from the manifest's
        ``layouts`` (the engine's live capacities — or even backends —
        need not match the checkpoint's).  A step whose manifest or
        leaves are torn, fail the checksum, or mismatch the snapshot's
        *own* layout manifest is quarantined (``corrupt_step_*`` — out of
        the restorable set and the ``keep=`` retention count) and the
        restore falls back to the previous committed step.  Returns the
        restored step's ``meta`` (offset/segment/layouts), or None when
        nothing is restorable.  The engine gets new tensors on its device,
        each relation in the layout the engine owns (one ``[S, d]`` plane
        a relation); a sparse view keeps the snapshot's capacity and its
        zombie slots."""
        for step in reversed(self.ckpt.all_steps()):
            try:
                meta = self.ckpt.read_meta(step)
                layouts = meta["layouts"]
                views_t = {
                    name: storage_mod.layout_template(v, layouts[name])
                    for name, v in engine.views.items()
                }
                template = _sorted_state(canonical_state(
                    (views_t, engine.base, engine.indicators)))
                state = self.ckpt.restore(template, step)
            except CORRUPTION_ERRORS + (AssertionError,) as e:
                # the template came from the snapshot's own manifest, so
                # a leaf-shape assertion here is self-inconsistency of
                # the snapshot — corruption, not a caller mismatch
                log.warning(
                    "snapshot step %d unreadable (%r); quarantining and "
                    "falling back to the previous committed step", step, e)
                self.ckpt.quarantine_step(step)
                continue
            except Exception as e:  # noqa: BLE001 — fall back to older step
                log.warning(
                    "snapshot step %d unreadable (%r); falling back to the "
                    "previous committed step", step, e)
                continue
            engine.set_state(canonical_state(tuple(
                {name: restored[name].owned() for name in live}
                for restored, live in zip(state, engine.state))))
            # restoring may change capacities → storage signature → the
            # plan-cache key: stale plans become unreachable automatically
            got = [list(entry)
                   for entry in plan_mod.storage_signature(engine.views)]
            if got != meta["storage_sig"]:
                raise AssertionError(
                    "restored storage signature diverges from the snapshot "
                    "fingerprint — layout template bug")
            return meta
        return None
