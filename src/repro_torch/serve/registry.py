"""Version-stamped view snapshots published at segment boundaries (PyTorch
port of ``repro.serve.registry``).

The serving plane's consistency primitive: while the stream executor's
segments write the state in place (from segment 1 on, its CUDA graphs
replay on the same tensors), readers only ever touch :class:`Snapshot`
objects — device-side clones of the read-visible views, stamped with a
monotonically increasing generation and the cumulative stream offset they
correspond to.  An alias of the live views would tear; a clone is issued on
the current stream without a host synchronise, after the producing segment
and before the next segment's replays, so publication rides the same
discipline as the asynchronous checkpoint save — and the checkpointer
*reuses* these copies when both are attached
(``StreamCheckpointer.save_boundary(view_copies=)``).

Consistency contract:

* a generation is published atomically under the registry lock — a reader
  pinning generation ``g`` sees **every** view at ``g`` (the whole view
  hierarchy was copied from the same post-segment, post-audit engine
  state), never a mix of generations and never the in-flight state;
* generations are immutable once published — pins are refcounts, not
  locks on the writer;
* retention is double-buffered by default (``retain=2``): the newest
  ``retain`` generations stay readable without pinning, older ones are
  dropped unless pinned.  ``pin`` protects a generation from eviction for
  multi-query reads spanning segment boundaries.

On the card each snapshot also records the stream its clones were issued
on and an event after them (:attr:`Snapshot.stream`,
:attr:`Snapshot.ready`).  A reader on another stream waits on the event
and marks every tensor it reads as used on its stream
(``ViewServer._view``), so the caching allocator cannot hand an evicted
generation's memory to the next segment while a read of it is queued.

Thread safety: ``publish`` runs on the stream thread, ``pin`` /
``release`` / ``latest`` on any reader thread; all registry state is
guarded by one lock.  The snapshot tensors are never written, so lookups
on a pinned snapshot need no lock at all.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Mapping, Sequence

import torch
from torch.utils import _pytree as pytree

from ..core.relations import is_sharded
from ..core.storage import SparseRelation


@dataclasses.dataclass
class Snapshot:
    """One published generation: device-side view copies, never written.

    ``offset`` is the cumulative stream offset the views correspond to (how
    many leading updates of the run's stream are fully applied) — the replay
    cursor an offline recomputation of this generation uses; -1 when
    unknown (bootstrap publish of a pre-existing engine state)."""

    generation: int
    offset: int
    segment: int
    views: dict[str, Any]
    published_at: float
    meta: dict = dataclasses.field(default_factory=dict)
    #: host wall of the first read against this generation (staleness
    #: telemetry; None until read)
    first_read_at: float | None = None
    #: the CUDA stream the copies were issued on, and an event recorded on
    #: it after them (None off the card)
    stream: Any = None
    ready: Any = None


def copy_view(view):
    """A device copy of one view on new tensors, issued on the current
    stream: a sparse view's table and plane once each, any other pytree leaf
    by leaf.  A rank's slice of a sharded view is gathered whole (a
    collective every rank of its group makes, on the stream thread), so a
    snapshot is always the logical view and a reader never issues a
    collective."""
    if is_sharded(view):
        return view.logical()
    if isinstance(view, SparseRelation):
        return view.owned()
    return pytree.tree_map(torch.clone, view)


def _device_of(copies: Mapping[str, Any]):
    for v in copies.values():
        for leaf in pytree.tree_leaves(v):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return None


class SnapshotRegistry:
    """Double-buffered, generation-stamped view snapshots.

    ``views`` restricts publication to a subset of the engine's views
    (cheaper copies when only some views are served); ``None`` publishes the
    whole hierarchy.  ``segment_updates`` caps the number of stream updates
    between publications the same way the checkpointer's knob does — the
    executor splits segments so fresh generations appear even when capacity
    segmentation never would."""

    def __init__(self, retain: int = 2,
                 segment_updates: int | None = None,
                 views: Sequence[str] | None = None):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        if segment_updates is not None and segment_updates < 1:
            raise ValueError("segment_updates must be >= 1")
        self.retain = int(retain)
        self.segment_updates = segment_updates
        self.view_names = tuple(views) if views is not None else None
        self._lock = threading.Lock()
        self._snaps: dict[int, Snapshot] = {}
        self._pins: dict[int, int] = {}
        #: newest published generation (-1 before the first publish)
        self.generation: int = -1
        self.publishes: int = 0
        self.last_publish_seconds: float = 0.0
        #: publish→first-read latencies (seconds) of retired generations
        self._first_read_s: list[float] = []

    # ------------------------------------------------------------- publish
    def publish(self, views: Mapping[str, Any], offset: int = -1,
                segment: int = -1, meta: dict | None = None) -> Snapshot:
        """Copy the read-visible views and stamp a new generation.

        Called by the stream thread at segment boundaries (after the audit
        hook, so a repaired state — never a drifted one — is what readers
        see).  The clones are issued on the current stream without a host
        synchronise, ahead of the next segment's in-place replays.  Returns
        the new :class:`Snapshot`."""
        t0 = time.perf_counter()
        names = (self.view_names if self.view_names is not None
                 else tuple(views))
        # by name: a sharded view's copy is a collective, which every rank
        # must issue in the same order
        copies = {n: copy_view(views[n]) for n in sorted(names)}
        stream = ready = None
        device = _device_of(copies)
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            ready = torch.cuda.Event()
            ready.record(stream)
        with self._lock:
            gen = self.generation + 1
            snap = Snapshot(generation=gen, offset=int(offset),
                            segment=int(segment), views=copies,
                            published_at=time.perf_counter(),
                            meta=dict(meta or {}), stream=stream, ready=ready)
            self._snaps[gen] = snap
            self.generation = gen
            self.publishes += 1
            self._evict_locked()
        self.last_publish_seconds = time.perf_counter() - t0
        return snap

    def _evict_locked(self) -> None:
        floor = self.generation - self.retain + 1
        for g in [g for g in self._snaps
                  if g < floor and not self._pins.get(g)]:
            snap = self._snaps.pop(g)
            if snap.first_read_at is not None:
                self._first_read_s.append(
                    snap.first_read_at - snap.published_at)

    # ----------------------------------------------------------------- read
    def latest(self) -> Snapshot:
        """The newest published generation (no pin — the snapshot object
        stays valid even if evicted, but new reads should re-fetch)."""
        with self._lock:
            if self.generation < 0:
                raise LookupError("no generation published yet")
            return self._snaps[self.generation]

    def get(self, generation: int) -> Snapshot:
        with self._lock:
            snap = self._snaps.get(generation)
        if snap is None:
            raise LookupError(
                f"generation {generation} is not retained (newest is "
                f"{self.generation}, retain={self.retain}) — pin "
                "generations you need across publishes")
        return snap

    def pin(self, generation: int | None = None) -> Snapshot:
        """Pin a generation (default: newest) against eviction.

        Every pin must be matched by a :meth:`release`; a pinned generation
        survives arbitrarily many later publishes, so a reader can issue a
        multi-query, multi-view session against one consistent state while
        the stream advances."""
        with self._lock:
            g = self.generation if generation is None else int(generation)
            snap = self._snaps.get(g)
            if snap is None:
                raise LookupError(
                    f"generation {g} is not retained (newest is "
                    f"{self.generation})")
            self._pins[g] = self._pins.get(g, 0) + 1
            return snap

    def release(self, generation: int) -> None:
        with self._lock:
            g = int(generation)
            n = self._pins.get(g, 0)
            if n <= 1:
                self._pins.pop(g, None)
            else:
                self._pins[g] = n - 1
            self._evict_locked()

    def note_read(self, snap: Snapshot) -> None:
        """Record the first read against a generation (publish-to-first-read
        latency telemetry)."""
        if snap.first_read_at is None:
            snap.first_read_at = time.perf_counter()

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        with self._lock:
            lat = list(self._first_read_s)
            lat += [s.first_read_at - s.published_at
                    for s in self._snaps.values()
                    if s.first_read_at is not None]
            return dict(
                generation=self.generation,
                publishes=self.publishes,
                retained=len(self._snaps),
                pinned={g: n for g, n in self._pins.items()},
                publish_s=self.last_publish_seconds,
                publish_to_first_read_s=(
                    sorted(lat)[len(lat) // 2] if lat else None),
            )
