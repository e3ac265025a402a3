"""ViewServer: the consumer-facing front end of the serving plane (PyTorch
port of ``repro.serve.server``).

``ViewServer(executor, views=...)`` attaches a
:class:`~repro_torch.serve.registry.SnapshotRegistry` to a
:class:`~repro_torch.core.stream.StreamExecutor` (the executor publishes at
every segment boundary from then on) and answers batched point / range /
top-k lookups against the published generations while segments execute.

Request discipline (no host synchronise on the read path):

* every lookup is *batched* — callers hand whole key batches, the server
  pads them to the next power of two with ``-1`` rows (bounding the shapes a
  view's reads see to one a size class) and slices the pad back off.  Host
  keys are padded on the host and staged through pinned memory, then copied
  with ``non_blocking=True``;
* results are **device-resident** :class:`ReadResult` objects; nothing in
  the request path waits for the device.  Materialize explicitly with
  ``ReadResult.host()``, the only synchronise;
* reads run on the reader's current stream.  A read from another stream
  than the one a generation was published on waits on the publish's event
  and marks each tensor it reads as used on its stream
  (``Tensor.record_stream``), so an evicted generation's memory is not
  reused while the read is queued;
* multi-query consistency comes from generation pinning: ``with
  server.pin() as snap:`` answers every lookup inside the block against one
  generation of *every* view, no matter how many segments the stream
  completes meanwhile.

Staleness telemetry rides in :meth:`ViewServer.stats`: current generation,
generation lag of the last unpinned read, publish-to-first-read latency,
and the executor's per-segment stats (admit / dispatch / publish walls,
straggler verdicts).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.storage import next_pow2
from . import lookup as lookup_mod
from .registry import Snapshot, SnapshotRegistry

#: smallest padded batch — tiny interactive lookups share one size class
MIN_BATCH = 8


@dataclasses.dataclass
class ReadResult:
    """Device-resident lookup result, stamped with its generation."""

    view: str
    kind: str  # "point" | "range_sum" | "range_scan" | "top_k"
    generation: int
    data: Any  # pytree of device tensors

    def host(self):
        """Explicit device→host materialization (the only synchronise):
        the same pytree of numpy arrays."""
        return pytree.tree_map(lambda x: x.detach().cpu().numpy(), self.data)


class PinnedGeneration:
    """Context manager binding lookups to one pinned generation."""

    def __init__(self, server: "ViewServer", snap: Snapshot):
        self._server = server
        self._snap = snap
        self._released = False

    @property
    def generation(self) -> int:
        return self._snap.generation

    @property
    def offset(self) -> int:
        return self._snap.offset

    def point(self, view: str, keys, **kw) -> ReadResult:
        return self._server.point(view, keys, snapshot=self._snap, **kw)

    def range_sum(self, view: str, lo, hi) -> ReadResult:
        return self._server.range_sum(view, lo, hi, snapshot=self._snap)

    def range_scan(self, view: str, lo, hi, k: int) -> ReadResult:
        return self._server.range_scan(view, lo, hi, k, snapshot=self._snap)

    def top_k(self, view: str, k: int, **kw) -> ReadResult:
        return self._server.top_k(view, k, snapshot=self._snap, **kw)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._server.registry.release(self._snap.generation)

    def __enter__(self) -> "PinnedGeneration":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ViewServer:
    """Serve point / range / top-k lookups against a maintained hierarchy.

    ``executor`` is a :class:`StreamExecutor`; attaching the server sets
    ``executor.registry`` so every later run that takes the engine's own
    state publishes a generation a boundary (``segment_updates`` caps the
    boundaries' spacing like the checkpointer's knob).  The engine's
    *current* state is published at once as the bootstrap generation
    (``offset=bootstrap_offset``), so reads work before any stream runs.
    ``views`` restricts serving (and snapshot copies) to a subset of the
    hierarchy."""

    def __init__(self, executor, views: Sequence[str] | None = None,
                 retain: int = 2, segment_updates: int | None = None,
                 registry: SnapshotRegistry | None = None,
                 bootstrap_offset: int = 0):
        self.executor = executor
        self.engine = executor.engine
        if views is not None:
            missing = sorted(set(views) - set(self.engine.views))
            if missing:
                raise ValueError(f"unknown views: {missing}")
        self.registry = registry if registry is not None else \
            SnapshotRegistry(retain=retain,
                             segment_updates=segment_updates, views=views)
        executor.registry = self.registry
        self.registry.publish(self.engine.views, offset=bootstrap_offset,
                              segment=-1, meta=dict(bootstrap=True))
        #: generation of the most recent unpinned read (staleness lag)
        self._last_read_generation: int = self.registry.generation

    # ----------------------------------------------------------- snapshots
    def pin(self, generation: int | None = None) -> PinnedGeneration:
        """Pin a generation (default newest) for multi-query reads."""
        return PinnedGeneration(self, self.registry.pin(generation))

    def _resolve(self, snapshot: Snapshot | None,
                 generation: int | None) -> Snapshot:
        if snapshot is not None:
            return snapshot
        snap = (self.registry.latest() if generation is None
                else self.registry.get(generation))
        self._last_read_generation = snap.generation
        return snap

    def _view(self, snap: Snapshot, name: str):
        view = snap.views.get(name)
        if view is None:
            raise KeyError(f"view {name!r} is not served (registry publishes "
                           f"{sorted(snap.views)})")
        self.registry.note_read(snap)
        if snap.stream is not None:
            stream = torch.cuda.current_stream(snap.stream.device)
            if stream != snap.stream:
                # order the read after the publish's clones, and keep the
                # allocator from reusing the snapshot's memory for the
                # producer's stream until this read has run
                stream.wait_event(snap.ready)
                for leaf in pytree.tree_leaves(view):
                    leaf.record_stream(stream)
        return view

    def _device(self, snap: Snapshot, view) -> torch.device:
        if snap.stream is not None:
            return snap.stream.device
        leaf = pytree.tree_leaves(view)[0]
        return leaf.device

    @staticmethod
    def _pad_keys(keys, device) -> tuple[torch.Tensor, int]:
        """int32 keys [b, k] padded with ``-1`` rows to ``max(MIN_BATCH,
        next_pow2(b))`` on ``device``: a device tensor is padded there,
        host keys on the host and then copied through pinned memory without
        a synchronise."""
        if isinstance(keys, torch.Tensor) and keys.device.type != "cpu":
            keys = keys.to(device=device, dtype=torch.int32)
            if keys.dim() == 1:
                keys = keys[:, None]
            b = keys.shape[0]
            padded = max(MIN_BATCH, next_pow2(b))
            if padded != b:
                keys = torch.cat([keys, keys.new_full(
                    (padded - b, keys.shape[1]), -1)])
            return keys, b
        host = np.asarray(keys.numpy() if isinstance(keys, torch.Tensor)
                          else keys, dtype=np.int32)
        if host.ndim == 1:
            host = host[:, None]
        b = host.shape[0]
        padded = max(MIN_BATCH, next_pow2(b))
        out = torch.full((padded, host.shape[1]), -1, dtype=torch.int32,
                         pin_memory=device.type == "cuda")
        out[:b] = torch.from_numpy(host)
        return out.to(device, non_blocking=True), b

    # ------------------------------------------------------------- lookups
    def point(self, view: str, keys, *, generation: int | None = None,
              snapshot: Snapshot | None = None) -> ReadResult:
        """Batched point lookup; absent keys read ring zero."""
        snap = self._resolve(snapshot, generation)
        v = self._view(snap, view)
        padded, b = self._pad_keys(keys, self._device(snap, v))
        out = lookup_mod.point(v, padded)
        data = {c: arr[:b] for c, arr in out.items()}
        return ReadResult(view, "point", snap.generation, data)

    def range_sum(self, view: str, lo, hi, *,
                  generation: int | None = None,
                  snapshot: Snapshot | None = None) -> ReadResult:
        """⊕ over linearized key ids in [lo, hi)."""
        snap = self._resolve(snapshot, generation)
        v = self._view(snap, view)
        data = lookup_mod.range_sum(v, lo, hi)
        return ReadResult(view, "range_sum", snap.generation, data)

    def range_scan(self, view: str, lo, hi, k: int, *,
                   generation: int | None = None,
                   snapshot: Snapshot | None = None) -> ReadResult:
        """First ``k`` live keys in [lo, hi), ascending linearized order:
        data = dict(keys=[k, nk], payload={comp: [k, *shp]}, valid=[k])."""
        snap = self._resolve(snapshot, generation)
        v = self._view(snap, view)
        keys, payload, valid = lookup_mod.range_scan(v, lo, hi, int(k))
        return ReadResult(view, "range_scan", snap.generation,
                          dict(keys=keys, payload=payload, valid=valid))

    def top_k(self, view: str, k: int, *, component: str | None = None,
              index: tuple = (), generation: int | None = None,
              snapshot: Snapshot | None = None) -> ReadResult:
        """Top-``k`` live keys by one payload-plane entry: data =
        dict(keys=[k, nk], values=[k], valid=[k])."""
        snap = self._resolve(snapshot, generation)
        v = self._view(snap, view)
        keys, values, valid = lookup_mod.top_k(
            v, int(k), component=component, index=tuple(index))
        return ReadResult(view, "top_k", snap.generation,
                          dict(keys=keys, values=values, valid=valid))

    # ----------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Serving-plane health: the registry's generation and staleness
        telemetry plus the executor's per-segment stats (the reference's
        nine keys)."""
        reg = self.registry.stats()
        return dict(
            generation=reg["generation"],
            publishes=reg["publishes"],
            retained=reg["retained"],
            pinned=reg["pinned"],
            publish_s=reg["publish_s"],
            publish_to_first_read_s=reg["publish_to_first_read_s"],
            generation_lag=reg["generation"] - self._last_read_generation,
            last_segment_stats=list(self.executor.last_segment_stats),
            straggler_baseline=self.executor.stragglers.baseline,
        )
