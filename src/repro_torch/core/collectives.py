"""The collective layer of the port's sharded execution (``core/shard.py``).

The reference partitions the scan carry with GSPMD and lets XLA place the
collectives.  The port runs explicit SPMD instead: one process is one rank
of a ``torch.distributed`` group, each rank holds only its slice of every
sharded view, every rank sees every update row, computes the same delta,
and keeps only the writes to the range it owns.  Cross-rank traffic is what
this module issues, and nothing else does:

* **read** — a by-key read of a sharded view (a sibling gather): each rank
  gathers the rows it owns of the batch, rows it does not own read as the
  ring's zero, and one all-reduce over the ``[B, d]`` batch completes it.
* **gather** — a whole sharded view made logical (a join that densifies
  it, a publish, a checkpoint save, a rehash that moves plane rows across
  ranks): each rank writes its rows into a zero ``[S, d]`` plane and one
  all-reduce (to every rank) or reduce (to rank 0) fills it.
* **broadcast** — stream inputs replicated from rank 0.

Sums run on the bit patterns (a float32 plane reinterpreted as int32):
every row has one owner and every other rank contributes zero bits, so the
sum is the owner's value exactly, a negative zero and a NaN included, on
every rank and in every reduction order.

Under NCCL a collective takes the device tensor itself and can be captured
in a CUDA graph.  Gloo reduces host tensors: a device tensor goes through
a host copy, so a gloo group's executor runs eagerly (``StreamExecutor``
says so in ``last_run_stats``).  :data:`STATS` counts every collective by
kind, with its bytes and the backend that ran it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: collectives issued, by kind: ``{kind: {"calls", "bytes", "backend"}}``
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def _record(kind: str, t: torch.Tensor, backend: str) -> None:
    entry = STATS.setdefault(kind, {"calls": 0, "bytes": 0,
                                    "backend": backend})
    entry["calls"] += 1
    entry["bytes"] += t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class ShardGroup:
    """One rank's view of its group: the ``torch.distributed`` process
    group (None for a bare world size, which plans but cannot place), the
    group's size, this process's rank in it, and the backend."""

    group: Any
    size: int
    rank: int
    backend: str  # "nccl" | "gloo" | "none"

    @property
    def capturable(self) -> bool:
        """Whether the group's collectives may run inside a CUDA graph
        capture (NCCL), or it never issues one (a single rank)."""
        return self.size == 1 or self.backend == "nccl"

    def _require(self) -> None:
        if self.group is None and self.size > 1:
            raise RuntimeError(
                f"a bare world size ({self.size}) plans shards but has no "
                "process group to run collectives on: pass make_mesh(...)")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf of the state lives over a group: its dim 0 split
    into equal contiguous ranges over the mesh axis ``axis`` (rank r holds
    range r), or replicated whole on every rank.  The port's counterpart of
    a ``NamedSharding`` over a 1-D mesh."""

    kind: str  # "split" | "replicate"
    axis: str | None = None
    #: the group a split leaf is split over (None: planned, not placed)
    grp: Any = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def split(cls, axis: str, grp: "ShardGroup | None" = None) -> "Placement":
        return cls("split", axis, grp)

    @classmethod
    def replicate(cls) -> "Placement":
        return cls("replicate")

    def take(self, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf: its range of dim 0 when split
        over a group of more than one rank, else the leaf."""
        if self.kind != "split" or self.grp is None or self.grp.size == 1:
            return leaf
        n = leaf.shape[0] // self.grp.size
        return leaf[self.grp.rank * n:(self.grp.rank + 1) * n]


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` reinterpreted as integers of its width (itself if integral)."""
    if t.is_floating_point():
        return t.view(_BITS[t.element_size()])
    return t


def _reduce(t: torch.Tensor, grp: ShardGroup, dst: int | None) -> None:
    """Sum ``t`` over the group in place (to every rank, or to ``dst``)."""
    import torch.distributed as dist

    grp._require()
    bits = _bits(t)
    host = bits.cpu() if grp.backend == "gloo" and bits.is_cuda else bits
    if dst is None:
        dist.all_reduce(host, group=grp.group)
    else:
        dist.reduce(host, dst=dist.get_global_rank(grp.group, dst),
                    group=grp.group)
    if host is not bits:
        bits.copy_(host)


def complete_read(rows: torch.Tensor, grp: ShardGroup) -> torch.Tensor:
    """Finish a by-key read: ``rows`` ``[B, d]`` holds this rank's owned
    rows and zeros elsewhere; returns the whole batch on every rank."""
    rows = rows.contiguous()
    if grp.size > 1:
        _record("read", rows, grp.backend)
        _reduce(rows, grp, None)
    return rows


def gather_rows(local: torch.Tensor, grp: ShardGroup, row_lo: int,
                total: int, dst: int | None = None) -> torch.Tensor:
    """The logical ``[total, d]`` plane of a view whose rank-local rows are
    ``local`` (starting at global row ``row_lo``): on every rank, or only
    on rank ``dst`` (the others get their own rows in a zero plane)."""
    if grp.size == 1:
        return local.clone()
    full = local.new_zeros((total, local.shape[1]))
    full[row_lo:row_lo + local.shape[0]] = local
    _record("gather", full, grp.backend)
    _reduce(full, grp, dst)
    return full


def broadcast(t: torch.Tensor, grp: ShardGroup, src: int = 0) -> torch.Tensor:
    """``t`` replaced by rank ``src``'s value on every rank (in place)."""
    import torch.distributed as dist

    if grp.size == 1:
        return t
    grp._require()
    _record("broadcast", t, grp.backend)
    host = t.cpu() if grp.backend == "gloo" and t.is_cuda else t
    dist.broadcast(host, src=dist.get_global_rank(grp.group, src),
                   group=grp.group)
    if host is not t:
        t.copy_(host)
    return t


def barrier(grp: ShardGroup) -> None:
    import torch.distributed as dist

    if grp.size > 1:
        grp._require()
        dist.barrier(group=grp.group)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSlice:
    """The range of one view's shard axis that one rank owns.

    ``extent`` is the axis's global size (a dense view's leading key
    domain, a sparse view's capacity) and ``row_width`` the plane rows one
    index of the axis spans (the trailing key domains' product; 1 for a
    slot axis).  Rank r owns indices ``[r·e/n, (r+1)·e/n)``: a contiguous
    range of plane rows."""

    grp: ShardGroup
    extent: int
    row_width: int = 1

    @property
    def per_rank(self) -> int:
        return self.extent // self.grp.size

    @property
    def rows(self) -> int:
        """Plane rows this rank holds (its zero row excluded)."""
        return self.per_rank * self.row_width

    @property
    def total_rows(self) -> int:
        return self.extent * self.row_width

    @property
    def lo(self) -> int:
        """The first index of the shard axis this rank owns."""
        return self.grp.rank * self.per_rank

    @property
    def row_lo(self) -> int:
        return self.lo * self.row_width

    def _local(self, ids: torch.Tensor, other: int) -> torch.Tensor:
        """Global plane rows → this rank's rows, ``other`` where another
        rank owns the row (or the id is a padding id < 0)."""
        lo = self.row_lo
        ids = ids.to(torch.int32)
        own = (ids >= lo) & (ids < lo + self.rows)
        return torch.where(own, ids - lo, other).to(torch.int32)

    def route(self, ids: torch.Tensor) -> torch.Tensor:
        """Write routing: a row another rank owns becomes -1, which every
        ⊎ kernel drops."""
        return self._local(ids, -1)

    def read_index(self, ids: torch.Tensor) -> torch.Tensor:
        """Read routing: a row another rank owns reads the local zero row
        (index :attr:`rows`)."""
        return self._local(ids, self.rows)

    def read(self, plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The global rows ``ids`` of a view whose local plane (zero row
        last) is ``plane``: ``[B, d]`` on every rank."""
        rows = plane.index_select(0, self.read_index(ids).long())
        return complete_read(rows, self.grp)

    def gather(self, local_rows: torch.Tensor, dst: int | None = None):
        """The view's logical ``[total_rows, d]`` plane (:func:`gather_rows`;
        with ``dst``, whole on that rank only)."""
        return gather_rows(local_rows, self.grp, self.row_lo, self.total_rows,
                           dst=dst)

    def take(self, full_rows: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a logical plane, as a new local plane with
        its zero row appended."""
        lo = self.row_lo
        out = full_rows.new_zeros((self.rows + 1, full_rows.shape[1]))
        out[:self.rows] = full_rows[lo:lo + self.rows]
        return out
