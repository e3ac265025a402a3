"""Plan-driven sharding of the engine state over ``torch.distributed``
(PyTorch port of ``repro.core.shard``; DESIGN.md §9).

The placement is decided at plan time, from the same compiled
:class:`repro_torch.core.plan.TriggerPlan` objects every execution path
replays, exactly as in the reference:

* **write sets** name the views whose ⊎ sites want their key space split —
  each row lands on the rank that owns its key or slot range;
* **read views** (``TriggerPlan.read_views``) name the views sibling
  gathers and joins read *by key*; such a read must see the whole axis, so
  it runs a collective;
* everything else — read-only views, indicator planes, base relations,
  layouts whose leading extent does not divide the group — replicates.

:func:`plan.collective_placement` performs that classification and
:func:`plan_shards` turns it into a :class:`ShardPlan`: a 1-D mesh (a group
of ranks) and one :class:`ShardSpec` per view.  The specs, their reasons
and :meth:`ShardPlan.pretty` are the reference's, for the same plans.

Execution differs.  The reference relies on GSPMD: ``place`` puts the state
under ``NamedSharding``s and XLA places the collectives.  PyTorch has no
partitioner that sees through the port's hand ⊎ and hash kernels, so the
port runs **explicit SPMD**: one process is one rank, and

* each rank holds only its slice of each sharded view
  (``relations.ShardedDense``: the rows of its leading keys;
  ``storage.ShardedSparse``: the payload rows of its slot range beside the
  whole key table, which linear probing needs);
* update rows are replicated (:meth:`ShardPlan.replicate` broadcasts them
  from rank 0), so every rank sees every row and computes the same delta;
* each ⊎ keeps only the writes to the range its rank owns (a row another
  rank owns gets id -1, which every ⊎ kernel drops; the rest are offset to
  the local plane), so the plan ops do not change shape;
* a by-key read of an ``all_gather`` view gathers the rows the rank owns —
  rows it does not own read as the ring's zero — and one all-reduce over
  the batch completes it (``repro_torch.core.collectives``); a read of the
  whole view (a join that densifies it, a publish, a save, a rehash)
  gathers the whole view.

The result is the same computation in a different partition: bitwise for
integer-valued payloads, and within reduction-order tolerance for general
floats (the hand ⊎ kernels' atomics are order-free).  At one rank nothing
is split and the executor runs exactly the unsharded program.

A group is made with :func:`make_mesh` over an initialized
``torch.distributed`` process group (NCCL on one card a rank; gloo for
several ranks on one card, or on the CPU).  :func:`plan_shards` also takes a
bare world size, which plans the specs without a group (it cannot place).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from torch.utils import _pytree as pytree

from . import plan as plan_mod
from .collectives import Placement, ShardGroup, ShardSlice, broadcast
from .relations import ShardedDense, is_sharded
from .storage import ShardedSparse, SparseRelation, comp_width

#: mesh axis every sharded view axis maps onto
AXIS = "view"

__all__ = ["AXIS", "Mesh", "Placement", "ShardPlan", "ShardSpec",
           "make_mesh", "plan_shards", "replan_shards", "shard_executor"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Placement decision for one state entry."""

    name: str
    kind: str  # "shard" | "replicate"
    axis: str | None  # "lead" (dense key axis) | "slot" (sparse) | None
    collective: str | None  # "scatter" | "all_gather" | None (replicated)
    extent: int  # size of the sharded axis (0 when replicated)
    reason: str

    def label(self) -> str:
        if self.kind == "replicate":
            return f"{self.name}: replicate ({self.reason})"
        return (f"{self.name}: shard {self.axis}[{self.extent}]"
                f" reads={self.collective} ({self.reason})")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: the ranks of one process group along one axis."""

    grp: ShardGroup
    axis_name: str = AXIS

    @property
    def size(self) -> int:
        return self.grp.size

    @property
    def rank(self) -> int:
        return self.grp.rank

    @property
    def backend(self) -> str:
        return self.grp.backend


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    """A 1-D mesh over the ranks of a group.

    ``devices`` is None (the default ``torch.distributed`` group when one
    is initialized, else this process alone), a process group, an int (a
    bare world size: plans, never places or runs a collective) or a
    :class:`Mesh`."""
    if isinstance(devices, Mesh):
        return devices if devices.axis_name == axis_name else Mesh(
            devices.grp, axis_name)
    if isinstance(devices, int):
        return Mesh(ShardGroup(None, int(devices), 0, "none"), axis_name)
    import torch.distributed as dist

    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            return Mesh(ShardGroup(None, 1, 0, "none"), axis_name)
        devices = dist.group.WORLD
    size = dist.get_world_size(devices)
    rank = dist.get_rank(devices)
    backend = str(dist.get_backend(devices)).lower()
    return Mesh(ShardGroup(devices, size, rank, backend), axis_name)


@dataclasses.dataclass
class ShardPlan:
    """A mesh plus per-view placement, applied by explicit SPMD.

    ``specs`` covers the engine's views; base relations and indicator
    states always replicate.  One plan serves an executor for its whole
    lifetime, across capacity-segment rehashes: a shard/replicate decision
    depends only on whether the view's axis extent divides the group,
    sparse capacities are powers of two and a rehash only doubles them, so
    every spec survives growth for power-of-two groups (a rehashed slice
    keeps its group and takes the new capacity's range)."""

    mesh: Mesh
    axis_name: str
    specs: dict[str, ShardSpec]

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def world_size(self) -> int:
        return self.mesh.size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def group(self):
        """The ``torch.distributed`` process group (None for one rank or a
        bare world size)."""
        return self.mesh.grp.group

    @property
    def backend(self) -> str:
        return self.mesh.backend

    # -------------------------------------------------------------- shardings
    def _sharded(self, name: str) -> bool:
        spec = self.specs.get(name)
        return spec is not None and spec.kind == "shard"

    def _replicated(self, tree):
        rep = Placement.replicate()
        return pytree.tree_map(lambda _: rep, tree)

    def state_shardings(self, state):
        """A :class:`Placement` per leaf of the state (the relations'
        pytree leaves, the reference's)."""
        views, base, indicators = state
        return (
            {n: v.leaf_shardings(self.mesh, self.axis_name, self._sharded(n))
             for n, v in views.items()},
            self._replicated(base),
            self._replicated(indicators),
        )

    # -------------------------------------------------------------- placement
    def place_view(self, name: str, view):
        """One view in its planned placement on this rank: its slice (new
        tensors) where the spec shards it over more than one rank, else the
        whole view.  A slice already placed over this group is kept; a
        slice of another group is gathered first (a collective over it)."""
        grp = self.mesh.grp
        if is_sharded(view):
            if view.shard.grp is grp and self._sharded(name):
                return view
            view = view.logical()
        if not self._sharded(name) or grp.size == 1:
            return view
        if grp.group is None:
            raise RuntimeError("a ShardPlan of a bare world size cannot "
                               "place state: plan over make_mesh(group)")
        if isinstance(view, SparseRelation):
            return ShardedSparse.place(view, grp)
        return ShardedDense.place(view, ShardSlice(
            grp, int(view.domains[0]), comp_width(view.domains[1:])))

    def place(self, state):
        """The state in its planned placement (views sliced where the plan
        shards them; base relations and indicators stay whole)."""
        views, base, indicators = state
        # by name: re-placing another group's slice is a collective
        placed = {n: self.place_view(n, views[n]) for n in sorted(views)}
        return ({n: placed[n] for n in views}, base, indicators)

    def replicate(self, tree):
        """Stream inputs replicated over the group: a copy of each tensor
        leaf holding rank 0's value on every rank (every rank consumes
        every update row)."""
        if self.mesh.size == 1:
            return tree
        return pytree.tree_map(
            lambda t: broadcast(t.clone(), self.mesh.grp), tree)

    # -------------------------------------------------------------- reporting
    def pretty(self) -> str:
        head = f"mesh[{self.axis_name}={self.n_devices}]"
        lines = [head] + [f"  {self.specs[n].label()}"
                          for n in sorted(self.specs)]
        return "\n".join(lines)

    def sharded_views(self) -> tuple:
        return tuple(sorted(n for n, s in self.specs.items()
                            if s.kind == "shard"))


def plan_shards(engine, rels: Sequence[str] | None = None,
                devices=None, axis_name: str = AXIS) -> ShardPlan:
    """Derive a :class:`ShardPlan` for an engine from its trigger plans.

    ``rels`` are the relations whose triggers the plan must serve
    (default: everything updatable); their compiled plans' write sets and
    read views drive :func:`plan.collective_placement`.  ``devices`` is
    what :func:`make_mesh` takes (an int plans for a bare world size).
    Derived against the engine's current views; the specs stay valid
    across segment rehashes (see :class:`ShardPlan`)."""
    mesh = make_mesh(devices, axis_name)
    n = mesh.size
    rels = tuple(rels if rels is not None else engine.updatable)
    views = engine.views

    plans = [engine.plans.lookup_sig(
        engine, rel, ("coo", tuple(engine.query.relations[rel]), 1))
        for rel in rels]

    def divisible(v) -> bool:
        ax = v.shard_axis()
        return ax is not None and v.shard_extent() % n == 0 \
            and v.shard_extent() >= n

    shardable = {name: divisible(v) for name, v in views.items()}
    placement = plan_mod.collective_placement(plans, shardable)

    specs: dict[str, ShardSpec] = {}
    for name, v in views.items():
        place = placement.get(name, "replicate")
        axis = "slot" if isinstance(v, SparseRelation) else "lead"
        if place == "replicate":
            if not shardable[name]:
                reason = "indivisible axis"
            elif name not in placement:
                reason = "untouched by these triggers"
            else:
                reason = "not scatter-written"
            specs[name] = ShardSpec(name, "replicate", None, None, 0,
                                    reason)
        else:
            reason = ("scatter-written, gathered by siblings"
                      if place == "all_gather"
                      else "scatter-written, never read by key")
            specs[name] = ShardSpec(name, "shard", axis, place,
                                    v.shard_extent(), reason)
    shard_plan = ShardPlan(mesh=mesh, axis_name=axis_name, specs=specs)

    # static multi-rank race check (rule race/shard-spec): every sharded
    # spec must agree with the plans' re-derived read/write sets before any
    # state is placed under it
    from ..analysis import verifier as verifier_mod

    if verifier_mod.verify_mode() == "on":
        verifier_mod.check_shard(shard_plan, plans, views)
    return shard_plan


def replan_shards(engine, old_plan: ShardPlan | None = None,
                  devices=None) -> ShardPlan:
    """Re-derive a plan for the *current* group — the mesh-elastic leg of
    crash recovery: checkpoints store logical arrays, so a run killed on
    one group restores onto whatever group the restarted job has, and only
    the placement plan (not the checkpoint) is rebuilt.  The old plan's
    axis name carries over; everything else — the group, and with it every
    divisibility-driven decision — is derived fresh."""
    axis_name = old_plan.axis_name if old_plan is not None else AXIS
    return plan_shards(engine, devices=devices, axis_name=axis_name)


def shard_executor(engine, devices=None, rels=None, checkpoint=None):
    """Derive a plan, place the engine's state under it, and return a
    group-aware ``StreamExecutor`` (optionally durable — see
    ``StreamExecutor.checkpoint``)."""
    from .stream import StreamExecutor

    plan = plan_shards(engine, rels=rels, devices=devices)
    engine.shard_state(plan)
    return StreamExecutor(engine, shard=plan, checkpoint=checkpoint)
