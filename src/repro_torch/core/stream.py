"""Fused update-stream executor (PyTorch port of ``repro.core.stream``).

The eager engine replays each trigger op by op from Python, and on the card
the device idles while the host dispatches.  This module runs a whole
multi-relation stream through a few CUDA graphs instead:

  1. **Bucketing** — updates are grouped by schedule position and padded to
     a per-position bucket size.  Padding rows carry key ``0`` and ring-zero
     payloads, which ⊎ adds as an exact no-op, and indicator maintenance
     gates its ±1 deltas on per-row transitions, so padded rows leave the
     ∃ counts and planes as they were.
  2. **Stacking** — keys and payloads are stacked into ``[n_steps, B, ...]``
     tensors on the engine's device, once a stream.
  3. **Dispatch** — three shapes, picked by schedule structure, as in the
     reference:

     * ``scan``   — single-relation streams: one trigger a step.
     * ``rounds`` — (near-)periodic mixed schedules: a step is one round,
       one trigger per pattern position in order, with the sibling planes
       that several positions gather built once a round
       (``plan.shared_prep_ops``).  A trailing partial round runs once
       after the rounds, eagerly.
     * ``switch`` — aperiodic mixed schedules: a step is one relation's
       trigger; the host walks the schedule, which it knows at prepare
       time.

Every step runs the same compiled :class:`repro_torch.core.plan.TriggerPlan`
objects the eager path executes, fetched at prepare time from the engine's
plan cache.

**On the card** the unit of capture is one step body: the scan step, the
rounds round, or one relation's trigger in switch mode.  A body reads its
inputs as ``xs[counter]`` through a device-resident step counter, which it
then advances, so a replay copies nothing from the host and never
synchronises.  The state is updated in place at fixed addresses: where a
trigger returns a tensor that is not its leaf's own storage (reevaluation,
first-order and densified views), the body copies it back into the leaf,
and a trigger may replace only the leaves its plan's write set names
(``plan.state_write_mask``).  Warm-up: the first step of each body runs
eagerly on the real state, which builds what allocates or copies on first
use (lift relations, kernel libraries, cuBLAS handles); the body is then
captured, and every later step of it is a replay.  The graphs of one
signature share one memory pool.  They read the program's own input
buffers, into which each run copies its stream's stacked inputs on the
device, so any stream of the signature replays them; and they write the
state leaves they were captured against.  So a run on other state tensors
captures anew: the default run (``donate_input=False``) copies the state
and therefore warms up and captures on every call, while a run on the same
state (``donate_input=True`` on the engine's own state after an
``update_engine`` run) only replays.  A failed capture or replay raises; it
never falls back to eager execution.  Each wrapper's launch count sees
replays (``kernels._cuda.CapturedLaunches``).

**On the CPU** the same bodies, counter included, run eagerly step by step.

The state is ``(views, base, indicators)``: an indicator's counts and plane
are leaves like a view's, written in place by the trigger that bumps them,
so a step with an ``IndicatorBump`` is one graph like any other.

**Sparse views** are state like any other: their key tables and payload
planes are leaves that a trigger writes in place (``plan.relation_leaves``),
and the hash kernels that resolve their slots never synchronise, so a step
that writes one is captured as one graph.  Capacities are fixed inside a
prepared stream.  A raw stream run against the engine's own state is first
split into capacity segments (:func:`capacity_segments`): before a segment
whose worst-case inserts could cross a table's load-factor bound, the table
rehashes to a larger capacity, which changes the storage signature, so the
segment compiles its plans and captures its graphs anew
(:meth:`StreamExecutor._run_segmented`).  Sizing reads occupancy and the
stream's keys on the host: admission synchronises, replay does not.

**Durability and integrity** ride the segment boundaries
(:meth:`StreamExecutor._run_segmented`).  A run with a
``repro_torch.checkpoint.StreamCheckpointer`` or an active
``repro_torch.runtime.integrity.IntegrityConfig`` always takes the segment
loop, its segments capped at their ``segment_updates``.  Admission
validates each segment (``strict`` reads one flag vector on the host a
segment, ``quarantine`` none until the run's end), the audited Reevaluate
runs every ``audit_interval`` boundaries before the boundary's snapshot,
and the snapshot clones the state's leaves on the current stream, after
the segment's replays and before the next segment's, for a writer thread
that never synchronises the host.  :meth:`StreamExecutor.resume` restores
the newest committed snapshot and replays the rest of the stream; named
fault points (``repro_torch.runtime.faults``) let tests kill the run at
each stage, and ``repro_torch.runtime.fault_tolerance.StreamSupervisor``
drives resume through its escalation ladder.

**Serving** rides them too: with a ``repro_torch.serve.SnapshotRegistry``
attached (``registry=``, or a ``ViewServer`` that attaches one), every
boundary publishes device clones of the read-visible views as a new
generation, after the audit and before the save, and the save reuses those
clones (``save_boundary(view_copies=)``), so a boundary copies each served
view once.  Readers read the snapshots, never the state the next segment's
graphs write in place.

**Sharding**: with a ``repro_torch.core.shard.ShardPlan`` (``shard=``) the
executor is one rank of an explicit-SPMD group: each run places the state
under the plan (each rank holds its slice of every sharded view) and
replicates the stream's inputs from rank 0, every rank runs the same steps,
each ⊎ keeps the writes to its rank's range, and by-key reads of sharded
views run their collectives at the read site.  Under NCCL (or at one rank,
where nothing is split) the steps are captured as on one card; gloo
collectives cannot be captured, so a gloo group's executor runs the eager
program and says so in ``last_run_stats`` (``program``, ``program_reason``).
:meth:`StreamExecutor.resume` re-plans for the current group and re-places
the restored (logical) state: the mesh-elastic half of recovery.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Sequence

import torch
from torch.utils import _pytree as pytree

from ..kernels import _cuda
from ..runtime import faults
from ..runtime.fault_tolerance import StragglerMonitor
from . import plan as plan_mod
from . import storage as storage_mod
from .ivm import IVMEngine, canonical_state
from .relations import COOUpdate

#: longest schedule period run as a rounds body; longer periods take
#: switch dispatch
MAX_ROUNDS_PERIOD = 16


@dataclasses.dataclass
class PreparedStream:
    """A bucketed, stacked, device-resident update stream."""

    mode: str  # "scan" | "rounds" | "switch"
    rel_order: tuple[str, ...]  # distinct relations in first-seen order
    schemas: tuple[tuple[str, ...], ...]  # per-rel_order COO schemas
    pattern: tuple[str, ...]  # per-position relations ("rounds": one round)
    #: stacked inputs, leading dim n_steps: ``(keys, payload)`` (scan and
    #: switch, switch keys padded to the widest schema) or a tuple of them
    #: per pattern position (rounds)
    xs: Any
    n_steps: int
    buckets: tuple[int, ...]  # padded batch size per pattern position
    n_tuples: int  # true (unpadded) tuple count across the stream
    tail: Any = ()  # per-position (keys, payload) of the trailing partial round
    tail_len: int = 0
    #: embedded trigger plans: per pattern position (scan/rounds) or per
    #: rel_order entry (switch)
    plans: tuple = ()
    #: storage layout the plans were compiled against
    storage_sig: tuple = ()
    #: scatter-backend override active at prepare time
    backend_sig: str | None = None
    #: plan-fusion mode active at prepare time
    fusion_sig: str | None = None
    #: switch mode: the rel_order index of each step
    schedule: tuple = ()
    #: a sharded executor's group-replicated ``(mesh, xs, tail)``, cached
    #: beside the originals so the same prepared stream can still feed an
    #: unsharded executor
    placed: Any = None

    @property
    def signature(self):
        """Cache key of the executor's programs: the shapes and plans a
        step body is built for.  The stacked inputs, the tail and the switch
        schedule are read from the stream each run is given."""
        return (self.mode, self.rel_order, self.schemas, self.pattern,
                self.n_steps, self.buckets, self.tail_len, self.storage_sig,
                self.backend_sig, self.fusion_sig)


def _schedule_period(sched: Sequence[str]) -> int | None:
    """Smallest period p <= MAX_ROUNDS_PERIOD with sched[i] == sched[i - p]
    for every i >= p; None if the schedule is aperiodic.  A period must
    repeat (>= 2 full rounds); p == 1 (one relation) always counts.  Rotated
    round-robin streams and streams ending in a partial round canonicalize
    to (pattern, full rounds, tail)."""
    T = len(sched)
    for p in range(1, min(MAX_ROUNDS_PERIOD, T) + 1):
        if p > 1 and T // p < 2:
            break
        if all(sched[i] == sched[i - p] for i in range(p, T)):
            return p
    return None


class StreamCapacityError(RuntimeError):
    """A stream prepared as one program could overflow a sparse view's hash
    table.  Capacities are fixed inside a prepared stream, and an insert
    into a full table drops its row: run the raw stream through
    ``StreamExecutor.run(stream)`` instead, which splits it into capacity
    segments with a rehash between them."""


def check_stream_capacity(engine: IVMEngine, stream, views=None) -> None:
    """Worst-case insert-budget audit of a stream run as one program;
    raises :class:`StreamCapacityError` when a sparse view could cross its
    load-factor bound.

    Per (view, relation) the budget is the number of distinct projected
    update keys across the stream times the extent of the view variables
    the update does not bind, clamped to the view's domain product; the
    occupancy counts zombie slots.  Tables whose capacity covers their
    domain product are skipped.  ``views`` is the state the stream will run
    against (default: the engine's).  Reads occupancy and the stream's keys
    on the host (admission, never a replay)."""
    views = engine.views if views is None else views
    caps: dict[str, tuple] = {}
    for name, v in views.items():
        if not isinstance(v, storage_mod.SparseRelation):
            continue
        dom_prod = storage_mod.comp_width(v.domains)
        if v.capacity >= storage_mod.next_pow2(dom_prod):
            continue
        caps[name] = (v, v.num_slots_used_sync(), dom_prod)
    if not caps:
        return
    by_rel: dict[str, list[COOUpdate]] = {}
    for rel, upd in stream:
        by_rel.setdefault(rel, []).append(upd)
    rel_keys = {rel: torch.cat([u.keys for u in upds]).cpu()
                for rel, upds in by_rel.items()}
    offenders = []
    for name, (v, occ, dom_prod) in caps.items():
        budget = 0
        for rel, upds in by_rel.items():
            wv, _, _ = engine.plans.write_sets(engine, rel)
            if name not in wv:
                continue
            sch = tuple(upds[0].schema)
            extra = 1
            for var in v.schema:
                if var not in sch:
                    extra *= int(v.domain_of(var))
            cols = [sch.index(var) for var in v.schema if var in sch]
            distinct = (torch.unique(rel_keys[rel][:, cols], dim=0).shape[0]
                        if cols else 1)
            budget += min(distinct * extra, dom_prod)
        budget = min(budget, dom_prod)
        if occ + budget > storage_mod.LOAD_FACTOR * v.capacity:
            offenders.append(
                f"{name}: {occ} occupied + worst-case {budget} inserts > "
                f"{storage_mod.LOAD_FACTOR:.0%} of capacity {v.capacity}")
    if offenders:
        raise StreamCapacityError(
            "prepared stream could overflow sparse view(s) — "
            + "; ".join(offenders)
            + ".  Pass the raw stream to StreamExecutor.run() so it is split "
            "into capacity segments (rehash + recompile between them), or "
            "size the tables with more headroom "
            "(storage_opts=dict(headroom=...)).")


def capacity_segments(engine: IVMEngine, stream):
    """Split a raw stream so no sparse view's worst-case insert budget
    crosses the load-factor bound inside one segment: ``[(sub_stream,
    grow_caps), ...]``, where ``grow_caps`` maps view names to the capacity
    they rehash to before the segment runs.  Budgets are the eager growth
    path's (B × unbound-domain product a batch, clamped to the domain
    product) and occupancy is tracked conservatively, so a segment never
    drops a row; capacities stop growing at the domain product's power of
    two.  Reads each sparse view's occupancy on the host once."""
    caps: dict[str, int] = {}
    occ: dict[str, int] = {}
    full: dict[str, int] = {}
    for name, v in engine.views.items():
        if isinstance(v, storage_mod.SparseRelation):
            caps[name] = v.capacity
            occ[name] = v.num_slots_used_sync()
            full[name] = storage_mod.next_pow2(
                storage_mod.comp_width(v.domains))
    if not caps:
        return [(list(stream), {})]
    touched: dict[str, list[str]] = {}
    for rel in {r for r, _ in stream}:
        wv, _, _ = engine.plans.write_sets(engine, rel)
        touched[rel] = [n for n in wv if n in caps]

    def budget(name: str, rel: str, upd: COOUpdate) -> int:
        v = engine.views[name]
        return min(engine._insert_budget(v, rel, upd),
                   storage_mod.comp_width(v.domains))

    segments: list = []
    cur: list = []
    grow: dict[str, int] = {}
    for rel, upd in stream:
        need: dict[str, int] = {}
        for name in touched[rel]:
            b = budget(name, rel, upd)
            c = caps[name]
            while (c < full[name]
                   and occ[name] + b > storage_mod.LOAD_FACTOR * c):
                c *= 2
            if c != caps[name]:
                need[name] = c
        if need and cur:
            segments.append((cur, grow))
            cur, grow = [], {}
        if need:
            grow.update(need)
            caps.update(need)
        cur.append((rel, upd))
        for name in touched[rel]:
            occ[name] = min(occ[name] + budget(name, rel, upd), full[name])
    segments.append((cur, grow))
    return segments


def split_segments(segments, max_updates: int | None):
    """Subdivide capacity segments so no segment spans more than
    ``max_updates`` stream updates; the pre-segment rehash (``grow_caps``)
    stays attached to the first chunk."""
    if max_updates is None:
        return segments
    out = []
    for sub, grow in segments:
        for lo in range(0, len(sub), max_updates):
            out.append((sub[lo:lo + max_updates], grow if lo == 0 else {}))
    return out


def prepare_stream(engine: IVMEngine, stream: Sequence[tuple[str, COOUpdate]],
                   check_capacity: bool = True) -> PreparedStream:
    """Bucket, pad and stack a ``[(rel, COOUpdate), ...]`` stream on the
    engine's device, and fetch the trigger plan of every schedule position
    from the engine's plan cache.  ``check_capacity`` runs
    :func:`check_stream_capacity` first."""
    stream = list(stream)
    if not stream:
        raise ValueError("empty update stream")
    if check_capacity:
        check_stream_capacity(engine, stream)
    ring = engine.query.ring
    dev = engine.device
    sched = [rel for rel, _ in stream]
    rel_order = tuple(dict.fromkeys(sched))
    schemas: dict[str, tuple[str, ...]] = {}
    for rel, upd in stream:
        if not isinstance(upd, COOUpdate):
            raise TypeError("the stream executor takes COO streams; "
                            "factorized updates go through apply_update")
        sch = tuple(upd.schema)
        if schemas.setdefault(rel, sch) != sch:
            raise ValueError(f"inconsistent update schemas for {rel}")
    n_tuples = sum(upd.batch for _, upd in stream)
    comps = tuple(ring.components)
    sigs = dict(storage_sig=plan_mod.storage_signature(engine.views),
                backend_sig=plan_mod.active_backend_override(),
                fusion_sig=plan_mod.fusion_mode(dev))

    def plan_for(rel: str, bucket: int):
        return engine.plans.lookup_sig(engine, rel,
                                       ("coo", schemas[rel], bucket))

    def verified(plans: tuple) -> tuple:
        """The step-level static race check (rule race/memo-write): the
        CSE memo a step builds once must not name a view any plan of the
        step writes.  It rides stream preparation, not replay."""
        from ..analysis import verifier

        if verifier.verify_mode() == "on":
            verifier.check_step(plans)
        return plans

    def stack(upds: list[COOUpdate], bucket: int):
        padded = [u.pad_to(ring, bucket) for u in upds]
        keys = torch.stack([u.keys for u in padded]).to(dev)
        payload = {c: torch.stack([u.payload[c] for u in padded]).to(dev)
                   for c in comps}
        return keys, payload

    period = _schedule_period(sched)
    if period is not None:
        pattern = tuple(sched[:period])
        cols = [[u for _, u in stream[j::period]] for j in range(period)]
        n_full = len(stream) // period
        tail_len = len(stream) % period
        buckets = tuple(max(u.batch for u in col) for col in cols)
        xs = tuple(stack(col[:n_full], b) for col, b in zip(cols, buckets))
        tail = tuple(
            (u.keys.to(dev), {c: u.payload[c].to(dev) for c in comps})
            for u in (cols[j][n_full].pad_to(ring, buckets[j])
                      for j in range(tail_len)))
        return PreparedStream(
            mode="scan" if period == 1 else "rounds",
            rel_order=rel_order,
            schemas=tuple(schemas[r] for r in rel_order),
            pattern=pattern,
            xs=xs[0] if period == 1 else xs,
            n_steps=n_full,
            buckets=buckets,
            n_tuples=n_tuples,
            tail=tail,
            tail_len=tail_len,
            plans=verified(tuple(plan_for(r, b)
                                 for r, b in zip(pattern, buckets))),
            **sigs)

    # aperiodic: one bucket and key width for every step
    bucket = max(upd.batch for _, upd in stream)
    k_max = max(len(schemas[r]) for r in rel_order)
    padded = [u.pad_to(ring, bucket) for _, u in stream]
    keys = torch.stack([
        torch.cat([u.keys, u.keys.new_zeros((bucket, k_max - u.keys.shape[1]))],
                  dim=1)
        for u in padded]).to(dev)  # [T, B, k_max]
    payload = {c: torch.stack([u.payload[c] for u in padded]).to(dev)
               for c in comps}
    return PreparedStream(
        mode="switch",
        rel_order=rel_order,
        schemas=tuple(schemas[r] for r in rel_order),
        pattern=(),
        xs=(keys, payload),
        n_steps=len(stream),
        buckets=(bucket,),
        n_tuples=n_tuples,
        plans=verified(tuple(plan_for(r, bucket) for r in rel_order)),
        schedule=tuple(rel_order.index(r) for r in sched),
        **sigs)


# ---------------------------------------------------------------------------
# Step bodies and their runners
# ---------------------------------------------------------------------------
def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


def _owned_state(state):
    """A copy of a ``(views, base, indicators)`` state, each relation one
    new [S, d] plane (the layout the ⊎ kernels update in place), each
    indicator new counts and plane."""
    return tuple({name: rel.owned() for name, rel in part.items()}
                 for part in state)


def _settle(fixed, new, mask):
    """Bring the trigger output ``new`` back into the leaves of ``fixed``:
    copy every leaf that is not ``fixed``'s own storage into it.  A trigger
    may replace only the leaves ``mask`` (``plan.state_write_mask``) names.
    Returns ``fixed``."""
    for old, leaf, may in zip(plan_mod.state_leaves(fixed),
                              plan_mod.state_leaves(new), mask):
        if _same_storage(old, leaf):
            continue
        if not may:
            raise AssertionError("a trigger replaced a state leaf that its "
                                 "plan's write set does not name")
        old.copy_(leaf)
    return fixed


class _Program:
    """The step bodies of one prepared signature.

    ``bodies[u](state, counter)`` applies one step of body ``u`` to the
    state in place, reading its inputs at ``self.xs[counter]``, and
    advances the counter.  A program serves every stream of its signature:
    :meth:`run` takes the stacked inputs, the tail and the switch schedule
    from the stream it is given.  It walks the steps eagerly (the CPU);
    :class:`_GraphProgram` captures and replays them (the card)."""

    def __init__(self, executor: "StreamExecutor", prepared: PreparedStream):
        engine = executor.engine
        schema_of = dict(zip(prepared.rel_order, prepared.schemas))
        wv: set[str] = set()
        wb: set[str] = set()
        wi: set[str] = set()
        for p in prepared.plans:
            v, b, i = p.write_sets()
            wv |= set(v)
            wb |= set(b)
            wi |= set(i)
        mask = plan_mod.state_write_mask(engine.state, wv, wb, wi)
        self.mode = prepared.mode
        #: stacked inputs the bodies read, ``prepared.xs``'s structure
        self.xs = None

        def at(counter):
            return pytree.tree_map(lambda a: a.index_select(0, counter)[0],
                                   self.xs)

        if prepared.mode in ("scan", "rounds"):
            pattern = prepared.pattern
            triggers = [engine.trigger_body(rel, plan)
                        for rel, plan in zip(pattern, prepared.plans)]
            shared = (plan_mod.shared_prep_ops(prepared.plans)
                      if prepared.mode == "rounds" else ())
            executor.last_shared_ops = shared

            def apply(state, rel, trigger, keys, payload, memo=None):
                new = trigger(state, COOUpdate(schema_of[rel], keys, payload),
                              memo)
                _settle(state, new, mask)

            def step(state, counter):
                x = at(counter)
                cols = (x,) if prepared.mode == "scan" else x
                memo = (plan_mod.build_prep_memo(shared, state[0])
                        if shared else None)
                for rel, trigger, (keys, payload) in zip(pattern, triggers,
                                                         cols):
                    apply(state, rel, trigger, keys, payload, memo)
                counter.add_(1)

            def tail(state, items):
                for rel, trigger, (keys, payload) in zip(pattern, triggers,
                                                         items):
                    apply(state, rel, trigger, keys, payload)

            self.bodies = [step]
            self.tail = tail
            return

        def switch_body(rel, plan):
            trigger = engine.trigger_body(rel, plan)
            k = len(schema_of[rel])

            def step(state, counter):
                keys, payload = at(counter)
                new = trigger(state, COOUpdate(schema_of[rel], keys[:, :k],
                                               payload))
                _settle(state, new, mask)
                counter.add_(1)

            return step

        self.bodies = [switch_body(rel, plan)
                       for rel, plan in zip(prepared.rel_order, prepared.plans)]
        self.tail = lambda state, items: None

    def release(self) -> None:
        """Nothing to drop: an eager program holds no graphs."""

    def steps(self, prepared: PreparedStream) -> list:
        """The body of each step of ``prepared``."""
        if self.mode == "switch":
            return list(prepared.schedule)
        return [0] * prepared.n_steps

    def run(self, state, prepared: PreparedStream, stats: dict):
        self.xs = prepared.xs
        counter = torch.zeros((1,), dtype=torch.long,
                              device=pytree.tree_leaves(prepared.xs)[0].device)
        steps = self.steps(prepared)
        try:
            for u in steps:
                self.bodies[u](state, counter)
        finally:
            self.xs = None
        stats["eager_steps"] = len(steps)
        self.tail(state, prepared.tail)
        return state


class _GraphProgram(_Program):
    """:class:`_Program` on the card: each body's first step of a run on
    new state tensors runs eagerly (the warm-up), then the body is captured
    as a CUDA graph, and every later step replays it.  The graphs read the
    program's own input buffers, into which every run copies its stream's
    stacked inputs on the device, so a later stream of the same signature
    replays the same graphs."""

    def __init__(self, executor, prepared):
        super().__init__(executor, prepared)
        self._bound = None  # the state leaves the graphs write
        self._graphs: list = []  # per body: (CUDAGraph, CapturedLaunches)
        self._counter = None
        self._pool = None

    def release(self) -> None:
        """Drop the graphs, their input buffers and their memory pool."""
        self._bound = self.xs = None
        self._graphs = []
        self._counter = self._pool = None

    def _capture(self, u: int, state):
        graph = torch.cuda.CUDAGraph()
        launches = _cuda.CapturedLaunches()
        # No garbage collection while a graph is captured: a program is a
        # reference cycle (its bodies read ``self.xs``), so one dropped
        # without :meth:`release` frees its graphs only when the collector
        # runs, and a graph destroyed mid-capture invalidates the capture.
        # The collector runs on its own schedule outside captures (a full
        # collection before each capture made a stream of 12 capacity
        # segments 40 times slower, PERF.md section 6).
        # Thread-local capture mode: a boundary save's writer thread may be
        # copying the last snapshot to pinned host memory on a side stream
        # while this thread captures the next segment's graphs, and under
        # the global mode its calls would invalidate the capture.
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                self.bodies[u](state, self._counter)
        finally:
            if enabled:
                gc.enable()
            launches.close()
        return graph, launches

    def run(self, state, prepared: PreparedStream, stats: dict):
        bound = plan_mod.state_leaves(state)
        if self._bound is None or len(bound) != len(self._bound) or any(
                x is not y for x, y in zip(bound, self._bound)):
            self.release()
            self._bound = bound
            self._graphs = [None] * len(self.bodies)
            self.xs = pytree.tree_map(torch.empty_like, prepared.xs)
            self._counter = torch.zeros((1,), dtype=torch.long,
                                        device=bound[0].device)
            self._pool = torch.cuda.graph_pool_handle()
        else:
            self._counter.zero_()
        pytree.tree_map(lambda dst, src: dst.copy_(src), self.xs, prepared.xs)
        eager = replays = 0
        capture_s = replay_s = 0.0
        for u in self.steps(prepared):
            entry = self._graphs[u]
            if entry is None:
                self.bodies[u](state, self._counter)
                eager += 1
                t0 = time.perf_counter()
                self._graphs[u] = self._capture(u, state)
                capture_s += time.perf_counter() - t0
                continue
            t0 = time.perf_counter()
            entry[0].replay()
            entry[1].replayed()
            replay_s += time.perf_counter() - t0
            replays += 1
        self.tail(state, prepared.tail)
        stats.update(eager_steps=eager, replays=replays,
                     graphs=sum(g is not None for g in self._graphs),
                     capture_s=capture_s, replay_host_s=replay_s)
        return state


def _rehash(engine: IVMEngine, caps: dict) -> None:
    """Rehash the sparse views ``caps`` names to their new capacities (by
    name: a sharded table's rehash is a collective, which every rank must
    issue in the same order)."""
    grown = {name: engine.views[name].rehash(caps[name])
             for name in sorted(caps)}
    engine.views = {name: grown.get(name, v)
                    for name, v in engine.views.items()}


class StreamExecutor:
    """Runs prepared update streams against one engine.

    Programs are cached per :attr:`PreparedStream.signature`; on the card a
    program keeps the CUDA graphs of its last run (see the module
    docstring), which :meth:`release` drops.  :attr:`last_run_stats` holds
    the last run's steps, eager steps, graph replays, graphs, and host
    seconds of capture and replay.

    ``checkpoint`` (a ``StreamCheckpointer``) snapshots the engine at every
    segment boundary, ``integrity`` (an ``IntegrityConfig``) validates
    admission and audits the views, and ``stragglers`` (default: a fresh
    ``StragglerMonitor``) watches each segment's host wall, and ``registry``
    (a ``repro_torch.serve.SnapshotRegistry``) publishes a generation of the
    views at every boundary.  ``shard`` (a ``repro_torch.core.shard.
    ShardPlan``) makes the executor one rank of its group (see the module
    docstring): every rank of the group runs the same streams."""

    def __init__(self, engine: IVMEngine, shard=None, checkpoint=None,
                 integrity=None, stragglers: StragglerMonitor | None = None,
                 registry=None):
        self.engine = engine
        self.shard = shard
        self.checkpoint = checkpoint
        self.integrity = integrity
        #: serving-plane snapshot registry: when attached, every segment
        #: boundary of a run on the engine's own state publishes a
        #: generation-stamped device copy of the read-visible views
        self.registry = registry
        self.stragglers = (stragglers if stragglers is not None
                           else StragglerMonitor())
        self._compiled: dict[Any, _Program] = {}
        #: shared prep-op keys of the last rounds build (CSE telemetry)
        self.last_shared_ops: tuple = ()
        self.last_run_stats: dict = {}
        #: per segment of the last segmented run: steps, grown capacities,
        #: admission, dispatch, audit, publish and save host seconds, the
        #: published generation, the straggler verdict, and the run's stats
        self.last_segment_stats: list = []

    def _integrity_active(self) -> bool:
        return self.integrity is not None and self.integrity.active

    def program_kind(self) -> tuple[str, str]:
        """``(program, reason)``: ``"graphed"`` (captured and replayed) or
        ``"eager"`` (stepped from the host), and why."""
        if self.engine.device.type != "cuda":
            return "eager", "CPU tensors: no CUDA graphs"
        if self.shard is not None and not self.shard.mesh.grp.capturable:
            return "eager", (f"{self.shard.backend} collectives cannot be "
                             "captured in a CUDA graph")
        return "graphed", "CUDA graphs"

    def _build(self, prepared: PreparedStream) -> _Program:
        if self.program_kind()[0] == "graphed":
            return _GraphProgram(self, prepared)
        return _Program(self, prepared)

    def compiled(self, prepared: PreparedStream) -> _Program:
        entry = self._compiled.get(prepared.signature)
        if entry is None:
            entry = self._compiled[prepared.signature] = self._build(prepared)
        return entry

    def release(self) -> None:
        """Drop every cached program, and with them, now, their CUDA graphs
        and graph memory."""
        for program in self._compiled.values():
            program.release()
        self._compiled.clear()

    def run(self, stream_or_prepared, state=None, update_engine: bool = True,
            donate_input: bool = False, pipeline: bool = True,
            _offset: int = 0):
        """Apply the whole stream; returns the new ``(views, base,
        indicators)`` state.

        Unless ``donate_input=True`` the input state is copied first and
        the copy is updated in place.  A raw stream run against the
        engine's own state (``state=None``) is split into capacity segments
        first (:func:`capacity_segments`; one segment that grows nothing
        when no sparse table could fill), those capped at the checkpoint's
        and the integrity config's ``segment_updates``
        (:func:`split_segments`), and runs segment by segment
        (:meth:`_run_segmented`) whenever there is more than one segment, a
        rehash, a checkpoint, an active integrity config or a registry (whose
        ``segment_updates`` caps them too); a checkpointed or
        registry-attached run must update the engine.  An explicit-state raw run is audited
        against the caller's state, and one that fails the audit spills to
        the eager path when the integrity config's ``capacity_degrade`` is
        set (:meth:`_eager_spill`); a :class:`PreparedStream` is replayed as
        it is, trusting its prepare-time audit.  With
        ``update_engine=False`` the engine's views, base and indicators are
        restored afterwards, also when the run raises.  ``pipeline=False``
        makes the boundary saves blocking; segments always run one after
        the other.  ``_offset`` is the stream index of the first update
        (:meth:`resume`)."""
        if state is None and donate_input and not update_engine:
            raise ValueError("donating the engine's own state without "
                             "updating the engine would leave it holding "
                             "the stream's result")
        saved = None if update_engine else (dict(self.engine.views),
                                            dict(self.engine.base),
                                            dict(self.engine.indicators))
        try:
            prepared = stream_or_prepared
            if not isinstance(prepared, PreparedStream):
                stream = list(prepared)
                if state is None:
                    segments = capacity_segments(self.engine, stream)
                    if self.checkpoint is not None:
                        if not update_engine:
                            raise ValueError(
                                "a checkpointed run must update the engine — "
                                "boundary snapshots capture the engine's state")
                        segments = split_segments(
                            segments, self.checkpoint.segment_updates)
                    if self._integrity_active():
                        # integrity boundaries must exist even where
                        # capacity segmentation never splits
                        segments = split_segments(
                            segments, self.integrity.segment_updates)
                    if self.registry is not None:
                        if not update_engine:
                            raise ValueError(
                                "a registry-attached run must update the "
                                "engine — published generations snapshot "
                                "the engine's state")
                        segments = split_segments(
                            segments, self.registry.segment_updates)
                    if (self.checkpoint is not None or len(segments) > 1
                            or segments[0][1] or self._integrity_active()
                            or self.registry is not None):
                        return self._run_segmented(segments, pipeline=pipeline,
                                                   base_offset=_offset)
                else:
                    try:
                        check_stream_capacity(self.engine, stream,
                                              views=state[0])
                    except StreamCapacityError as e:
                        if (self._integrity_active()
                                and self.integrity.capacity_degrade):
                            # graceful degradation: the eager per-batch
                            # path grows tables instead of dropping rows
                            return self._eager_spill(
                                stream, state, update_engine=update_engine,
                                donate_input=donate_input, error=e)
                        raise
                prepared = prepare_stream(self.engine, stream,
                                          check_capacity=False)
            if state is None:
                state = self.engine.state
            if not donate_input:
                state = _owned_state(state)
            program, reason = self.program_kind()
            stats = dict(mode=prepared.mode, steps=prepared.n_steps,
                         tail=prepared.tail_len, program=program,
                         program_reason=reason)
            runnable = prepared
            if self.shard is not None:
                state = self.shard.place(state)
                # every rank consumes every update row: rank 0's inputs,
                # replicated once a prepared stream
                mesh = self.shard.mesh
                if prepared.placed is None or prepared.placed[0] is not mesh:
                    prepared.placed = (mesh, self.shard.replicate(prepared.xs),
                                       self.shard.replicate(prepared.tail))
                runnable = dataclasses.replace(
                    prepared, xs=prepared.placed[1], tail=prepared.placed[2],
                    placed=None)
            new_state = self.compiled(prepared).run(state, runnable, stats)
            self.last_run_stats = stats
            if update_engine:
                self.engine.set_state(new_state)
            return new_state
        finally:
            if saved is not None:
                self.engine.set_state(saved)

    def _admit_segment(self, sub_stream, grow_caps, offset: int = 0):
        """Admission of one segment: validate it (with an integrity config
        whose policy is not ``permissive``: ``strict`` raises here, before
        the segment can run or snapshot; ``quarantine`` masks rows), rehash
        the views ``grow_caps`` names to their new capacities (device work
        queued behind the previous segment), re-audit the capacity budget
        against live occupancy where the integrity config degrades
        (pressure found here splits the segment: an emergency
        re-segmentation, recorded in ``degrade_log``), then bucket and
        stack the updates and fetch the plans and program.

        Returns ``(prepared, admit_seconds, admitted_sub, deferred)``:
        ``admitted_sub`` is the (possibly sanitized, possibly shortened)
        update list the segment applies, ``deferred`` the emergency split's
        remainder (``[(sub, grow), ...]``) for the segment loop to splice
        in after it."""
        engine = self.engine
        cfg = self.integrity
        t0 = time.perf_counter()
        faults.crossing("mid_admit", updates=len(sub_stream))
        if cfg is not None and cfg.policy != "permissive":
            from ..runtime import integrity as integrity_mod

            sub_stream = integrity_mod.admit_stream(engine, sub_stream, cfg,
                                                    base_offset=offset)
        if grow_caps:
            _rehash(engine, grow_caps)
            # the tables carry the grown capacities, but nothing is
            # compiled (or checkpointed) against them yet
            faults.crossing("post_rehash_pre_recompile",
                            grown=sorted(grow_caps))
        deferred: list = []
        if cfg is not None and cfg.active and cfg.capacity_degrade:
            try:
                check_stream_capacity(engine, sub_stream)
            except StreamCapacityError as e:
                resegmented = capacity_segments(engine, sub_stream)
                sub_stream, extra_grow = resegmented[0]
                deferred = resegmented[1:]
                _rehash(engine, extra_grow)
                cfg.degrade_log.append(dict(
                    kind="emergency_resegment",
                    segments=1 + len(deferred),
                    grow={k: int(v) for k, v in extra_grow.items()},
                    occupancy=storage_mod.occupancy_report(engine.views),
                    error=str(e)))
        prepared = prepare_stream(engine, sub_stream, check_capacity=False)
        self.compiled(prepared)
        return prepared, time.perf_counter() - t0, sub_stream, deferred

    def _eager_spill(self, stream, state, update_engine: bool,
                     donate_input: bool, error):
        """Graceful degradation of an explicit-state run that failed its
        capacity audit: apply the stream batch by batch through the
        trigger plans with eager table growth (``grow_if_loaded``) —
        slower (a host read a touched sparse view a batch) but it cannot
        drop a row.  The spill still passes validated admission, and the
        decision is recorded in ``integrity.degrade_log``."""
        from ..runtime import integrity as integrity_mod

        cfg = self.integrity
        t0 = time.perf_counter()
        stream = integrity_mod.admit_stream(self.engine, stream, cfg,
                                            base_offset=0)
        engine = self.engine
        if not donate_input:
            state = _owned_state(state)
        views, base, indicators = (dict(state[0]), dict(state[1]),
                                   dict(state[2]))
        for rel, upd in stream:
            touched, _, _ = engine.plans.write_sets(engine, rel)
            views = {
                name: (storage_mod.grow_if_loaded(
                           v, engine._insert_budget(v, rel, upd))
                       if name in touched else v)
                for name, v in views.items()
            }
            views, base, indicators = engine.functional_update(
                views, base, indicators, rel, upd)
        integrity_mod.flush_dead_letters(cfg)
        new_state = canonical_state((views, base, indicators))
        cfg.degrade_log.append(dict(
            kind="eager_spill", updates=len(stream), error=str(error),
            wall_s=time.perf_counter() - t0))
        if update_engine:
            engine.set_state(new_state)
        return new_state

    def _run_segmented(self, segments, pipeline: bool = True,
                       base_offset: int = 0):
        """The segment loop: admit segment 0 (:meth:`_admit_segment`), then
        for each segment run it as one prepared stream on the engine's
        state, pass the boundary, and admit the next.  Segment 0 copies the
        state (it may be the caller's); later segments donate the previous
        segment's output, so on the card their graphs replay on the same
        tensors.  A rehash changes the storage signature, so the segment
        after it compiles its plans and captures its graphs anew.

        At each boundary, in order: the ``mid_segment`` fault crossing; the
        audited Reevaluate when ``integrity.audit_due`` (before the publish
        and the save, so a repaired state, never a drifted one, is served
        and committed; an in-place repair keeps the graphs bound); the
        registry's ``publish`` of the views, stamped with the audit's
        outcome (``integrity.publish_meta``: clones issued on the current
        stream before the next segment's replays write the state in place);
        the checkpoint's ``save_boundary`` (asynchronous: clones issued on
        the current stream, no host synchronise, the publish's clones reused
        for the served views; blocking with ``pipeline=False``), the last
        one awaited so a finished run is durable and a writer failure
        surfaces here; one ``stragglers.observe`` of the segment's admit + dispatch
        host wall (on the card the time to enqueue its replays, not device
        time).  Boundary steps are numbered by cumulative stream offset
        (``base_offset`` + updates applied), :meth:`resume`'s replay
        cursor.  An emergency re-segmentation splices its remainder into
        the queue; quarantined rows become dead letters once, after the
        last segment (``flush_dead_letters``).  Per-segment stats land in
        :attr:`last_segment_stats`."""
        stats: list = []
        state = None
        ck = self.checkpoint
        cfg = self.integrity
        if cfg is not None:
            # a failed earlier attempt may have left validation results
            # pending; re-admission below records them again
            cfg.pending_dead_letters.clear()
        offset = base_offset
        queue = list(segments)
        prepared, admit_s, sub, deferred = self._admit_segment(
            *queue[0], offset=offset)
        queue[1:1] = deferred
        i = 0
        while i < len(queue):
            t0 = time.perf_counter()
            state = self.run(prepared, update_engine=True, donate_input=i > 0)
            dispatch_s = time.perf_counter() - t0
            run_stats = dict(self.last_run_stats)
            offset += len(sub)
            faults.crossing("mid_segment", segment=i, offset=offset)
            audit_s = 0.0
            audit_meta: dict = {}
            if cfg is not None and cfg.audit_due(i):
                from ..runtime import integrity as integrity_mod

                t1 = time.perf_counter()
                records = integrity_mod.audit_engine(self.engine, cfg,
                                                     segment=i)
                state = self.engine.state
                audit_meta = integrity_mod.publish_meta(records)
                audit_s = time.perf_counter() - t1
            publish_s = 0.0
            snap = None
            if self.registry is not None:
                t1 = time.perf_counter()
                snap = self.registry.publish(self.engine.views, offset=offset,
                                             segment=i, meta=audit_meta)
                publish_s = time.perf_counter() - t1
            save_s = save_dispatch_s = 0.0
            if ck is not None:
                t1 = time.perf_counter()
                ck.save_boundary(self.engine, offset=offset, segment=i,
                                 blocking=not pipeline,
                                 view_copies=(snap.views if snap is not None
                                              else None))
                save_dispatch_s = ck.last_dispatch_seconds
                if i + 1 == len(queue):
                    ck.wait()  # a finished run is durably checkpointed
                save_s = time.perf_counter() - t1
            straggler = self.stragglers.observe(i, admit_s + dispatch_s)
            stats.append(dict(segment=i, n_steps=prepared.n_steps,
                              updates=len(sub), grow=dict(queue[i][1]),
                              admit_s=admit_s, dispatch_s=dispatch_s,
                              save_s=save_s, save_dispatch_s=save_dispatch_s,
                              audit_s=audit_s, publish_s=publish_s,
                              generation=(self.registry.generation
                                          if self.registry is not None
                                          else None),
                              straggler=straggler,
                              straggler_baseline=self.stragglers.baseline,
                              run=run_stats))
            if i + 1 < len(queue):
                prepared, admit_s, sub, deferred = self._admit_segment(
                    *queue[i + 1], offset=offset)
                queue[i + 2:i + 2] = deferred
            i += 1
        if cfg is not None and cfg.pending_dead_letters:
            # every admitted segment has run: one host read for them all
            from ..runtime import integrity as integrity_mod

            integrity_mod.flush_dead_letters(cfg)
        self.last_segment_stats = stats
        return state

    # --------------------------------------------------------------- recovery
    def resume(self, stream, checkpoint=None, pipeline: bool = True):
        """Replay-from-offset recovery: restore the newest committed
        snapshot and continue ``stream`` from where it left off.

        ``stream`` is the *full* raw update stream of the original run;
        the restored snapshot's ``offset`` says how many leading updates
        are already applied, and the rest runs through the checkpointed
        segment loop, so a crash during recovery recovers the same way.
        A pending save of an interrupted run is discarded first.  When no
        committed snapshot exists yet, a blocking offset-0 baseline is
        written first: a resumed run always restarts from a snapshot,
        never from a partially advanced live engine.  With a registry
        attached the restored state is published as a new generation
        (``meta={"restored": True}``), so readers never see what the engine
        held before the restore.  The restore installs new state tensors, so
        this executor's next run captures its graphs anew.

        Mesh-elastic: snapshots hold logical (unsharded) arrays, so a
        sharded executor re-derives its ``ShardPlan`` for the *current*
        group (``replan_shards``) and re-places the restored state — a run
        killed on 4 ranks resumes on 2 or 1 (or the other way round)."""
        ck = checkpoint if checkpoint is not None else self.checkpoint
        if ck is None:
            raise ValueError("resume needs a StreamCheckpointer (pass "
                             "checkpoint= or construct the executor with one)")
        self.checkpoint = ck
        # an interrupted run may have died with an async save in flight
        # (or a captured writer failure); recovery restarts from the last
        # committed step regardless
        ck.ckpt.discard_pending()
        stream = list(stream)
        meta = ck.restore_into(self.engine)
        offset = int(meta["offset"]) if meta is not None else 0
        if self.shard is not None:
            from . import shard as shard_mod

            self.shard = shard_mod.replan_shards(self.engine, self.shard)
            self.release()
            self.engine.shard_state(self.shard)
        if meta is None:
            ck.save_boundary(self.engine, offset=0, segment=-1,
                             blocking=True)
        if self.registry is not None:
            # generations stay monotonic across restarts within this
            # registry's lifetime
            self.registry.publish(self.engine.views, offset=offset,
                                  segment=-1, meta=dict(restored=True))
        if not 0 <= offset <= len(stream):
            raise ValueError(
                f"snapshot offset {offset} exceeds the replayed stream "
                f"({len(stream)} updates) — wrong stream or checkpoint dir?")
        remaining = stream[offset:]
        if not remaining:
            return self.engine.state
        return self.run(remaining, update_engine=True, pipeline=pipeline,
                        _offset=offset)
