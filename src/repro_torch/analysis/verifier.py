"""Static verification of compiled trigger plans (PyTorch port of
``repro.analysis.verifier``).

F-IVM's maintenance invariants are *assumed* by cooperating subsystems —
plan legality and CSE (``core.plan``), fusion legality
(``kernels.ring_fused``), capacity budgeting (``core.stream``) — and each
re-derives them on its own.  This module is the cross-check: an independent
static pass over the compiled :class:`repro_torch.core.plan.TriggerPlan` IR
that re-derives every invariant from the op sequence alone and reports
disagreements as structured :class:`PlanViolation` records.

The verifier runs at plan-compile time (``PlanCache.lookup_sig``), gated by
``REPRO_TORCH_PLAN_VERIFY=on|off|auto`` (the port reads none of the
reference's variables) — ``auto`` is on under pytest and CI and off
otherwise, and a verified plan is cached with its verification, so a cache
hit and a graph replay pay nothing.  The same entry points back the
standalone gate (``tools/verify_plans_torch.py``) and the broken-plan
fixtures (``tests/test_torch_verifier.py``).

Rule catalogue (the reference's, with its fusion rule rebased on the H100
legality model of ``kernels.ring_fused``):

======================  ====================================================
rule id                 invariant re-derived
======================  ====================================================
schema/view-unknown     every op's view resolves against the engine state
schema/view-schema      op var tuple matches the stored view's schema
schema/key-extent       view key extents match the query's variable domains
schema/payload-width    view ring payload width matches the query ring
schema/storage-class    op storage annotations match the live storage class
schema/backend          scatter backends resolved + legal for the site
schema/state            op flags agree with the symbolic delta-state replay
schema/write-set        declared write sets equal the op-derived sets
race/memo-write         no CSE memo plane is written by any plan that step
race/fused-read-set     FusedChain.reads == gathers of its flattened ops
race/fused-write-set    FusedChain.writes == its terminal scatter target
race/fused-raw          a chain never reads a view the plan already wrote
race/shard-spec         shard placement consistent with true read/write sets
fusion/ring             chain ring spec == independent fused_ring_spec
fusion/commutativity    ring commutativity witnessed on sample payloads
fusion/smem             the block's shared memory re-derived from the ring
                        width (``chain_smem_bytes``), within
                        ``SMEM_PER_BLOCK``, and at most ``MAX_SOURCES``
                        sources (the reference's ``fusion/vmem``)
fusion/terminal         chain shape: legal entry state + terminal ⊎
capacity/under-budget   engine insert budget covers the plan-derived bound
======================  ====================================================

``race/shard-spec`` checks a ``repro_torch.core.shard.ShardPlan`` against
the plans it was derived from (:func:`verify_shard_plan`); ``plan_shards``
runs :func:`check_shard` when verification is on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core import plan as plan_mod
from ..core.plan import (
    IND_PREFIX,
    BaseBump,
    Emit,
    FusedChain,
    Gather,
    IndicatorBump,
    JoinContract,
    LeafDelta,
    Lift,
    Marginalize,
    PlanOp,
    Reevaluate,
    ScatterAccum,
    TriggerPlan,
    iter_flat_ops,
)
from ..core.storage import payload_width

# ---------------------------------------------------------------------------
# Gating (mirrors plan.fusion_mode: override > env > auto)
# ---------------------------------------------------------------------------
VERIFY_ENV_VAR = "REPRO_TORCH_PLAN_VERIFY"

VERIFY_MODES = ("on", "off", "auto")

_verify_override: str | None = None

def _check_mode(mode: str | None) -> None:
    if mode is not None and mode not in VERIFY_MODES:
        raise ValueError(f"unknown verify mode {mode!r}; one of {VERIFY_MODES}")


def set_verify(mode: str | None) -> None:
    """Process-wide verify-mode override (None restores env / auto)."""
    global _verify_override
    _check_mode(mode)
    _verify_override = mode


@contextlib.contextmanager
def use_verify(mode: str | None):
    """Scoped verify override — fixture tests force "on" / "off" a case."""
    global _verify_override
    prev = _verify_override
    set_verify(mode)
    try:
        yield
    finally:
        _verify_override = prev


def active_verify_override() -> str | None:
    return _verify_override or os.environ.get(VERIFY_ENV_VAR) or None


def verify_mode() -> str:
    """Resolved verify mode: explicit override / env > auto.  Auto turns the
    pass on under pytest and CI (where a violation must fail loudly) and off
    elsewhere — production replay runs from the plan cache and never
    re-pays compile-time work anyway."""
    mode = active_verify_override() or "auto"
    _check_mode(mode)
    if mode != "auto":
        return mode
    on = os.environ.get("PYTEST_CURRENT_TEST") or os.environ.get("CI")
    return "on" if on else "off"


# ---------------------------------------------------------------------------
# Violation reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanViolation:
    """One invariant violation: rule id + the plan / op / view it names."""

    rule: str
    plan: str  # short plan head, e.g. "trigger R kind=coo"
    op: str  # offending op label ("" for plan-level rules)
    view: str  # view name involved ("" when not view-specific)
    message: str

    def label(self) -> str:
        loc = f" at {self.op}" if self.op else ""
        return f"[{self.rule}] {self.plan}{loc}: {self.message}"


class PlanVerificationError(AssertionError):
    """Raised by the gated compile-time pass when any rule fires."""

    def __init__(self, violations: Sequence[PlanViolation]):
        self.violations = tuple(violations)
        lines = [v.label() for v in self.violations]
        super().__init__(
            "plan verification failed (%d violation%s):\n  %s"
            % (len(lines), "s" if len(lines) != 1 else "",
               "\n  ".join(lines)))


class _Reporter:
    def __init__(self, plan: TriggerPlan):
        self.head = f"trigger {plan.rel} kind={plan.kind}"
        self.out: list[PlanViolation] = []

    def __call__(self, rule: str, op, view: str, message: str) -> None:
        label = op.label() if isinstance(op, PlanOp) else (op or "")
        self.out.append(
            PlanViolation(rule, self.head, label, view or "", message))


# ---------------------------------------------------------------------------
# View resolution (indicator planes + 1-IVM recomputed store proxies)
# ---------------------------------------------------------------------------
def _make_resolver(engine, plan: TriggerPlan, views: Mapping):
    query = engine.query
    if plan.kind == "first_order":
        # 1-IVM gathers read the trigger-internal recomputed store: every
        # tree node resolves, unmaterialized ones as dense proxies — the
        # mapping the compiler planned against
        store = {n.name: views.get(n.name, plan_mod._DenseProxy(n, query))
                 for n in engine.tree.walk()}
    else:
        store = views

    def resolve(name: str):
        if name.startswith(IND_PREFIX):
            ind = engine.indicators.get(name[len(IND_PREFIX):])
            return None if ind is None else ind.dense
        return store.get(name)

    return resolve


# ---------------------------------------------------------------------------
# Rule family 1: dataflow / schema typing
# ---------------------------------------------------------------------------
def _scatter_backends() -> tuple:
    from ..kernels import scatter_ops

    return tuple(scatter_ops.BACKENDS)


#: keyed by id(ring), value (ring, width): the ring is kept in the value so
#: its id is never recycled while the entry lives
_ring_width_memo: dict = {}


def _ring_width(ring) -> int:
    hit = _ring_width_memo.get(id(ring))
    if hit is None:
        hit = (ring, payload_width(ring))
        _ring_width_memo[id(ring)] = hit
    return hit[1]


def _check_op_schema(engine, plan: TriggerPlan, op, resolve, bad) -> None:
    """Per-op static typing: view existence, schema / extent agreement,
    payload width, storage class, backend legality, lift specs."""
    query = engine.query
    if isinstance(op, (Gather, JoinContract, ScatterAccum)):
        view = resolve(op.view)
        if view is None:
            bad("schema/view-unknown", op, op.view,
                f"references view '{op.view}' which is not materialized "
                f"in the engine state")
            return
        kind = plan_mod._storage_kind(view)
        if op.storage != kind:
            bad("schema/storage-class", op, op.view,
                f"annotated storage '{op.storage}' but view '{op.view}' "
                f"is stored {kind}")
        ring = getattr(view, "ring", None)
        if ring is not None:
            vw = _ring_width(ring)
            qw = _ring_width(query.ring)
            if vw != qw:
                bad("schema/payload-width", op, op.view,
                    f"view '{op.view}' carries a {vw}-wide ring payload "
                    f"but the query ring is {qw}-wide")
    if isinstance(op, (Gather, JoinContract)):
        view = resolve(op.view)
        if view is None:
            return
        vschema = tuple(getattr(view, "schema", ()))
        if set(op.vars) != set(vschema):
            bad("schema/view-schema", op, op.view,
                f"joins on vars {tuple(op.vars)} but view '{op.view}' "
                f"has schema {vschema}")
            return
        for v in op.vars:
            dom = int(query.domains[v])
            ext = int(view.domain_of(v))
            if ext != dom:
                bad("schema/key-extent", op, op.view,
                    f"view '{op.view}' extent {ext} for var '{v}' != "
                    f"query domain {dom}")
    elif isinstance(op, Lift):
        if op.var not in query.domains:
            bad("schema/view-unknown", op, "",
                f"lift var '{op.var}' is not a query variable")
            return
        spec = tuple(query.lift_spec(op.var))
        if tuple(op.spec) != spec:
            bad("schema/state", op, "",
                f"lift spec {tuple(op.spec)} != query lift spec {spec} "
                f"for var '{op.var}'")
        elif spec == ("one",) and plan.kind != "factorized":
            # the factorized walk always contracts against the lift
            # relation (no identity skip); only path plans skip
            bad("schema/state", op, "",
                f"identity lift of '{op.var}' must compile to no Lift op")
    elif isinstance(op, ScatterAccum):
        backends = _scatter_backends()
        if op.backend is not None and op.backend not in backends:
            bad("schema/backend", op, op.view,
                f"unknown scatter backend '{op.backend}' "
                f"(known: {','.join(backends)})")
        elif op.backend == "auto":
            bad("schema/backend", op, op.view,
                "backend resolution is a plan-time decision; compiled "
                "plans must not carry 'auto'")
        elif op.backend is None and op.storage == "sparse" \
                and plan.kind == "coo":
            bad("schema/backend", op, op.view,
                f"sparse ⊎ into '{op.view}' needs a resolved scatter "
                f"backend on the COO path")
    elif isinstance(op, BaseBump):
        if op.rel not in query.relations:
            bad("schema/view-unknown", op, op.rel,
                f"bumps base relation '{op.rel}' which is not in the query")
        if op.backend is not None and op.backend not in _scatter_backends():
            bad("schema/backend", op, op.rel,
                f"unknown scatter backend '{op.backend}'")
    elif isinstance(op, IndicatorBump):
        if op.rel not in query.relations:
            bad("schema/view-unknown", op, op.rel,
                f"indicator over unknown relation '{op.rel}'")
        elif not set(op.proj) <= set(query.relations[op.rel]):
            bad("schema/view-schema", op, op.rel,
                f"projection {tuple(op.proj)} is not a subset of "
                f"{op.rel}'s schema {tuple(query.relations[op.rel])}")
    elif isinstance(op, Reevaluate):
        if op.scope not in ("root", "store"):
            bad("schema/state", op, "",
                f"unknown Reevaluate scope '{op.scope}'")


# ---------------------------------------------------------------------------
# Rule families 2+3: symbolic replay + fusion oracle
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _ReplayState:
    """Independent mirror of the compiler's ``_SymDelta`` state machine —
    re-derived here from the op sequence alone so a plan whose recorded
    flags disagree with its own dataflow is caught.

    ``pending`` follows the *unfused* compile-time timeline (op flags are
    recorded against it, and fusion preserves ops verbatim).  A fused chain
    materializes its delta at run time, so chain-entry legality runs on a
    second timeline: ``rt_pending`` mirrors ``fuse_trigger_ops``' state,
    which clears after every accepted chain."""

    coo: list
    dense: list
    b: int
    pending: bool
    rt_pending: bool = False


def _replay_op(engine, plan: TriggerPlan, op, st: _ReplayState,
               resolve, bad) -> None:
    """Advance the replay state through one op, checking every recorded
    flag (forces / grows / collapses / fused / mixed) against the
    re-derived state."""
    ring = engine.query.ring
    if isinstance(op, LeafDelta):
        if tuple(op.schema) != tuple(plan.schema) and plan.kind != "first_order":
            bad("schema/state", op, "",
                f"leaf schema {tuple(op.schema)} != plan schema "
                f"{tuple(plan.schema)}")
        if op.densify:
            st.coo, st.dense, st.b = [], list(op.schema), 1
        else:
            st.coo, st.dense, st.b = list(op.schema), [], max(op.batch, 1)
        st.pending = False
        st.rt_pending = False
    elif isinstance(op, Gather):
        if op.forces != st.pending:
            bad("schema/state", op, op.view,
                f"forces={op.forces} but the replayed delta has "
                f"pending={st.pending} at this op")
        if st.dense:
            bad("schema/state", op, op.view,
                f"deferred gather of '{op.view}' with dense delta axes "
                f"{tuple(st.dense)} (defer requires a pure-COO delta)")
        missing = [v for v in op.vars if v not in st.coo]
        if missing:
            bad("schema/state", op, op.view,
                f"gather vars {missing} not bound by the COO schema "
                f"{tuple(st.coo)}")
        if ring.mul_terms is None or not ring.commutative:
            bad("schema/state", op, op.view,
                f"deferred gather of '{op.view}' requires a commutative "
                f"bilinear ring; {getattr(ring, 'name', type(ring).__name__)}"
                f" is not")
        st.pending = True
        st.rt_pending = True
    elif isinstance(op, JoinContract):
        if op.forces != st.pending:
            bad("schema/state", op, op.view,
                f"forces={op.forces} but the replayed delta has "
                f"pending={st.pending} at this op")
        st.pending = False
        st.rt_pending = False
        if plan.kind == "factorized":
            return  # factor-list joins never grow delta state
        if op.gathers:
            if op.storage != "sparse":
                bad("schema/state", op, op.view,
                    "gather-multiply join is the sparse fully-bound path")
            missing = [v for v in op.vars if v not in st.coo]
            if missing:
                bad("schema/state", op, op.view,
                    f"fully-bound join vars {missing} not in COO schema "
                    f"{tuple(st.coo)}")
            return
        rest = [v for v in op.vars if v not in st.coo]
        grows = tuple(v for v in rest if v not in st.dense)
        if tuple(op.grows) != grows:
            bad("schema/state", op, op.view,
                f"records grown axes {tuple(op.grows)} but the replayed "
                f"delta grows {grows}")
        st.dense.extend(grows)
    elif isinstance(op, Marginalize):
        if op.axis == "factor":
            if plan.kind != "factorized":
                bad("schema/state", op, "",
                    "factor-axis marginalization outside a factorized plan")
            return
        if op.axis == "coo":
            if op.var not in st.coo:
                bad("schema/state", op, "",
                    f"marginalizes '{op.var}' on the COO axis but the "
                    f"replayed COO schema is {tuple(st.coo)}")
                return
            forces = st.pending and st.b > 1 and len(st.coo) == 1
            if op.forces != forces:
                bad("schema/state", op, "",
                    f"forces={op.forces} but the replayed delta "
                    f"{'must force' if forces else 'does not force'} here")
            if forces:
                st.pending = False
            if op.forces:
                st.rt_pending = False
            st.coo.remove(op.var)
            collapses = (not st.coo) and st.b > 1
            if op.collapses != collapses:
                bad("schema/state", op, "",
                    f"collapses={op.collapses} but the replayed batch "
                    f"{'collapses' if collapses else 'stays'} here")
            if collapses:
                st.b = 1
        else:  # dense
            if op.var in st.coo:
                bad("schema/state", op, "",
                    f"marginalizes '{op.var}' on the dense axis but the "
                    f"var is COO-bound")
            st.dense = [v for v in st.dense if v != op.var]
    elif isinstance(op, ScatterAccum):
        if plan.kind == "factorized":
            if op.backend is not None:
                bad("schema/backend", op, op.view,
                    "factorized ⊎ is the outer-product accumulate; it "
                    "never resolves a scatter backend")
            return
        if plan.kind == "first_order":
            # built against a fresh delta state (the 1-IVM root apply)
            exp_fused, exp_mixed = False, False
        else:
            exp_mixed = bool(st.dense)
            exp_fused = st.pending if (op.storage == "sparse"
                                       or (st.coo and not st.dense)) else False
        if op.fused != exp_fused:
            bad("schema/state", op, op.view,
                f"fused={op.fused} but the replayed delta has "
                f"pending={st.pending} at this ⊎")
        if op.mixed != exp_mixed:
            bad("schema/state", op, op.view,
                f"mixed={op.mixed} but the replayed delta carries dense "
                f"axes {tuple(st.dense)}")
        if op.backend is None and op.storage == "dense" and st.coo \
                and plan.kind == "coo" and not st.dense:
            bad("schema/backend", op, op.view,
                f"pure-COO dense ⊎ into '{op.view}' needs a resolved "
                f"backend")


def _sample_payload(ring, offset: float):
    """A deterministic, component-wise distinct sample element of the ring
    on the CPU (the commutativity witness input)."""
    out = {}
    i = 0.0
    for comp, shp in ring.components.items():
        n = 1
        for s in shp:
            n *= int(s)
        vals = (torch.arange(1, n + 1, dtype=torch.float32) * 0.37
                + offset + i).reshape(tuple(shp))
        out[comp] = vals.to(ring.dtype)
        i += 1.0
    return out


#: keyed by id(ring); the ring object itself is kept in the value so the id
#: can never be recycled while the entry is live
_commutativity_memo: dict = {}


def commutativity_witness(ring) -> bool:
    """Evaluate a ⊗ b == b ⊗ a on sample payloads — the property-based
    oracle behind ``ring.commutative``.  Memoized per ring instance, so the
    compile-time pass pays it once a ring, not once a plan."""
    hit = _commutativity_memo.get(id(ring))
    if hit is not None:
        return hit[1]
    if ring.mul_terms is None:
        ok = False
    else:
        a = _sample_payload(ring, 0.5)
        b = _sample_payload(ring, 2.25)
        ab, ba = ring.mul(a, b), ring.mul(b, a)
        ok = all(torch.allclose(ab[c], ba[c], rtol=1e-5, atol=1e-6)
                 for c in ring.components)
    _commutativity_memo[id(ring)] = (ring, ok)
    return ok


def _check_fused_chain(engine, plan: TriggerPlan, chain: FusedChain,
                       st: _ReplayState, written: set, resolve, bad) -> None:
    """Rule family 3: the fusion legality oracle — re-derive everything
    ``fuse_trigger_ops`` decided and require agreement.  The size rule is
    the H100 model: one block's shared memory, ``chain_smem_bytes`` of the
    ring width, within ``SMEM_PER_BLOCK``, and at most ``MAX_SOURCES``
    gathered or lifted sources; source planes stay in device memory, so
    their rows are not bounded."""
    from ..kernels import ring_fused

    query = engine.query
    # entry state: chains only start on a pure-COO delta with no carried
    # pending gather.  The run-time timeline applies: an earlier chain
    # materialized its delta, so its deferred gather is consumed
    if st.rt_pending or st.dense or not st.coo:
        bad("fusion/terminal", chain, "",
            f"chain starts on an illegal delta state (coo={tuple(st.coo)} "
            f"dense={tuple(st.dense)} pending={st.rt_pending}); fusion "
            f"requires a pure-COO unforced boundary")
    spec = ring_fused.fused_ring_spec(query.ring)
    if spec is None:
        bad("fusion/ring", chain, "",
            f"query ring "
            f"{getattr(query.ring, 'name', type(query.ring).__name__)} is "
            f"outside the fused algebra but the plan carries a fused chain")
    elif tuple(chain.spec) != tuple(spec):
        bad("fusion/ring", chain, "",
            f"chain ring spec {tuple(chain.spec)} != re-derived fused "
            f"ring spec {tuple(spec)}")
    if query.ring.commutative and not commutativity_witness(query.ring):
        bad("fusion/commutativity", chain, "",
            "ring claims commutativity but a ⊗ b != b ⊗ a on sample "
            "payloads; fused gathers reorder past later lift-multiplies")
    # structure: Gather*/Lift*/Marginalize*/Emit* then one terminal ⊎
    ops = chain.ops
    if not ops or not isinstance(ops[-1], ScatterAccum):
        bad("fusion/terminal", chain, "",
            "chain must end in its terminal ScatterAccum")
        return
    terminal = ops[-1]
    if terminal.mixed:
        bad("fusion/terminal", chain, terminal.view,
            f"terminal ⊎ into '{terminal.view}' is a mixed (dense-axes) "
            f"apply; the kernel only covers pure-COO scatters")
    if terminal.view.startswith(IND_PREFIX):
        bad("fusion/terminal", chain, terminal.view,
            "indicator planes never fuse")
    reads, n_src = [], 0
    for op in ops[:-1]:
        if isinstance(op, ScatterAccum):
            bad("fusion/terminal", chain, op.view,
                f"interior ⊎ into '{op.view}'; only the terminal op may "
                f"scatter")
        elif isinstance(op, Gather):
            reads.append(op.view)
            n_src += 1
            if op.view.startswith(IND_PREFIX):
                bad("race/fused-raw", chain, op.view,
                    f"chain gathers indicator plane '{op.view}' (updated "
                    f"in place mid-trigger; must stay unfused)")
            if op.view in written:
                bad("race/fused-raw", chain, op.view,
                    f"chain gathers '{op.view}' which an earlier op in "
                    f"this plan already wrote; fusion would skip the "
                    f"op-by-op read-after-write ordering")
        elif isinstance(op, Lift):
            n_src += 1
        elif isinstance(op, (Marginalize, Emit)):
            pass
        else:
            bad("fusion/terminal", chain, "",
                f"op {op.label()} is outside the fused vocabulary")
    if n_src == 0:
        bad("fusion/terminal", chain, terminal.view,
            "chain has no gather/lift source; a bare scatter is no fusion")
    if n_src > ring_fused.MAX_SOURCES:
        bad("fusion/smem", chain, terminal.view,
            f"chain has {n_src} gather/lift sources > MAX_SOURCES="
            f"{ring_fused.MAX_SOURCES}, the kernel's source slots")
    # recorded read / write sets must equal the flattened-op truth — the
    # CSE and capacity passes trust them
    if tuple(chain.reads) != tuple(reads):
        bad("race/fused-read-set", chain, terminal.view,
            f"chain records reads={tuple(chain.reads)} but its ops gather "
            f"{tuple(reads)}")
    if tuple(chain.writes) != (terminal.view,):
        bad("race/fused-write-set", chain, terminal.view,
            f"chain records writes={tuple(chain.writes)} but its terminal "
            f"⊎ targets '{terminal.view}'")
    # the block's shared memory: re-derive from the ring width and require
    # exact agreement, then the per-block limit
    smem = ring_fused.chain_smem_bytes(_ring_width(query.ring))
    if smem != chain.smem_bytes:
        bad("fusion/smem", chain, terminal.view,
            f"chain records smem={chain.smem_bytes}B but the kernel model "
            f"re-derives {smem}B from the ring width")
    if smem > ring_fused.SMEM_PER_BLOCK:
        bad("fusion/smem", chain, terminal.view,
            f"re-derived shared memory {smem}B exceeds SMEM_PER_BLOCK "
            f"{ring_fused.SMEM_PER_BLOCK}B")


def _derived_write_views(plan: TriggerPlan) -> set:
    out = set()
    for op in iter_flat_ops(plan.ops + plan.ind_ops):
        if isinstance(op, ScatterAccum) and not op.view.startswith(IND_PREFIX):
            out.add(op.view)
    return out


def _check_write_sets(engine, plan: TriggerPlan, bad) -> None:
    """Rule schema/write-set: the declared write sets *are* the authority
    for state partitioning, growth and the executor's in-place writes —
    they must equal what the op sequence actually scatters."""
    root = engine.tree.name
    if plan.kind == "reeval":
        if set(plan.write_views) != {root}:
            bad("schema/write-set", "", root,
                f"reeval writes {sorted(plan.write_views)} but "
                f"re-evaluation replaces exactly the root '{root}'")
    else:
        derived = _derived_write_views(plan)
        if plan.kind == "first_order":
            derived |= {root}
        if set(plan.write_views) != derived:
            bad("schema/write-set", "", ",".join(sorted(derived)),
                f"declares write_views={sorted(plan.write_views)} but the "
                f"op sequence ⊎-writes {sorted(derived)}")
    derived_inds = {op.node for op in plan.ind_ops
                    if isinstance(op, IndicatorBump)}
    if set(plan.write_indicators) != derived_inds:
        bad("schema/write-set", "", ",".join(sorted(derived_inds)),
            f"declares write_indicators={sorted(plan.write_indicators)} "
            f"but the indicator sections bump {sorted(derived_inds)}")
    bumps = {op.rel for op in iter_flat_ops(plan.ops)
             if isinstance(op, BaseBump)}
    expected_base = bumps | (({plan.rel} & set(engine.base))
                             if plan.kind in ("coo", "factorized") else set())
    if set(plan.write_base) != expected_base:
        bad("schema/write-set", "", ",".join(sorted(expected_base)),
            f"declares write_base={sorted(plan.write_base)} but the plan "
            f"bumps {sorted(expected_base)}")


def _check_capacity(engine, plan: TriggerPlan, views: Mapping, bad) -> None:
    """Rule family 4: the engine's insert-budget model (which sizes
    ``grow_if_loaded`` / ``check_stream_capacity`` headroom) must cover the
    worst case the plan's op schemas imply for every sparse ⊎."""
    from ..core import storage as storage_mod
    from ..core.relations import COOUpdate

    if plan.kind not in ("coo", "first_order"):
        return
    B = plan.batch or 1
    # host-side proto: _insert_budget only reads .schema and .batch
    # (keys.shape[0]) off a COOUpdate, so numpy keys keep the whole rule
    # free of device work
    proto = COOUpdate(schema=tuple(plan.schema),
                      keys=np.zeros((B, len(plan.schema)), np.int32),
                      payload=None)
    for op in iter_flat_ops(plan.ops + plan.ind_ops):
        if not isinstance(op, ScatterAccum) or op.storage != "sparse":
            continue
        if op.view.startswith(IND_PREFIX):
            continue
        view = views.get(op.view)
        if not isinstance(view, storage_mod.SparseRelation):
            continue
        dom_prod, unbound = 1, 1
        for v in view.schema:
            d = int(engine.query.domains[v])
            dom_prod *= d
            if v not in plan.schema:
                unbound *= d
        derived = min(B * unbound, dom_prod)
        budget = min(int(engine._insert_budget(view, plan.rel, proto)),
                     dom_prod)
        if budget < derived:
            bad("capacity/under-budget", op, op.view,
                f"engine insert budget {budget} for '{op.view}' under "
                f"δ{plan.rel} is below the plan-derived worst case "
                f"{derived} ({B} rows × {unbound} unbound keys); "
                f"growth/admission would under-provision")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def verify_trigger_plan(engine, plan: TriggerPlan,
                        views: Mapping | None = None) -> list[PlanViolation]:
    """Run every per-plan rule family over one compiled plan.  Returns the
    violation list (empty == clean); :func:`check_plan` raises instead."""
    views = engine.views if views is None else views
    bad = _Reporter(plan)
    resolve = _make_resolver(engine, plan, views)

    for op in iter_flat_ops(plan.ops + plan.ind_ops):
        _check_op_schema(engine, plan, op, resolve, bad)

    if plan.kind != "reeval":
        st = _ReplayState(coo=list(plan.schema), dense=[],
                          b=(plan.batch or 1), pending=False)
        written: set = set()
        for op in plan.ops:
            if isinstance(op, FusedChain):
                _check_fused_chain(engine, plan, op, st, written, resolve,
                                   bad)
                # inner ops replay through the same unfused state mirror:
                # fusion preserves ops (and their flags) verbatim
                for inner in op.ops:
                    _replay_op(engine, plan, inner, st, resolve, bad)
                    if isinstance(inner, ScatterAccum):
                        written.add(inner.view)
                st.rt_pending = False  # the chain materialized its delta
                continue
            _replay_op(engine, plan, op, st, resolve, bad)
            if isinstance(op, ScatterAccum):
                written.add(op.view)
        for op in plan.ind_ops:
            if isinstance(op, IndicatorBump):
                # each indicator section restarts from the projected δ∃
                st = _ReplayState(coo=list(op.proj), dense=[],
                                  b=(plan.batch or 1), pending=False)
                continue
            if isinstance(op, FusedChain):
                bad("fusion/terminal", op, "",
                    "indicator sections never fuse (they read views "
                    "updated in place mid-trigger)")
                continue
            _replay_op(engine, plan, op, st, resolve, bad)

    _check_write_sets(engine, plan, bad)
    _check_capacity(engine, plan, views, bad)
    return bad.out


def verify_step_plans(plans: Sequence[TriggerPlan]) -> list[PlanViolation]:
    """Rule race/memo-write: across one stream step, no CSE memo plane
    (``shared_prep_ops``) may name a view any plan in the step writes — the
    memo is built once a step, so a write would make later positions read a
    stale plane.  The write union is re-derived from the op sequences, not
    trusted from ``write_views``."""
    out: list[PlanViolation] = []
    shared = plan_mod.shared_prep_ops(plans)
    if not shared:
        return out
    write_union: dict[str, TriggerPlan] = {}
    for p in plans:
        for name in _derived_write_views(p) | set(p.write_views):
            write_union.setdefault(name, p)
    for form, name in shared:
        if name in write_union:
            writer = write_union[name]
            out.append(PlanViolation(
                "race/memo-write",
                f"step[{','.join(sorted({p.rel for p in plans}))}]",
                f"memo({form})", name,
                f"shared prep plane '{name}' is written by trigger "
                f"{writer.rel}'s plan this step; positions after it would "
                f"read a stale memo"))
    return out


def verify_shard_plan(shard_plan, plans: Sequence[TriggerPlan],
                      views: Mapping) -> list[PlanViolation]:
    """Rule race/shard-spec: the multi-device race detector.  Every
    sharded spec must name a view the plans actually scatter-write, carry
    the collective its true by-key readers require, and declare the live
    storage extent — all re-derived from the op sequences."""
    out: list[PlanViolation] = []
    write_union: set = set()
    for p in plans:
        write_union |= _derived_write_views(p) | set(p.write_views)
    read_union = set(plan_mod.read_sets(plans))
    n = shard_plan.n_devices
    head = f"shard[{shard_plan.axis_name}={n}]"

    def bad(name, message):
        out.append(PlanViolation("race/shard-spec", head,
                                 f"spec({name})", name, message))

    for name, spec in shard_plan.specs.items():
        if spec.kind != "shard":
            continue
        if name not in write_union:
            bad(name,
                f"view '{name}' is sharded but no plan scatter-writes it; "
                f"sharding buys nothing and every read pays a collective")
        if name in read_union and spec.collective != "all_gather":
            bad(name,
                f"view '{name}' is read by key by a sibling gather but "
                f"its shard spec routes reads via "
                f"'{spec.collective}'; cross-shard reads need all_gather")
        if name not in read_union and spec.collective == "all_gather":
            bad(name,
                f"view '{name}' is never read by key but pays an "
                f"all_gather on every read site")
        view = views.get(name)
        if view is not None:
            ext = int(view.shard_extent())
            if spec.extent != ext:
                bad(name,
                    f"spec extent {spec.extent} != live storage extent "
                    f"{ext} for view '{name}'")
            elif ext % n != 0:
                bad(name,
                    f"extent {ext} of view '{name}' does not divide the "
                    f"{n}-device mesh")
    return out


def check_plan(engine, plan: TriggerPlan,
               views: Mapping | None = None) -> TriggerPlan:
    """Verify one plan and raise :class:`PlanVerificationError` on any
    violation (the compile-time gate's entry point)."""
    violations = verify_trigger_plan(engine, plan, views=views)
    if violations:
        raise PlanVerificationError(violations)
    return plan


def check_step(plans: Sequence[TriggerPlan]) -> None:
    violations = verify_step_plans(plans)
    if violations:
        raise PlanVerificationError(violations)


def check_shard(shard_plan, plans: Sequence[TriggerPlan],
                views: Mapping) -> None:
    violations = verify_shard_plan(shard_plan, plans, views)
    if violations:
        raise PlanVerificationError(violations)
