"""Runtime integrity layer: validated admission, quarantine, and audited
Reevaluate self-healing (PyTorch port of ``repro.runtime.integrity``).

Every materialized view is recomputable from the stored base relations
(the "higher-order views as insurance" property of Nikolic & Olteanu
2017), so integrity decomposes into four pillars:

1. **Validated admission** (:func:`admit_stream`): per-batch checks at
   segment-admission time — finite payloads, in-domain keys, schema/dtype
   conformance — under three policies.  ``strict`` raises
   :class:`StreamIntegrityError` before the offending segment runs (and
   therefore before any poisoned boundary snapshot can commit);
   ``quarantine`` masks offending tuples out of the batch (key 0 +
   ring-zero payload: exactly the executor's padding convention, so a
   masked row is bit-transparent) and routes them to a
   :class:`DeadLetterLog` with reason codes; ``permissive`` skips
   validation.  The row checks are plain torch on the batch's device (an
   ``isfinite`` row reduction over float leaves, a compare per key column
   against its domain, ``masked_fill`` masking) and build no tensor from
   host data.  ``strict`` reads one stacked flag vector on the host per
   segment; ``quarantine`` parks its reason bits on
   ``cfg.pending_dead_letters`` and reads them once, in
   :func:`flush_dead_letters`, after the run.

2. **Checksummed snapshots**: per-leaf CRC32 fingerprints written into
   the checkpoint manifest and verified on restore
   (``repro_torch.checkpoint.checkpointer``, ``ChecksumError``), proven by
   the ``snapshot_committed`` bit-flip fault point.

3. **Drift-bounded reconciliation** (:func:`audit_engine`): every
   ``audit_interval`` segment boundaries the audited views are recomputed
   from base relations (``plan.reevaluate_store``) and compared with the
   live incremental state.  Integer rings must match exactly (a
   divergence is corruption and raises); float rings may drift up to
   ``audit_tol`` — beyond it the live view is repaired from the
   recomputation.  A repair writes *in place* (``copy_`` into the live
   leaves) wherever the repaired view keeps the live layout — a dense view
   always, a sparse view when the repaired table has the live capacity —
   so the executor's CUDA graphs, bound to those tensors, stay valid; a
   sparse view whose recomputed keys no longer fit installs a larger table
   (new tensors: the next segment captures anew).

4. **Graceful degradation**: capacity pressure on the segmented path
   downgrades to emergency re-segmentation or an eager per-batch spill
   (``repro_torch.core.stream``, recorded in ``degrade_log``);
   ``StreamSupervisor`` (``repro_torch.runtime.fault_tolerance``) adds the
   escalation ladder with :func:`reevaluate_from_base` as its strongest
   rung.

This module imports nothing of ``repro_torch.core.stream`` (the executor
imports it lazily; the edge stays one-directional).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..core import plan as plan_mod
from ..core import storage as storage_mod
from ..core.relations import COOUpdate, DenseRelation, is_sharded

# --------------------------------------------------------------------------
# Reason codes (dead-letter vocabulary)
# --------------------------------------------------------------------------
REASON_NONFINITE = "nonfinite_payload"
REASON_KEY_DOMAIN = "key_out_of_domain"
REASON_SCHEMA = "schema_mismatch"
REASON_DTYPE = "dtype_mismatch"

#: bit positions of the row validator (:func:`validate_rows`)
_BIT_REASONS = ((1, REASON_NONFINITE), (2, REASON_KEY_DOMAIN))

POLICIES = ("strict", "quarantine", "permissive")


class StreamIntegrityError(RuntimeError):
    """An integrity invariant failed: poisoned admission under ``strict``,
    integer-ring audit divergence, or an audit that cannot run (no stored
    base).  Carries the offending :class:`DeadLetter` records when the
    failure is data-shaped."""

    def __init__(self, msg: str, records=()):
        super().__init__(msg)
        self.records = tuple(records)


@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """One quarantined tuple (or whole batch, ``row == -1``)."""

    rel: str
    stream_index: int  # absolute update index in the run's stream
    row: int  # row within the batch; -1 = the whole batch
    key: tuple  # the offending key (empty for whole-batch records)
    reasons: tuple[str, ...]  # reason codes, see REASON_*


class DeadLetterLog:
    """Host-side sink for quarantined tuples.

    Bounded (``max_records``): past the cap only the drop counter grows,
    so a hostile stream cannot exhaust host memory through its rejects."""

    def __init__(self, max_records: int = 10_000):
        self.max_records = max_records
        self.records: list[DeadLetter] = []
        self.dropped = 0

    def append(self, rec: DeadLetter) -> None:
        if len(self.records) < self.max_records:
            self.records.append(rec)
        else:
            self.dropped += 1

    def counts(self) -> dict[str, int]:
        """Quarantined-record count per reason code."""
        out: dict[str, int] = {}
        for rec in self.records:
            for r in rec.reasons:
                out[r] = out.get(r, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.records) + self.dropped

    def __iter__(self):
        return iter(self.records)

    def clear(self) -> None:
        self.records.clear()
        self.dropped = 0


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------
@dataclasses.dataclass
class IntegrityConfig:
    """Integrity policy + telemetry attached to a ``StreamExecutor``.

    ``policy`` governs admission validation; ``audit_interval`` enables
    the audited Reevaluate pass every k segment boundaries (requires the
    engine to store its base relations — ``IVMEngine.build(...,
    store_base=True)``); ``segment_updates`` caps segment length the same
    way the checkpointer's knob does, so validation/audit boundaries
    exist even on streams capacity segmentation would never split;
    ``capacity_degrade`` turns :class:`StreamCapacityError` hard fails
    into emergency re-segmentation / eager spill."""

    policy: str = "quarantine"
    audit_interval: int | None = None
    audit_views: tuple[str, ...] | None = None  # None -> the root view
    audit_tol: float = 1e-5
    audit_repair: bool = True
    segment_updates: int | None = None
    capacity_degrade: bool = True
    dead_letters: DeadLetterLog = dataclasses.field(
        default_factory=DeadLetterLog)
    audit_log: list = dataclasses.field(default_factory=list)
    degrade_log: list = dataclasses.field(default_factory=list)
    #: quarantine-mode validation results awaiting their host readback —
    #: (stream index, rel, original update, device reason bits).  Drained
    #: by :func:`flush_dead_letters`; never touched under ``strict``.
    pending_dead_letters: list = dataclasses.field(
        default_factory=list, repr=False)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.audit_interval is not None and self.audit_interval < 1:
            raise ValueError("audit_interval must be >= 1")
        if self.segment_updates is not None and self.segment_updates < 1:
            raise ValueError("segment_updates must be >= 1")

    @property
    def active(self) -> bool:
        """Whether the executor must take the segmented path for this
        config to observe anything."""
        return (self.policy != "permissive"
                or self.audit_interval is not None
                or self.segment_updates is not None)

    def audit_due(self, segment: int) -> bool:
        """Audit at every ``audit_interval``-th boundary (segment is the
        0-based index; the first audit lands after segment k-1)."""
        k = self.audit_interval
        return k is not None and (segment + 1) % k == 0


# --------------------------------------------------------------------------
# Pillar 1 — validated admission
# --------------------------------------------------------------------------
def validate_rows(keys: torch.Tensor, payload_leaves: tuple,
                  domains: tuple[int, ...]) -> torch.Tensor:
    """Per-row reason bits (int32 ``[B]``) of one COO batch, on its
    device: bit 1 = non-finite payload in any ring component, bit 2 = key
    outside ``[0, domain)`` in any column.  Integer payload leaves are
    vacuously finite and skipped.  Reads nothing on the host and builds no
    tensor from host data (each column is compared with a Python int)."""
    B = keys.shape[0]
    bad_pay = torch.zeros((B,), dtype=torch.bool, device=keys.device)
    for leaf in payload_leaves:
        if leaf.is_floating_point():
            bad_pay |= ~torch.isfinite(leaf).reshape(B, -1).all(dim=1)
    bad_key = (keys < 0).any(dim=1)
    for i, d in enumerate(domains):
        bad_key |= keys[:, i] >= int(d)
    return bad_pay.to(torch.int32) + 2 * bad_key.to(torch.int32)


def _mask_rows(bad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` with the rows ``bad`` flags set to zero: the padding key, and
    the ring zero of every ring of the port (``Ring.zeros``)."""
    return x.masked_fill(bad.reshape((-1,) + (1,) * (x.dim() - 1)), 0)


def _validate_sanitize(keys: torch.Tensor, payload: dict,
                       domains: tuple[int, ...]):
    """Validate + sanitize — the quarantine hot path: the reason bits
    beside the masked keys and payload, which equal the inputs when no
    bit is set."""
    bits = validate_rows(keys, tuple(payload.values()), domains)
    bad = bits > 0
    return (bits, _mask_rows(bad, keys),
            {c: _mask_rows(bad, v) for c, v in payload.items()})


def reasons_of(bits: int) -> tuple[str, ...]:
    """Decode a row's reason bits into reason codes."""
    return tuple(code for bit, code in _BIT_REASONS if bits & bit)


def sanitize_batch(upd: COOUpdate, reason_bits: torch.Tensor,
                   ring) -> COOUpdate:
    """Mask offending rows transparent: key 0 + ring-zero payload — the
    executor's padding convention, so ⊎ and indicator transition gating
    both treat the row as a no-op.  No host read.  (``ring`` is the
    reference's argument: the ring zero is 0 in every ring of the port.)"""
    bad = reason_bits > 0
    return COOUpdate(upd.schema, _mask_rows(bad, upd.keys),
                     {c: _mask_rows(bad, x) for c, x in upd.payload.items()})


def batch_schema_errors(query, rel: str, upd) -> tuple[str, ...]:
    """Host-side static conformance of one batch against the declared
    relation: schema tuple, key arity, an integer key dtype, payload leaf
    dtypes equal to the ring's torch dtype.  These are whole-batch defects
    — no per-row mask can fix a wrong shape."""
    errs: list[str] = []
    declared = tuple(query.relations[rel])
    if not isinstance(upd, COOUpdate):
        return (REASON_SCHEMA,)
    if tuple(upd.schema) != declared:
        errs.append(REASON_SCHEMA)
    elif upd.keys.dim() != 2 or upd.keys.shape[1] != len(declared):
        errs.append(REASON_SCHEMA)
    if upd.keys.is_floating_point() or upd.keys.is_complex() \
            or upd.keys.dtype == torch.bool:
        errs.append(REASON_DTYPE)
    want = query.ring.dtype
    for leaf in upd.payload.values():
        if leaf.dtype != want:
            errs.append(REASON_DTYPE)
            break
    return tuple(errs)


def _transparent_batch(query, rel: str, batch: int, device) -> COOUpdate:
    """An all-padding replacement batch (whole-batch quarantine)."""
    ring = query.ring
    k = len(query.relations[rel])
    return COOUpdate(tuple(query.relations[rel]),
                     torch.zeros((max(batch, 1), k), dtype=torch.int32,
                                 device=device),
                     ring.zeros((max(batch, 1),), device=device))


def _batch_dead_letters(rel: str, index: int, upd, bits) -> list:
    """Host readback of one flagged batch's offending rows (blocks on
    ``bits``)."""
    bits_h = bits.cpu()
    rows = torch.nonzero(bits_h).reshape(-1).tolist()
    keys_h = upd.keys.cpu()
    return [DeadLetter(rel, index, int(r),
                       tuple(int(k) for k in keys_h[r].tolist()),
                       reasons_of(int(bits_h[r])))
            for r in rows]


def _batch_flags(checks) -> list[bool]:
    """Whether each checked batch has a set reason bit: one stacked host
    read for all of them."""
    return torch.stack([(b > 0).any() for *_, b in checks]).cpu().tolist()


def admit_stream(engine, sub_stream, cfg: IntegrityConfig,
                 base_offset: int = 0):
    """Validated admission of one segment's updates.

    Returns the sub-stream with offending rows/batches masked out
    (``quarantine``), raises :class:`StreamIntegrityError` carrying the
    offending records (``strict``), or passes through (``permissive``).
    Under ``quarantine`` the whole admission reads nothing on the host:
    every checked batch is sanitized on its device (the identity when its
    reason bits are all zero), and the readback that turns flagged rows
    into dead letters is parked on ``cfg.pending_dead_letters`` for
    :func:`flush_dead_letters`.  ``strict`` must synchronise: a poisoned
    update fails admission *before* its segment can run or snapshot, so it
    pays one stacked host read per segment.  Replay-deterministic:
    resuming a run re-admits the same raw updates and masks them the same
    way (dead letters may be re-recorded across restarts)."""
    if cfg is None or cfg.policy == "permissive":
        return list(sub_stream)
    query = engine.query
    out: list = []
    checks: list = []  # (position, rel, upd, reason_bits)
    for j, (rel, upd) in enumerate(sub_stream):
        errs = batch_schema_errors(query, rel, upd)
        if errs:
            rec = DeadLetter(rel, base_offset + j, -1, (), errs)
            if cfg.policy == "strict":
                raise StreamIntegrityError(
                    f"update {base_offset + j} ({rel}) rejected at "
                    f"admission: {', '.join(errs)}", [rec])
            cfg.dead_letters.append(rec)
            out.append((rel, _transparent_batch(
                query, rel, getattr(upd, "batch", 1), engine.device)))
            continue
        doms = tuple(int(query.domains[v]) for v in upd.schema)
        if cfg.policy == "quarantine":
            bits, keys_s, payload_s = _validate_sanitize(upd.keys, upd.payload,
                                                         doms)
            out.append((rel, COOUpdate(upd.schema, keys_s, payload_s)))
        else:
            bits = validate_rows(upd.keys, tuple(upd.payload.values()), doms)
            out.append((rel, upd))
        checks.append((j, rel, upd, bits))
    if not checks:
        return out
    if cfg.policy == "quarantine":
        cfg.pending_dead_letters.extend(
            (base_offset + j, rel, upd, bits)
            for j, rel, upd, bits in checks)
        return out
    # strict: one stacked host read, before anything can run or snapshot
    for (j, rel, upd, bits), flagged in zip(checks, _batch_flags(checks)):
        if not flagged:
            continue
        records = _batch_dead_letters(rel, base_offset + j, upd, bits)
        raise StreamIntegrityError(
            f"update {base_offset + j} ({rel}) rejected at admission: "
            f"{len(records)} offending row(s) — "
            + ", ".join(sorted({c for rec in records
                                for c in rec.reasons})), records)
    return out


def flush_dead_letters(cfg: IntegrityConfig | None) -> int:
    """Drain ``cfg.pending_dead_letters`` into the dead-letter log: one
    stacked host read of the per-batch violation flags, then a row
    readback for flagged batches only.  Called by the executor once the
    admitted segments have run; returns the number of dead letters
    recorded."""
    if cfg is None or not cfg.pending_dead_letters:
        return 0
    pending, cfg.pending_dead_letters = cfg.pending_dead_letters, []
    n = 0
    for (idx, rel, upd, bits), flagged in zip(pending, _batch_flags(pending)):
        if not flagged:
            continue
        for rec in _batch_dead_letters(rel, idx, upd, bits):
            cfg.dead_letters.append(rec)
            n += 1
    return n


# --------------------------------------------------------------------------
# Pillar 3 — audited Reevaluate (drift-bounded reconciliation)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class AuditRecord:
    """Outcome of auditing one view at one segment boundary."""

    segment: int
    view: str
    exact: bool  # bit-identical to the from-base recomputation
    max_abs_err: float
    repaired: bool
    wall_s: float


def reference_store(engine) -> dict:
    """Recompute every view from the stored base relations via the plan
    IR's ``Reevaluate`` interpretation.  The audit's ground truth — and
    only available when the engine stores all base relations."""
    missing = sorted(set(engine.query.relations) - set(engine.base))
    if missing:
        raise StreamIntegrityError(
            f"audited Reevaluate needs stored base relations (missing "
            f"{missing}); build the engine with store_base=True")
    return plan_mod.reevaluate_store(engine, engine.base)


def _repair_capacity(live, active: int) -> int:
    """Capacity for a repaired sparse view: keep the live capacity (so
    the executor's graphs stay bound) unless the recomputed active set
    could not fit under the load factor."""
    cap = live.capacity
    while active > storage_mod.LOAD_FACTOR * cap:
        cap *= 2
    return cap


def repair_view(engine, name: str, ref_dense: DenseRelation) -> str:
    """Swap the recomputed view in under the live storage backend.

    Returns the route: ``"in_place"`` where the repaired view keeps the
    live layout (a dense view; a sparse view whose repaired table has the
    live capacity) — its values are copied into the live tensors, whose
    identity the executor's graphs are bound to — else ``"replaced"`` (a
    sparse view that needs a larger table gets new tensors).  The sparse
    table is ``SparseRelation.from_dense`` at the repair capacity, the
    reference's slot layout.  One rank's slice of a sharded view takes
    its own rows of the repaired view (every rank repairs alike: the
    audit compares whole views)."""
    live = engine.views[name]
    sharded = is_sharded(live)
    if isinstance(live, storage_mod.SparseRelation):
        ring = ref_dense.ring
        active = int((~ring.is_zero(ref_dense.payload)).sum())
        new = storage_mod.SparseRelation.from_dense(
            ref_dense, capacity=_repair_capacity(live, active))
        if new.capacity != live.capacity:
            engine.views[name] = (storage_mod.ShardedSparse.place(new, live.shard.grp)
                                  if sharded else new)
            return "replaced"
        live.table.copy_(new.table)
        live.plane.copy_(live.shard.take(new.rows) if sharded else new.plane)
        return "in_place"
    if sharded:
        live.assign(ref_dense)
        return "in_place"
    for c, leaf in live.payload.items():
        leaf.copy_(ref_dense.payload[c])
    return "in_place"


def _divergence(live_dense, ref_dense, is_float: bool) -> tuple[float, float]:
    """(max |live - ref|, max |live - ref| / max(|ref|, 1)) over every
    component; NaN in the live view counts as infinite divergence."""
    max_abs = 0.0
    max_scaled = 0.0
    for c in ref_dense.ring.components:
        ref = ref_dense.payload[c]
        live = live_dense.payload[c].to(ref.dtype)
        diff = (live - ref).abs()
        if is_float:
            diff = diff.masked_fill(torch.isnan(diff), float("inf"))
        max_abs = max(max_abs, float(diff.max()) if diff.numel() else 0.0)
        scale = ref.abs().clamp_min(1)
        max_scaled = max(max_scaled,
                         float((diff / scale).max()) if diff.numel() else 0.0)
    return max_abs, max_scaled


def audit_engine(engine, cfg: IntegrityConfig,
                 segment: int = -1) -> list[AuditRecord]:
    """One audited Reevaluate pass: recompute the audited views from base
    relations, compare against the live incremental state, and repair
    divergence.

    Integer rings must be exact — any mismatch is corruption and raises
    :class:`StreamIntegrityError`.  Float rings tolerate replay drift up
    to ``audit_tol`` (relative, floored at 1): beyond it the live view is
    repaired from the recomputation (``audit_repair``; see
    :func:`repair_view` for the in-place and replacing routes).  Every
    pass appends divergence telemetry to ``cfg.audit_log`` (with the
    repair's ``route``).  Host-synchronous by construction (it compares
    device values): the executor runs it at segment boundaries."""
    t0 = time.perf_counter()
    store = reference_store(engine)
    names = cfg.audit_views if cfg.audit_views else (engine.tree.name,)
    records: list[AuditRecord] = []
    for name in names:
        ref_dense = storage_mod.as_dense(store[name])
        live_dense = storage_mod.as_dense(engine.views[name])
        is_float = ref_dense.ring.dtype.is_floating_point
        max_abs, max_scaled = _divergence(live_dense, ref_dense, is_float)
        exact = max_abs == 0.0
        route = None
        if not exact and not is_float:
            rec = AuditRecord(segment, name, False, max_abs, False,
                              time.perf_counter() - t0)
            cfg.audit_log.append(dataclasses.asdict(rec))
            raise StreamIntegrityError(
                f"integer-ring audit divergence in view {name!r} at "
                f"segment {segment}: max |live - reeval| = {max_abs} "
                "(exact rings cannot drift — state corruption)")
        if not exact and max_scaled > cfg.audit_tol and cfg.audit_repair:
            route = repair_view(engine, name, ref_dense)
        rec = AuditRecord(segment, name, exact, max_abs, route is not None,
                          time.perf_counter() - t0)
        records.append(rec)
        cfg.audit_log.append(dict(dataclasses.asdict(rec), route=route))
    return records


def publish_meta(records: list[AuditRecord]) -> dict:
    """Audit provenance for a snapshot publication (the serving plane,
    ROADMAP Queue 1 item 17): whether the boundary's audit found the state
    clean, repaired it, or never ran (empty meta)."""
    if not records:
        return {}
    return dict(audited=True,
                audit_exact=all(r.exact for r in records),
                repaired=sorted(r.view for r in records if r.repaired))


def reevaluate_from_base(engine) -> dict[str, float]:
    """Full self-heal: rebuild *every* materialized view from the stored
    base relations, preserving each view's storage backend (and sparse
    capacity where it still fits).  The strongest rung of the
    ``StreamSupervisor`` escalation ladder.  Returns per-view max
    absolute correction as telemetry."""
    store = reference_store(engine)
    drift: dict[str, float] = {}
    for name in list(engine.views):
        ref_dense = storage_mod.as_dense(store[name])
        drift[name] = _divergence(storage_mod.as_dense(engine.views[name]),
                                  ref_dense,
                                  ref_dense.ring.dtype.is_floating_point)[0]
        repair_view(engine, name, ref_dense)
    return drift


__all__ = [
    "AuditRecord",
    "DeadLetter",
    "DeadLetterLog",
    "IntegrityConfig",
    "POLICIES",
    "REASON_DTYPE",
    "REASON_KEY_DOMAIN",
    "REASON_NONFINITE",
    "REASON_SCHEMA",
    "StreamIntegrityError",
    "admit_stream",
    "audit_engine",
    "batch_schema_errors",
    "flush_dead_letters",
    "publish_meta",
    "reasons_of",
    "reevaluate_from_base",
    "reference_store",
    "repair_view",
    "sanitize_batch",
    "validate_rows",
]
