"""Hash probe and insert for sparse view storage on the card.

Wrappers for ``csrc/hash_probe.cu`` and ``csrc/hash_insert.cu``, which
resolve the slots of an open-addressed int32 key table (``EMPTY`` = free,
linear probing from Knuth's multiplicative hash, capacity a power of two).
They replace the probe and insert loops of ``repro/core/storage.py``
(``_find_slots`` / ``_probe_slots`` and ``_insert_ids``), which the
reference writes as ``lax.while_loop``s that end on ``jnp.any(pending)``.
In PyTorch that test is a host read, one synchronise a probe round, and
CUDA graph capture refuses it; each kernel is one launch that never
synchronises.  There was no Pallas kernel to translate.

* :func:`hash_probe` / :func:`hash_probe_keys` — a group of 8 lanes
  takes an id and reads 8 consecutive slots of its chain at once; a
  ballot finds the first slot that holds the id or is free, the slot the
  reference's walk stops at.  The keyed form
  takes a key matrix, the view's columns in it and the view's row-major
  strides, linearizes in the kernel as ``storage.linear_ids`` does, and
  also returns the gather row ``found ? slot : C``.
* :func:`hash_insert` — distinct ids into the table, in place, by the
  reference's lockstep rounds: every pending row reads its slot; a hit
  resolves it; rows that met a free slot claim it and the lowest row wins;
  the winners write their ids; the losers advance one slot.  At most
  ``C + B`` rounds; a row that never places (a full table) reports
  ``placed = False`` and slot 0.
* :func:`hash_insert_targets` / :func:`hash_insert_targets_keys` — the
  same rounds over a batch's raw ids (duplicates and sentinels included),
  the smallest id winning a claim: each row's target slot, ``EMPTY`` where
  the table is full or the id is a sentinel.  That equals the reference's
  ``_rank_ids`` → ``_insert_ids`` → ``where(placed, slot, EMPTY)[rank]``,
  table and targets, with no rank prepass.

The keyed forms linearize up to :data:`MAX_KEY_ARITY` key columns in the
kernel; a wider key is linearized before the launch (as
``storage.linear_ids``) and probed or claimed as ids by the same kernel.
The insert runs by one of two routes (:func:`insert_route`): ``cta``,
table and claim words in one block's shared memory; ``global``, through L2
in one block.  A CPU tensor takes the plain version (:func:`probe_ref`,
:func:`probe_keys_ref`, :func:`insert_ref`, :func:`insert_targets_ref`: the
reference's loops in torch, which synchronise once a round); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import (I32, I64, PTR, CudaKernel, LaunchCount, check_tensor, on_card,
                    stream_handle)

#: open-addressing sentinel: a table slot holding EMPTY is free
EMPTY = -1

#: Knuth's multiplicative hash constant (2^32 / golden ratio)
HASH_MUL = 2654435761

#: the widest view key the kernels linearize themselves (``hash_table.cuh``)
MAX_KEY_ARITY = 3

#: slots a block's shared memory holds, rows a thread keeps in registers
#: and the threads of a block (``hash_insert.cu``)
SLOTS_PER_BLOCK, ROWS_PER_THREAD, BLOCK_THREADS = 16384, 8, 1024
ROUTES = ("cta", "global")
_INT32_MAX = 2 ** 31 - 1


class KeySpec(ctypes.Structure):
    """``repro::KeySpec`` (``csrc/hash_table.cuh``), passed by value: arity
    0 reads an id column, arity k a key matrix's columns ``col[:k]`` times
    ``stride[:k]``."""

    _fields_ = [("arity", ctypes.c_int), ("row_stride", ctypes.c_int),
                ("col", ctypes.c_int * MAX_KEY_ARITY),
                ("stride", ctypes.c_int * MAX_KEY_ARITY)]


_IDS = KeySpec()  # arity 0: an id column

HASH_PROBE = CudaKernel("hash_probe.cu", "repro_hash_probe",
                        [PTR, PTR, KeySpec, PTR, PTR, PTR, I32, I64])
HASH_INSERT = CudaKernel("hash_insert.cu", "repro_hash_insert",
                         [PTR, PTR, KeySpec, PTR, PTR, PTR, PTR, PTR, I32, I32, I32, I32])

#: launches by entry and route, beside each kernel's own count
ROUTE_LAUNCHES = {f"{entry}:{route}": LaunchCount(f"{entry}:{route}")
                  for entry in ("hash_insert", "hash_insert_targets")
                  for route in ROUTES}
ROUTE_LAUNCHES.update({f"hash_probe:{form}": LaunchCount(f"hash_probe:{form}")
                       for form in ("ids", "keys")})


def hash_ids(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """``(uint32(id) · HASH_MUL) mod 2^32 & (capacity - 1)`` as int32: the
    product in int64 (exact for ids below 2^31), masked."""
    return ((ids.to(torch.int64) & 0xFFFFFFFF) * HASH_MUL
            & (int(capacity) - 1)).to(torch.int32)


def _check(table: torch.Tensor, ids: torch.Tensor) -> tuple[int, int]:
    C, B = table.shape[0], ids.shape[0]
    check_tensor("table", table, torch.int32, (C,), table.device)
    check_tensor("ids", ids, torch.int32, (B,), table.device)
    _check_sizes(C, B)
    return C, B


def _check_sizes(C: int, B: int) -> None:
    if C < 2 or C & (C - 1) or C >= 2 ** 31:
        raise ValueError(f"table capacity {C} is not a power of two in [2, 2^31)")
    if B >= 2 ** 31:
        raise ValueError(f"{B} ids exceed the kernels' int32 row index")


def _check_keys(table: torch.Tensor, keys: torch.Tensor, cols, strides):
    """(cols, strides) as int tuples; raises unless ``keys`` is a 2-D int32
    matrix on the table's device and ``cols``/``strides`` name at least one
    of its columns with int32 strides."""
    if keys.dim() != 2 or keys.dtype is not torch.int32:
        raise TypeError(f"keys must be a 2-D int32 matrix, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if keys.device != table.device:
        raise ValueError(f"keys are on {keys.device}, expected {table.device}")
    cols, strides = tuple(int(c) for c in cols), tuple(int(s) for s in strides)
    if not cols or len(strides) != len(cols):
        raise ValueError(f"{len(cols)} key columns with {len(strides)} strides")
    if any(not 0 <= c < keys.shape[1] for c in cols):
        raise ValueError(f"key columns {cols} outside a key matrix of "
                         f"{keys.shape[1]} columns")
    if any(not 0 <= s <= _INT32_MAX for s in strides):
        raise ValueError(f"strides {strides} do not fit in int32")
    _check_sizes(table.shape[0], keys.shape[0])
    return cols, strides


def key_source(keys: torch.Tensor, cols, strides) -> tuple[torch.Tensor, KeySpec]:
    """What a keyed launch reads: the key matrix ``keys`` and the
    :class:`KeySpec` of its columns ``cols`` (with ``strides``), which needs
    a unit column stride and an int32 row stride; a key wider than
    :data:`MAX_KEY_ARITY` columns is linearized here (:func:`linearize_ref`,
    as ``storage.linear_ids``) and read as ids."""
    if len(cols) > MAX_KEY_ARITY:
        return linearize_ref(keys, cols, strides), _IDS
    B, K = keys.shape
    if K > 1 and keys.stride(1) != 1:
        raise ValueError("keys must have unit column stride")
    if B > 1 and keys.stride(0) > _INT32_MAX:
        raise ValueError(f"key row stride {keys.stride(0)} does not fit in int32")
    spec = KeySpec()
    spec.arity, spec.row_stride = len(cols), int(keys.stride(0)) if B > 1 else 0
    for j, (c, s) in enumerate(zip(cols, strides)):
        spec.col[j], spec.stride[j] = c, s
    return keys, spec


def linearize_ref(keys: torch.Tensor, cols, strides) -> torch.Tensor:
    """Plain linearization of view columns ``cols`` of ``keys``: the sum of
    column times stride in int32, added as ``storage.linear_ids`` adds
    (the last column first, then the others right to left)."""
    cols = list(cols)
    ids = keys[:, cols[-1]].to(torch.int32, copy=True)
    if int(strides[-1]) != 1:
        ids.mul_(int(strides[-1]))
    for j in range(len(cols) - 2, -1, -1):
        ids.add_(keys[:, cols[j]].to(torch.int32), alpha=int(strides[j]))
    return ids


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def probe_ref(table: torch.Tensor, ids: torch.Tensor):
    """Plain version of :func:`hash_probe`: the reference's lockstep probe
    (``_find_slots``)."""
    C = table.shape[0]
    valid = ids >= 0
    slot = hash_ids(ids.clamp(min=0), C)
    done = ~valid
    for _ in range(C):
        if bool(done.all()):
            break
        cur = table.index_select(0, slot.long())
        stop = (cur == ids) | (cur == EMPTY)
        slot = torch.where(done | stop, slot, (slot + 1) & (C - 1))
        done = done | stop
    found = valid & (table.index_select(0, slot.long()) == ids)
    return slot, found


def probe_keys_ref(table: torch.Tensor, keys: torch.Tensor, cols, strides):
    """Plain version of :func:`hash_probe_keys`: linearize, probe, and the
    gather row ``found ? slot : C``."""
    slot, found = probe_ref(table, linearize_ref(keys, cols, strides))
    return slot, found, torch.where(found, slot, table.shape[0])


def _lockstep_ref(table: torch.Tensor, ids: torch.Tensor, by_id: bool):
    """The reference's ``_insert_ids`` rounds, in place: (slot, placed,
    rounds run).  A claim goes to the lowest row, or with ``by_id`` to the
    smallest id (rows of one id claim and write together)."""
    C, B = table.shape[0], ids.shape[0]
    prio = ids if by_id else torch.arange(B, dtype=torch.int32, device=ids.device)
    pending = ids >= 0
    slot = hash_ids(ids.clamp(min=0), C)
    out_slot = torch.zeros((B,), dtype=torch.int32, device=ids.device)
    placed = torch.zeros((B,), dtype=torch.bool, device=ids.device)
    rounds = 0
    for _ in range(C + B):
        if not bool(pending.any()):
            break
        rounds += 1
        cur = table.index_select(0, slot.long())
        hit = pending & (cur == ids)
        out_slot = torch.where(hit, slot, out_slot)
        placed = placed | hit
        pending = pending & ~hit
        empty = pending & (cur == EMPTY)
        # scatter-min claim; index C is the drop slot of the other rows
        claim = torch.full((C + 1,), _INT32_MAX, dtype=torch.int32, device=ids.device)
        claim.scatter_reduce_(0, torch.where(empty, slot, C).long(), prio, "amin")
        won = empty & (claim.index_select(0, slot.long()) == prio)
        table[slot[won].long()] = ids[won]
        out_slot = torch.where(won, slot, out_slot)
        placed = placed | won
        pending = pending & ~won
        slot = torch.where(pending, (slot + 1) & (C - 1), slot)
    return out_slot, placed, rounds


def insert_ref(table: torch.Tensor, ids: torch.Tensor, rounds=None):
    """Plain version of :func:`hash_insert` (the reference's
    ``_insert_ids``), writing ``table`` in place."""
    slot, placed, n = _lockstep_ref(table, ids, by_id=False)
    if rounds is not None:
        rounds.fill_(n)
    return slot, placed


def insert_targets_ref(table: torch.Tensor, ids: torch.Tensor, rounds=None):
    """Plain version of :func:`hash_insert_targets`: the lockstep rounds
    with the smallest id winning a claim, writing ``table`` in place."""
    slot, placed, n = _lockstep_ref(table, ids, by_id=True)
    if rounds is not None:
        rounds.fill_(n)
    return torch.where(placed, slot, EMPTY)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _probe(table, src, spec, C, B, rows: bool):
    slot = torch.empty((B,), dtype=torch.int32, device=table.device)
    found = torch.empty((B,), dtype=torch.bool, device=table.device)
    row = torch.empty((B,), dtype=torch.int32, device=table.device) if rows else None
    if B:
        HASH_PROBE.launch(table.data_ptr(), src.data_ptr(), spec, slot.data_ptr(),
                          found.data_ptr(), row.data_ptr() if rows else None, C, B,
                          stream_handle(table))
        ROUTE_LAUNCHES["hash_probe:keys" if rows else "hash_probe:ids"].launches += 1
    return slot, found, row


def hash_probe(table: torch.Tensor, ids: torch.Tensor):
    """``(slot [B] int32, found [B] bool)`` of int32 ``ids`` in ``table``
    ``[C]``: where each id lives, or the first free slot of its chain; ids
    < 0 are not probed (slot ``hash(0)``, found False)."""
    C, B = _check(table, ids)
    if not on_card(table):
        return probe_ref(table, ids)
    slot, found, _ = _probe(table, ids, _IDS, C, B, False)
    return slot, found


def hash_probe_keys(table: torch.Tensor, keys: torch.Tensor, cols, strides):
    """``(slot, found, rows)`` [B] of the view keys in columns ``cols`` of
    the int32 key matrix ``keys`` [B, K], linearized with the view's
    row-major ``strides`` (as ``storage.linear_ids``): the probe of
    :func:`hash_probe`, and the gather row ``found ? slot : C`` (the
    plane's zero row C for a missed key), in one launch."""
    C, B = table.shape[0], keys.shape[0]
    check_tensor("table", table, torch.int32, (C,), table.device)
    cols, strides = _check_keys(table, keys, cols, strides)
    if not on_card(table):
        return probe_keys_ref(table, keys, cols, strides)
    return _probe(table, *key_source(keys, cols, strides), C, B, True)


def insert_route(C: int, B: int) -> str:
    """The insert's route for a table of ``C`` slots and ``B`` rows:
    ``"cta"`` where one block's shared memory holds the table and its
    threads the rows, else ``"global"``."""
    fits = C <= SLOTS_PER_BLOCK and B <= BLOCK_THREADS * ROWS_PER_THREAD
    return "cta" if fits else "global"


def _insert(table, src, spec, C, B, by_id: bool, rounds):
    route = insert_route(C, B)
    dev = table.device
    if by_id:
        slot = placed = None
        target = torch.empty((B,), dtype=torch.int32, device=dev)
    else:
        slot = torch.empty((B,), dtype=torch.int32, device=dev)
        placed = torch.empty((B,), dtype=torch.bool, device=dev)
        target = None
    if rounds is not None:
        check_tensor("rounds", rounds, torch.int32, (1,), dev)
    if B:
        scratch = (torch.empty((C + 3 * B,), dtype=torch.int32, device=dev)
                   if route == "global" else None)

        def ptr(t):
            return None if t is None else t.data_ptr()

        HASH_INSERT.launch(table.data_ptr(), src.data_ptr(), spec, ptr(slot), ptr(placed),
                           ptr(target), ptr(rounds), ptr(scratch), C, B,
                           ROUTES.index(route), int(by_id), stream_handle(table))
        entry = "hash_insert_targets" if by_id else "hash_insert"
        ROUTE_LAUNCHES[f"{entry}:{route}"].launches += 1
    elif rounds is not None:
        rounds.zero_()
    return target if by_id else (slot, placed)


def hash_insert(table: torch.Tensor, ids: torch.Tensor, rounds=None):
    """Insert distinct int32 ``ids`` (EMPTY = skip) into ``table`` ``[C]``
    in place, by the route :func:`insert_route` picks; returns ``(slot [B]
    int32, placed [B] bool)``.  ``rounds``, an int32 [1] tensor, receives
    the rounds run."""
    C, B = _check(table, ids)
    if not on_card(table):
        return insert_ref(table, ids, rounds)
    return _insert(table, ids, _IDS, C, B, False, rounds)


def hash_insert_targets(table: torch.Tensor, ids: torch.Tensor,
                        rounds=None) -> torch.Tensor:
    """Claim slots in ``table`` ``[C]`` for a batch's int32 ``ids``
    (duplicates share a slot, ids < 0 are sentinels), in place: the target
    slot of every row, EMPTY where the table is full or the id a sentinel.
    ``rounds`` as in :func:`hash_insert`."""
    C, B = _check(table, ids)
    if not on_card(table):
        return insert_targets_ref(table, ids, rounds)
    return _insert(table, ids, _IDS, C, B, True, rounds)


def hash_insert_targets_keys(table: torch.Tensor, keys: torch.Tensor, cols, strides,
                             rounds=None) -> torch.Tensor:
    """:func:`hash_insert_targets` of the view keys in columns ``cols`` of
    the int32 key matrix ``keys`` [B, K], linearized in the kernel with the
    view's row-major ``strides`` (as ``storage.linear_ids``)."""
    C, B = table.shape[0], keys.shape[0]
    check_tensor("table", table, torch.int32, (C,), table.device)
    cols, strides = _check_keys(table, keys, cols, strides)
    if not on_card(table):
        return insert_targets_ref(table, linearize_ref(keys, cols, strides), rounds)
    return _insert(table, *key_source(keys, cols, strides), C, B, True, rounds)
