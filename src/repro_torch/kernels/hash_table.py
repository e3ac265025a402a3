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

* :func:`hash_probe` — one thread an id walks its chain until it meets the
  id or a free slot, for at most ``C`` steps (the lockstep and the per-row
  forms of the reference give the same slots).
* :func:`hash_insert` — distinct ids into the table, in place, by the
  reference's lockstep rounds: every pending row reads its slot; a hit
  resolves it; rows that met a free slot claim it and the lowest row wins;
  the winners write their ids; the losers advance one slot.  At most
  ``C + B`` rounds; a row that never places (a full table) reports
  ``placed = False`` and slot 0.  The rounds run in one block of the
  kernel, with block barriers between their phases, so the table it builds
  is exactly the reference's.

A CPU tensor takes the plain version (:func:`probe_ref`,
:func:`insert_ref`: the reference's loops in torch, which synchronise once
a round); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._cuda import I32, I64, PTR, CudaKernel, check_tensor, on_card, stream_handle

#: open-addressing sentinel: a table slot holding EMPTY is free
EMPTY = -1

#: Knuth's multiplicative hash constant (2^32 / golden ratio)
HASH_MUL = 2654435761

HASH_PROBE = CudaKernel("hash_probe.cu", "repro_hash_probe",
                        [PTR, PTR, PTR, PTR, I32, I64])
HASH_INSERT = CudaKernel("hash_insert.cu", "repro_hash_insert",
                         [PTR, PTR, PTR, PTR, PTR, I32, I32])


def hash_ids(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """``(uint32(id) · HASH_MUL) mod 2^32 & (capacity - 1)`` as int32: the
    product in int64 (exact for ids below 2^31), masked."""
    return ((ids.to(torch.int64) & 0xFFFFFFFF) * HASH_MUL
            & (int(capacity) - 1)).to(torch.int32)


def _check(table: torch.Tensor, ids: torch.Tensor) -> tuple[int, int]:
    C, B = table.shape[0], ids.shape[0]
    check_tensor("table", table, torch.int32, (C,), table.device)
    check_tensor("ids", ids, torch.int32, (B,), table.device)
    if C < 2 or C & (C - 1) or C >= 2 ** 31:
        raise ValueError(f"table capacity {C} is not a power of two in [2, 2^31)")
    if B >= 2 ** 31:
        raise ValueError(f"{B} ids exceed the kernels' int32 row index")
    return C, B


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


def insert_ref(table: torch.Tensor, ids: torch.Tensor):
    """Plain version of :func:`hash_insert` (the reference's
    ``_insert_ids``), writing ``table`` in place."""
    C, B = table.shape[0], ids.shape[0]
    row = torch.arange(B, dtype=torch.int32, device=ids.device)
    pending = ids >= 0
    slot = hash_ids(ids.clamp(min=0), C)
    out_slot = torch.zeros((B,), dtype=torch.int32, device=ids.device)
    placed = torch.zeros((B,), dtype=torch.bool, device=ids.device)
    for _ in range(C + B):
        if not bool(pending.any()):
            break
        cur = table.index_select(0, slot.long())
        hit = pending & (cur == ids)
        out_slot = torch.where(hit, slot, out_slot)
        placed = placed | hit
        pending = pending & ~hit
        empty = pending & (cur == EMPTY)
        # scatter-min claim; index C is the drop slot of the other rows
        claim = torch.full((C + 1,), B, dtype=torch.int32, device=ids.device)
        claim.scatter_reduce_(0, torch.where(empty, slot, C).long(), row, "amin")
        won = empty & (claim.index_select(0, slot.long()) == row)
        table[slot[won].long()] = ids[won]
        out_slot = torch.where(won, slot, out_slot)
        placed = placed | won
        pending = pending & ~won
        slot = torch.where(pending, (slot + 1) & (C - 1), slot)
    return out_slot, placed


def hash_probe(table: torch.Tensor, ids: torch.Tensor):
    """``(slot [B] int32, found [B] bool)`` of int32 ``ids`` in ``table``
    ``[C]``: where each id lives, or the first free slot of its chain; ids
    < 0 are not probed (slot ``hash(0)``, found False)."""
    C, B = _check(table, ids)
    if not on_card(table):
        return probe_ref(table, ids)
    slot = torch.empty((B,), dtype=torch.int32, device=table.device)
    found = torch.empty((B,), dtype=torch.bool, device=table.device)
    if B:
        HASH_PROBE.launch(table.data_ptr(), ids.data_ptr(), slot.data_ptr(),
                          found.data_ptr(), C, B, stream_handle(table))
    return slot, found


def hash_insert(table: torch.Tensor, ids: torch.Tensor):
    """Insert distinct int32 ``ids`` (EMPTY = skip) into ``table`` ``[C]``
    in place; returns ``(slot [B] int32, placed [B] bool)``."""
    C, B = _check(table, ids)
    if not on_card(table):
        return insert_ref(table, ids)
    slot = torch.empty((B,), dtype=torch.int32, device=table.device)
    placed = torch.empty((B,), dtype=torch.bool, device=table.device)
    if B:
        claim = torch.empty((C,), dtype=torch.int32, device=table.device)
        HASH_INSERT.launch(table.data_ptr(), ids.data_ptr(), claim.data_ptr(),
                           slot.data_ptr(), placed.data_ptr(), C, B,
                           stream_handle(table))
    return slot, placed
