"""Checkpointing with async writes and atomic commit (PyTorch port of
``repro.checkpoint.checkpointer``).

Layout: one directory per step containing
    manifest.json      — tree description, leaf shapes/dtypes/crc32, step, meta
    leaf_<i>.npy       — one file per leaf (logical array, host bytes)

Design points:
  * **Atomic commit**: writes go to ``<dir>.tmp`` and are renamed only
    after the manifest is fsynced — a job killed mid-save never corrupts
    the latest checkpoint; ``restore_latest`` picks the newest *committed*
    step.  Retention (``keep=``) renames a step to ``*.gc.tmp`` before it
    deletes it, so a kill mid-delete leaves only a ``*.tmp`` directory.
  * **Async**: ``save(..., blocking=False)`` hands the work to a writer
    thread so the stream loop is not blocked by the filesystem.  With
    ``sync_copy=True`` (default) the device→host copy happens on the
    calling thread — the caller may mutate its tensors as soon as ``save``
    returns.  ``sync_copy=False`` moves the transfer into the writer
    thread: ``save`` records a CUDA event on the current stream (no host
    synchronise), and the writer makes a side stream wait on that event,
    copies every leaf into a pinned host buffer (kept per leaf and reused
    by the next save of the same shape: at most one save is in flight,
    because ``save`` waits for the previous one first) and waits on an
    event of its own.  The caller then *must* hand over tensors that
    nothing writes until the save finished (the stream checkpointer passes
    clones — see ``repro_torch.checkpoint.stream_state``); the
    checkpointer keeps them alive until the next :meth:`wait`.
  * **Failure transparency**: an exception in the writer thread (disk
    full, injected fault) is captured and re-raised on the next
    ``wait()``/``save()`` — an async save can never silently *not* commit
    while the caller keeps running as if it had.  Stale ``*.tmp`` and
    ``corrupt_step_*`` directories of a previous process are swept on
    ``__init__``.
  * **Checksums**: each leaf's ``crc32`` is taken over the C-contiguous
    bytes of its host array (int32 keys and counts, the ring's dtype), so
    one state fingerprints alike in this package and the JAX package.

Trees are flattened with ``torch.utils._pytree`` (the port's relation
classes are registered nodes that flatten as the reference's pytrees do).
Leaves are logical, unsharded arrays.  ``restore(shardings=)`` (a
``collectives.Placement`` per leaf, as ``ShardPlan.state_shardings`` gives)
returns each rank's part of a split leaf: a run saved on one group restores
onto any other (the mesh-elastic path).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..runtime import faults

log = logging.getLogger("repro_torch.checkpoint")


class ChecksumError(RuntimeError):
    """A leaf file's content does not match its manifest fingerprint —
    the snapshot was corrupted *after* commit (bit rot, torn sector)."""


#: error classes that mean "this snapshot directory is damaged" (as
#: opposed to "the caller passed an incompatible template"): these are
#: the classes :meth:`Checkpointer.restore_latest` and the stream
#: checkpointer quarantine on, so retention (`keep=`) only ever counts
#: restorable snapshots
CORRUPTION_ERRORS = (ChecksumError, OSError, EOFError, ValueError, KeyError)


def crc32(x: np.ndarray) -> int:
    """The manifest fingerprint of one host leaf."""
    return zlib.crc32(np.ascontiguousarray(x).tobytes()) & 0xFFFFFFFF


def _host_copy(x) -> np.ndarray:
    """A host array of ``x`` that shares no memory with it (blocks until
    the device produced ``x``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 verify_checksums: bool = True):
        self.directory = directory
        self.keep = keep
        #: verify per-leaf crc32 fingerprints on restore; manifests without
        #: fingerprints restore as before
        self.verify_checksums = verify_checksums
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: the leaves an async save reads (kept alive until :meth:`wait`)
        self._inflight: list | None = None
        #: per leaf index, the pinned host buffer of the writer's copy
        self._pinned: dict[int, torch.Tensor] = {}
        self._side_stream = None
        #: wall seconds of the last completed ``_write`` (device→host
        #: transfer included when ``sync_copy=False``) and the total
        self.last_write_seconds: float = 0.0
        self.total_write_seconds: float = 0.0
        self.saves_committed: int = 0
        #: per committed save: its step, writer seconds and leaf bytes
        self.writes: list[dict] = []
        #: steps quarantined (renamed ``corrupt_step_*``) this process
        self.quarantined: list[int] = []
        # sweep torn writes of a previous process: a ``*.tmp`` directory
        # is by construction uncommitted (the rename is the commit), and
        # a ``corrupt_step_*`` directory was already diagnosed unreadable
        for name in os.listdir(directory):
            if name.endswith(".tmp") or name.startswith("corrupt_step_"):
                log.warning("sweeping stale checkpoint dir %s", name)
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, tree: Any, step: int, blocking: bool = True,
             meta: dict | None = None, sync_copy: bool = True) -> None:
        """Write ``tree`` as step ``step``.  ``meta`` (JSON-serializable)
        is stored in the manifest and read back via :meth:`read_meta`.
        See the module docstring for the ``blocking`` × ``sync_copy``
        contract; a pending async failure re-raises here first."""
        leaves, spec = pytree.tree_flatten(tree)
        self.save_leaves(leaves, str(spec), step, blocking=blocking,
                         meta=meta, sync_copy=sync_copy)

    def save_leaves(self, leaves: list, treedef: str, step: int,
                    blocking: bool = True, meta: dict | None = None,
                    sync_copy: bool = True) -> None:
        """:meth:`save` of an already flattened tree (``treedef`` is its
        description)."""
        self.wait()  # serialize with (and surface errors of) a prior save
        ready = None
        if sync_copy:
            leaves = [_host_copy(x) for x in leaves]
        else:
            dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)
                        and x.is_cuda), None)
            if dev is not None:
                # the writer's copies wait on this event, not the host
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
        if blocking:
            self._write(leaves, treedef, step, meta, ready)
        else:
            self._inflight = leaves
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(leaves, treedef, step, meta, ready))
            self._thread.start()

    def wait(self) -> None:
        """Join a pending async save; re-raise its failure if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def discard_pending(self) -> None:
        """Join a pending async save and swallow its failure — the
        recovery path's entry point: an interrupted run may have died
        with a save in flight, and recovery restarts from the last
        *committed* step regardless of how that save ended."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._inflight = None
        self._error = None

    def _write_guarded(self, leaves, treedef, step, meta, ready) -> None:
        try:
            self._write(leaves, treedef, step, meta, ready)
        except BaseException as e:  # noqa: BLE001 — surfaced on next wait()
            self._error = e

    def _host_leaves(self, leaves, ready) -> list[np.ndarray]:
        """Host arrays of ``leaves``: CUDA tensors through the pinned
        buffers on a side stream that waits on ``ready`` (no call that
        synchronises the caller's stream), host tensors as they are."""
        out = list(leaves)
        cuda = [i for i, x in enumerate(out)
                if isinstance(x, torch.Tensor) and x.is_cuda]
        if cuda:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(device=out[cuda[0]].device)
            side = self._side_stream
            with torch.cuda.stream(side):
                if ready is not None:
                    side.wait_event(ready)
                for i in cuda:
                    x, buf = out[i], self._pinned.get(i)
                    if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                        buf = self._pinned[i] = torch.empty(
                            x.shape, dtype=x.dtype, pin_memory=True)
                    buf.copy_(x, non_blocking=True)
                    out[i] = buf
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
            for i in set(self._pinned) - set(cuda):
                del self._pinned[i]
        return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in out]

    def _write(self, leaves, treedef: str, step: int,
               meta: dict | None = None, ready=None) -> None:
        t0 = time.perf_counter()
        # device -> host copy (no-op for host arrays): on the writer
        # thread this is where an async save waits on the device work that
        # produced its leaves instead of the caller doing so
        host_leaves = self._host_leaves(leaves, ready)
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": treedef,
            # per-leaf content fingerprint: restore re-hashes each leaf
            # file and refuses a snapshot whose bytes changed after
            # commit — the atomic rename protects against torn writes,
            # the crc32 against silent post-commit corruption
            "leaves": [{"shape": list(x.shape), "dtype": str(x.dtype),
                        "crc32": crc32(x)} for x in host_leaves],
            "meta": meta or {},
        }
        for i, x in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), x)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # a kill between here and the rename must leave the newest
        # *committed* step untouched (the chaos suite injects exactly this)
        faults.crossing("mid_checkpoint_write", step=step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        # bit-flip fault point: the snapshot is durable and GC-visible —
        # a "bitflip" plan corrupts it here, post-commit
        faults.crossing("snapshot_committed", step=step,
                        path=os.path.join(final, "leaf_0.npy"))
        self.last_write_seconds = time.perf_counter() - t0
        self.total_write_seconds += self.last_write_seconds
        self.writes.append(dict(step=step, seconds=self.last_write_seconds,
                                bytes=sum(x.nbytes for x in host_leaves)))
        self.saves_committed += 1
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            d = os.path.join(self.directory, f"step_{s:08d}")
            # renamed first: a process killed while deleting leaves a
            # ``*.tmp`` directory (swept at the next ``__init__``), never a
            # half-deleted step that still looks committed
            try:
                os.rename(d, d + ".gc.tmp")
                d += ".gc.tmp"
            except OSError:
                pass
            shutil.rmtree(d, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def read_manifest(self, step: int) -> dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def read_meta(self, step: int) -> dict:
        return self.read_manifest(step).get("meta", {})

    def restore(self, template: Any, step: int, shardings: Any = None):
        """Restore into the structure of ``template``: each leaf on its
        template leaf's device, in its dtype.  With ``shardings`` (a pytree
        of ``collectives.Placement`` matching the template's leaves) a leaf
        split over a group comes back as this rank's rows of dim 0 (the
        template holds the whole leaf's shape)."""
        manifest = self.read_manifest(step)
        d = os.path.join(self.directory, f"step_{step:08d}")
        t_leaves, spec = pytree.tree_flatten(template)
        places = (pytree.tree_leaves(shardings) if shardings is not None
                  else [None] * len(t_leaves))
        if len(places) != len(t_leaves):
            raise AssertionError(
                f"{len(places)} placements for {len(t_leaves)} leaves")
        # AssertionError, as the reference's asserts, but kept under -O: a
        # caller's template mismatch is skipped, not quarantined
        if manifest["n_leaves"] != len(t_leaves):
            raise AssertionError(
                f"checkpoint has {manifest['n_leaves']} leaves; template has "
                f"{len(t_leaves)} — incompatible structure")
        out = []
        for i, tl in enumerate(t_leaves):
            x = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if self.verify_checksums:
                want = manifest["leaves"][i].get("crc32")
                if want is not None:
                    got = crc32(x)
                    if got != want:
                        raise ChecksumError(
                            f"step {step} leaf_{i}.npy checksum mismatch "
                            f"(manifest {want:#010x} != content {got:#010x})"
                            " — snapshot corrupted after commit")
            if tuple(x.shape) != tuple(tl.shape):
                raise AssertionError((i, x.shape, tl.shape))
            if isinstance(tl, torch.Tensor):
                t = torch.from_numpy(x)
                if places[i] is not None:
                    t = places[i].take(t)
                out.append(t.to(device=tl.device, dtype=tl.dtype))
            else:
                out.append(x)
        return pytree.tree_unflatten(out, spec)

    def quarantine_step(self, step: int) -> None:
        """Take a damaged snapshot out of the restorable set: rename
        ``step_<n>`` to ``corrupt_step_<n>`` so :meth:`all_steps` no
        longer lists it — and therefore :meth:`_gc`'s ``keep=`` retention
        only counts *restorable* snapshots.  Falls back to deletion if the
        rename fails."""
        src = os.path.join(self.directory, f"step_{step:08d}")
        dst = os.path.join(self.directory, f"corrupt_step_{step:08d}")
        try:
            if os.path.exists(dst):
                shutil.rmtree(dst)
            os.rename(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        self.quarantined.append(step)
        log.warning("quarantined unrestorable checkpoint step %d", step)

    def restore_latest(self, template: Any, shardings: Any = None):
        """Restore the newest *readable* committed step.

        A truncated manifest, a missing/corrupt leaf file, or a checksum
        mismatch quarantines the damaged step and falls back to the
        previous committed step instead of raising mid-recovery; returns
        None when no step is restorable."""
        for step in reversed(self.all_steps()):
            try:
                return self.restore(template, step, shardings), step
            except CORRUPTION_ERRORS as e:
                log.warning("checkpoint step %d unreadable (%r); "
                            "falling back to the previous committed step",
                            step, e)
                self.quarantine_step(step)
            except Exception as e:  # noqa: BLE001 — fall back to older step
                # e.g. a template/structure mismatch: the snapshot itself
                # may be fine for another caller — skip, don't quarantine
                log.warning("checkpoint step %d not restorable into this "
                            "template (%r); falling back", step, e)
        return None
