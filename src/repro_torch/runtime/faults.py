"""Deterministic fault injection for chaos-testing the durable stream path
(PyTorch port of ``repro.runtime.faults``; host-only, it never touches a
device).

The executor (and the checkpointer's writer) call ``faults.crossing(point)``
at named execution points; when no plan is installed this is a dict lookup
and return — cheap enough to leave in production code paths.  A test
installs a :class:`FaultPlan` to kill execution at exactly the N-th
crossing of a point, either by raising :class:`InjectedFault` (in-process
recovery tests) or by ``SIGKILL``-ing the process (subprocess chaos tests:
no ``atexit``, no ``finally`` — the same torn state a preempted worker or
an OOM kill leaves behind).

Injection points wired into the stream executor / checkpointer:

====================================  =========================================
point                                 fires
====================================  =========================================
``mid_segment``                       after a segment's dispatch, before its
                                      boundary checkpoint commits
``mid_admit``                         at the top of segment admission, before
                                      any rehash/prepare work
``post_rehash_pre_recompile``         after sparse tables were rehashed to the
                                      segment's grown capacities but before
                                      the new plans compile — the engine's
                                      storage signature has already changed
``mid_checkpoint_write``              inside ``Checkpointer._write`` after the
                                      tmp dir is fully written but before the
                                      atomic rename (commit)
``snapshot_committed``                inside ``Checkpointer._write`` right
                                      after the atomic rename — the snapshot
                                      is durable; ``mode="bitflip"`` corrupts
                                      it in place (silent media corruption)
====================================  =========================================

Determinism: ``FaultPlan(point, at=k)`` fires on the k-th crossing
(0-based) of ``point`` and only once — after firing, the plan is spent and
execution (on the resumed process) runs clean.  Crossing counters survive
the fire so tests can assert how far execution got.

Besides ``raise``/``kill9`` there is a third mode, ``bitflip``: instead of
stopping execution it flips one bit of the file named by the crossing's
``path`` context and lets execution continue — modelling silent storage
corruption (a torn sector, a cosmic-ray bit) that only snapshot
checksums (DESIGN.md §11) can catch.
"""
from __future__ import annotations

import os
import signal
from contextlib import contextmanager
from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """Raised by an in-process fault crossing; never raised organically."""


#: the valid ``FaultPlan.point`` values — kept in one place so a typo'd
#: point name fails fast at install time instead of silently never firing
POINTS = (
    "mid_segment",
    "mid_admit",
    "post_rehash_pre_recompile",
    "mid_checkpoint_write",
    "snapshot_committed",
)


@dataclass
class FaultPlan:
    point: str          # one of POINTS
    at: int = 0         # fire on the at-th crossing of `point` (0-based)
    mode: str = "raise"  # "raise" | "kill9" | "bitflip" (corrupt & continue)

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"expected one of {POINTS}")
        if self.mode not in ("raise", "kill9", "bitflip"):
            raise ValueError(f"unknown fault mode {self.mode!r}")


def _flip_bit(path: str) -> None:
    """Flip the top bit of the last byte of ``path`` in place."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        f.seek(size - 1)
        byte = f.read(1)[0]
        f.seek(size - 1)
        f.write(bytes([byte ^ 0x80]))


@dataclass
class FaultInjector:
    plan: FaultPlan | None = None
    counts: dict = field(default_factory=dict)   # point -> crossings seen
    fired: list = field(default_factory=list)    # (point, index, ctx) log

    def crossing(self, point: str, **ctx) -> None:
        n = self.counts.get(point, 0)
        self.counts[point] = n + 1
        plan = self.plan
        if plan is None or plan.point != point or plan.at != n:
            return
        self.plan = None  # spent: the resumed/retried path runs clean
        self.fired.append((point, n, ctx))
        if plan.mode == "kill9":
            os.kill(os.getpid(), signal.SIGKILL)
        if plan.mode == "bitflip":
            # silent corruption: damage the crossing's file and let
            # execution continue — only checksum verification can tell
            _flip_bit(ctx["path"])
            return
        raise InjectedFault(f"injected fault at {point}[{n}] ({ctx})")


_active = FaultInjector()


def injector() -> FaultInjector:
    return _active


def install(plan: FaultPlan | None) -> FaultInjector:
    """Arm ``plan`` (or disarm with None) and reset counters/fired log."""
    global _active
    _active = FaultInjector(plan=plan)
    return _active


def clear() -> None:
    install(None)


@contextmanager
def inject(point: str, at: int = 0, mode: str = "raise"):
    """``with faults.inject("mid_segment", at=1): ...`` — arms a plan for
    the body and always disarms on exit, yielding the injector for
    post-mortem assertions on ``counts``/``fired``."""
    inj = install(FaultPlan(point=point, at=at, mode=mode))
    try:
        yield inj
    finally:
        clear()


def crossing(point: str, **ctx) -> None:
    """The production-side hook: no-op unless a plan is armed on this
    exact point/index."""
    _active.crossing(point, **ctx)
