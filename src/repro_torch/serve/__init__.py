"""Snapshot-consistent serving plane over the maintained view hierarchy
(PyTorch port of ``repro.serve``).

Batched point / range / top-k lookups against version-stamped view
snapshots published at segment boundaries by the stream executor,
concurrent with segment execution.

    from repro_torch.serve import ViewServer

    server = ViewServer(executor, views=("Q",))
    executor.run(stream)               # publishes a generation a boundary
    res = server.point("Q", keys)      # device-resident, newest generation
    with server.pin() as snap:         # multi-query consistency
        a = snap.point("Q", keys)
        b = snap.top_k("Q", 10)
    print(res.host(), server.stats())
"""
from .lookup import point, range_scan, range_sum, top_k
from .registry import Snapshot, SnapshotRegistry
from .server import PinnedGeneration, ReadResult, ViewServer

__all__ = [
    "PinnedGeneration",
    "ReadResult",
    "Snapshot",
    "SnapshotRegistry",
    "ViewServer",
    "point",
    "range_scan",
    "range_sum",
    "top_k",
]
