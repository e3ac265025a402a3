"""Checkpointing (PyTorch port of ``repro.checkpoint``): the atomic,
checksummed, async :class:`Checkpointer` and the stream executor's
segment-boundary snapshots (:class:`StreamCheckpointer`)."""
from .checkpointer import CORRUPTION_ERRORS, Checkpointer, ChecksumError
from .stream_state import StreamCheckpointer

__all__ = ["CORRUPTION_ERRORS", "Checkpointer", "ChecksumError",
           "StreamCheckpointer"]
