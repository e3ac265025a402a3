"""Device selection for the port's public entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A host
without CUDA raises unless the caller asked for the CPU: the port never
moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU")
    return dev
