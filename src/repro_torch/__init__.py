"""F-IVM in PyTorch for one NVIDIA H100 (port of the JAX package ``repro``).

The port mirrors the reference's module names (``repro_torch.core.plan`` is
the counterpart of ``repro.core.plan``) and never imports JAX or ``repro``.
Every public entry point takes ``device=`` (default ``"cuda"``) and raises
on a host without CUDA unless the caller passes ``device="cpu"``.
"""
