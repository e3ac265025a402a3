"""Runnable examples of the port (``python -m repro_torch.examples.<name>``)."""
