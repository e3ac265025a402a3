"""Architecture configurations (copies of ``repro.configs``)."""
