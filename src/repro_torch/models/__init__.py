"""The LM scaffold's serving path (port of ``repro.models``): dense GQA only."""
