"""The LM scaffold's serving and training paths (port of ``repro.models``):
the GQA decoders, dense and MoE."""
