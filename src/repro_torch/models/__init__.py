"""The LM scaffold's serving and training paths (port of ``repro.models``):
the decoder-only LMs, attention (GQA or MLA, dense or MoE), SSM (mLSTM and
sLSTM) and hybrid (Mamba with GQA), and the encoder-decoder (seamless-m4t,
its audio front-end a stub)."""
