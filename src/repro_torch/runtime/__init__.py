"""Training runtime: atomic, resumable checkpoints (``checkpoint``) and
the restart-oriented training loop (``train_loop``)."""
