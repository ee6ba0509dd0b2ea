"""Training runtime: atomic, resumable checkpoints (``checkpoint``), the
restart-oriented training loop (``train_loop``) and the mesh transition
description the elastic serving session records (``elastic``)."""
