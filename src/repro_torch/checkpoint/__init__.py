"""Crash-resumable state: ``ckpt`` writes and restores a tree of tensors,
``manager`` keeps numbered checkpoints with async writes and retention."""
