"""Checkpoints (the training loop is a later slice)."""
