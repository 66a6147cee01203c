"""Checkpoint-polling evaluation."""
