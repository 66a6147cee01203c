"""Eval-time preprocessing."""
