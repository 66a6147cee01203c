"""Graceful shutdown."""
