"""Graceful shutdown, and the NaN sentinel's rollback policy."""
