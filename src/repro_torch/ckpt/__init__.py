"""Atomic, optionally asynchronous checkpoints (``manager``)."""
