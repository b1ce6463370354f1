"""Atomic per-leaf checkpoints (``checkpoint``), in the reference's format."""
