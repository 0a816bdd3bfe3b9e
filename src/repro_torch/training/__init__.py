"""Checkpoint format shared with ``repro.training.checkpoint``."""
