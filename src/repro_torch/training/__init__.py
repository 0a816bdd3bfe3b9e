"""Training: AdamW (``optimizer``) and checkpoints in the format shared
with ``repro.training.checkpoint`` (``checkpoint``)."""
