"""Checkpoints of the training state (`checkpoint.manager`)."""
