"""Atomic, async checkpoints of tensor trees in the reference's npz +
manifest layout (`checkpoint.checkpoint`)."""
from . import checkpoint  # noqa: F401
