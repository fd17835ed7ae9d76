"""Optimizers for the language model's training step."""
from . import adam  # noqa: F401
