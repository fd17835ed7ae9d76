"""Optimizers for the language model's training step."""
from . import adam, compress  # noqa: F401
