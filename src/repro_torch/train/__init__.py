"""The language model's training step and its resumable trainer."""
from . import train_step, trainer  # noqa: F401
