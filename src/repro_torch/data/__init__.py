"""The training data stream and its SW-AKDE drift monitor."""
from . import pipeline  # noqa: F401
