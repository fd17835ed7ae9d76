"""Core paper algorithms on PyTorch tensors: LSH, EH, RACE, SW-AKDE, S-ANN."""
from . import eh, lsh, race, sann, swakde, theory, util  # noqa: F401
