"""Core paper algorithms on PyTorch tensors: LSH, EH, RACE, SW-AKDE, S-ANN,
the JL baseline and the threefry keys of the sampling schedule."""
from . import eh, jl, lsh, prng, race, sann, swakde, theory, util  # noqa: F401
