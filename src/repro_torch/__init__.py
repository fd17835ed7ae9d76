"""PyTorch/CUDA port of the sublinear ANN and KDE sketches.

Mirrors the module tree of the JAX package ``repro`` (the reference, which
this package never imports): ``core`` holds the sketch state machines,
``kernels`` the hand-written CUDA kernels for Hopper with their plain
PyTorch versions, ``configs``, ``models`` and ``serve`` the sketch-gated
language-model decode, and ``convert`` carries parameters and states
between the two packages as numpy arrays.

Device rule: entry points that allocate default to ``device="cuda"`` and
raise when no card is present; callers pass ``device="cpu"`` explicitly to
run the plain PyTorch versions of the kernels.
"""
from . import configs, convert, core, kernels, models, serve  # noqa: F401
