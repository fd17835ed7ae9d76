"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their plain
PyTorch versions.

`ops` is the dispatching public API (a CUDA tensor launches the kernel, a
CPU tensor runs the plain version in `ref`); `_build` compiles and loads the
kernels on first use.
"""
from . import ops, ref  # noqa: F401
