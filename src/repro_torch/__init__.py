"""PyTorch/CUDA port of the sublinear ANN and KDE sketches.

Mirrors the module tree of the JAX package ``repro`` (the reference, which
this package never imports): ``core`` holds the sketch state machines,
``kernels`` the hand-written CUDA kernels for Hopper with their plain
PyTorch versions, ``serve`` the streaming sketch services (on
``persist``'s WAL and snapshots over ``checkpoint``, and the single-device
``parallel.sketch_sharding`` contexts) and, with ``configs`` and
``models``, the sketch-gated language-model decode; ``data``, ``optim``
and ``train`` train the language model on a token stream watched by an
SW-AKDE drift monitor; ``net`` runs the
merge cluster's workers as processes behind the reference's RPC wire
format; ``convert`` carries
parameters and states between the two packages as numpy arrays.

Device rule: entry points that allocate default to ``device="cuda"`` and
raise when no card is present; callers pass ``device="cpu"`` explicitly to
run the plain PyTorch versions of the kernels.
"""
from . import (checkpoint, configs, convert, core, data,  # noqa: F401
               kernels, models, net, optim, parallel, persist, serve, train)
