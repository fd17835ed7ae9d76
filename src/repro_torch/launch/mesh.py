"""Test mesh construction: the port of the reference's ``launch/mesh.py``.

A function, not a module-level constant: importing this module touches no
device.  The production meshes (16 x 16, 2 x 16 x 16) come with the
dry run.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import Mesh


def make_test_mesh(n_data: int = 2, n_model: int = 2, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh of ``n_data * n_model`` ranks: ``"cuda"``
    (no index) takes the first cards and raises when fewer are visible; a
    card with an index (``"cuda:0"``) or ``"cpu"`` is repeated for every
    rank."""
    n = n_data * n_model
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise ValueError(
                f"a {n_data} x {n_model} mesh needs {n} cards, {visible} "
                "visible (repeat one with device='cuda:0')")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devices = (device,) * n
    return Mesh(devices, axis_names=("data", "model"),
                axis_sizes=(n_data, n_model))
