"""Sketch sharding contexts (single device; the mesh bodies are not ported
yet)."""
from . import sketch_sharding  # noqa: F401
