"""Sketch sharding: meshes of devices (`sharding`) and the sharded sketch
bodies (`sketch_sharding`)."""
from . import sharding, sketch_sharding  # noqa: F401
