"""Meshes of devices, sharded leaves and collectives (`sharding`), the
LM's parameter specs (`param_specs`) and the sharded sketch bodies
(`sketch_sharding`)."""
from . import param_specs, sharding, sketch_sharding  # noqa: F401
