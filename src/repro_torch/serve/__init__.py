"""Batched single-token decode with the sketch-gated KV cache."""
from . import kv_cache, serve_step  # noqa: F401
