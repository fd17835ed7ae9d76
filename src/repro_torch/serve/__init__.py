"""Serving: the streaming sketch services on the shared engine (`engine`,
`retrieval`, `kde_service`, `race_service`) and the batched single-token
LM decode with the sketch-gated KV cache (`kv_cache`, `serve_step`)."""
from . import (engine, kde_service, kv_cache, race_service,  # noqa: F401
               retrieval, serve_step)
