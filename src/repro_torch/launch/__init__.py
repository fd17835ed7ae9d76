"""Model inputs for a train or prefill step (the dry-run is not ported)."""
from . import inputs  # noqa: F401
