"""Model inputs for a train or prefill step and the test mesh (the dry-run
and the production meshes are not ported)."""
from . import inputs, mesh  # noqa: F401
