"""Model configurations (a copy of the reference's schema) and the registry
of the architectures the port runs."""
from . import base, registry  # noqa: F401
