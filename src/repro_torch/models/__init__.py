"""The language-model stack: layers, flash attention, init and forward of
every family."""
from . import flash, layers, model  # noqa: F401
