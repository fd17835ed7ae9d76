"""The language-model stack: layers, flash attention, dense-family init and
forward."""
from . import flash, layers, model  # noqa: F401
