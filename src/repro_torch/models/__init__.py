"""The language-model stack for decoding: layers and dense-family init."""
from . import layers, model  # noqa: F401
