"""Launch layer: step builders (serving steps so far)."""
from . import steps

__all__ = ["steps"]
