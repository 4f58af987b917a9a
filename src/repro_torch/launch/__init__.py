"""Launch layer: step builders and the training driver (`train`)."""
from . import steps

__all__ = ["steps"]
