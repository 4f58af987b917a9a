"""Model parameters for the port: the paper's CNN."""
from . import cnn

__all__ = ["cnn"]
