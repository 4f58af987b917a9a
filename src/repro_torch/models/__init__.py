"""Model parameters and the LM serving path for the port: the paper's
CNN, and the dense decoder (config, layers, attention, transformer)."""
from . import attention, cnn, config, layers, transformer

__all__ = ["attention", "cnn", "config", "layers", "transformer"]
