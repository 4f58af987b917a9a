"""npz checkpointing for parameter and optimizer trees."""
from .ckpt import load_pytree, restore, save, save_pytree

__all__ = ["load_pytree", "restore", "save", "save_pytree"]
