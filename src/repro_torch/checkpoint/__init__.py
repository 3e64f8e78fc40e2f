"""Round checkpoints of the port — counterpart of ``repro/checkpoint``."""

from .store import CheckpointStore, load_pytree, save_pytree

__all__ = ["CheckpointStore", "save_pytree", "load_pytree"]
