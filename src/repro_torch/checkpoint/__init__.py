"""Checkpoints: msgpack-serialized trees in the reference's format, so a
file written by either package loads in the other."""

from .io import (
    load_checkpoint,
    save_checkpoint,
    save_silo_checkpoint,
    tree_from_bytes,
    tree_to_bytes,
)

__all__ = ["load_checkpoint", "save_checkpoint", "save_silo_checkpoint", "tree_from_bytes",
           "tree_to_bytes"]
