"""Tree utilities shared across the port (see :mod:`repro_torch.utils.tree`)."""

from repro_torch.utils.tree import (
    path_str,
    tree_bytes,
    tree_count,
    tree_flatten_with_paths,
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_zeros_like,
)

__all__ = [
    "path_str", "tree_bytes", "tree_count", "tree_flatten_with_paths",
    "tree_leaves", "tree_map", "tree_unflatten", "tree_zeros_like",
]
