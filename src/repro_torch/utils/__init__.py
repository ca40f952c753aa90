"""Tree utilities shared across the port (see :mod:`repro_torch.utils.tree`)
and the collective-traffic stats (:mod:`repro_torch.utils.hlo`)."""

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
from repro_torch.utils.hlo import CollectiveStats, collective_bytes_from_hlo

__all__ = [
    "path_str", "tree_bytes", "tree_count", "tree_flatten_with_paths",
    "tree_leaves", "tree_map", "tree_unflatten", "tree_zeros_like",
    "collective_bytes_from_hlo", "CollectiveStats",
]
