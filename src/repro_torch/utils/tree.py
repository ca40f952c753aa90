"""Tree utilities of the port: the counterpart of :mod:`repro.utils.tree`.

A tree is a nest of dicts, lists and tuples (a namedtuple by field name)
with tensors, arrays or scalars at its leaves; ``None`` is an empty subtree.
The order and the paths follow JAX's flattening, so that a checkpoint written
by either package numbers its leaves the same and names them alike: a dict's
keys in **sorted** order (``torch.utils._pytree`` keeps insertion order
instead), a sequence's items by index, and each path a dotted string such as
``params.layers.0.wq``.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch


def _children(node) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs of an inner node, in JAX's order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return [(str(i), child) for i, child in enumerate(node)]


def _is_inner(node) -> bool:
    return node is None or isinstance(node, (dict, list, tuple))


def path_str(path) -> str:
    """Render a tree path (a sequence of keys) as a dotted string."""
    return ".".join(str(p) for p in path)


def _walk(node, path: tuple, out: list) -> None:
    if node is None:
        return
    if not _is_inner(node):
        out.append((path_str(path), node))
        return
    for key, child in _children(node):
        _walk(child, path + (key,), out)


def tree_flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """Return ``[(path_str, leaf), ...]`` in JAX's deterministic order.

    The walks here are module-level functions, not nested ones: a nested
    recursive function is a reference cycle, which would hold the leaves it
    saw until the cyclic collector runs — a whole gradient tree a call, in
    a train step."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), out)
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


_END = object()


def _build(node, it):
    if node is None:
        return None
    if not _is_inner(node):
        return next(it)
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}        # the template's key order
    items = [_build(child, it) for _, child in _children(node)]
    return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in flattening
    order, by ``leaves``."""
    it = iter(leaves)
    out = _build(template, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure), in ``tree``'s structure — as
    ``jax.tree.map`` does."""
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError(f"tree_map: trees of {len(leaves)} and "
                         f"{[len(o) for o in others]} leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def _leaf_size(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    return int(getattr(x, "size", 1))


def _leaf_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if hasattr(x, "size") and hasattr(x, "dtype"):
        return int(x.size) * x.dtype.itemsize
    return 0


def tree_count(tree: Any) -> int:
    """Total number of scalar elements across all leaves (param count)."""
    return sum(_leaf_size(leaf) for leaf in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves."""
    return sum(_leaf_bytes(leaf) for leaf in tree_leaves(tree))


def tree_zeros_like(tree: Any) -> Any:
    return tree_unflatten(tree, [torch.zeros_like(leaf) for leaf in tree_leaves(tree)])
