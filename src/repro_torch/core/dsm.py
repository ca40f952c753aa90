"""Distributed shared memory (DSM) — STEP §4.1/§5.1 over tensors on one card.

:class:`GlobalStore` is the Table-1 store API (``def_global`` /
``new_array`` / ``new_object`` / ``get`` / ``set`` / ``mget`` / ``inc`` /
``delete``) routed through the consistent-hash ring of
:class:`~repro_torch.core.shards.ShardedStore`.  Where the JAX package keeps
named, sharded ``jax.Array``s across a mesh, the port keeps named tensors on
the store's device.

:func:`load_numpy_state` is the carry-across function: it seeds a port store
from values read out of a JAX store (``np.asarray(store.get(name))``), so a
test can start both packages from the same shared state.

Coarse-grained packing (§5.1) fuses a tree's leaves into one flat buffer of
package-aligned segments (:func:`pack_spec`, :func:`pack_tree`,
:func:`unpack_tree`), so a collective over the packed buffer moves one
large block instead of one transfer per leaf.  The package stays
``repro``'s 128 elements: a tree's offsets, sizes and ``total`` are the
JAX package's, and so are the packed bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.addressing import TPU_PACKAGE_ELEMS, align_up
from repro_torch.core.shards import (  # noqa: F401  (re-exported, public surface)
    GlobalEntry,
    HashRing,
    OwnerHandle,
    Shard,
    ShardedStore,
    _nbytes,
)
from repro_torch.utils.tree import tree_leaves, tree_unflatten


class GlobalStore(ShardedStore):
    """The DSM: a named global address space of tensors on one device.

    ``shards=1`` (the default) is the paper's single-store setup;
    ``shards=S`` partitions the namespace so operations on names owned by
    different shards never contend on a common lock.
    """


def load_numpy_state(store: ShardedStore, state: Dict[str, np.ndarray]) -> None:
    """Declare (or overwrite) each ``name -> ndarray`` of ``state`` in
    ``store``, in the given order.  A dict value becomes a shared object."""
    names = set(store.names())
    for name, value in state.items():
        if name in names:
            store.set(name, value)
        elif isinstance(value, dict):
            store.new_object(name, value)
        else:
            store.def_global(name, value)


# ---------------------------------------------------------------------------
# Coarse-grained packing: fuse a tree into package-aligned flat buffers.
# ---------------------------------------------------------------------------

_LEAF = object()     # a leaf's place in a PackSpec's structure


@dataclass
class PackSpec:
    """Metadata to unpack a fused buffer back into the original tree.

    ``treedef`` is the tree's structure with a placeholder at each leaf (no
    tensor of the packed tree is kept alive by it)."""

    treedef: Any
    shapes: list
    dtypes: list
    offsets: list  # start offset of each leaf in the packed buffer (elements)
    sizes: list    # padded size of each leaf (elements)
    total: int

    @property
    def padding_waste(self) -> int:
        return self.total - sum(math.prod(s) for s in self.shapes)


def pack_spec(tree, *, package: int = TPU_PACKAGE_ELEMS) -> PackSpec:
    """The packing of ``tree``: each leaf starts on a multiple of
    ``package`` elements (an empty leaf still takes one package)."""
    leaves = tree_leaves(tree)
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        shapes.append(tuple(leaf.shape))
        dtypes.append(leaf.dtype)
        size = align_up(max(1, leaf.numel()), package)
        offsets.append(off)
        sizes.append(size)
        off += size
    return PackSpec(tree_unflatten(tree, [_LEAF] * len(leaves)), shapes, dtypes,
                    offsets, sizes, off)


def pack_tree(tree, spec: PackSpec, *, dtype=torch.float32) -> torch.Tensor:
    """Fuse all leaves into one package-aligned flat buffer (coarse DSM) of
    ``dtype``, zeros in the padding, on the first leaf's device.  The
    leaves are copied into one buffer allocated once (the JAX package
    concatenates padded copies: the same bytes)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((0,), dtype=dtype)
    out = torch.empty((spec.total,), dtype=dtype, device=leaves[0].device)
    for leaf, off, size in zip(leaves, spec.offsets, spec.sizes):
        n = leaf.numel()
        out[off:off + n].copy_(leaf.reshape(-1))
        out[off + n:off + size].zero_()
    return out


def unpack_tree(buf: torch.Tensor, spec: PackSpec):
    """Inverse of :func:`pack_tree`: each leaf a view of ``buf`` where its
    dtype is ``buf``'s, a cast copy where not."""
    leaves = [buf[off:off + math.prod(shape)].to(dt).reshape(shape)
              for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.offsets)]
    return tree_unflatten(spec.treedef, leaves)
