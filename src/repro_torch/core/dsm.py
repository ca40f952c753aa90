"""Distributed shared memory (DSM) — STEP §4.1/§5.1 over tensors on one card.

:class:`GlobalStore` is the Table-1 store API (``def_global`` /
``new_array`` / ``new_object`` / ``get`` / ``set`` / ``mget`` / ``inc`` /
``delete``) routed through the consistent-hash ring of
:class:`~repro_torch.core.shards.ShardedStore`.  Where the JAX package keeps
named, sharded ``jax.Array``s across a mesh, the port keeps named tensors on
the store's device.

:func:`load_numpy_state` is the carry-across function: it seeds a port store
from values read out of a JAX store (``np.asarray(store.get(name))``), so a
test can start both packages from the same shared state.  The coarse-DSM
packing helpers (``pack_tree`` / ``unpack_tree``) wait for the optim slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.shards import (  # noqa: F401  (re-exported, public surface)
    GlobalEntry,
    HashRing,
    OwnerHandle,
    Shard,
    ShardedStore,
    _nbytes,
)


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
