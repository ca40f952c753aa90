"""STEP core on PyTorch: DSM, cache, sync, threads, accumulator, Session."""

from repro_torch.core import telemetry
from repro_torch.core.accumulator import (
    AccumMode, DAddAccumulator, accumulate, accumulate_scatter, accumulate_tree)
from repro_torch.core.addressing import AddressAllocator, make_address, ring_hash, split_address, watcher_node
from repro_torch.core.cache import CacheStats, DSMCache
from repro_torch.core.compat import Mesh, PartitionSpec, axis_index, axis_size, make_mesh, shard_map
from repro_torch.core.dsm import (
    GlobalStore, PackSpec, load_numpy_state, pack_spec, pack_tree, unpack_tree)
from repro_torch.core.session import (
    Backend, HostBackend, HostWorkerCtx, Session, SharedRef, SpmdBackend, SpmdWorkerCtx, WorkerCtx)
from repro_torch.core.shards import (
    GlobalEntry, HashRing, MigrationWindow, OwnerHandle, Shard, ShardedStore, ShardMigration)
from repro_torch.core.sparse import (
    SparsePairs,
    block_layout,
    blocked_topk_accumulate,
    blocked_topk_sparsify,
    default_auto_k,
    densify,
    pair_capacity,
    sparse_beneficial,
    sparse_beneficial_batch,
    topk_sparsify,
)
from repro_torch.core.sync import DBarrier, DSemaphore, SSPClock
from repro_torch.core.telemetry import NULL_TRACER, Tracer, as_tracer
from repro_torch.core.tiers import ColdTier, DiskTier, HostMemTier
from repro_torch.core.threads import DThread, DThreadPool, ThreadState, spmd_threads

__all__ = [
    "AccumMode", "AddressAllocator", "Backend", "CacheStats", "ColdTier",
    "DAddAccumulator", "DBarrier", "DSMCache", "DSemaphore", "DThread", "DThreadPool",
    "DiskTier", "GlobalEntry", "GlobalStore", "HashRing", "HostBackend", "HostMemTier",
    "HostWorkerCtx", "Mesh", "MigrationWindow", "NULL_TRACER", "OwnerHandle",
    "PackSpec", "PartitionSpec", "SSPClock", "Session", "Shard", "ShardMigration",
    "ShardedStore", "SharedRef", "SparsePairs", "SpmdBackend", "SpmdWorkerCtx",
    "ThreadState", "Tracer", "WorkerCtx", "accumulate", "accumulate_scatter",
    "accumulate_tree", "as_tracer", "axis_index", "axis_size", "block_layout",
    "blocked_topk_accumulate", "blocked_topk_sparsify", "default_auto_k", "densify",
    "load_numpy_state", "make_address", "make_mesh", "pack_spec", "pack_tree",
    "pair_capacity", "ring_hash", "shard_map", "sparse_beneficial",
    "sparse_beneficial_batch", "split_address", "spmd_threads", "telemetry",
    "topk_sparsify", "unpack_tree", "watcher_node",
]
