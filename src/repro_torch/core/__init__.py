"""STEP core on PyTorch: DSM, cache, sync, threads, accumulator, Session."""

from repro_torch.core import telemetry
from repro_torch.core.accumulator import AccumMode, DAddAccumulator
from repro_torch.core.addressing import AddressAllocator, make_address, ring_hash, split_address, watcher_node
from repro_torch.core.cache import CacheStats, DSMCache
from repro_torch.core.dsm import GlobalStore, load_numpy_state
from repro_torch.core.session import HostBackend, HostWorkerCtx, Session, SharedRef, WorkerCtx
from repro_torch.core.shards import GlobalEntry, HashRing, OwnerHandle, Shard, ShardedStore
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
from repro_torch.core.threads import DThread, DThreadPool, ThreadState

__all__ = [
    "AccumMode", "AddressAllocator", "CacheStats", "DAddAccumulator", "DBarrier",
    "DSMCache", "DSemaphore", "DThread", "DThreadPool", "GlobalEntry", "GlobalStore",
    "HashRing", "HostBackend", "HostWorkerCtx", "NULL_TRACER", "OwnerHandle",
    "SSPClock", "Session", "Shard", "ShardedStore", "SharedRef", "SparsePairs",
    "ThreadState", "Tracer", "WorkerCtx", "as_tracer", "block_layout",
    "blocked_topk_accumulate", "blocked_topk_sparsify", "default_auto_k", "densify",
    "load_numpy_state", "make_address", "pair_capacity", "ring_hash",
    "sparse_beneficial", "sparse_beneficial_batch", "split_address", "telemetry",
    "topk_sparsify",
    "watcher_node",
]
