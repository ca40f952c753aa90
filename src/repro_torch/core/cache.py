"""DSM cache layer — STEP §5.1's directory-based write-invalidate cache.

The paper's cache absorbs DSM reads on a hit and invalidates remote copies on
writes through per-block *watcher node* directories.  Each logical node
keeps a bounded LRU of *replicas* keyed by DSM name, validated by the store's
per-entry epoch; a write bumps the epoch (write-through) and the directory
records which nodes must invalidate.  Hit/miss/invalidate counters make the
paper's throughput argument measurable in tests and benchmarks.

The directory is **shard-local**: the watcher for a name is the
consistent-hash shard that owns it, the directory record lives on that
:class:`~repro_torch.core.shards.Shard` and is guarded by *its* lock — so
coherence traffic for names on different shards never serialises on a common
lock.  Node replica LRUs are guarded by small per-node locks; lock order is
strictly shard → node, and eviction cleanup for a name owned by a
*different* shard happens after the held shard lock is released.

A replica is the stored tensor itself: a hit hands the same tensor to every
thread of the node, so no reader may write into a value it read.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.shards import ShardedStore


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    write_messages: int = 0   # "write" messages to watcher nodes
    missing_messages: int = 0  # "missing" messages to watcher nodes
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        """Canonical plain-dict view (the ``cache`` rows of
        ``Session.metrics()``); key set pinned by
        :data:`repro.core.telemetry.CACHE_METRIC_KEYS`."""
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "write_messages": self.write_messages,
                "missing_messages": self.missing_messages,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


class _NodeCache:
    """One node's bounded LRU of (name -> (epoch, value)) replicas.

    Carries its own lock: with a sharded store, threads working on different
    shards may race into the same node's LRU (the replica set is per *node*,
    not per shard)."""

    def __init__(self, node_id: int, capacity: int):
        self.id = node_id
        self.capacity = capacity
        self.blocks: OrderedDict[str, tuple[int, object]] = OrderedDict()
        self._lock = threading.Lock()
        # step.check target: DSMCache propagates the session's checker here
        # so node-lock acquisitions land in the lock-order sanitizer
        self.checker = stepcheck.NULL_CHECKER

    def get(self, name: str):
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_acquired(("node", self.id))
            try:
                return self._get(name)
            finally:
                ck.lock_released(("node", self.id))
        return self._get(name)

    def _get(self, name: str):
        with self._lock:
            if name in self.blocks:
                self.blocks.move_to_end(name)
                return self.blocks[name]
            return None

    def put(self, name: str, epoch: int, value) -> Optional[str]:
        """Insert a replica; returns the evicted name (LRU) or None.  The
        caller must drop the evicted name from the watcher directory, or the
        node stays listed as a holder forever."""
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_acquired(("node", self.id))
            try:
                return self._put(name, epoch, value)
            finally:
                ck.lock_released(("node", self.id))
        return self._put(name, epoch, value)

    def _put(self, name: str, epoch: int, value) -> Optional[str]:
        with self._lock:
            evicted = None
            if name not in self.blocks and len(self.blocks) >= self.capacity:
                evicted, _ = self.blocks.popitem(last=False)  # LRU eviction
            self.blocks[name] = (epoch, value)
            self.blocks.move_to_end(name)
            return evicted

    def invalidate(self, name: str) -> bool:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_acquired(("node", self.id))
            try:
                return self._invalidate(name)
            finally:
                ck.lock_released(("node", self.id))
        return self._invalidate(name)

    def _invalidate(self, name: str) -> bool:
        with self._lock:
            return self.blocks.pop(name, None) is not None

    def contains(self, name: str) -> bool:
        """Membership without touching LRU order (eviction-cleanup guard)."""
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_acquired(("node", self.id))
            try:
                return self._contains(name)
            finally:
                ck.lock_released(("node", self.id))
        return self._contains(name)

    def _contains(self, name: str) -> bool:
        with self._lock:
            return name in self.blocks


class DSMCache:
    """Directory-based write-invalidate cache over a sharded store.

    ``n_nodes`` logical nodes each hold ``capacity`` replicas (paper: 1024
    blocks/node).  The watcher for a name is its owning shard; the directory
    record lives on that shard, under that shard's lock.  Constructing the
    cache registers a store-side delete hook, so even a *direct*
    ``store.delete(name)`` (bypassing ``Session.delete``) tears down every
    replica and directory holder of the name.
    """

    def __init__(self, store: ShardedStore, n_nodes: int, capacity: int = 1024):
        self.store = store
        self.n_nodes = n_nodes
        self.caches = [_NodeCache(i, capacity) for i in range(n_nodes)]
        self._checker = stepcheck.NULL_CHECKER
        # per-shard coherence counters, aggregated by the `stats` property
        self._stats: Dict[int, CacheStats] = {}
        # weak: the store outlives sessions rolled over it (FT recovery);
        # this cache's teardown hook must die with the cache, not pin it
        store.add_delete_hook(self.drop, weak=True)
        # step.trace target (Session attaches its tracer); coherence events
        # are counters, not spans — timing lives on the store ops beneath
        self.tracer = telemetry.NULL_TRACER

    @property
    def checker(self):
        return self._checker

    @checker.setter
    def checker(self, ck) -> None:
        """Session attaches its checker here; node LRUs share it so their
        lock acquisitions land in the lock-order sanitizer."""
        self._checker = ck
        for c in self.caches:
            c.checker = ck

    def _shard_stats(self, shard_id: int) -> CacheStats:
        return self._stats.setdefault(shard_id, CacheStats())

    @property
    def stats(self) -> CacheStats:
        """Aggregate coherence counters across shards."""
        total = CacheStats()
        for s in self._stats.values():
            total.hits += s.hits
            total.misses += s.misses
            total.invalidations += s.invalidations
            total.write_messages += s.write_messages
            total.missing_messages += s.missing_messages
            total.evictions += s.evictions
        return total

    def shard_stats(self) -> Dict[int, CacheStats]:
        """Per-shard coherence counters, keyed by shard id."""
        return dict(self._stats)

    @property
    def directory(self) -> List[Dict[str, set]]:
        """The shard-local watcher directories (one dict per active shard)."""
        return [self.store._shards[sid].directory
                for sid in self.store.shard_ids()]

    def _forget_holder(self, node_id: int, name: str) -> None:
        """Remove ``node_id`` from ``name``'s shard directory (the replica is
        gone).  Resolves the owner through the ring — a deleted name still
        hashes to a shard, so no directory scan is needed.

        Guarded against the eviction/re-read race: cleanup runs *after* the
        evicting op released its shard lock, so the same node may have
        re-read the name in between.  Re-reads register their holdership
        under this same shard lock, so checking the node's LRU here decides
        atomically — if the replica is back, the holder record must stay."""
        with self.store.locked_owner(name) as shard:
            if self.caches[node_id].contains(name):
                return
            holders = shard.directory.get(name)
            if holders is not None:
                holders.discard(node_id)
                if not holders:
                    del shard.directory[name]

    def _note_eviction(self, node_id: int, evicted: Optional[str]) -> None:
        if evicted is None:
            return
        with self.store.locked_owner(evicted) as shard:
            self._shard_stats(shard.id).evictions += 1
        if telemetry.TRACING and self.tracer.enabled:
            self.tracer.count("cache.evictions")
        self._forget_holder(node_id, evicted)

    # -- reads ---------------------------------------------------------------

    def read(self, node_id: int, name: str, *, owner=None):
        evicted = None
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        try:
            with self.store.locked_entry(name, owner) as (shard, entry):
                stats = self._shard_stats(shard.id)
                cached = self.caches[node_id].get(name)
                if cached is not None and cached[0] == entry.epoch:
                    stats.hits += 1
                    if tracing:
                        trc.count("cache.replica_hits")
                    return cached[1]
                # miss: fetch through the DSM internal layer + tell the watcher
                stats.misses += 1
                stats.missing_messages += 1
                if tracing:
                    trc.count("cache.replica_misses")
                # re-entrant on the held shard lock; the handle spares the
                # nested op its second ring_hash of the same name
                value = self.store.get(name, owner=owner)
                evicted = self.caches[node_id].put(name, entry.epoch, value)
                shard.directory.setdefault(name, set()).add(node_id)
                return value
        finally:
            # the evicted name may be owned by a different shard: clean up
            # after this shard's lock is released (lock order: one shard at
            # a time, never shard → shard)
            self._note_eviction(node_id, evicted)

    # -- writes (write-through + invalidate) ----------------------------------

    def write(self, node_id: int, name: str, value, *, owner=None) -> None:
        evicted = None
        try:
            with self.store.locked_entry(name, owner) as (shard, entry):
                stats = self._shard_stats(shard.id)
                self.store.set(name, value, owner=owner)       # write-through
                stats.write_messages += 1
                holders = shard.directory.get(name, set())
                invalidated = 0
                for holder in list(holders):
                    if holder != node_id:
                        # the store outlives sessions (FT recovery rolls a
                        # smaller world over it): a holder id beyond this
                        # session's node count is a dead session's record —
                        # there is no replica to invalidate, just drop it
                        if (holder < len(self.caches)
                                and self.caches[holder].invalidate(name)):
                            stats.invalidations += 1
                            invalidated += 1
                        holders.discard(holder)
                # one batched tracer count per write, not one per holder —
                # this runs under the shard lock, where tracer time multiplies
                if invalidated and telemetry.TRACING and self.tracer.enabled:
                    self.tracer.count("cache.invalidations", invalidated)
                # the writer keeps (updates) its own replica
                evicted = self.caches[node_id].put(name, entry.epoch, value)
                holders.add(node_id)
                shard.directory[name] = holders
        finally:
            self._note_eviction(node_id, evicted)

    # -- bypass (atomic ops skip the cache, per §5.1) --------------------------

    def atomic_inc(self, name: str, amount=1, *, owner=None):
        val = self.store.inc(name, amount, owner=owner)
        # epoch bump means every cached replica is now stale; lazily invalid.
        return val

    # -- teardown (DelArray / DelObj) ------------------------------------------

    def drop(self, name: str) -> None:
        """Purge every node's replica of ``name`` and its directory record —
        the coherence half of a DSM delete.  Registered as a store delete
        hook, so it also fires for direct ``store.delete`` calls; without it,
        a deleted-then-re-declared name leaves phantom holders and
        (pre-generation-epochs) could serve the deleted era's value."""
        for c in self.caches:
            c.invalidate(name)
        with self.store.locked_owner(name) as shard:
            shard.directory.pop(name, None)
