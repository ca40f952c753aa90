"""step.shards — the partitioned KV store beneath the DSM, holding tensors.

The port of :mod:`repro.core.shards` on one ring:

* :class:`HashRing` — the immutable consistent-hash ring (``vnodes`` virtual
  points per shard, :func:`~repro_torch.core.addressing.ring_hash`
  positions) that maps every DSM name to its owning shard.
* :class:`Shard` — one partition: its entries, its delete-era generations,
  its watcher directory and **its own lock**, so operations on names owned
  by different shards never touch a common lock.
* :class:`ShardedStore` — the store facade over the ring.  Values are
  tensors on the store's ``device``: placement, which the JAX package does
  with a ``NamedSharding``, is one ``.to(device)``.

Values handed out by ``get`` are the stored tensors themselves.  JAX arrays
are immutable; tensors are not, so callers (the cache, the accumulator, the
apps) never write into a value read from the store — every update builds a
new tensor and ``set``s it.

Elastic rebalancing (``add_shard``/``remove_shard`` and the incremental
migration window) and cold tiers wait for the ft slice (ROADMAP Queue 1
item 9); ``cold_tier``/``cold_budget`` raise until then, and the ring
version stays 0.
"""

from __future__ import annotations

import bisect
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

import torch

from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.addressing import (
    AddressAllocator,
    FieldSlot,
    GLOBALS_OBJECT_ID,
    WORD_BYTES,
    ring_hash,
)
from repro_torch.device import resolve_device, to_tensor

DEFAULT_VNODES = 128


def _leaves(v) -> list:
    return list(v.values()) if isinstance(v, dict) else [v]


def _nbytes(v) -> int:
    """Payload bytes of a value: a tensor, or a dict of tensor fields."""
    return sum(t.numel() * t.element_size() for t in _leaves(v))


@dataclass
class GlobalEntry:
    """One named piece of shared data plus its DSM directory record."""

    name: str
    slot: FieldSlot
    value: Any  # torch.Tensor | Dict[str, torch.Tensor]
    epoch: int = 0  # bumped on every Set — drives cache invalidation


class HashRing:
    """Immutable consistent-hash ring over shard ids.

    Each shard contributes ``vnodes`` virtual points; a key is owned by the
    first point clockwise of ``ring_hash(key)``.
    """

    __slots__ = ("ids", "vnodes", "version", "_keys", "_owners")

    def __init__(self, shard_ids, vnodes: int = DEFAULT_VNODES,
                 version: int = 0):
        ids = tuple(sorted(set(int(i) for i in shard_ids)))
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.ids = ids
        self.vnodes = int(vnodes)
        # topology epoch, carried ON the ring so one reference read yields a
        # consistent (arcs, version) pair for memoised OwnerHandles
        self.version = int(version)
        points = sorted((ring_hash(f"shard:{sid}#vnode:{v}"), sid)
                        for sid in ids for v in range(self.vnodes))
        self._keys = [h for h, _ in points]
        self._owners = [sid for _, sid in points]

    def owner(self, key) -> int:
        """Shard id owning ``key`` (a DSM name, or any hashable address)."""
        if not self._keys:
            raise ValueError(
                "cannot resolve an owner on an empty hash ring — all shards "
                "have been removed")
        i = bisect.bisect_right(self._keys, ring_hash(key)) % len(self._keys)
        return self._owners[i]

    def __len__(self) -> int:
        return len(self.ids)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"HashRing(ids={self.ids}, vnodes={self.vnodes}, "
                f"version={self.version})")


class OwnerHandle:
    """Memoised (ring version, shard id) owner resolution of one name.

    Immutable by contract: holders compare ``version`` against
    :attr:`ShardedStore.ring_version` and swap in a fresh handle from
    :meth:`ShardedStore.owner_handle`; a stale handle passed to a store op is
    ignored (the op re-hashes)."""

    __slots__ = ("version", "shard")

    def __init__(self, version: int, shard: int):
        self.version = int(version)
        self.shard = int(shard)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"OwnerHandle(version={self.version}, shard={self.shard})"


def _fresh_stats() -> Dict[str, int]:
    # the JAX store's key set, tier and migration counters included, so the
    # normalised metrics of the two packages compare key for key
    return {"get": 0, "set": 0, "inc": 0, "bytes_get": 0, "bytes_set": 0,
            "transfers": 0, "migrated_in": 0, "migrated_out": 0,
            "migrated_bytes": 0, "hot_hits": 0, "cold_hits": 0,
            "promotions": 0, "demotions": 0}


class Shard:
    """One partition of the namespace: entries + generations + directory,
    guarded by this shard's own lock (an RLock: the cache layer composes
    store ops while already holding it)."""

    __slots__ = ("id", "lock", "entries", "gen", "directory", "stats")

    def __init__(self, shard_id: int):
        self.id = int(shard_id)
        self.lock = threading.RLock()
        self.entries: Dict[str, GlobalEntry] = {}
        # per-name monotonic generation: a name deleted at epoch e re-declares
        # at e+1, so no cache replica of the deleted era can ever validate
        self.gen: Dict[str, int] = {}
        # shard-local watcher directory: name -> node ids holding a replica
        self.directory: Dict[str, Set[int]] = {}
        self.stats = _fresh_stats()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Shard(id={self.id}, names={len(self.entries)})"


class ShardedStore:
    """The DSM: a named global address space partitioned over a hash ring.

    ``device=None`` is the card (see :func:`~repro_torch.device.resolve_device`);
    every stored value lives there.  ``shards=1`` is the paper's single flat
    store; larger shard counts let operations on different shards proceed
    concurrently.
    """

    def __init__(self, device=None, *, granularity: str = "coarse",
                 shards: int = 1, vnodes: int = DEFAULT_VNODES,
                 cold_tier=None, cold_budget: Optional[int] = None):
        if granularity not in ("coarse", "fine"):
            raise ValueError(f"granularity must be coarse|fine, got {granularity}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if cold_tier is not None or cold_budget is not None:
            raise NotImplementedError(
                "cold tiers are not ported yet (ROADMAP Queue 1 item 9); "
                "pass cold_tier=None, cold_budget=None")
        self.device = resolve_device(device)
        self.granularity = granularity
        self._alloc = AddressAllocator(coarse=(granularity == "coarse"))
        self._alloc_lock = threading.Lock()
        self._shards: Dict[int, Shard] = {i: Shard(i) for i in range(shards)}
        self._ring = HashRing(range(shards), vnodes=vnodes)
        self._delete_hooks: List[Any] = []
        # step.trace target; Session attaches its tracer here
        self.tracer = telemetry.NULL_TRACER
        self.checker = stepcheck.NULL_CHECKER

    # -- topology -------------------------------------------------------------

    def shard_ids(self) -> List[int]:
        return list(self._ring.ids)

    def shard_of(self, name: str) -> int:
        """Owning shard id of ``name`` under the current ring."""
        return self._ring.owner(name)

    @property
    def ring_version(self) -> int:
        """Topology epoch of the current ring (:class:`OwnerHandle` holders
        compare against it to detect staleness)."""
        return self._ring.version

    def owner_handle(self, name: str) -> OwnerHandle:
        """Resolve ``name``'s owner once and return the memoisable handle."""
        ring = self._ring
        return OwnerHandle(ring.version, ring.owner(name))

    def _resolve_owner(self, ring: HashRing, name: str,
                       owner: Optional[OwnerHandle]) -> int:
        if owner is not None and owner.version == ring.version:
            trc = self.tracer
            if telemetry.TRACING and trc.enabled:
                trc.count("store.owner_cache_hit")
            return owner.shard
        return ring.owner(name)

    def _lock_shard(self, shard: Shard) -> None:
        """Acquire a shard's lock, recording the wait when tracing is armed."""
        trc = self.tracer
        if telemetry.TRACING and trc.enabled and not shard.lock._is_owned():
            t0 = time.perf_counter()
            shard.lock.acquire()
            trc.observe("store.lock_wait", (time.perf_counter() - t0) * 1e6,
                        shard=shard.id)
        else:
            shard.lock.acquire()

    @contextmanager
    def locked_entry(self, name: str, owner: Optional[OwnerHandle] = None):
        """Yield ``(shard, entry)`` with the owning shard's lock held.

        Lock-free ring snapshot + validate-after-lock; a missing name under a
        current ring is a ``KeyError``."""
        while True:
            ring = self._ring
            shard = self._shards[self._resolve_owner(ring, name, owner)]
            self._lock_shard(shard)
            try:
                entry = shard.entries.get(name)
                if entry is not None:
                    yield shard, entry
                    return
                if self._ring is ring:
                    raise KeyError(name)
            finally:
                shard.lock.release()

    @contextmanager
    def locked_owner(self, name: str, owner: Optional[OwnerHandle] = None):
        """Like :meth:`locked_entry` but for declarations: the name need not
        exist, only the ring snapshot must still be current once locked."""
        while True:
            ring = self._ring
            shard = self._shards[self._resolve_owner(ring, name, owner)]
            self._lock_shard(shard)
            try:
                if self._ring is ring:
                    yield shard
                    return
            finally:
                shard.lock.release()

    # -- tier / migration views (single-tier, fixed ring until the ft slice) --

    def tier_stats(self) -> Dict[str, Any]:
        """The JAX store's ``tier_stats`` shape for a store with no cold tier
        (hot bytes are accounted only under a cold budget, so they read 0)."""
        hot_entries = sum(len(s.entries) for s in list(self._shards.values()))
        return {"kind": None, "budget_bytes": None,
                "hot": {"entries": hot_entries, "bytes": 0},
                "cold": {"puts": 0, "gets": 0, "deletes": 0, "entries": 0,
                         "bytes": 0},
                "cold_entries": 0, "hot_hits": 0, "cold_hits": 0,
                "promotions": 0, "demotions": 0}

    def migration_totals(self) -> Dict[str, Any]:
        """The JAX store's ``migration_totals`` shape: nothing ever migrates
        on a fixed ring."""
        return {"windows": 0, "entries_moved": 0, "bytes_moved": 0,
                "pulled": 0, "window_s": 0.0, "open": False, "pending": 0}

    # -- store-side delete hooks (cache coherence teardown) --------------------

    def add_delete_hook(self, hook: Callable[[str], None], *,
                        weak: bool = False) -> Callable[[str], None]:
        """Register ``hook(name)`` to fire inside :meth:`delete`, under the
        owning shard's lock.  ``weak=True`` holds a bound-method hook only
        weakly, so a store outliving its sessions does not pin their caches."""
        self._delete_hooks.append(weakref.WeakMethod(hook) if weak else hook)
        return hook

    def _fire_delete_hooks(self, name: str) -> None:
        dead = []
        for entry in list(self._delete_hooks):
            hook = entry() if isinstance(entry, weakref.WeakMethod) else entry
            if hook is None:
                dead.append(entry)
            else:
                hook(name)
        for entry in dead:
            self._delete_hooks.remove(entry)

    # -- declaration ----------------------------------------------------------

    def _place(self, value) -> torch.Tensor:
        return to_tensor(value, self.device)

    def _num_words(self, t: torch.Tensor) -> int:
        nbytes = max(1, t.numel()) * t.element_size()
        return max(1, (nbytes + WORD_BYTES - 1) // WORD_BYTES)

    @staticmethod
    def _fresh_epoch(shard: Shard, name: str) -> int:
        """Starting epoch for a (re-)declared name: strictly above every epoch
        the name has ever had, so stale replicas can never validate."""
        prev = shard.gen.get(name, 0)
        e = shard.entries.get(name)
        if e is not None:
            prev = max(prev, e.epoch + 1)
        return prev

    def _install(self, name: str, slot: FieldSlot, value) -> None:
        with self.locked_owner(name) as shard:
            shard.entries[name] = GlobalEntry(
                name, slot, value, epoch=self._fresh_epoch(shard, name))

    def def_global(self, name: str, value) -> str:
        """``DefGlobal(NAME, TYPE)`` — declare a shared variable and set it."""
        placed = self._place(value)
        with self._alloc_lock:
            slot = self._alloc.alloc_field(GLOBALS_OBJECT_ID,
                                           self._num_words(placed))
        self._install(name, slot, placed)
        return name

    def new_array(self, name: str, shape, dtype=torch.float32) -> str:
        """``NewArray<TYPE>(n)`` — allocate a zeroed shared array."""
        placed = torch.zeros(shape, dtype=dtype, device=self.device)
        with self._alloc_lock:
            oid = self._alloc.new_object()
            slot = self._alloc.alloc_field(oid, self._num_words(placed))
        self._install(name, slot, placed)
        return name

    def new_object(self, name: str, fields: Dict[str, Any]) -> str:
        """``NewObj`` — a shared object: a dict of fields under one object_id."""
        placed = {f: self._place(v) for f, v in fields.items()}
        words = sum(self._num_words(t) for t in placed.values())
        with self._alloc_lock:
            oid = self._alloc.new_object()
            slot = self._alloc.alloc_field(oid, words)
        self._install(name, slot, placed)
        return name

    def delete(self, name: str) -> None:
        """``DelArray`` / ``DelObj``.  Records the retired epoch so a later
        re-declaration starts strictly past it, and fires the delete hooks
        (cache replica + directory teardown) under the owning shard's lock."""
        with self.locked_entry(name) as (shard, e):
            del shard.entries[name]
            shard.gen[name] = max(shard.gen.get(name, 0), e.epoch + 1)
            shard.directory.pop(name, None)
            self._fire_delete_hooks(name)

    # -- access (the DSM-internal-layer Get/Set of Table 1) -------------------

    def get(self, name: str, *, owner: Optional[OwnerHandle] = None):
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        with self.locked_entry(name, owner) as (shard, e):
            value, sid = e.value, shard.id
            shard.stats["get"] += 1
            shard.stats["bytes_get"] += _nbytes(value)
            shard.stats["transfers"] += self._transfer_count(value)
        if tracing:
            trc.store_op("get", sid, t0, name=name)
        return value

    def set(self, name: str, value, *, bump_epoch: bool = True,
            owner: Optional[OwnerHandle] = None) -> None:
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        with self.locked_entry(name, owner) as (shard, e):
            if isinstance(e.value, dict):
                e.value = {f: self._place(v) for f, v in value.items()}
            else:
                e.value = self._place(value)
            if bump_epoch:
                e.epoch += 1
            shard.stats["set"] += 1
            shard.stats["bytes_set"] += _nbytes(e.value)
            shard.stats["transfers"] += self._transfer_count(e.value)
            sid = shard.id
        if tracing:
            trc.store_op("set", sid, t0, name=name)

    def mget(self, names, *, owners=None) -> list:
        """``MGet`` — batched get, one logical round trip *per shard touched*
        (names are grouped by owner, each group read under one lock hold)."""
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        names = list(names)
        if owners is not None:
            owners = list(owners)
            if len(owners) != len(names):
                raise ValueError(
                    f"owners must align with names: got {len(owners)} handles "
                    f"for {len(names)} names")
        vals: list = [None] * len(names)
        ring = self._ring
        groups: Dict[int, List[int]] = {}
        for i, n in enumerate(names):
            h = owners[i] if owners is not None else None
            groups.setdefault(self._resolve_owner(ring, n, h), []).append(i)
        for sid, idxs in groups.items():
            shard = self._shards[sid]
            self._lock_shard(shard)
            try:
                got_bytes = 0
                for i in idxs:
                    e = shard.entries.get(names[i])
                    if e is None:
                        raise KeyError(names[i])
                    vals[i] = e.value
                    got_bytes += _nbytes(e.value)
                shard.stats["get"] += 1
                shard.stats["transfers"] += 1
                shard.stats["bytes_get"] += got_bytes
            finally:
                shard.lock.release()
        if tracing:
            t1 = time.perf_counter()
            trc.add_span("store-op", "store.mget", t0, t1,
                         {"names": len(names), "shards": len(groups)})
            trc.observe("store.mget", (t1 - t0) * 1e6)
        return vals

    def inc(self, name: str, amount=1, *, owner: Optional[OwnerHandle] = None):
        """Atomic increment (Table 1) — skips the cache layer by contract,
        serialised under the owning shard's lock.  Builds a new tensor: the
        old value may still be held by a reader."""
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        with self.locked_entry(name, owner) as (shard, e):
            if isinstance(amount, torch.Tensor):
                amount = amount.to(self.device)
            e.value = self._place(e.value + amount)
            e.epoch += 1
            value, sid = e.value, shard.id
            shard.stats["inc"] += 1
            shard.stats["bytes_set"] += _nbytes(value)
            shard.stats["transfers"] += self._transfer_count(value)
        if tracing:
            trc.store_op("inc", sid, t0, name=name)
        return value

    def epoch(self, name: str) -> int:
        with self.locked_entry(name) as (_, e):
            return e.epoch

    def address(self, name: str) -> int:
        with self.locked_entry(name) as (_, e):
            return e.slot.address

    def names(self) -> List[str]:
        out: List[str] = []
        for shard in list(self._shards.values()):
            with shard.lock:
                out.extend(shard.entries)
        return out

    # -- stats / introspection -------------------------------------------------

    @property
    def stats(self) -> Dict[str, int]:
        """Aggregate op counters across every shard."""
        total = _fresh_stats()
        for shard in list(self._shards.values()):
            for key, v in shard.stats.items():
                total[key] += v
        return total

    def shard_stats(self) -> Dict[int, Dict[str, Any]]:
        """Per-shard op counters + entry count, keyed by shard id."""
        out: Dict[int, Dict[str, Any]] = {}
        for sid in self._ring.ids:
            shard = self._shards[sid]
            with shard.lock:
                row: Dict[str, Any] = dict(shard.stats)
                row["names"] = len(shard.entries)
            out[sid] = row
        return out

    def metrics(self) -> Dict[str, Any]:
        """Aggregate counters under the canonical (normalized) key set."""
        return telemetry.normalize_store_stats(self.stats)

    def _transfer_count(self, value) -> int:
        """How many physical transfers a get/set of `value` costs under the
        current granularity — the quantity Fig. 3 is about."""
        leaves = _leaves(value)
        if self.granularity == "coarse":
            return len(leaves)  # one package-aligned bulk transfer per leaf
        # fine-grained: one word-sized KV op per word
        return int(sum(max(1, _nbytes(t) // WORD_BYTES) for t in leaves))
