"""step.shards — the partitioned KV store beneath the DSM, holding tensors.

The port of :mod:`repro.core.shards`:

* :class:`HashRing` — the immutable consistent-hash ring (``vnodes`` virtual
  points per shard, :func:`~repro_torch.core.addressing.ring_hash`
  positions) that maps every DSM name to its owning shard; a topology change
  builds a new ring, so readers take a lock-free snapshot (``self._ring``)
  and validate it after locking.
* :class:`Shard` — one partition: its entries, its delete-era generations,
  its watcher directory and **its own lock**, so operations on names owned
  by different shards never touch a common lock.
* :class:`ShardedStore` — the store facade over the ring.  Values are
  tensors on the store's ``device``: placement, which the JAX package does
  with a ``NamedSharding``, is one ``.to(device)``.
* **Tiered entries** (step.tiers) — with a ``cold_budget``, each shard
  demotes its least-recently-used entries' *payloads* to the store's
  :class:`~repro_torch.core.tiers.ColdTier` (a device→host copy; the entry's
  metadata stays hot) and promotes them back to the device on access with
  their epoch intact, so a cache replica that validated before a demote
  still validates after the promote.
* **Elastic rebalancing** — ``add_shard`` / ``remove_shard`` move only the
  names whose ring arc changed owner, each with its epoch, delete-era
  generation and directory record.  By default they open a
  :class:`MigrationWindow`: the new ring is published at once, and each
  moved name crosses on first access (a pull under exactly the two involved
  shard locks) or by the drain, so a reader waits for the moves on its own
  shards' locks, not for the whole arc.  ``incremental=False`` keeps the
  stop-the-world path.  Shards share one
  device, so a move is a dict move with no tensor copy; ``bytes_moved``
  still counts the payload, as the JAX package does.

Values handed out by ``get`` are the stored tensors themselves.  JAX arrays
are immutable; tensors are not, so callers (the cache, the accumulator, the
apps) never write into a value read from the store — every update builds a
new tensor and ``set``s it.  A demotion only drops the store's reference (a
caller's stays valid), and a promotion makes a new device tensor.

Locking order is strictly ``shard → node-cache``; the rebalancer takes every
involved shard lock in sorted id order and publishes the new ring before
releasing, so in-flight operations either finish under the old topology or
retry under the new one (see ``locked_entry``).
"""

from __future__ import annotations

import bisect
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

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
from repro_torch.core.tiers import ColdTier, _leaves, resolve_cold_tier
from repro_torch.core.tiers import payload_nbytes as _nbytes
from repro_torch.device import resolve_device, to_tensor

DEFAULT_VNODES = 128
# how long the migrator waits, between moves, for blocked ops to take the
# pair's locks first, and the nap between its looks
_DEFER_S = 0.005
_DEFER_NAP_S = 20e-6


def _demotable(value) -> bool:
    """Only values with a payload can spill: a meta tensor (shape and dtype
    alone, the counterpart of the JAX package's ``ShapeDtypeStruct``) has
    none to store."""
    leaves = _leaves(value)
    return bool(leaves) and not any(t.is_meta for t in leaves)


@dataclass
class GlobalEntry:
    """One named piece of shared data plus its DSM directory record."""

    name: str
    slot: FieldSlot
    value: Any  # torch.Tensor | Dict[str, torch.Tensor] | None (demoted)
    epoch: int = 0  # bumped on every Set — drives cache invalidation
    # tier bookkeeping (step.tiers): hot_nbytes is this entry's share of the
    # shard's hot-byte budget; cold_bytes is the payload size parked in the
    # cold tier while value is None.  Both stay 0 when no tier is configured.
    hot_nbytes: int = 0
    cold_bytes: int = 0


class HashRing:
    """Immutable consistent-hash ring over shard ids.

    Each shard contributes ``vnodes`` virtual points; a key is owned by the
    first point clockwise of ``ring_hash(key)``.  ``added``/``removed``
    return new rings, one version on, and never mutate this one.
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

    def added(self, shard_id: int) -> "HashRing":
        return HashRing(self.ids + (shard_id,), self.vnodes, self.version + 1)

    def removed(self, shard_id: int) -> "HashRing":
        return HashRing(tuple(i for i in self.ids if i != shard_id),
                        self.vnodes, self.version + 1)

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
    store ops while already holding it).

    ``entries`` is the *hot* tier — insertion order doubles as LRU order when
    a cold tier is configured (hits reinsert at the MRU end).  ``cold``
    indexes entries whose payload lives in the store's cold tier: their
    :class:`GlobalEntry` metadata stays here, so validation and coherence
    never touch the backend."""

    __slots__ = ("id", "lock", "wait_lock", "waiters", "entries", "cold",
                 "hot_bytes", "gen", "directory", "stats")

    def __init__(self, shard_id: int):
        self.id = int(shard_id)
        self.lock = threading.RLock()
        # threads blocked on ``lock`` right now (guarded by ``wait_lock``)
        self.wait_lock = threading.Lock()
        self.waiters = 0
        self.entries: Dict[str, GlobalEntry] = {}
        self.cold: Dict[str, GlobalEntry] = {}
        self.hot_bytes = 0
        # per-name monotonic generation: a name deleted at epoch e re-declares
        # at e+1, so no cache replica of the deleted era can ever validate
        self.gen: Dict[str, int] = {}
        # shard-local watcher directory: name -> node ids holding a replica
        self.directory: Dict[str, Set[int]] = {}
        self.stats = _fresh_stats()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Shard(id={self.id}, names={len(self.entries)}, "
                f"cold={len(self.cold)})")


@dataclass
class ShardMigration:
    """Report of one ring topology change: which names moved where, the epoch
    each carried across (kept by contract), how many payload bytes crossed
    shards and how long the migration window stayed open."""

    added: Tuple[int, ...]
    removed: Tuple[int, ...]
    moved: Dict[str, Tuple[int, int]]   # name -> (old shard, new shard)
    epochs: Dict[str, int]              # kept epoch of each moved name
    total_names: int                    # namespace size at migration time
    bytes_moved: int = 0                # payload bytes that crossed shards
    window_s: float = 0.0               # open → closed wall time of the window
    pulled: int = 0                     # entries moved by reader/writer pulls

    @property
    def moved_names(self) -> List[str]:
        return list(self.moved)

    @property
    def moved_fraction(self) -> float:
        return len(self.moved) / self.total_names if self.total_names else 0.0


class MigrationWindow:
    """State of one in-flight incremental arc handoff.

    The new ring is already published when a window exists; ``pending`` maps
    each name not yet moved to its ``(old owner, new owner)`` pair.  Until the
    planner has listed the source shards (``sealed``), the pending set is
    still filling and membership is decided by comparing the two rings.  The
    window closes (and fills in its :class:`ShardMigration`'s
    ``bytes_moved``/``window_s``/``pulled``) when the sealed pending set
    drains — by access pulls, ``migrate_step`` / ``drain_window``, or the
    default inline drain of ``add_shard`` / ``remove_shard``."""

    __slots__ = ("old_ring", "new_ring", "pending", "lock", "t_open",
                 "sealed", "closed", "entries_moved", "bytes_moved",
                 "pulled", "migration")

    def __init__(self, old_ring: HashRing, new_ring: HashRing):
        self.old_ring = old_ring
        self.new_ring = new_ring
        self.pending: Dict[str, Tuple[int, int]] = {}
        self.lock = threading.Lock()     # guards pending + the counters below
        self.t_open = time.perf_counter()
        self.sealed = False
        self.closed = False
        self.entries_moved = 0
        self.bytes_moved = 0
        self.pulled = 0
        self.migration: Optional[ShardMigration] = None

    @property
    def remaining(self) -> int:
        return len(self.pending)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"MigrationWindow(v{self.old_ring.version}->"
                f"v{self.new_ring.version}, pending={len(self.pending)}, "
                f"closed={self.closed})")


class ShardedStore:
    """The DSM: a named global address space partitioned over a hash ring.

    ``device=None`` is the card (see :func:`~repro_torch.device.resolve_device`);
    every hot value lives there.  ``shards=1`` is the paper's single flat
    store; larger shard counts let operations on different shards proceed
    concurrently.  ``cold_tier`` (``"host"``, ``"disk"`` or a
    :class:`~repro_torch.core.tiers.ColdTier`) with ``cold_budget`` (hot
    bytes per shard) turns on LRU demotion.
    """

    def __init__(self, device=None, *, granularity: str = "coarse",
                 shards: int = 1, vnodes: int = DEFAULT_VNODES,
                 cold_tier: "ColdTier | str | None" = None,
                 cold_budget: Optional[int] = None):
        if granularity not in ("coarse", "fine"):
            raise ValueError(f"granularity must be coarse|fine, got {granularity}")
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if cold_budget is not None and cold_budget < 0:
            raise ValueError(f"cold_budget must be >= 0 bytes, got {cold_budget}")
        self.device = resolve_device(device)
        self.granularity = granularity
        self._alloc = AddressAllocator(coarse=(granularity == "coarse"))
        self._alloc_lock = threading.Lock()
        # retired shards stay in _shards (empty) so stragglers holding an old
        # ring snapshot can still lock them, fail the ownership check, retry
        self._shards: Dict[int, Shard] = {i: Shard(i) for i in range(shards)}
        self._ring = HashRing(range(shards), vnodes=vnodes)
        self._rebalance_lock = threading.Lock()
        self._delete_hooks: List[Any] = []
        # step.tiers: the shared cold backend and the per-shard hot-byte
        # budget that triggers LRU demotion; None keeps every path
        # single-tier at one extra branch per op
        self._cold = resolve_cold_tier(cold_tier)
        self._cold_budget = int(cold_budget) if cold_budget is not None else None
        # incremental arc handoff: at most one open window at a time (the
        # rebalance lock serialises openers; pulls run lock-free against it)
        self._window: Optional[MigrationWindow] = None
        self._mig_lock = threading.Lock()
        self._migration_totals: Dict[str, Any] = {
            "windows": 0, "entries_moved": 0, "bytes_moved": 0,
            "pulled": 0, "window_s": 0.0}
        # test/benchmark seam: called with the name inside each pair-locked
        # entry move (stress tests inject a delay or count moves here)
        self._migrate_entry_hook: Optional[Callable[[str], None]] = None
        # step.trace target; Session attaches its tracer here
        self.tracer = telemetry.NULL_TRACER
        # step.check target: the lock-order sanitizer sees every shard/alloc
        # acquisition through _lock_shard/_unlock_shard/_locked_alloc
        self.checker = stepcheck.NULL_CHECKER

    # -- topology -------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self._ring)

    def shard_ids(self) -> List[int]:
        return list(self._ring.ids)

    def shard_of(self, name: str) -> int:
        """Owning shard id of ``name`` under the current ring."""
        return self._ring.owner(name)

    def shard_for(self, name: str) -> Shard:
        """Owning :class:`Shard` of ``name`` (lock NOT held)."""
        return self._shards[self._ring.owner(name)]

    @property
    def ring_version(self) -> int:
        """Topology epoch of the current ring, bumped by every
        ``add_shard``/``remove_shard`` (:class:`OwnerHandle` holders compare
        against it to detect staleness)."""
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
        """Acquire a shard's lock, recording the wait when tracing is armed
        and the acquisition when a checker is.  A thread that must block
        counts itself in ``shard.waiters``, so the migrator can let it in
        first (see :meth:`_defer_to_waiters`)."""
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled and not shard.lock._is_owned()
        t0 = time.perf_counter() if tracing else 0.0
        if not shard.lock.acquire(blocking=False):
            with shard.wait_lock:
                shard.waiters += 1
            try:
                shard.lock.acquire()
            finally:
                with shard.wait_lock:
                    shard.waiters -= 1
        if tracing:
            wait_us = (time.perf_counter() - t0) * 1e6
            # record-only (an armed flight recorder) keeps true waits alone:
            # uncontended sub-µs acquires are most acquisitions, and what
            # the tracer spends on each is the recorder's armed overhead
            if not trc.record_only or wait_us >= 1.0:
                trc.observe("store.lock_wait", wait_us, shard=shard.id)
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_acquired(("shard", shard.id))

    def _unlock_shard(self, shard: Shard) -> None:
        shard.lock.release()
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            ck.lock_released(("shard", shard.id))

    @contextmanager
    def _locked_alloc(self):
        """The allocator lock, seen by the lock-order sanitizer as a leaf."""
        with self._alloc_lock:
            ck = self.checker
            checking = stepcheck.CHECKING and ck.enabled
            if checking:
                ck.lock_acquired(("alloc", 0))
            try:
                yield
            finally:
                if checking:
                    ck.lock_released(("alloc", 0))

    @contextmanager
    def locked_entry(self, name: str, owner: Optional[OwnerHandle] = None):
        """Yield ``(shard, entry)`` with the owning shard's lock held.

        Lock-free ring snapshot + validate-after-lock: if a rebalance moved
        the name between the snapshot and the lock, retry against the new
        ring.  A missing name under a current ring is a ``KeyError``.  During
        an open migration window the name is settled first (pulled to its new
        owner under the two involved shard locks), so a reader moves its own
        entry, never the whole arc.  The entry may be cold (``entry.value is
        None``); value-reading callers go through ``_promote``."""
        while True:
            ring = self._ring
            win = self._window
            pinned = self._settle(win, name) if win is not None else None
            if pinned is not None:
                shard = self._shards[pinned]
            else:
                shard = self._shards[self._resolve_owner(ring, name, owner)]
            self._lock_shard(shard)
            try:
                entry = shard.entries.get(name)
                if entry is not None:
                    if self._cold is not None:
                        shard.stats["hot_hits"] += 1
                        # LRU touch: reinsertion puts the name at the MRU end
                        shard.entries[name] = shard.entries.pop(name)
                    yield shard, entry
                    return
                entry = shard.cold.get(name)
                if entry is not None:
                    shard.stats["cold_hits"] += 1
                    yield shard, entry
                    return
                if self._ring is ring and (pinned is not None
                                           or not self._window_pending(name)):
                    raise KeyError(name)
            finally:
                self._unlock_shard(shard)
            # the ring (or the window) moved under us — resolve and retry

    @contextmanager
    def locked_owner(self, name: str, owner: Optional[OwnerHandle] = None):
        """Like :meth:`locked_entry` but for declarations: the name need not
        exist, only the ring snapshot must still be current once locked.
        Settling first matters here too: a redeclare during a window must see
        the old owner's delete-era generation."""
        while True:
            ring = self._ring
            win = self._window
            pinned = self._settle(win, name) if win is not None else None
            if pinned is not None:
                shard = self._shards[pinned]
            else:
                shard = self._shards[self._resolve_owner(ring, name, owner)]
            self._lock_shard(shard)
            try:
                if pinned is not None or self._ring is ring:
                    yield shard
                    return
            finally:
                self._unlock_shard(shard)

    # -- tiers (step.tiers: hot dict + pluggable cold backend) -----------------

    def _promote(self, shard: Shard, e: GlobalEntry, *, load: bool = True) -> None:
        """Move a cold entry back into the hot dict (owning shard lock held).

        ``load=True`` copies the payload back to the store's device, a new
        tensor (the epoch is untouched, so a replica that validated before
        the demote still validates).  ``load=False`` (Set overwrites the
        whole value) only reclaims the tier slot; the caller assigns the
        value and accounts bytes via :meth:`_note_resize`."""
        name = e.name
        if shard.cold.pop(name, None) is None:
            return
        if load:
            payload = self._cold.get(name)
            if isinstance(payload, dict):
                e.value = {k: v.to(self.device) for k, v in payload.items()}
            else:
                e.value = payload.to(self.device)
            shard.stats["promotions"] += 1
            trc = self.tracer
            if telemetry.TRACING and trc.enabled:
                trc.count("tier.promotions")
        self._cold.delete(name)
        e.cold_bytes = 0
        e.hot_nbytes = _nbytes(e.value) if load else 0
        shard.hot_bytes += e.hot_nbytes
        shard.entries[name] = e

    def _note_resize(self, shard: Shard, e: GlobalEntry) -> None:
        """Re-account an entry's hot bytes after its value changed (owning
        shard lock held), then demote LRU entries past the budget."""
        nb = _nbytes(e.value)
        shard.hot_bytes += nb - e.hot_nbytes
        e.hot_nbytes = nb
        self._maybe_demote(shard)

    def _install(self, shard: Shard, entry: GlobalEntry) -> None:
        """Insert a (re-)declared entry into the hot dict (owning shard lock
        held), displacing any previous hot or cold incarnation of the name."""
        name = entry.name
        if self._cold is None:
            shard.entries[name] = entry
            return
        prev = shard.entries.get(name)
        if prev is not None:
            shard.hot_bytes -= prev.hot_nbytes
        elif shard.cold.pop(name, None) is not None:
            self._cold.delete(name)
        entry.hot_nbytes = _nbytes(entry.value)
        shard.hot_bytes += entry.hot_nbytes
        shard.entries[name] = entry
        self._maybe_demote(shard)

    def _maybe_demote(self, shard: Shard) -> None:
        """Spill least-recently-used hot entries to the cold tier until the
        shard is back under its hot-byte budget (owning shard lock held).
        The just-touched entry sits at the MRU end, so it is demoted only
        when it is the lone demotable entry left.  The copy to the host is
        blocking: the payload is whole before the device tensor is let go."""
        budget = self._cold_budget
        if budget is None or shard.hot_bytes <= budget:
            return
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        while shard.hot_bytes > budget and len(shard.entries) > 1:
            victim = next(((n, e) for n, e in shard.entries.items()
                           if _demotable(e.value)), None)
            if victim is None:
                break
            name, e = victim
            nb = self._cold.put(name, e.value)
            del shard.entries[name]
            shard.hot_bytes -= e.hot_nbytes
            e.hot_nbytes = 0
            e.cold_bytes = nb
            e.value = None
            shard.cold[name] = e
            shard.stats["demotions"] += 1
            if tracing:
                trc.count("tier.demotions")

    @property
    def cold_tier(self) -> Optional[ColdTier]:
        """The configured cold backend (None when single-tier)."""
        return self._cold

    def tier_stats(self) -> Dict[str, Any]:
        """Hot/cold occupancy and movement counters across every shard
        (advisory reads, stats-grade like the ``stats`` property)."""
        hot_entries = hot_bytes = cold_entries = 0
        hot_hits = cold_hits = promotions = demotions = 0
        for shard in list(self._shards.values()):
            hot_entries += len(shard.entries)
            cold_entries += len(shard.cold)
            hot_bytes += shard.hot_bytes
            hot_hits += shard.stats["hot_hits"]
            cold_hits += shard.stats["cold_hits"]
            promotions += shard.stats["promotions"]
            demotions += shard.stats["demotions"]
        cold = (self._cold.stats() if self._cold is not None else
                {"puts": 0, "gets": 0, "deletes": 0, "entries": 0, "bytes": 0})
        return {"kind": self._cold.kind if self._cold is not None else None,
                "budget_bytes": self._cold_budget,
                "hot": {"entries": hot_entries, "bytes": hot_bytes},
                "cold": cold,
                "cold_entries": cold_entries,
                "hot_hits": hot_hits, "cold_hits": cold_hits,
                "promotions": promotions, "demotions": demotions}

    # -- elastic rebalancing ---------------------------------------------------

    def add_shard(self, shard_id: Optional[int] = None, *,
                  incremental: bool = True, drain: bool = True) -> ShardMigration:
        """Grow the ring by one shard (node join); moves only the names whose
        owner changed, epochs kept.

        ``incremental=True`` (default) publishes the new ring at once and
        opens a :class:`MigrationWindow`: moved names cross on first access
        or by the inline drain, each under exactly the two involved shard
        locks.  ``drain=False`` returns with the window still open (drive it
        with :meth:`migrate_step` / :meth:`drain_window`).
        ``incremental=False`` is the stop-the-world path (every involved lock
        held for the whole move)."""
        with self._rebalance_lock:
            if self._window is not None:    # one window at a time
                self._drain_locked(self._window)
            if shard_id is None:
                shard_id = max(self._shards) + 1 if self._shards else 0
            shard_id = int(shard_id)
            if shard_id in self._ring.ids:
                raise ValueError(f"shard {shard_id} already on the ring")
            self._shards.setdefault(shard_id, Shard(shard_id))
            new_ring = self._ring.added(shard_id)
            if not incremental:
                return self._migrate(new_ring, added=(shard_id,), removed=())
            return self._open_window(new_ring, added=(shard_id,), removed=(),
                                     drain=drain)

    def remove_shard(self, shard_id: int, *, incremental: bool = True,
                     drain: bool = True) -> ShardMigration:
        """Shrink the ring by one shard (node leave); its names move to the
        survivors that inherit its arcs, epochs kept.  Window semantics as in
        :meth:`add_shard`; with ``drain=False`` the retired shard keeps its
        entries not yet pulled until the window drains."""
        with self._rebalance_lock:
            if self._window is not None:
                self._drain_locked(self._window)
            shard_id = int(shard_id)
            if shard_id not in self._ring.ids:
                raise KeyError(f"shard {shard_id} is not on the ring")
            if len(self._ring) == 1:
                raise ValueError("cannot remove the last shard")
            new_ring = self._ring.removed(shard_id)
            if not incremental:
                return self._migrate(new_ring, added=(), removed=(shard_id,))
            return self._open_window(new_ring, added=(), removed=(shard_id,),
                                     drain=drain)

    # -- incremental arc handoff (the migration-window state machine) ----------

    def _open_window(self, new_ring: HashRing, *, added, removed,
                     drain: bool) -> ShardMigration:
        """Publish ``new_ring`` behind a migration window and plan the moves.

        Caller holds ``_rebalance_lock``.  The window is published *before*
        the ring, so any op resolving under the new ring sees it; ops that
        locked under the old ring complete at the old owner (the entry is
        still there — moves need that same lock).  Planning lists each
        source shard's names one lock at a time: its longest pause on a
        concurrent op is one key-list copy, not a payload move."""
        old_ring = self._ring
        win = MigrationWindow(old_ring, new_ring)
        self._window = win
        self._ring = new_ring
        src_ids = tuple(removed) if removed else old_ring.ids
        moved: Dict[str, Tuple[int, int]] = {}
        epochs: Dict[str, int] = {}
        for sid in src_ids:
            src = self._shards[sid]
            self._lock_shard(src)
            try:
                names = set(src.entries) | set(src.cold) | set(src.gen) \
                    | set(src.directory)
                for name in names:
                    dst = new_ring.owner(name)
                    if dst == sid:
                        continue
                    with win.lock:
                        win.pending[name] = (sid, dst)
                    e = src.entries.get(name) or src.cold.get(name)
                    if e is not None:
                        moved[name] = (sid, dst)
                        epochs[name] = e.epoch
            finally:
                self._unlock_shard(src)
        total = sum(len(self._shards[i].entries) + len(self._shards[i].cold)
                    for i in set(old_ring.ids) | set(new_ring.ids))
        mig = ShardMigration(tuple(added), tuple(removed), moved, epochs,
                             total)
        win.migration = mig
        with win.lock:
            win.sealed = True
            empty = not win.pending
            pending = len(win.pending)
        trc = self.tracer
        if telemetry.TRACING and trc.enabled:
            # lifecycle breadcrumb: a window that then stalls emits nothing
            # more, so this mark is what a flight-recorder dump shows
            trc.mark("migration", "window.open", pending=pending,
                     added=list(added), removed=list(removed))
        if empty:
            self._close_window(win)
        elif drain:
            self._drain_locked(win)
        return mig

    @property
    def migration_window(self) -> Optional[MigrationWindow]:
        """The currently-open incremental handoff window, or None."""
        return self._window

    def migrate_step(self, max_entries: int = 1) -> int:
        """Drive up to ``max_entries`` pending moves of the open window
        (no-op without one); returns how many names remain pending."""
        win = self._window
        if win is None:
            return 0
        for _ in range(max_entries):
            with win.lock:
                item = next(iter(win.pending.items()), None)
            if item is None:
                break
            name, (src, dst) = item
            self._defer_to_waiters(src, dst)
            self._migrate_one(win, name, src, dst, pulled=False)
        with win.lock:
            return len(win.pending)

    def drain_window(self) -> Optional[ShardMigration]:
        """Complete any open migration window inline (idempotent; safe to
        race with access pulls) and return its migration report."""
        win = self._window
        if win is None:
            return None
        self._drain_locked(win)
        return win.migration

    def _drain_locked(self, win: MigrationWindow) -> None:
        while True:
            with win.lock:
                item = next(iter(win.pending.items()), None)
            if item is None:
                return
            name, (src, dst) = item
            self._defer_to_waiters(src, dst)
            self._migrate_one(win, name, src, dst, pulled=False)

    def _defer_to_waiters(self, *shard_ids: int) -> None:
        """Before the migrator's next move, let the threads blocked on the
        pair's locks in (for at most a few ms).  The locks are not fair: a
        migrator looping over moves retakes a lock before a woken waiter
        runs, and would hold that op for many moves instead of one."""
        shards = [self._shards[i] for i in shard_ids]
        deadline = time.perf_counter() + _DEFER_S
        while any(s.waiters for s in shards) and time.perf_counter() < deadline:
            time.sleep(_DEFER_NAP_S)

    def _window_move(self, win: MigrationWindow,
                     name: str) -> Optional[Tuple[int, int]]:
        """``(src, dst)`` if ``name`` may still need to cross shards under
        ``win``, else None.  Before the planner seals the pending set,
        membership is decided by comparing the rings (a false positive costs
        one empty pair-locked pull)."""
        if win.closed:
            return None
        if win.sealed:
            return win.pending.get(name)
        src = win.old_ring.owner(name)
        dst = win.new_ring.owner(name)
        return (src, dst) if src != dst else None

    def _window_pending(self, name: str) -> bool:
        win = self._window
        return win is not None and self._window_move(win, name) is not None

    def _settle(self, win: MigrationWindow, name: str) -> Optional[int]:
        """Ensure ``name`` is on its new-ring owner before an op proceeds.

        Returns None in the common case (nothing to move, or the pull
        completed).  Returns a shard id to serve from when this thread
        already holds one of the pair's locks (the cache composes store ops
        re-entrantly): pulling here would take the pair out of order, and
        serving in place is correct — the entry is the one authoritative
        copy on whichever side it sits, and no other thread can move it
        while this thread holds that lock.  The new-owner check covers the
        unsealed phase, where the ring comparison still reports a move for a
        name that has already crossed."""
        mv = self._window_move(win, name)
        if mv is None:
            return None
        if self._shards[mv[0]].lock._is_owned():
            return mv[0]
        if self._shards[mv[1]].lock._is_owned():
            return mv[1]
        self._migrate_one(win, name, mv[0], mv[1], pulled=True)
        return None

    def _migrate_one(self, win: MigrationWindow, name: str, src_id: int,
                     dst_id: int, *, pulled: bool) -> None:
        """Move one name across shards under exactly the two involved locks
        (sorted id order; the checker's handoff exemption).  The entry (hot,
        or a cold index record with no payload I/O), its delete-era
        generation and its directory record cross together.  Idempotent: a
        racer that loses finds nothing at the source and only drops the
        pending record."""
        if src_id == dst_id:
            return
        src, dst = self._shards[src_id], self._shards[dst_id]
        first, second = (src, dst) if src.id < dst.id else (dst, src)
        ck = self.checker
        checking = stepcheck.CHECKING and ck.enabled
        if checking:
            ck.handoff_begin()
        self._lock_shard(first)
        self._lock_shard(second)
        try:
            hook = self._migrate_entry_hook
            if hook is not None:
                hook(name)
            nb = 0
            e = src.entries.pop(name, None)
            if e is not None:
                dst.entries[name] = e
                nb = e.hot_nbytes or _nbytes(e.value)
                if self._cold is not None:
                    src.hot_bytes -= e.hot_nbytes
                    dst.hot_bytes += e.hot_nbytes
            else:
                e = src.cold.pop(name, None)
                if e is not None:
                    dst.cold[name] = e
                    nb = e.cold_bytes
            moved_entry = e is not None
            if moved_entry:
                src.stats["migrated_out"] += 1
                src.stats["migrated_bytes"] += nb
                dst.stats["migrated_in"] += 1
            g = src.gen.pop(name, None)
            if g is not None:
                dst.gen[name] = max(dst.gen.get(name, 0), g)
            d = src.directory.pop(name, None)
            if d is not None:
                dst.directory.setdefault(name, set()).update(d)
        finally:
            self._unlock_shard(second)
            self._unlock_shard(first)
            if checking:
                ck.handoff_end()
        closed = False
        with win.lock:
            win.pending.pop(name, None)
            if moved_entry:
                win.entries_moved += 1
                win.bytes_moved += nb
                if pulled:
                    win.pulled += 1
            if win.sealed and not win.pending and not win.closed:
                win.closed = True
                closed = True
        trc = self.tracer
        if telemetry.TRACING and trc.enabled and moved_entry:
            trc.count("migration.entries")
            trc.count("migration.bytes", nb)
        if closed:
            self._close_window(win)

    def _close_window(self, win: MigrationWindow) -> None:
        t_close = time.perf_counter()
        dt = t_close - win.t_open
        m = win.migration
        if m is not None:
            m.bytes_moved = win.bytes_moved
            m.window_s = dt
            m.pulled = win.pulled
        self._note_migration(windows=1, entries_moved=win.entries_moved,
                             bytes_moved=win.bytes_moved, pulled=win.pulled,
                             window_s=dt)
        self._window = None
        trc = self.tracer
        if telemetry.TRACING and trc.enabled:
            trc.add_span("migration", "store.migration_window", win.t_open,
                         t_close, {"entries": win.entries_moved,
                                   "bytes": win.bytes_moved,
                                   "pulled": win.pulled})

    def _note_migration(self, **deltas) -> None:
        with self._mig_lock:
            for key, v in deltas.items():
                self._migration_totals[key] += v

    def migration_totals(self) -> Dict[str, Any]:
        """Cumulative rebalancing cost over this store's lifetime (window and
        stop-the-world paths), plus the live window's state — the
        ``rebalance`` section of ``ft.metrics_payload``."""
        with self._mig_lock:
            out: Dict[str, Any] = dict(self._migration_totals)
        win = self._window
        out["open"] = win is not None and not win.closed
        out["pending"] = win.remaining if win is not None else 0
        return out

    def _migrate(self, new_ring: HashRing, *, added, removed) -> ShardMigration:
        """Stop the world: move every entry, generation and directory record
        whose owner changed.

        Caller holds ``_rebalance_lock``.  Every involved shard lock is taken
        in sorted id order; the new ring is published before any is
        released, so concurrent ops either complete under the old topology
        or see the new ring when they validate after locking."""
        old_ring = self._ring
        ids = sorted(set(old_ring.ids) | set(new_ring.ids))
        shards = [self._shards[i] for i in ids]
        ck = self.checker
        checking = stepcheck.CHECKING and ck.enabled
        if checking:
            ck.rebalance_begin()
        t0 = time.perf_counter()
        for s in shards:
            self._lock_shard(s)
        try:
            moved: Dict[str, Tuple[int, int]] = {}
            epochs: Dict[str, int] = {}
            bytes_moved = 0
            total = sum(len(s.entries) + len(s.cold) for s in shards)
            for s in shards:
                # hot entries, then cold ones as index records alone: the tier
                # keys payloads by (store-unique) name, so a handoff never
                # touches the backend
                for table, hot in ((s.entries, True), (s.cold, False)):
                    for name in list(table):
                        owner = new_ring.owner(name)
                        if owner == s.id:
                            continue
                        dst = self._shards[owner]
                        e = table.pop(name)
                        (dst.entries if hot else dst.cold)[name] = e
                        if hot:
                            nb = e.hot_nbytes or _nbytes(e.value)
                            if self._cold is not None:
                                s.hot_bytes -= e.hot_nbytes
                                dst.hot_bytes += e.hot_nbytes
                        else:
                            nb = e.cold_bytes
                        moved[name] = (s.id, owner)
                        epochs[name] = e.epoch       # the epoch rides along
                        bytes_moved += nb
                        s.stats["migrated_out"] += 1
                        s.stats["migrated_bytes"] += nb
                        dst.stats["migrated_in"] += 1
                # delete-era generations (live or not) and directory records
                # follow the ring too: a redeclare after the move must still
                # start strictly past the deleted era
                for name in list(s.gen):
                    owner = new_ring.owner(name)
                    if owner != s.id:
                        dst = self._shards[owner]
                        dst.gen[name] = max(dst.gen.get(name, 0), s.gen.pop(name))
                for name in list(s.directory):
                    owner = new_ring.owner(name)
                    if owner != s.id:
                        self._shards[owner].directory[name] = s.directory.pop(name)
            self._ring = new_ring   # publish while every lock is still held
            window_s = time.perf_counter() - t0
            self._note_migration(windows=1, entries_moved=len(moved),
                                 bytes_moved=bytes_moved, pulled=0,
                                 window_s=window_s)
            return ShardMigration(tuple(added), tuple(removed), moved, epochs,
                                  total, bytes_moved, window_s, 0)
        finally:
            for s in reversed(shards):
                self._unlock_shard(s)
            if checking:
                ck.rebalance_end()

    # -- store-side delete hooks (cache coherence teardown) --------------------

    def add_delete_hook(self, hook: Callable[[str], None], *,
                        weak: bool = False) -> Callable[[str], None]:
        """Register ``hook(name)`` to fire inside :meth:`delete`, under the
        owning shard's lock.  ``weak=True`` holds a bound-method hook only
        weakly, so a store outliving its sessions (FT recovery adopts it)
        does not pin their caches."""
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
        the name has ever had (hot or demoted), so stale replicas can never
        validate."""
        prev = shard.gen.get(name, 0)
        e = shard.entries.get(name) or shard.cold.get(name)
        if e is not None:
            prev = max(prev, e.epoch + 1)
        return prev

    def _declare(self, name: str, slot: FieldSlot, value) -> None:
        with self.locked_owner(name) as shard:
            self._install(shard, GlobalEntry(
                name, slot, value, epoch=self._fresh_epoch(shard, name)))

    def def_global(self, name: str, value) -> str:
        """``DefGlobal(NAME, TYPE)`` — declare a shared variable and set it."""
        placed = self._place(value)
        with self._locked_alloc():
            slot = self._alloc.alloc_field(GLOBALS_OBJECT_ID,
                                           self._num_words(placed))
        self._declare(name, slot, placed)
        return name

    def new_array(self, name: str, shape, dtype=torch.float32) -> str:
        """``NewArray<TYPE>(n)`` — allocate a zeroed shared array."""
        placed = torch.zeros(shape, dtype=dtype, device=self.device)
        with self._locked_alloc():
            oid = self._alloc.new_object()
            slot = self._alloc.alloc_field(oid, self._num_words(placed))
        self._declare(name, slot, placed)
        return name

    def new_object(self, name: str, fields: Dict[str, Any]) -> str:
        """``NewObj`` — a shared object: a dict of fields under one object_id."""
        placed = {f: self._place(v) for f, v in fields.items()}
        words = sum(self._num_words(t) for t in placed.values())
        with self._locked_alloc():
            oid = self._alloc.new_object()
            slot = self._alloc.alloc_field(oid, words)
        self._declare(name, slot, placed)
        return name

    def delete(self, name: str) -> None:
        """``DelArray`` / ``DelObj``.  Records the retired epoch so a later
        re-declaration starts strictly past it, and fires the delete hooks
        (cache replica + directory teardown) under the owning shard's lock.
        A demoted entry is deleted without loading its payload back."""
        with self.locked_entry(name) as (shard, e):
            if shard.entries.pop(name, None) is not None:
                if self._cold is not None:
                    shard.hot_bytes -= e.hot_nbytes
            elif shard.cold.pop(name, None) is not None:
                self._cold.delete(name)
            shard.gen[name] = max(shard.gen.get(name, 0), e.epoch + 1)
            shard.directory.pop(name, None)
            self._fire_delete_hooks(name)

    # -- access (the DSM-internal-layer Get/Set of Table 1) -------------------

    def get(self, name: str, *, owner: Optional[OwnerHandle] = None):
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        with self.locked_entry(name, owner) as (shard, e):
            promoted = self._cold is not None and e.value is None
            if promoted:
                self._promote(shard, e)
            # take the value before re-budgeting: if every older hot entry is
            # not demotable, the demotion pass's only victim is this entry
            value, sid = e.value, shard.id
            shard.stats["get"] += 1
            shard.stats["bytes_get"] += _nbytes(value)
            shard.stats["transfers"] += self._transfer_count(value)
            if promoted:
                self._maybe_demote(shard)
        if tracing:
            trc.store_op("get", sid, t0, name=name)
        return value

    def set(self, name: str, value, *, bump_epoch: bool = True,
            owner: Optional[OwnerHandle] = None) -> None:
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        with self.locked_entry(name, owner) as (shard, e):
            if self._cold is not None and e.value is None:
                # Set overwrites the whole value: reclaim the tier slot but
                # skip loading the payload it is about to replace
                self._promote(shard, e, load=False)
            if isinstance(e.value, dict) or (e.value is None
                                             and isinstance(value, dict)):
                e.value = {f: self._place(v) for f, v in value.items()}
            else:
                e.value = self._place(value)
            if bump_epoch:
                e.epoch += 1
            # account bytes before _note_resize: its demotion pass may spill
            # this very entry, and a demoted value reads as zero bytes
            shard.stats["set"] += 1
            shard.stats["bytes_set"] += _nbytes(e.value)
            shard.stats["transfers"] += self._transfer_count(e.value)
            sid = shard.id
            if self._cold is not None:
                self._note_resize(shard, e)
        if tracing:
            trc.store_op("set", sid, t0, name=name)

    def mget(self, names, *, owners=None) -> list:
        """``MGet`` — batched get, one logical round trip *per shard touched*
        (names are grouped by owner, each group read under one lock hold).
        A name found cold, or moved by a rebalance, is read by :meth:`get`."""
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
            stragglers: List[int] = []
            self._lock_shard(shard)
            try:
                got_bytes = 0
                served = 0
                for i in idxs:
                    e = shard.entries.get(names[i])
                    if e is None:   # cold, migrated or missing: one by one
                        stragglers.append(i)
                        continue
                    vals[i] = e.value
                    got_bytes += _nbytes(e.value)
                    served += 1
                if served:
                    shard.stats["get"] += 1
                    shard.stats["transfers"] += 1
                    shard.stats["bytes_get"] += got_bytes
            finally:
                self._unlock_shard(shard)
            for i in stragglers:
                vals[i] = self.get(names[i])
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
            if self._cold is not None and e.value is None:
                self._promote(shard, e)
            if isinstance(amount, torch.Tensor):
                amount = amount.to(self.device)
            e.value = self._place(e.value + amount)
            e.epoch += 1
            # take the value before _note_resize: its demotion pass may pick
            # this very entry and null e.value out
            value, sid = e.value, shard.id
            shard.stats["inc"] += 1
            shard.stats["bytes_set"] += _nbytes(value)
            shard.stats["transfers"] += self._transfer_count(value)
            if self._cold is not None:
                self._note_resize(shard, e)
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
        # every shard, not just ring members: during an open remove-window
        # the retired shard still holds its entries not yet pulled (an entry
        # lives in exactly one shard dict, so no name appears twice); list()
        # snapshots the table, which add_shard can grow concurrently
        out: List[str] = []
        for shard in list(self._shards.values()):
            with shard.lock:
                out.extend(shard.entries)
                out.extend(shard.cold)
        return out

    # -- stats / introspection -------------------------------------------------

    @property
    def stats(self) -> Dict[str, int]:
        """Aggregate op counters across every shard (retired shards included,
        so counters never run backwards across a rebalance)."""
        total = _fresh_stats()
        for shard in list(self._shards.values()):
            for key, v in shard.stats.items():
                total[key] += v
        return total

    def shard_stats(self) -> Dict[int, Dict[str, Any]]:
        """Per-shard op counters + entry count, keyed by shard id (ring
        members only)."""
        out: Dict[int, Dict[str, Any]] = {}
        for sid in self._ring.ids:
            shard = self._shards[sid]
            with shard.lock:
                row: Dict[str, Any] = dict(shard.stats)
                row["names"] = len(shard.entries) + len(shard.cold)
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
