"""The port's tiered store and live rebalancing against repro's.

Mirrors ``tests/test_tiers.py`` case by case, and the ring, rebalance and
recovery cases of ``tests/test_shards.py``.  Each case runs one op sequence
(written once, over a package's constructors) on ``repro.core.shards`` and
on ``repro_torch.core.shards`` from the same numpy inputs, and the two
stores must end equal: owners, ``moved`` and kept epochs, ``tier_stats()``
counts and bytes, ``migration_totals()`` keys and counts (``window_s`` is a
wall time), store counters and every value bit for bit.  The threaded cases
compare what threads cannot reorder: names, values and totals.  The timing
case's mirror bounds each op's pause in entry moves, not in seconds.
"""

import hashlib
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.shards as jshards  # noqa: E402
import repro.core.tiers as jtiers  # noqa: E402
import repro.ft as jft  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.shards as tshards  # noqa: E402
import repro_torch.core.tiers as ttiers  # noqa: E402
import repro_torch.ft as tft  # noqa: E402

CPU = "cpu"
ONE_KB = (256,)  # float32 (256,) == 1024 bytes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Pkg:
    """One package's store, session, tier and ft constructors, so that a
    program is written once for both."""

    def __init__(self, name, core, shards, tiers, ft, full, abstract, to_np, **ctor):
        self.name, self.core, self.shards, self.tiers, self.ft = name, core, shards, tiers, ft
        self.full, self.abstract, self.to_np = full, abstract, to_np
        self._ctor = ctor

    def store(self, **kw):
        return self._ctor["store"](**kw)

    def gstore(self, **kw):
        return self._ctor["gstore"](**kw)

    def session(self, **kw):
        return self._ctor["session"](**kw)


def _jnp(v):
    if isinstance(v, dict):
        return {k: np.asarray(x) for k, x in v.items()}
    return np.asarray(v)


def _tnp(v):
    if isinstance(v, dict):
        return {k: x.cpu().numpy() for k, x in v.items()}
    return v.cpu().numpy()


JAX = _Pkg("repro", J, jshards, jtiers, jft,
           full=lambda shape, v: jnp.full(shape, v, jnp.float32),
           abstract=lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32),
           to_np=_jnp,
           store=lambda **kw: J.ShardedStore(**kw),
           gstore=lambda **kw: J.GlobalStore(**kw),
           session=lambda **kw: J.Session(**kw))
PORT = _Pkg("repro_torch", T, tshards, ttiers, tft,
            full=lambda shape, v: torch.full(shape, float(v)),
            abstract=lambda shape: torch.empty(shape, device="meta"),
            to_np=_tnp,
            store=lambda **kw: T.ShardedStore(CPU, **kw),
            gstore=lambda **kw: T.GlobalStore(CPU, **kw),
            session=lambda **kw: T.Session(device=CPU, **kw))


def _fill(pkg, store, names, base=0.0, shape=ONE_KB):
    for i, n in enumerate(names):
        store.def_global(n, pkg.full(shape, base + i))


def _state(pkg, store):
    """Everything two equal stores agree on, as plain data."""
    names = sorted(store.names())
    totals = store.migration_totals()
    return {"names": names,
            "owners": {n: store.shard_of(n) for n in names},
            "epochs": {n: store.epoch(n) for n in names},
            "values": {n: _bytes(pkg.to_np(store.get(n))) for n in names},
            "shard_ids": store.shard_ids(),
            "ring_version": store.ring_version,
            "tiers": store.tier_stats(),
            "migration": {k: v for k, v in totals.items() if k != "window_s"},
            "migration_keys": sorted(totals),
            "stats": store.stats}


def _bytes(v):
    if isinstance(v, dict):
        return {k: (x.dtype.str, x.shape, x.tobytes()) for k, x in v.items()}
    return (v.dtype.str, v.shape, v.tobytes())


def _mig(m):
    if m is None:
        return None
    return {"added": tuple(m.added), "removed": tuple(m.removed), "moved": dict(m.moved),
            "epochs": dict(m.epochs), "total_names": m.total_names,
            "bytes_moved": m.bytes_moved, "pulled": m.pulled}


def _both(program, compare_state=True):
    """``program(pkg)`` -> (store or None, extra) in both packages; the final
    stores' states and the extras must be equal."""
    out = {pkg.name: program(pkg) for pkg in (JAX, PORT)}
    (js, jx), (ts, tx) = out["repro"], out["repro_torch"]
    if compare_state and js is not None:
        assert _state(PORT, ts) == _state(JAX, js)
    assert tx == jx
    return tx


# -- cold tiers ---------------------------------------------------------------


def test_resolve_cold_tier_contract():
    def program(pkg):
        t = pkg.tiers
        assert t.resolve_cold_tier(None) is None
        assert isinstance(t.resolve_cold_tier("host"), t.HostMemTier)
        disk = t.resolve_cold_tier("disk")
        assert isinstance(disk, t.DiskTier)
        disk.close()
        tier = t.HostMemTier()
        assert t.resolve_cold_tier(tier) is tier
        msgs = []
        for bad, exc in (("tape", ValueError), (object(), TypeError)):
            with pytest.raises(exc) as info:
                t.resolve_cold_tier(bad)
            msgs.append(str(info.value).split(":")[0])
        return None, msgs

    msgs = _both(program)
    assert "cold_tier" in msgs[0] and "ColdTier" in msgs[1]


def test_budget_demotes_lru_first_and_counts():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=2 * 1024)
        _fill(pkg, store, [f"d{i}" for i in range(4)])        # 4 KB hot demand
        ts = store.tier_stats()
        assert ts["kind"] == "host" and ts["budget_bytes"] == 2 * 1024
        assert ts["hot"]["entries"] == 2 and ts["hot"]["bytes"] == 2 * 1024
        assert ts["cold_entries"] == 2 == ts["demotions"]
        assert ts["cold"] == {"puts": 2, "gets": 0, "deletes": 0,
                              "entries": 2, "bytes": 2 * 1024}
        shard = store._shards[0]
        assert sorted(shard.cold) == ["d0", "d1"]             # LRU spilled first
        np.testing.assert_allclose(pkg.to_np(store.get("d2")), 2.0)
        store.def_global("d4", pkg.full(ONE_KB, 4.0))
        assert "d3" in shard.cold and "d2" in shard.entries
        return store, (list(shard.entries), list(shard.cold))

    _both(program)


def test_promotion_preserves_epoch_and_value():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=1024)
        store.def_global("p", pkg.full(ONE_KB, 1.0))
        store.set("p", pkg.full(ONE_KB, 2.0))
        epoch = store._shards[0].entries["p"].epoch
        _fill(pkg, store, ["f0", "f1"], base=10.0)            # push "p" cold
        cold_entry = store._shards[0].cold["p"]
        assert cold_entry.value is None and cold_entry.epoch == epoch
        np.testing.assert_allclose(pkg.to_np(store.get("p")), 2.0)  # promote
        assert store._shards[0].entries["p"].epoch == epoch         # unchanged
        ts = store.tier_stats()
        assert ts["promotions"] >= 1 and ts["cold_hits"] >= 1
        return store, epoch

    _both(program)


def test_epoch_validated_cache_replica_survives_demote_promote_cycle():
    def program(pkg):
        store = pkg.gstore(shards=1, cold_tier="host", cold_budget=1024)
        cache = pkg.core.DSMCache(store, n_nodes=2)
        store.def_global("m", pkg.full(ONE_KB, 3.0))
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 3.0)
        _fill(pkg, store, ["g0", "g1"], base=5.0)             # demote "m"
        assert "m" in store._shards[0].cold
        hits, promos = cache.stats.hits, store.tier_stats()["promotions"]
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 3.0)
        assert cache.stats.hits == hits + 1                  # a hit, no promote
        assert store.tier_stats()["promotions"] == promos
        cache.write(1, "m", pkg.full(ONE_KB, 4.0))
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 4.0)
        return store, cache.stats.as_dict()

    _both(program)


def test_set_and_inc_operate_on_cold_entries():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=1024)
        store.def_global("s", pkg.full(ONE_KB, 1.0))
        store.def_global("i", pkg.full(ONE_KB, 1.0))
        store.def_global("hot", pkg.full(ONE_KB, 0.0))       # spills s and i
        assert {"s", "i"} <= set(store._shards[0].cold)
        store.set("s", pkg.full(ONE_KB, 9.0))                # overwrite: no load
        store.inc("i", 1.0)                                  # rmw: loads then incs
        np.testing.assert_allclose(pkg.to_np(store.get("s")), 9.0)
        np.testing.assert_allclose(pkg.to_np(store.get("i")), 2.0)
        return store, None

    _both(program)


def test_delete_reclaims_cold_payload():
    def program(pkg):
        tier = pkg.tiers.HostMemTier()
        store = pkg.store(shards=1, cold_tier=tier, cold_budget=1024)
        _fill(pkg, store, ["a", "b"])                        # "a" goes cold
        assert tier.stats()["entries"] == 1
        store.delete("a")
        assert tier.stats()["entries"] == 0
        assert "a" not in store._shards[0].cold
        with pytest.raises(KeyError):
            store.get("a")
        return store, tier.stats()

    _both(program)


def test_disk_tier_roundtrip_and_close_removes_spill_dir():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="disk", cold_budget=1024)
        _fill(pkg, store, ["x0", "x1", "x2"])
        tier = store.cold_tier
        root = tier.root
        assert os.path.isdir(root) and tier.stats()["entries"] == 2
        files = sorted(os.listdir(root))
        np.testing.assert_allclose(pkg.to_np(store.get("x0")), 0.0)
        np.testing.assert_allclose(pkg.to_np(store.get("x1")), 1.0)
        state = _state(pkg, store)
        tier.close()
        assert not os.path.exists(root)                      # owned tempdir removed
        return None, (files, state)

    _both(program)


def test_object_entries_round_trip_through_cold_tier():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=1024)
        store.new_object("obj", {"w": pkg.full(ONE_KB, 1.5), "b": pkg.full((4,), 0.0)})
        store.def_global("pad", pkg.full(ONE_KB, 0.0))
        assert "obj" in store._shards[0].cold
        got = pkg.to_np(store.get("obj"))
        np.testing.assert_allclose(got["w"], 1.5)
        np.testing.assert_allclose(got["b"], 0.0)
        return store, None

    _both(program)


def test_default_path_keeps_single_tier_shape():
    def program(pkg):
        store = pkg.store(shards=2)
        _fill(pkg, store, [f"n{i}" for i in range(4)])
        ts = store.tier_stats()
        assert ts["kind"] is None and ts["budget_bytes"] is None
        assert ts["cold_entries"] == 0 == ts["demotions"] == ts["promotions"]
        assert ts["hot"]["bytes"] == 0                       # untracked when untiered
        assert store.cold_tier is None
        for shard in store._shards.values():
            assert shard.cold == {}
        return store, None

    _both(program)


def test_session_plumbs_cold_tier_and_reports_tiers_metric():
    def program(pkg):
        sess = pkg.session(backend="host", n_nodes=1, threads_per_node=2,
                           shards=2, cold_tier="host", cold_budget=4 * 1024)
        refs = [sess.new_array(f"t{i}", ONE_KB) for i in range(12)]
        for i, r in enumerate(refs):
            r.set(pkg.full(ONE_KB, float(i)))
        m = sess.metrics()
        assert m["tiers"]["kind"] == "host"
        assert m["tiers"]["demotions"] > 0
        assert m["tiers"]["migration"] == sess.store.migration_totals()
        for i, r in enumerate(refs):                         # everything still exact
            np.testing.assert_allclose(pkg.to_np(r.get()), float(i))
        return sess.store, {k: v for k, v in m["tiers"].items() if k != "migration"}

    _both(program)


# -- review regressions -------------------------------------------------------


def _pin_hot_abstract(pkg, shard, names, shape=ONE_KB):
    """Make the named hot entries abstract (a ShapeDtypeStruct in repro, a
    meta tensor in the port): they keep counting toward hot_bytes but are
    not demotable, so the demotion pass can only pick a concrete entry."""
    for n in names:
        shard.entries[n].value = pkg.abstract(shape)


def test_get_returns_promoted_value_even_when_demoted_right_back():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=2 * 1024)
        _fill(pkg, store, ["victim", "pad0", "pad1"], base=6.0)
        shard = store._shards[0]
        assert "victim" in shard.cold                        # LRU spill past budget
        _pin_hot_abstract(pkg, shard, ["pad0", "pad1"])
        got = []
        for _ in range(2):                                   # stable across cycles
            got.append(_bytes(pkg.to_np(store.get("victim"))))
            assert "victim" in shard.cold                    # demoted back each time
        assert shard.stats["demotions"] >= 3
        return None, (got, store.tier_stats(), shard.stats)

    _both(program)


def test_inc_returns_new_value_even_when_demoted_right_back():
    def program(pkg):
        store = pkg.store(shards=1, cold_tier="host", cold_budget=2 * 1024)
        _fill(pkg, store, ["ctr", "pad0", "pad1"], base=1.0)
        shard = store._shards[0]
        assert "ctr" in shard.cold
        _pin_hot_abstract(pkg, shard, ["pad0", "pad1"])
        out = store.inc("ctr", 2.0)
        assert out is not None
        np.testing.assert_allclose(pkg.to_np(out), 3.0)
        assert "ctr" in shard.cold                           # demoted after serving
        got = pkg.to_np(store.get("ctr"))
        np.testing.assert_allclose(got, 3.0)
        return None, (_bytes(got), store.tier_stats(), shard.stats)

    _both(program)


def test_settle_serves_in_place_under_the_new_owners_lock():
    """During the unsealed window phase the ring comparison still reports a
    move for a name that has already crossed; a re-entrant op holding the
    new owner's lock is served in place, never re-entering the pair pull."""
    def program(pkg):
        store = pkg.store(shards=2)
        names = [f"u{i}" for i in range(16)]
        _fill(pkg, store, names)
        old_ring = store._ring
        store._shards[9] = pkg.shards.Shard(9)
        new_ring = old_ring.added(9)
        name = next(n for n in names if new_ring.owner(n) == 9)
        win = pkg.shards.MigrationWindow(old_ring, new_ring)  # unsealed on purpose
        store._ring = new_ring
        store._window = win
        src, dst = store._shards[old_ring.owner(name)], store._shards[9]
        dst.entries[name] = src.entries.pop(name)            # already crossed
        orig = store._migrate_one

        def boom(*a, **k):  # pragma: no cover - only fires on regression
            raise AssertionError("re-entrant settle re-entered the pair pull")

        store._migrate_one = boom
        store._lock_shard(dst)                               # the re-entrant posture
        try:
            assert store._settle(win, name) == 9
            np.testing.assert_allclose(pkg.to_np(store.get(name)),
                                       float(names.index(name)))
        finally:
            store._unlock_shard(dst)
            store._migrate_one = orig
            store._window = None
        np.testing.assert_allclose(pkg.to_np(store.get(name)), float(names.index(name)))
        return None, name

    _both(program)


def test_name_listings_and_stats_survive_concurrent_topology_changes():
    """names()/stats/tier_stats() walk the shard table while add_shard and
    remove_shard insert into it: they iterate a snapshot, never raising
    'dictionary changed size'.  (repro's test also reads its ``_entries``
    view, which nothing in the port needs.)"""
    def program(pkg):
        store = pkg.store(shards=2)
        names = [f"n{i}" for i in range(64)]
        _fill(pkg, store, names, shape=(8,))
        stop = threading.Event()
        errors = []

        def reader():
            try:
                while not stop.is_set():
                    store.names()
                    store.stats
                    store.tier_stats()
            except Exception as exc:  # pragma: no cover - the regression itself
                errors.append(repr(exc))

        th = threading.Thread(target=reader)
        th.start()
        try:
            for sid in range(50, 58):
                store.add_shard(sid)
                store.remove_shard(sid)
        finally:
            stop.set()
            th.join(timeout=30)
        assert not th.is_alive() and not errors, errors[:3]
        assert sorted(store.names()) == sorted(names)
        return store, None

    _both(program)


def test_disk_tier_spill_files_keyed_by_full_name_digest():
    def program(pkg):
        tier = pkg.tiers.DiskTier()
        try:
            path = tier._path("a")
            assert path != tier._path("b")
            want = hashlib.blake2b(b"a", digest_size=20).hexdigest() + ".pkl"
            assert os.path.basename(path) == want
            tier.put("a", pkg.full((4,), 1.0))
            tier.put("b", pkg.full((4,), 2.0))
            np.testing.assert_allclose(pkg.to_np(tier.get("a")), 1.0)
            np.testing.assert_allclose(pkg.to_np(tier.get("b")), 2.0)
            return None, (os.path.basename(path), tier.stats())
        finally:
            tier.close()

    _both(program)


def test_tier_payloads_keep_dtype_and_bits():
    """Port-only: a demoted payload is CPU tensors (numpy has no bfloat16),
    so bf16, int32 and float32 entries come back bit for bit from both
    backends; ``bytes`` counts numel × element_size, as repro does for f32."""
    rng = np.random.default_rng(0)
    f32 = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    values = {"f32": f32, "bf16": f32.to(torch.bfloat16),
              "i32": torch.from_numpy(rng.integers(-9, 9, 300, dtype=np.int32)),
              "obj": {"w": f32[:7].to(torch.bfloat16), "b": f32[7:9]}}
    nbytes = sum(t.numel() * t.element_size() for v in values.values()
                 for t in (v.values() if isinstance(v, dict) else [v]))
    for kind in ("host", "disk"):
        store = T.ShardedStore(CPU, cold_tier=kind, cold_budget=0)
        for name, v in values.items():
            (store.new_object if isinstance(v, dict) else store.def_global)(name, v)
        # budget 0: all but the newest entry are cold
        assert store.tier_stats()["cold_entries"] == len(values) - 1
        assert store.tier_stats()["hot"]["bytes"] + store.cold_tier.stats()["bytes"] == nbytes
        for name, v in values.items():
            got = store.get(name)
            pairs = got.items() if isinstance(v, dict) else [(None, got)]
            for key, t in pairs:
                want = v[key] if key is not None else v
                assert t.dtype == want.dtype and torch.equal(t, want), (kind, name, key)
        assert store.tier_stats()["hot"]["bytes"] + store.cold_tier.stats()["bytes"] == nbytes
        store.cold_tier.close()


# -- incremental migration windows --------------------------------------------


def test_add_shard_drains_inline_by_default_and_records_cost():
    def program(pkg):
        store = pkg.store(shards=2)
        names = [f"k{i}" for i in range(32)]
        _fill(pkg, store, names)
        mig = store.add_shard(7)
        assert store.migration_window is None                # drained before return
        assert mig.added == (7,) and len(mig.moved) > 0
        assert mig.bytes_moved == 1024 * len(mig.moved)
        assert mig.window_s > 0.0 and mig.pulled == 0
        for i, n in enumerate(names):
            np.testing.assert_allclose(pkg.to_np(store.get(n)), float(i))
        totals = store.migration_totals()
        assert totals["windows"] == 1 and totals["open"] is False
        assert totals["bytes_moved"] == mig.bytes_moved
        return store, _mig(mig)

    _both(program)


def test_open_window_settles_reads_writes_then_closes():
    def program(pkg):
        store = pkg.store(shards=2)
        names = [f"w{i}" for i in range(32)]
        _fill(pkg, store, names)
        mig = store.add_shard(9, drain=False)
        win = store.migration_window
        assert win is not None and win.remaining > 0
        before = win.remaining
        for i, n in enumerate(names):                        # each op settles its key
            np.testing.assert_allclose(pkg.to_np(store.get(n)), float(i))
        assert store.migration_window is None or store.migration_window.remaining < before
        left = store.migrate_step(10 ** 6)
        assert left == 0 and store.migration_window is None
        totals = store.migration_totals()
        assert totals["pulled"] > 0                          # reads did real handoffs
        assert totals["entries_moved"] == before
        return store, (_mig(mig), before)

    _both(program)


def test_remove_shard_window_serves_unpulled_keys_from_retired_shard():
    def program(pkg):
        store = pkg.store(shards=3)
        names = [f"r{i}" for i in range(30)]
        _fill(pkg, store, names)
        victim = store.shard_of(names[0])
        mig = store.remove_shard(victim, drain=False)
        assert mig.removed == (victim,)
        assert victim not in store.shard_ids()               # ring updated at once
        assert set(names) <= set(store.names())
        for i, n in enumerate(names):
            np.testing.assert_allclose(pkg.to_np(store.get(n)), float(i))
        store.drain_window()
        assert len(store._shards[victim].entries) == 0
        assert set(names) <= set(store.names())
        return store, _mig(mig)

    _both(program)


def test_cold_entries_migrate_as_index_records_without_payload_io():
    def program(pkg):
        tier = pkg.tiers.HostMemTier()
        store = pkg.store(shards=2, cold_tier=tier, cold_budget=0)
        names = [f"c{i}" for i in range(16)]
        _fill(pkg, store, names)                             # budget 0: all cold
        io_before = tier.stats()["gets"] + tier.stats()["puts"]
        mig = store.add_shard(5)
        assert len(mig.moved) > 0
        assert tier.stats()["gets"] + tier.stats()["puts"] == io_before
        assert mig.bytes_moved == 1024 * len(mig.moved)      # accounted at cold size
        for i, n in enumerate(names):
            np.testing.assert_allclose(pkg.to_np(store.get(n)), float(i))
        return store, _mig(mig)

    _both(program)


def test_back_to_back_topology_changes_serialize_windows():
    def program(pkg):
        store = pkg.store(shards=2)
        _fill(pkg, store, [f"b{i}" for i in range(24)])
        store.add_shard(4, drain=False)
        assert store.migration_totals()["open"] is True
        store.add_shard(5, drain=False)                      # drains window 1 first
        store.drain_window()
        totals = store.migration_totals()
        assert totals["windows"] == 2 and totals["open"] is False
        for i in range(24):
            np.testing.assert_allclose(pkg.to_np(store.get(f"b{i}")), float(i))
        return store, None

    _both(program)


def test_legacy_stop_the_world_path_still_works_and_reports_cost():
    def program(pkg):
        store = pkg.store(shards=2)
        _fill(pkg, store, [f"l{i}" for i in range(16)])
        mig = store.add_shard(3, incremental=False)
        assert store.migration_window is None
        assert mig.bytes_moved == 1024 * len(mig.moved) and mig.pulled == 0
        assert mig.window_s > 0.0
        for i in range(16):
            np.testing.assert_allclose(pkg.to_np(store.get(f"l{i}")), float(i))
        return store, _mig(mig)

    _both(program)


def _traffic(pkg, store, names, n_threads, write_every, body):
    """``n_threads`` workers, one writer per name (``names[t::n_threads]``),
    setting every ``write_every``-th op and getting every op, each read
    checked against the writer's latest value; ``body()`` runs meanwhile
    on this thread.  Returns (errors, per-op records of the worker)."""
    shape = pkg.to_np(store.get(names[0])).shape
    stop = threading.Event()
    errors, records = [], []

    def worker(t):
        mine = names[t::n_threads]
        latest = {n: float(names.index(n)) for n in mine}
        k = 0
        try:
            while not stop.is_set():
                n = mine[k % len(mine)]
                k += 1
                rec = [time.perf_counter()]
                if k % write_every == 0:
                    latest[n] += 1.0
                    store.set(n, pkg.full(shape, latest[n]))
                got = pkg.to_np(store.get(n))
                rec.append(time.perf_counter())
                records.append(rec)
                if not np.all(got == got[0]):
                    errors.append(f"torn read of {n}")
                elif got[0] != latest[n]:
                    errors.append(f"stale read of {n}: {got[0]} != {latest[n]}")
        except Exception as exc:  # pragma: no cover - surfaced via errors
            errors.append(f"worker {t}: {exc!r}")

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    try:
        body()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    return errors, records


def test_incremental_rebalance_bounds_reader_pause_and_never_goes_stale():
    """The port's mirror of repro's timing stress: concurrent single-writer
    set/get traffic across an add_shard window whose every entry move takes
    15 ms.  No read is stale or torn.  The pause is counted in entry moves
    (the ``_migrate_entry_hook`` calls that started while an op was in
    flight), not in seconds: the median op sees none, and the worst at most
    half of the window's moves, where each op issued during a stop-the-world
    rebalance waits for all of them.  Four writers pull their names into the
    one new shard, so an op can queue behind each other's pull and the
    migrator's move: 4–8 of ~30 on this CPU, idle or loaded (repro's
    version bounds the same in seconds, at 0.5 × ``window_s``)."""
    moves = []                                      # start time of each move
    lock = threading.Lock()

    def hook(name):
        with lock:
            moves.append(time.perf_counter())
        time.sleep(0.015)

    store = T.ShardedStore(CPU, shards=2)
    names = [f"s{i}" for i in range(96)]
    _fill(PORT, store, names, shape=(64,))
    store._migrate_entry_hook = hook
    out = {}

    def body():
        time.sleep(0.02)
        out["mig"] = store.add_shard(7, drain=False)
        store.drain_window()
        time.sleep(0.02)

    errors, records = _traffic(PORT, store, names, 4, 2, body)
    store._migrate_entry_hook = None
    assert not errors, errors[:5]
    mig = out["mig"]
    # a racer that loses a pull finds the source empty: its hook call counts
    assert len(mig.moved) >= 16 and len(moves) >= len(mig.moved)
    starts = np.asarray(moves)
    paused = np.asarray([np.count_nonzero((starts >= t0) & (starts < t1))
                         for t0, t1 in records])
    window_s = store.migration_totals()["window_s"]
    detail = (Counter(paused.tolist()), len(moves), window_s)
    assert window_s > 0.0
    assert np.median(paused) == 0, detail
    assert paused.max() <= len(moves) // 2, detail
    # the owners of repro's store after the same join; a name pulled before
    # the planner listed its source shard moved without a ``moved`` record
    js = J.ShardedStore(shards=2)
    _fill(JAX, js, names, shape=(64,))
    jmoved = js.add_shard(7).moved
    assert set(mig.moved) <= set(jmoved) and all(jmoved[n] == mig.moved[n] for n in mig.moved)
    assert {n: store.shard_of(n) for n in names} == {n: js.shard_of(n) for n in names}


def test_incremental_handoff_is_checker_clean():
    """step.check accepts the pair-locked handoff: a live window with
    concurrent disjoint traffic gives no finding, in either package."""
    def program(pkg):
        sess = pkg.session(backend="host", n_nodes=4, threads_per_node=1,
                           shards=4, check=True)
        refs = [sess.new_array(f"h{i}", (16,)) for i in range(16)]
        started = threading.Event()

        def rebalancer():
            started.wait()
            sess.store.add_shard(11, drain=False)            # workers pull on access
            time.sleep(0.01)
            sess.store.drain_window()

        def proc(ctx):
            started.set()
            for rnd in range(40):
                r = refs[ctx.tid * 4 + rnd % 4]              # disjoint per thread
                r.set(pkg.full((16,), float(rnd)))
                assert float(pkg.to_np(r.get())[0]) == float(rnd)
            return True

        mover = threading.Thread(target=rebalancer)
        mover.start()
        try:
            assert sess.run(proc) == [True] * 4
            mover.join(timeout=30)
            assert sess.store.migration_window is None
            assert sess.findings() == []
        finally:
            sess.checker.disable()
        return None, sorted(sess.store.names())

    _both(program)


# -- crash mid-migration + FT plumbing ----------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_recovery_mid_window_loses_and_duplicates_nothing(seed):
    """Kill the session inside an open migration window at a random drain
    point: session_recovery completes the handoff — every key present once,
    every value intact, window closed — and both packages end equal."""
    def program(pkg):
        rng = np.random.default_rng(seed)
        sess = pkg.session(backend="host", n_nodes=3, threads_per_node=1, shards=3)
        vals = {f"c{seed}_{i}": float(rng.integers(0, 1000))
                for i in range(int(rng.integers(5, 40)))}
        for k, v in vals.items():
            sess.store.def_global(k, pkg.full((8,), v))
        sess.store.add_shard(10 + seed, drain=False)
        sess.store.migrate_step(int(rng.integers(0, len(vals) + 1)))
        plan, new_sess = pkg.ft.session_recovery(sess, [2])  # crash strikes now
        assert new_sess.store is sess.store
        assert new_sess.store.migration_window is None
        assert sorted(new_sess.store.names()) == sorted(vals)
        for k, v in vals.items():
            np.testing.assert_allclose(pkg.to_np(new_sess.store.get(k)), v)
        return sess.store, (plan.reassignment, plan.new_world, _mig(plan.migration))

    _both(program)


def test_migration_stress_repeated_topology_changes_under_load():
    """Soak at scale 1: back-to-back add/remove windows under 6-way
    single-writer traffic; every read is the writer's latest, never torn,
    across every window, and the store ends with the same names, shards and
    window count as repro's store after the same topology changes."""
    store = T.ShardedStore(CPU, shards=2)
    names = [f"z{i}" for i in range(96)]
    _fill(PORT, store, names, shape=(64,))
    sids = iter(range(100, 103))

    def body():
        for _ in range(3):
            store.add_shard(next(sids), drain=False)
            store.migrate_step(5)                            # partial manual drain
            store.drain_window()
            store.remove_shard(min(store.shard_ids()), drain=False)
            store.drain_window()
            time.sleep(0.01)

    errors, _ = _traffic(PORT, store, names, 6, 3, body)
    assert not errors, errors[:5]
    totals = store.migration_totals()
    assert totals["windows"] == 6 and totals["open"] is False
    assert sorted(store.names()) == sorted(names)            # nothing lost, no dupes
    js = J.ShardedStore(shards=2)
    _fill(JAX, js, names, shape=(64,))
    for sid in range(100, 103):
        js.add_shard(sid)
        js.remove_shard(min(js.shard_ids()))
    assert store.shard_ids() == js.shard_ids() and len(store.shard_ids()) == 2
    assert {n: store.shard_of(n) for n in names} == {n: js.shard_of(n) for n in names}


def test_rebalance_plan_and_heartbeat_report_migration_cost():
    def program(pkg):
        sess = pkg.session(backend="host", n_nodes=2, threads_per_node=1, shards=2)
        for i in range(24):
            sess.store.def_global(f"fb{i}", pkg.full(ONE_KB, float(i)))
        mig = pkg.ft.rebalance_shards(sess.store, join=[6], leave=[0])
        assert mig is not None
        assert mig.bytes_moved >= 1024 * len(mig.moved) > 0
        assert mig.bytes_moved % 1024 == 0
        assert mig.window_s > 0.0
        payload = pkg.ft.metrics_payload(sess)
        assert payload["rebalance"]["windows"] == 2
        assert payload["rebalance"]["bytes_moved"] == mig.bytes_moved
        assert payload["rebalance"]["open"] is False
        for i in range(24):
            np.testing.assert_allclose(pkg.to_np(sess.store.get(f"fb{i}")), float(i))
        rebalance = {k: v for k, v in payload["rebalance"].items() if k != "window_s"}
        return sess.store, (_mig(mig), rebalance)

    _both(program)


# -- the ring and rebalancing (tests/test_shards.py) ----------------------------


def test_ring_change_moves_only_affected_arcs():
    keys = [f"name{i}" for i in range(500)]
    for pkg in (JAX, PORT):
        old = pkg.core.HashRing(range(4))
        grown = old.added(4)
        moved = [k for k in keys if old.owner(k) != grown.owner(k)]
        assert all(grown.owner(k) == 4 for k in moved)
        assert 0 < len(moved) < len(keys) // 2
        shrunk = old.removed(2)
        assert all(old.owner(k) == 2 for k in keys if old.owner(k) != shrunk.owner(k))
    jr, tr = J.HashRing(range(4)), T.HashRing(range(4))
    for a, b in ((jr.added(4), tr.added(4)), (jr.removed(2), tr.removed(2)),
                 (jr.added(7).removed(1), tr.added(7).removed(1))):
        assert a.ids == b.ids and a.version == b.version
        assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]


def test_ring_version_bumps_on_topology_change():
    def program(pkg):
        ring = pkg.core.HashRing([0, 1])
        assert ring.version == 0
        grown = ring.added(2)
        assert grown.version == 1
        assert grown.removed(2).version == 2
        assert ring.version == 0                             # immutable
        store = pkg.gstore(shards=2)
        assert store.ring_version == 0
        store.add_shard()
        assert store.ring_version == 1
        store.remove_shard(2)
        assert store.ring_version == 2
        return store, None

    _both(program)


def test_stale_owner_handle_across_rebalance():
    """A memoised OwnerHandle keeps every op correct across add_shard and
    remove_shard: a stale handle is ignored, a current one routes."""
    def program(pkg):
        store = pkg.gstore(shards=2)
        names = [f"h{i}" for i in range(64)]
        for i, n in enumerate(names):
            store.def_global(n, pkg.full((), float(i)))
        handles = {n: store.owner_handle(n) for n in names}
        for n, h in handles.items():
            assert h.version == 0 and h.shard == store.shard_of(n)
        mig = store.add_shard()                              # every handle stale
        assert store.ring_version == 1 and mig.moved
        for i, n in enumerate(names):
            assert float(pkg.to_np(store.get(n, owner=handles[n]))) == float(i)
            store.set(n, pkg.full((), float(i * 2)), owner=handles[n])
            assert float(pkg.to_np(store.inc(n, 1.0, owner=handles[n]))) == float(i * 2 + 1)
        vals = store.mget(names, owners=[handles[n] for n in names])
        assert [float(pkg.to_np(v)) for v in vals] == [float(i * 2 + 1)
                                                       for i in range(len(names))]
        fresh = {n: store.owner_handle(n) for n in names}
        store.remove_shard(2)
        assert store.ring_version == 2
        for i, n in enumerate(names):
            assert float(pkg.to_np(store.get(n, owner=fresh[n]))) == float(i * 2 + 1)
        return store, _mig(mig)

    _both(program)


def test_rebalance_moves_only_changed_owners_epochs_survive():
    def program(pkg):
        store = pkg.gstore(shards=4)
        names = [f"n{i}" for i in range(120)]
        for i, n in enumerate(names):
            store.def_global(n, pkg.full((), float(i)))
            store.set(n, pkg.full((), float(i) + 1.0))      # epochs past fresh
        owners = {n: store.shard_of(n) for n in names}
        epochs = {n: store.epoch(n) for n in names}
        mig = store.add_shard()                              # join: shard 4
        assert mig.added == (4,) and not mig.removed
        for n, (src, dst) in mig.moved.items():
            assert owners[n] == src and dst == 4
        for n in names:
            if n not in mig.moved:
                assert store.shard_of(n) == owners[n]
            assert store.epoch(n) == epochs[n] == mig.epochs.get(n, epochs[n])
        assert 0 < mig.moved_fraction < 0.5
        owners2 = {n: store.shard_of(n) for n in names}
        mig2 = store.remove_shard(1)                         # leave: shard 1
        assert set(mig2.moved) == {n for n in names if owners2[n] == 1}
        for n in names:
            assert store.epoch(n) == epochs[n]
        assert store.shard_ids() == [0, 2, 3, 4]
        return store, (_mig(mig), _mig(mig2))

    _both(program)


def test_rebalance_preserves_delete_generations():
    def program(pkg):
        store = pkg.gstore(shards=2)
        store.def_global("victim", pkg.full((4,), 1.0))
        store.set("victim", pkg.full((4,), 0.0))
        retired_epoch = store.epoch("victim")
        store.delete("victim")
        old_owner = store.shard_of("victim")
        while store.shard_of("victim") == old_owner:       # move the arc
            store.add_shard()
        store.def_global("victim", pkg.full((4,), 9.0))
        assert store.epoch("victim") > retired_epoch
        return store, None

    _both(program)


def test_no_stale_replica_survives_migration():
    def program(pkg):
        store = pkg.gstore(shards=2)
        cache = pkg.core.DSMCache(store, n_nodes=2)
        store.def_global("m", pkg.full((4,), 1.0))
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 1.0)
        old_owner = store.shard_of("m")
        while store.shard_of("m") == old_owner:
            store.add_shard()
        cache.write(1, "m", pkg.full((4,), 2.0))           # the directory moved along
        assert cache.stats.invalidations == 1
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 2.0)
        hits = cache.stats.hits
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "m")), 2.0)
        assert cache.stats.hits == hits + 1
        return store, cache.stats.as_dict()

    _both(program)


def test_store_side_delete_hook_kills_phantom_holders():
    def program(pkg):
        store = pkg.gstore(shards=2)
        cache = pkg.core.DSMCache(store, n_nodes=3)
        store.def_global("p", pkg.full((4,), 5.0))
        for node in range(3):
            cache.read(node, "p")
        assert any("p" in d for d in cache.directory)
        store.delete("p")                                    # direct store-level delete
        assert all("p" not in c.blocks for c in cache.caches)
        assert all("p" not in d for d in cache.directory)
        store.def_global("p", pkg.full((4,), 7.0))
        misses = cache.stats.misses
        np.testing.assert_allclose(pkg.to_np(cache.read(0, "p")), 7.0)
        assert cache.stats.misses == misses + 1
        return store, cache.stats.as_dict()

    _both(program)


def test_session_recovery_rebalances_ring_under_drill_scenario():
    """The drill on a sharded store: node 2 dies, session_recovery removes
    its shard — only its names move, epochs kept — and the recovered session
    computes on; centers against repro's to kmeans' tolerance."""
    from repro.analytics import kmeans as jkmeans
    from repro.data import kmeans_dataset
    from repro_torch.analytics import kmeans as tkmeans

    x, _, _ = kmeans_dataset(400, 8, 4, seed=0)
    fits = {"repro": jkmeans.fit, "repro_torch": tkmeans.fit}

    def program(pkg):
        fit = fits[pkg.name]
        sess = pkg.session(backend="host", n_nodes=4, threads_per_node=2, shards=4)
        fit(x, 4, iters=2, seed=0, session=sess)
        names = sess.names()
        owners = {n: sess.store.shard_of(n) for n in names}
        epochs = {n: sess.store.epoch(n) for n in names}
        sess.kill_node(2)
        plan, recovered = pkg.ft.session_recovery(sess, [2], mode="multi")
        assert plan.migration is not None and plan.migration.removed == (2,)
        assert set(plan.migration.moved) == {n for n in names if owners[n] == 2}
        assert recovered.store is sess.store
        assert recovered.store.shard_ids() == [0, 1, 3]
        for n in names:
            assert recovered.store.epoch(n) == epochs[n]
            if owners[n] != 2:
                assert recovered.store.shard_of(n) == owners[n]
        centers, _ = fit(x, 4, iters=2, seed=0, session=recovered)
        return None, (plan.reassignment, plan.new_world, _mig(plan.migration),
                      np.asarray(centers))

    out = {pkg.name: program(pkg)[1] for pkg in (JAX, PORT)}
    assert out["repro_torch"][:3] == out["repro"][:3]
    np.testing.assert_allclose(out["repro_torch"][3], out["repro"][3], rtol=1e-4, atol=1e-5)


def test_session_recovery_keeps_ring_when_shards_dont_follow_nodes():
    def program(pkg):
        sess = pkg.session(backend="host", n_nodes=4, threads_per_node=1, shards=8)
        plan, _ = pkg.ft.session_recovery(sess, [2], mode="multi")
        assert plan.migration is None
        assert sess.store.shard_ids() == list(range(8))
        plan, _ = pkg.ft.session_recovery(sess, [2], mode="multi", rebalance=True)
        assert plan.migration is not None and plan.migration.removed == (2,)
        assert sess.store.shard_ids() == [0, 1, 3, 4, 5, 6, 7]
        return sess.store, (plan.reassignment, _mig(plan.migration))

    _both(program)


def test_recovered_smaller_world_tolerates_stale_holder_records():
    def program(pkg):
        store = pkg.gstore(shards=2)
        store.def_global("w", pkg.full((4,), 0.0))
        old = pkg.session(backend="host", n_nodes=4, threads_per_node=1, store=store)
        old.cache.write(3, "w", pkg.full((4,), 1.0))        # node 3 the sole holder
        new = pkg.session(backend="host", n_nodes=2, threads_per_node=1, store=store)
        new.cache.write(0, "w", pkg.full((4,), 2.0))        # drops the stale record
        with store.locked_owner("w") as shard:
            assert shard.directory["w"] == {0}
        assert float(pkg.to_np(new.cache.read(1, "w"))[0]) == 2.0
        return store, None

    _both(program)


def test_delete_hooks_do_not_pin_dead_session_caches():
    import gc

    def program(pkg):
        store = pkg.gstore(shards=2)
        store.def_global("h", pkg.full((4,), 1.0))
        for _ in range(5):
            sess = pkg.session(backend="host", n_nodes=2, threads_per_node=1, store=store)
            sess.run(lambda ctx: float(pkg.to_np(sess.ref("h").get())[0]))
            del sess
        gc.collect()
        store.delete("h")                                    # prunes the dead hooks
        assert len(store._delete_hooks) <= 1
        return None, None

    _both(program)


def test_rebalance_shards_merges_join_and_leave():
    def program(pkg):
        store = pkg.gstore(shards=2)
        for i in range(40):
            store.def_global(f"j{i}", pkg.full((), float(i)))
        mig = pkg.ft.rebalance_shards(store, join=[2, 3], leave=[0])
        assert mig.added == (2, 3) and mig.removed == (0,)
        assert store.shard_ids() == [1, 2, 3]
        assert all(store.shard_of(n) != 0 for n in store.names())
        assert pkg.ft.rebalance_shards(store, join=[2], leave=[9]) is None
        return store, _mig(mig)

    _both(program)


def test_ring_validation_and_cold_budget():
    """add_shard/remove_shard validate as repro's do, and the constructor
    rejects a negative cold budget."""
    def program(pkg):
        store = pkg.gstore(shards=2)
        errs = []
        for call in (lambda: store.add_shard(1), lambda: store.remove_shard(9)):
            with pytest.raises((ValueError, KeyError)) as info:
                call()
            errs.append(info.type.__name__)
        store.remove_shard(1)
        with pytest.raises(ValueError):
            store.remove_shard(0)                            # never the last shard
        with pytest.raises(ValueError, match="cold_budget"):
            pkg.store(cold_budget=-1)
        return store, errs

    assert _both(program) == ["ValueError", "KeyError"]
