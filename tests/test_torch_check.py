"""The port's step.check (``repro_torch.check``) against repro's.

Mirrors ``tests/test_check.py`` case by case, the store's live rebalance
and FT recovery's re-armed checker included.  Each racy, lock or lint
program is written once, over ref handles and a package's array
constructors, and run through a repro session and a port session: the
findings (layer, kind, severity, name, tids and sites, which point at the
same lines of this file from both packages) must be equal as multisets.  The
four apps armed give no finding in either package.  Port-only cases: a bf16
replicated write is benign, the lint dry run's shadow store is a copy, and
its split of the rows is the backend's.  Every test leaves no checker and no
tracer armed.
"""

import collections
import json
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analytics import kmeans as jkmeans  # noqa: E402
from repro.analytics import logreg as jlogreg  # noqa: E402
from repro.analytics import nmf as jnmf  # noqa: E402
from repro.analytics import pagerank as jpagerank  # noqa: E402
from repro.check import Checker as JChecker  # noqa: E402
from repro.core import Session as JSession  # noqa: E402
from repro_torch.analytics import kmeans, logreg, nmf, pagerank  # noqa: E402
from repro_torch.check import CheckError, Checker, Finding, NULL_CHECKER  # noqa: E402
from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.check.races import snapshot_value, values_equal  # noqa: E402
from repro_torch.core import Session, SpmdBackend, make_mesh, telemetry  # noqa: E402

CPU = "cpu"
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _nothing_left_armed():
    """CHECKING and TRACING are process-wide: a test that arms a checker or
    a tracer of the port disarms it before returning."""
    yield
    leaked = (stepcheck.armed_count(), telemetry.armed_count())
    stepcheck.reset()
    telemetry.reset()
    assert leaked == (0, 0), f"test left (checkers, tracers) armed: {leaked}"


class _Pkg:
    """One package's session and array constructors, so that a program is
    written once for both."""

    def __init__(self, name, session, f32, ones, checker):
        self.name, self._session, self.f32, self.ones = name, session, f32, ones
        self.Checker = checker

    def session(self, **kw):
        return self._session(**kw)


JAX = _Pkg("repro", lambda **kw: JSession(**kw), jnp.float32, jnp.ones, JChecker)
PORT = _Pkg("repro_torch", lambda **kw: Session(device=CPU, **kw),
            lambda v: torch.tensor(v, dtype=torch.float32), torch.ones, Checker)


def _host(pkg, n_nodes=1, tpn=2, **kw):
    return pkg.session(backend="host", n_nodes=n_nodes, threads_per_node=tpn,
                       check=True, **kw)


def _key(f):
    return (f.layer, f.kind, f.severity, f.name, f.tids, f.sites)


def _both(program):
    """``program(pkg)`` -> findings, in both packages; equal as multisets."""
    found = {pkg.name: program(pkg) for pkg in (JAX, PORT)}
    assert (collections.Counter(map(_key, found["repro_torch"]))
            == collections.Counter(map(_key, found["repro"]))), found
    return found["repro_torch"]


# -- no-op by default ---------------------------------------------------------


def test_noop_by_default():
    """A plain Session arms nothing: CHECKING stays False, and findings()
    answers (empty) against a disabled checker."""
    assert stepcheck.armed_count() == 0
    sess = Session(backend="host", n_nodes=1, threads_per_node=2, device=CPU)
    assert not sess.checker.enabled
    assert stepcheck.CHECKING is False
    ref = sess.def_global("g", torch.tensor(0.0))
    sess.run(lambda ctx: ref.set(ref.get() + 1))   # racy — but nobody looks
    assert sess.findings() == []


def test_arm_disarm_scoping():
    c1, c2 = Checker(enabled=True), Checker(enabled=True)
    try:
        assert stepcheck.CHECKING and stepcheck.armed_count() == 2
        c1.disable()
        assert stepcheck.CHECKING and stepcheck.armed_count() == 1
        c2.disable()
        assert not stepcheck.CHECKING and stepcheck.armed_count() == 0
    finally:
        stepcheck.reset()


def test_checker_context_manager():
    with Checker(enabled=True) as ck:
        assert ck.enabled and stepcheck.armed_count() == 1
    assert not ck.enabled and stepcheck.armed_count() == 0


# -- the seeded unsynchronized RMW --------------------------------------------


def _seeded_rmw(pkg):
    sess = _host(pkg)
    counter = sess.def_global("counter", pkg.f32(0))

    def proc(ctx):
        for _ in range(4):
            v = counter.get()
            counter.set(v + pkg.f32(ctx.tid + 1))  # distinct per thread
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_seeded_rmw_race_detected_with_both_sites():
    found = _both(_seeded_rmw)
    assert {"write-write", "read-write"} <= {f.kind for f in found}
    for f in found:
        assert f.layer == "race" and f.severity == "error"
        assert f.name == "counter" and len(f.tids) == 2
        assert f.sites and "test_torch_check.py" in f.sites[0]
    rw = next(f for f in found if f.kind == "read-write")
    assert len(rw.sites) == 2


def test_race_detection_deterministic():
    a = {(f.kind, f.name, f.sites) for f in _seeded_rmw(PORT)}
    b = {(f.kind, f.name, f.sites) for f in _seeded_rmw(PORT)}
    assert a == b and a


def _ww(pkg):
    sess = _host(pkg)
    ref = sess.def_global("w", pkg.f32(0))

    def proc(ctx):
        ref.set(pkg.f32(ctx.tid + 1))       # differing values, no sync
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_ww_fixture_two_blind_writers():
    found = _both(_ww)
    assert [f.kind for f in found] == ["write-write"]
    assert found[0].tids == (0, 1)


def _replicated(pkg, value):
    sess = _host(pkg)
    ref = sess.def_global("r", value(0.0))

    def proc(ctx):
        ref.set(value(7.0))                 # the same value from both threads
        return None

    sess.run(proc)
    found, benign = sess.findings(), sess.checker.benign_replicated
    sess.checker.disable()
    return found, benign


def test_equal_value_writes_are_benign_replication():
    for pkg in (JAX, PORT):
        found, benign = _replicated(pkg, pkg.f32)
        assert found == [] and benign > 0, pkg.name


def test_bf16_replicated_write_is_benign():
    """numpy holds no bf16: the port's snapshot is a torch clone, so a bf16
    replicated write compares equal and stays benign."""
    found, benign = _replicated(
        PORT, lambda v: torch.tensor(v, dtype=torch.bfloat16))
    assert found == [] and benign > 0
    a = snapshot_value(torch.tensor([1.5], dtype=torch.bfloat16))
    assert values_equal(a, snapshot_value(torch.tensor([1.5], dtype=torch.bfloat16)))
    assert not values_equal(a, snapshot_value(torch.tensor([1.5])))   # dtype
    assert not values_equal(a, snapshot_value(torch.tensor([1.0], dtype=torch.bfloat16)))


def test_snapshot_is_a_copy():
    """The store hands out the stored tensor: a snapshot that kept a
    reference would change under an in-place write."""
    t = torch.zeros(4)
    snap = snapshot_value({"b": t, "a": torch.ones(2)})
    t += 1
    assert [s.shape for s in snap] == [(2,), (4,)]      # sorted field order
    assert torch.equal(snap[1], torch.zeros(4))
    assert snapshot_value(None) == ()


def _inc_inc(pkg):
    sess = _host(pkg)
    ref = sess.def_global("acc", pkg.f32(0))
    sess.run(lambda ctx: ref.inc(pkg.f32(ctx.tid + 1)))
    found = sess.findings()
    sess.checker.disable()
    return found


def test_inc_inc_commutes():
    assert _both(_inc_inc) == []


def _real(ctx) -> bool:
    """Not the spawn-time lint's dry run (which runs every tid's proc in the
    driver thread, one after another)."""
    return type(ctx).__name__ != "LintCtx"


def _barrier_edge(pkg, with_barrier):
    sess = _host(pkg)
    ref = sess.def_global("x", pkg.f32(0))
    bar = sess.barrier()
    written = threading.Event()

    def proc(ctx):
        if ctx.tid == 0:
            ref.set(pkg.f32(42.0))
            written.set()
        bar.enter() if with_barrier else None
        if not with_barrier and ctx.tid == 1 and _real(ctx):
            # no STEP edge, so the checker sees none: the read comes after
            # the write's record, which both packages flag in any schedule
            assert written.wait(timeout=60)
        out = ref.get() if ctx.tid == 1 else None
        if not with_barrier:
            bar.enter()     # keep barrier arity identical for the lint
        return out

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_barrier_creates_happens_before_edge():
    assert _both(lambda pkg: _barrier_edge(pkg, True)) == []
    flagged = _both(lambda pkg: _barrier_edge(pkg, False))
    assert {f.kind for f in flagged} == {"read-write"}


def _read_recorded_first(pkg):
    """tid 0's store write lands, tid 1's get observes its bits and is
    recorded, and only then is tid 0's write recorded: the interleaving in
    which a session records an access after its store op.  No STEP edge
    orders the two, and tid 1 never wrote the bits itself."""
    sess = _host(pkg)
    ref = sess.def_global("x", pkg.f32(0))
    bar = sess.barrier()
    stored, read_recorded = threading.Event(), threading.Event()
    record = sess.checker.on_access

    def on_access(name, kind, value):
        if kind == "write":
            stored.set()
            assert read_recorded.wait(timeout=60)
        record(name, kind, value)
        if kind == "read":
            read_recorded.set()

    sess.checker.on_access = on_access
    seen = []

    def proc(ctx):
        if _real(ctx):
            if ctx.tid == 0:
                ref.set(pkg.f32(42.0))
            else:
                assert stored.wait(timeout=60)
                seen.append(float(ref.get()))
        bar.enter()
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    assert seen == [42.0]
    return found


def test_race_found_when_the_read_is_recorded_first():
    """The port flags the unordered read whichever record comes first;
    repro's write-side check excuses a read that saw equal bits, so it
    misses this interleaving (a difference of repro's, recorded, not
    mirrored)."""
    flagged = _read_recorded_first(PORT)
    assert [(f.kind, f.tids) for f in flagged] == [("read-write", (0, 1))]
    assert _read_recorded_first(JAX) == []


def _handoff(pkg):
    sess = _host(pkg)
    ref = sess.def_global("h", pkg.f32(0))
    sem = sess.semaphore(0)                  # starts unavailable

    def proc(ctx):
        if ctx.tid == 0:
            ref.set(pkg.f32(1.0))
            sem.release()                    # hand-off publishes the write
        else:
            sem.acquire()
            ref.get()
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_semaphore_handoff_creates_edge():
    assert _both(_handoff) == []


def _accumulator_edge(pkg):
    sess = _host(pkg)
    partial = sess.new_array("p", (8,))
    out = sess.def_global("o", pkg.f32(0))

    def proc(ctx):
        tot = partial.accumulate(pkg.ones(8))
        if ctx.tid == 0:
            out.set(tot.sum())               # only one thread writes post-round
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_accumulator_round_is_a_barrier_edge():
    assert _both(_accumulator_edge) == []


def test_accumulator_round_orders_a_write_before_it():
    """Thread 1 reads what thread 0 wrote before the round: the round's
    edge (the accumulator's acc_begin / acc_done hooks) is the only order
    between them."""
    sess = _host(PORT)
    partial = sess.new_array("p", (8,))
    out = sess.def_global("o", torch.tensor(0.0))

    def proc(ctx):
        if ctx.tid == 0:
            out.set(torch.tensor(1.0))
        partial.accumulate(torch.ones(8))
        return out.get() if ctx.tid == 1 else None

    sess.run(proc)
    assert sess.findings() == []
    sess.checker.disable()


# -- the four analytics apps armed --------------------------------------------


def _app_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    pts = rng.normal(size=(60, 4)).astype(np.float32)
    r = np.abs(rng.normal(size=(24, 16))).astype(np.float32)
    edges = np.stack([rng.integers(0, 20, 60), rng.integers(0, 20, 60)],
                     axis=1).astype(np.int32)
    return x, y, pts, r, edges


@pytest.mark.parametrize("shards", [1, 4])
def test_apps_clean_under_armed_checker(shards):
    x, y, pts, r, edges = _app_data()
    mods = {"repro": (jlogreg, jkmeans, jnmf, jpagerank),
            "repro_torch": (logreg, kmeans, nmf, pagerank)}
    for pkg in (JAX, PORT):
        lr, km, nm, pr = mods[pkg.name]
        apps = [
            ("logreg", lambda s: lr.fit(x, y, iters=3, session=s)),
            ("logreg sparse", lambda s: lr.fit(x, y, iters=3, mode="sparse", k=4, session=s)),
            ("kmeans", lambda s: km.fit(pts, 3, iters=3, session=s)),
            ("nmf", lambda s: nm.fit(r, 4, iters=3, session=s)),
            ("pagerank", lambda s: pr.fit(edges, 20, iters=3, session=s)),
        ]
        for name, call in apps:
            sess = pkg.session(backend="host", n_nodes=2, threads_per_node=2,
                               shards=shards, check=True)
            call(sess)
            found = sess.findings()
            benign = sess.checker.benign_replicated
            sess.checker.disable()
            assert found == [], (f"{pkg.name} {name} S={shards}: "
                                 f"{[f.as_dict() for f in found]}")
            if name in ("kmeans", "nmf", "pagerank"):
                assert benign > 0, (pkg.name, name)  # the §4.5 replicated set


def test_armed_store_counters_match_repro():
    """The lint's dry run reads every stored value through the store, as
    repro's does: armed store counters are repro's armed figures (one
    thread, so no race between threads moves them)."""
    x, y, pts, _, edges = _app_data()
    mods = {"repro": (jlogreg, jkmeans, jpagerank),
            "repro_torch": (logreg, kmeans, pagerank)}
    stats = {}
    for pkg in (JAX, PORT):
        lr, km, pr = mods[pkg.name]
        for check in (None, True):
            rows = []
            for call in (lambda s: lr.fit(x, y, iters=3, session=s),
                         lambda s: km.fit(pts, 3, iters=3, session=s),
                         lambda s: pr.fit(edges, 20, iters=3, session=s)):
                sess = pkg.session(backend="host", n_nodes=1, threads_per_node=1,
                                   check=check)
                call(sess)
                sess.checker.disable()
                m = sess.metrics()
                rows.append((m["store"]["gets"], m["store"]["sets"],
                             m["cache"]["hits"], m["cache"]["misses"]))
            stats[pkg.name, check] = rows
    assert stats["repro_torch", True] == stats["repro", True]
    assert stats["repro_torch", None] == stats["repro", None]
    assert stats["repro_torch", True] != stats["repro_torch", None]


def test_kmeans_kernel_path_clean_under_armed_checker():
    """use_kernel=True runs the assignment kernel's wrapper (its plain
    version on the CPU) inside the lint dry run and every round."""
    _, _, pts, _, _ = _app_data()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU,
                   check=True)
    c, _ = kmeans.fit(pts, 3, iters=3, use_kernel=True, session=sess)
    found = sess.findings()
    sess.checker.disable()
    assert found == [] and np.all(np.isfinite(c))


# -- lock-order sanitizer -----------------------------------------------------


def _lock_program(pkg, steps, rebalance=False):
    ck = pkg.Checker(enabled=True)
    try:
        ck.bind_thread(0)
        if rebalance:
            ck.rebalance_begin()
        for op, key in steps:
            getattr(ck, f"lock_{op}")(key)
        if rebalance:
            ck.rebalance_end()
        return ck.findings()
    finally:
        ck.disable()


def test_inverted_node_shard_order_flagged():
    steps = [("acquired", ("node", 0)), ("acquired", ("shard", 1)),
             ("released", ("shard", 1)), ("released", ("node", 0))]
    found = _both(lambda pkg: _lock_program(pkg, steps))
    assert [f.kind for f in found] == ["lock-order-inversion"]
    assert "shard → node" in found[0].message


def test_correct_shard_then_node_order_clean():
    steps = [("acquired", ("shard", 3)), ("acquired", ("node", 0)),
             ("released", ("node", 0)), ("released", ("shard", 3))]
    assert _both(lambda pkg: _lock_program(pkg, steps)) == []


def test_rebalance_shard_pairs_must_be_sorted():
    """The checker-level rule, then its store-side callers: the
    stop-the-world rebalance takes every shard lock in sorted order under
    ``rebalance_begin``, a window's moves one sorted pair under
    ``handoff_begin``; armed, neither gives a lock finding in either
    package, and a descending pair taken by hand does."""
    steps = [("acquired", ("shard", 1)), ("acquired", ("shard", 2)),
             ("released", ("shard", 2)), ("released", ("shard", 1)),
             ("acquired", ("shard", 5)), ("acquired", ("shard", 4)),
             ("released", ("shard", 4)), ("released", ("shard", 5))]
    found = _both(lambda pkg: _lock_program(pkg, steps, rebalance=True))
    assert [f.kind for f in found] == ["rebalance-unsorted"]

    def store_side(pkg):
        sess = _host(pkg, n_nodes=2, tpn=1, shards=3)
        for i in range(24):
            sess.def_global(f"k{i}", pkg.f32(float(i)))
        sess.store.add_shard(7, incremental=False)           # every lock, sorted
        sess.store.remove_shard(1)                            # sorted pairs
        sess.store.add_shard(9, drain=False)
        sess.store.migrate_step(3)
        sess.store.drain_window()
        clean = [f for f in sess.findings() if f.layer == "lock"]
        sess.checker.bind_thread(0)
        sess.checker.handoff_begin()                          # a pair out of order
        try:
            sess.store._lock_shard(sess.store._shards[7])
            sess.store._lock_shard(sess.store._shards[0])
            sess.store._unlock_shard(sess.store._shards[0])
            sess.store._unlock_shard(sess.store._shards[7])
        finally:
            sess.checker.handoff_end()
        found = [f for f in sess.findings() if f.layer == "lock"]
        sess.checker.disable()
        return clean, [f.kind for f in found]

    runs = {pkg.name: store_side(pkg) for pkg in (JAX, PORT)}
    assert runs["repro_torch"] == runs["repro"] == ([], ["handoff-unsorted"])


def test_live_rebalance_passes_sanitizer():
    """A real add_shard migration takes its sorted shard-pair locks under
    the rebalance exemption — armed, it gives no lock finding."""
    def program(pkg):
        sess = _host(pkg, n_nodes=2, tpn=1, shards=2)
        for i in range(16):
            sess.def_global(f"k{i}", pkg.f32(float(i)))
        sess.store.add_shard(7)
        found = [f for f in sess.findings() if f.layer == "lock"]
        sess.checker.disable()
        return found

    assert _both(program) == []


def test_tier_churn_is_no_write_to_the_race_detector():
    """Port-only in spirit, run in both: threads that only read a shared
    value while the hot budget demotes and promotes it give no finding —
    a promotion is a new tensor with the same epoch and equal values."""
    def program(pkg):
        sess = _host(pkg, n_nodes=1, tpn=2, cold_tier="host", cold_budget=1024)
        shared = sess.def_global("shared", pkg.ones(256))
        pads = [sess.def_global(f"pad{t}", pkg.ones(256)) for t in range(2)]

        def proc(ctx):
            for _ in range(6):
                shared.get()
                pads[ctx.tid].get()

        sess.run(proc)
        tiers = sess.store.tier_stats()
        found = sess.findings()
        sess.checker.disable()
        assert tiers["promotions"] > 0 and tiers["demotions"] > 0
        return found

    assert _both(program) == []


def test_recovery_rearms_checker():
    """session_recovery's replacement session adopts the armed checker:
    the recovered run is checked, and clean, in both packages."""
    def program(pkg):
        from repro.ft import session_recovery as jrecover
        from repro_torch.ft import session_recovery as trecover

        recover = jrecover if pkg is JAX else trecover
        sess = _host(pkg, n_nodes=2, tpn=1, shards=2)
        ref = sess.new_array("w", (8,))

        def proc(ctx, r):
            r.accumulate(pkg.ones(8))

        sess.run(lambda ctx: proc(ctx, ref))
        plan, new_sess = recover(sess, [1])
        assert new_sess.checker is sess.checker and new_sess.checker.enabled
        ref2 = new_sess.ref("w")
        new_sess.run(lambda ctx: proc(ctx, ref2))
        found = new_sess.findings()
        sess.checker.disable()
        return found

    assert _both(program) == []


def test_shard_nesting_outside_rebalance_flagged():
    steps = [("acquired", ("shard", 0)), ("acquired", ("shard", 1))]
    found = _both(lambda pkg: _lock_program(pkg, steps))
    assert [f.kind for f in found] == ["shard-shard-nesting"]


@pytest.mark.parametrize("held,key,rebalance,handoff,kind", [
    ([], ("alloc", 0), False, False, None),
    ([("shard", 0)], ("alloc", 0), False, False, "lock-order-inversion"),
    ([("alloc", 0)], ("node", 1), False, False, "lock-order-inversion"),
    ([("node", 0)], ("node", 1), False, False, "lock-order-inversion"),
    ([("shard", 0)], ("shard", 0), False, False, None),
    ([("shard", 1)], ("shard", 2), False, True, None),
    ([("shard", 2)], ("shard", 1), False, True, "handoff-unsorted"),
    ([("shard", 1), ("shard", 2)], ("shard", 3), False, True, "handoff-pair-overflow"),
    ([("shard", 1), ("shard", 2)], ("shard", 3), True, False, None),
])
def test_check_order_matches_repro(held, key, rebalance, handoff, kind):
    from repro.check.locks import check_order as jcheck_order
    from repro_torch.check.locks import check_order

    got = check_order(held, key, rebalance, handoff)
    assert got == jcheck_order(held, key, rebalance, handoff)
    assert (got[0] if got else None) == kind


def test_store_and_cache_locks_pass_the_sanitizer():
    """The port's store and cache take their shard, node and allocator
    locks through the sanitizer's hooks, in the documented order."""
    sess = _host(PORT, n_nodes=2, tpn=1, shards=4)
    refs = [sess.new_array(f"k{i}", (4,)) for i in range(8)]
    obj = sess.new_object("o", {"w": torch.ones(2)})
    sess.def_global("g", torch.tensor(1.0))

    def proc(ctx):
        for r in refs:
            r.get()
        obj.get()
        return None

    sess.run(proc)
    sess.store.mget([f"k{i}" for i in range(8)])
    assert sess.findings() == []
    assert sess.checker._held() == []        # every acquire was released
    sess.checker.disable()


def _wait_cycle(pkg):
    sess = _host(pkg)
    sem = sess.semaphore(1)
    bar = sess.barrier(2)

    def proc(ctx):
        if ctx.tid == 0:
            sem.acquire()
            bar.enter(timeout=2.0)           # t1 never arrives
            sem.release()
        else:
            time.sleep(0.2)
            if sem.acquire(timeout=2.0):
                sem.release()
            bar.enter(timeout=2.0)
        return None

    sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_wait_cycle_semaphore_barrier_deadlock():
    """t0 holds the semaphore and parks on a 2-arrival barrier; t1 parks on
    the semaphore: both packages report the same cycle."""
    cycles = {}
    for pkg in (JAX, PORT):
        found = _wait_cycle(pkg)
        cycle = next(f for f in found if f.kind == "wait-cycle")
        assert "thread 0" in cycle.message and "thread 1" in cycle.message
        cycles[pkg.name] = (cycle.layer, cycle.severity, cycle.tids)
    assert cycles["repro"] == cycles["repro_torch"] == ("lock", "error", (0, 1))


# -- spawn-time lint ----------------------------------------------------------


def _arity(pkg, seen):
    sess = _host(pkg)
    bar = sess.barrier(3)                    # 3 arrivals, only 2 threads

    def proc(ctx):
        seen.append(threading.current_thread())
        bar.enter()
        return None

    with pytest.raises(Exception, match="arity") as info:
        sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    assert type(info.value).__name__ == "CheckError"
    return found


def test_lint_rejects_barrier_arity_before_threads_run():
    seen = []
    found = _both(lambda pkg: _arity(pkg, seen))
    # the only executions were the lint dry runs on this thread: no worker
    # thread ever started, nothing ever parked on the barrier
    assert len(seen) == 4 and all(t is threading.current_thread() for t in seen)
    assert [f.kind for f in found] == ["barrier-arity"]


def _ragged(pkg):
    sess = _host(pkg)
    g = sess.new_array("g", (4,))

    def proc(ctx):
        g.accumulate(pkg.ones(4))
        if ctx.tid == 0:
            g.accumulate(pkg.ones(4))        # one thread runs an extra round
        return None

    with pytest.raises(Exception, match="diverge") as info:
        sess.run(proc)
    found = sess.findings()
    sess.checker.disable()
    assert type(info.value).__name__ == "CheckError"
    return found


def test_lint_rejects_ragged_accumulate():
    found = _both(_ragged)
    assert [f.kind for f in found] == ["ragged-accumulate"]


def _fori(pkg):
    sess = _host(pkg)
    g = sess.new_array("g", (4,))

    def ok(ctx):
        return ctx.iterate(lambda c: c + g.accumulate(pkg.ones(4)).sum(),
                           pkg.f32(0), 3)

    sess.run(ok)                             # lints clean, then really runs
    assert sess.findings() == []

    def ragged(ctx):
        return ctx.iterate(lambda c: c + g.accumulate(pkg.ones(4)).sum(),
                           pkg.f32(0), 3 + ctx.tid)

    with pytest.raises(Exception, match="diverge"):
        sess.run(ragged)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_lint_counts_fori_trips():
    found = _both(_fori)
    assert [f.kind for f in found] == ["ragged-accumulate"]


def _spmd_sync(pkg):
    sess = pkg.session(backend="spmd", check=True)
    bar = sess.barrier()

    def proc(ctx, xs):
        bar.enter()                          # host-only primitive
        return xs.sum()

    with pytest.raises(Exception, match="SPMD"):
        sess.run(proc, data=(pkg.ones((4, 2)),))
    found = sess.findings()
    sess.checker.disable()
    return found


def test_lint_rejects_host_sync_under_spmd():
    found = _both(_spmd_sync)
    assert [f.kind for f in found] == ["spmd-host-sync"]


def test_lint_rejects_host_sync_under_spmd_positions():
    """On the port's mesh of 4 positions (threads) too, before any runs."""
    sess = Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), device=CPU)),
                   check=True)
    sem = sess.semaphore()
    ran = []

    def proc(ctx, xs):
        ran.append(threading.current_thread())
        sem.acquire()
        sem.release()
        return xs.sum()

    with pytest.raises(CheckError, match="SPMD"):
        sess.run(proc, data=(torch.ones((8, 2)),))
    found = sess.findings()
    sess.checker.disable()
    assert [f.kind for f in found] == ["spmd-host-sync"]
    assert found[0].tids == (0, 1, 2, 3)
    assert all(t is threading.current_thread() for t in ran)


def _sparse_budget(pkg):
    sess = _host(pkg)
    sess.new_array("sp", (16,), sparse_k=100)    # k > pair_capacity(16)
    sess.def_global("dg", pkg.ones(16), sparse_k=100)
    found = sess.findings()
    sess.checker.disable()
    return found


def test_lint_sparse_budget_warning():
    found = _both(_sparse_budget)
    assert [f.kind for f in found] == ["sparse-overbudget"] * 2
    assert {f.severity for f in found} == {"warning"}   # advisory


def _delete_live(pkg):
    sess = _host(pkg, n_nodes=2, tpn=1)
    ref = sess.new_array("d", (4,))

    def proc(ctx):
        ref.get()                               # both nodes cache a replica
        return None

    sess.run(proc)
    sess.delete("d")
    found = sess.findings()
    assert "d" not in sess.names()              # the delete still happened
    sess.checker.disable()
    return found


def test_delete_with_live_replicas_warns():
    found = _both(_delete_live)
    assert [f.kind for f in found] == ["delete-live-replicas"]
    assert found[0].severity == "warning"
    assert "node(s) [0, 1]" in found[0].message


def _non_strict(pkg):
    ck = pkg.Checker(enabled=True, strict=False)
    try:
        sess = pkg.session(backend="host", n_nodes=1, threads_per_node=2,
                           check=ck)
        bar = sess.barrier(3)

        def proc(ctx):
            bar.enter(timeout=0.5)           # arity-broken but non-strict
            return None

        sess.run(proc)                       # no CheckError
        return sess.findings()
    finally:
        ck.disable()


def test_strict_false_records_without_raising():
    for pkg in (JAX, PORT):
        kinds = [f.kind for f in _non_strict(pkg)]
        assert "barrier-arity" in kinds, pkg.name
        # the broken program really ran: the dynamic layer reports the
        # starvation the lint predicted
        assert "starved-barrier" in kinds, pkg.name


def test_lint_shadow_store_is_a_copy():
    """A thread_proc that writes in place into what it read changes the real
    store in a real run, but never during the lint dry run."""
    sess = _host(PORT)
    ref = sess.new_array("v", (4,))
    obj = sess.new_object("o", {"w": torch.zeros(2)})
    lints = []
    driver = threading.current_thread()

    def proc(ctx):
        if threading.current_thread() is driver:
            lints.append(ctx.tid)
            ref.get().add_(1.0)              # in place, against the contract
            obj.get()["w"].add_(1.0)
            ref.inc(torch.ones(4))
        return None

    sess.run(proc)
    assert lints == [0, 1]
    assert torch.equal(sess.store.get("v"), torch.zeros(4))
    assert torch.equal(sess.store.get("o")["w"], torch.zeros(2))
    assert sess.findings() == []
    sess.checker.disable()


@pytest.mark.parametrize("backend", ["host", "spmd"])
def test_lint_splits_rows_as_the_backend(backend):
    """The dry run hands each tid the rows the backend will: the host's
    partition (remainder to low tids), the mesh's even split (ragged rows
    trimmed)."""
    if backend == "host":
        sess = Session(backend="host", n_nodes=2, threads_per_node=2,
                       device=CPU, check=True)
    else:
        sess = Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), device=CPU)),
                       check=True)
    seen = {"lint": {}, "run": {}}
    driver = threading.current_thread()

    def proc(ctx, xs):
        phase = "lint" if threading.current_thread() is driver else "run"
        seen[phase][ctx.tid] = xs[:, 0].tolist()
        return None

    rows = np.arange(22, dtype=np.float32).reshape(11, 2)
    with pytest.warns(UserWarning, match="ragged") if backend == "spmd" else nullcontext():
        sess.run(proc, data=(rows,))
    sess.checker.disable()
    assert seen["lint"] == seen["run"] and len(seen["run"]) == 4


def test_spmd_app_clean_under_armed_checker():
    x, y, _, _, _ = _app_data()
    sess = Session(backend=SpmdBackend(mesh=make_mesh((4,), ("data",), device=CPU)),
                   check=True)
    th, _ = logreg.fit(x, y, iters=3, mode="sparse", k=4, session=sess)
    found = sess.findings()
    sess.checker.disable()
    assert found == [] and np.all(np.isfinite(th))


# -- findings model / export --------------------------------------------------


def test_findings_dedupe_and_export_roundtrip(tmp_path):
    found = _seeded_rmw(PORT)
    assert len(found) == len({f.key() for f in found})
    ck = Checker(enabled=True)
    try:
        for f in found:
            ck.record(f)
            ck.record(f)                     # duplicate — dropped
        assert len(ck.findings()) == len(found)
        path = ck.export(str(tmp_path / "check.json"))
        with open(path) as fh:
            report = json.load(fh)
        assert report["count"] == len(found)
        assert set(report["by_layer"]) == {"race"}
        assert report["by_severity"]["error"] == len(found)
        for row in report["findings"]:
            assert {"layer", "kind", "severity", "message"} <= set(row)
    finally:
        ck.disable()


def test_finding_cap_counts_drops():
    ck = Checker(enabled=True, max_findings=2)
    try:
        for i in range(5):
            ck.record(Finding("race", "write-write", "error", f"m{i}",
                              name=f"n{i}"))
        assert len(ck.findings()) == 2 and ck.dropped == 3
    finally:
        ck.disable()


def test_null_checker_is_inert():
    assert not NULL_CHECKER.enabled
    NULL_CHECKER.on_access("x", "write", 1.0)   # all hooks are safe no-ops
    assert NULL_CHECKER.findings() == []


def test_as_checker_resolution():
    ck = Checker()
    assert stepcheck.as_checker(ck) is ck
    for arg, armed in ((None, False), (False, False), (True, True)):
        c = stepcheck.as_checker(arg)
        assert c.enabled is armed
        c.disable()


# -- the example is the documented repro ---------------------------------------


def test_race_demo_smoke():
    """examples/torch_race_demo.py on the CPU: flags the seeded race with
    both sites, stays silent on the synchronized variant."""
    path = os.path.join(ROOT, "examples", "torch_race_demo.py")
    lines = open(path).read().splitlines()
    read = next(i for i, s in enumerate(lines, 1) if "site A" in s)
    write = next(i for i, s in enumerate(lines, 1) if "site B" in s)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, path, "--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"torch_race_demo.py:{read}" in proc.stdout
    assert f"torch_race_demo.py:{write}" in proc.stdout
    assert re.search(r"synchronized program: 0 finding\(s\)", proc.stdout)
