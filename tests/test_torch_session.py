"""The port's host Session, store and cache against repro's (the host half
of test_session.py, plus store and cache basics)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Session as JSession  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core.dsm import GlobalStore as JStore  # noqa: E402
from repro_torch.core import GlobalStore, HostBackend, Session, load_numpy_state  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _host(**kw):
    return Session(backend="host", device=CPU, **kw)


def test_handles_def_get_set_inc():
    sess = _host()
    x = sess.def_global("x", torch.arange(4.0))
    assert torch.equal(x.get(), torch.arange(4.0))
    x.set(torch.ones(4))
    assert x.epoch == 1
    assert torch.equal(x.inc(2.0), torch.full((4,), 3.0))
    arr = sess.new_array("a", (8,))
    assert arr.get().shape == (8,) and arr.get().device.type == "cpu"
    obj = sess.new_object("o", {"w": torch.ones(2, 2), "b": torch.zeros(2)})
    assert set(obj.get()) == {"w", "b"}
    assert x.address != arr.address
    obj.delete()
    with pytest.raises(KeyError):
        sess.ref("o")


def test_store_addresses_epochs_and_stats_match_repro():
    """The same declarations and ops give the same addresses, epochs, shard
    placement and store counters in both packages."""
    js, ts = JStore(shards=4), GlobalStore(CPU, shards=4)
    for s, arr in ((js, jnp.asarray), (ts, torch.as_tensor)):
        s.def_global("g", arr(np.arange(5, dtype=np.float32)))
        s.new_array("a", (300,))
        s.new_object("o", {"w": arr(np.ones((3, 3), np.float32)),
                           "b": arr(np.zeros(3, np.float32))})
        s.set("g", arr(np.ones(5, np.float32)))
        s.inc("g", 1.0)
        s.get("a")
        s.mget(["g", "a", "o"])
        s.delete("a")
        s.new_array("a", (7,))
    for name in ("g", "a", "o"):
        assert ts.address(name) == js.address(name)
        assert ts.epoch(name) == js.epoch(name)
        assert ts.shard_of(name) == js.shard_of(name)
    assert ts.stats == js.stats
    assert ts.shard_stats() == js.shard_stats()
    assert ts.metrics() == js.metrics()
    assert ts.tier_stats() == js.tier_stats()
    assert ts.migration_totals() == js.migration_totals()
    assert np.array_equal(ts.get("g").numpy(), np.asarray(js.get("g")))


def test_store_canonicalises_dtypes_like_jax():
    ts = GlobalStore(CPU)
    ts.def_global("f", np.arange(3, dtype=np.float64))
    ts.def_global("i", 7)
    assert ts.get("f").dtype == torch.float32 and ts.get("i").dtype == torch.int32
    src = np.zeros(3, np.float32)
    ts.def_global("n", src)
    src[0] = 9.0                          # the caller's array is not aliased
    assert float(ts.get("n")[0]) == 0.0


def test_accumulate_outside_worker_is_an_error():
    out = _host().new_array("out", (4,))
    with pytest.raises(RuntimeError, match="collective"):
        out.accumulate(torch.ones(4))


def test_spawn_accumulate_traffic_and_metrics():
    sess = _host(n_nodes=2, threads_per_node=2)
    out = sess.new_array("out", (16,))

    def proc(ctx):
        total = out.accumulate(torch.ones(16))
        return float(total[0])

    assert sess.run(proc) == [4.0] * 4
    assert sess.accumulator("out").bytes_transferred == (4 + 1) * 16
    assert sess.wire_traffic() == (4 + 1) * 16
    m = sess.metrics()
    assert m["cache"]["hits"] + m["cache"]["misses"] >= 4
    assert tuple(m) == jtelemetry.SESSION_METRIC_KEYS == telemetry.SESSION_METRIC_KEYS
    assert set(m["store"]) == set(jtelemetry.STORE_METRIC_KEYS)
    assert set(m["cache"]) == set(jtelemetry.CACHE_METRIC_KEYS)
    assert sum(r["wire_traffic"] for r in m["shards"].values()) == 80


def test_session_parity_from_shared_state():
    """load_numpy_state seeds the port from a repro store's values; the same
    thread_proc (get, accumulate, set over three rounds) then gives the same
    values, wire traffic and cache message counts in both packages."""
    rng = np.random.default_rng(0)
    j = JSession(backend="host", n_nodes=2, threads_per_node=2)
    j.def_global("w", jnp.asarray(rng.normal(size=32).astype(np.float32)))
    j.def_global("step", jnp.asarray(np.float32(0.5)))
    t = _host(n_nodes=2, threads_per_node=2)
    load_numpy_state(t.store, {n: np.asarray(j.store.get(n)) for n in ("w", "step")})
    data = rng.normal(size=(40, 32)).astype(np.float32)

    def make(sess):
        w, step = sess.ref("w"), sess.ref("step")
        g = sess.new_array("g", (32,))

        def proc(ctx, xs):
            # bulk-synchronous: each thread carries w and every thread sets
            # the same re-derived value after the round's accumulate
            def body(wl):
                total = g.accumulate((xs * (xs @ wl)[:, None]).sum(0),
                                     mode="reduce_scatter")
                wl = wl - step.get() * total / 1000.0
                w.set(wl)
                return wl
            return ctx.iterate(body, w.get(), 3)
        return proc

    j.run(make(j), data=(jnp.asarray(data),))
    t.run(make(t), data=(data,))
    np.testing.assert_allclose(t.store.get("w").numpy(), np.asarray(j.store.get("w")),
                               rtol=1e-5, atol=1e-6)
    assert t.wire_traffic() == j.wire_traffic() == 3 * (4 + 1) * 32
    jc, tc = j.cache.stats, t.cache.stats
    assert (tc.hits + tc.misses, tc.write_messages) == (jc.hits + jc.misses, jc.write_messages)


def test_data_partitioning_and_broadcast():
    sess = _host(n_nodes=2, threads_per_node=2)

    def proc(ctx, shard, rep):
        assert rep.shape == (3,) and shard.device.type == "cpu"
        return (float(shard[0]), int(shard.shape[0]))

    res = sess.run(proc, data=(np.arange(9.0),), broadcast=(np.full(3, 7.0),))
    assert [r[1] for r in res] == [3, 2, 2, 2]       # remainder to low tids
    assert [r[0] for r in res] == [0.0, 3.0, 5.0, 7.0]


def test_sync_factories():
    sess = _host(n_nodes=1, threads_per_node=3)
    assert sess.barrier().count == 3
    assert sess.ssp_clock(staleness=1).staleness == 1
    s = sess.semaphore(2)
    assert s.acquire() and s.acquire()
    assert s.acquire(timeout=0.01) is False


def test_accumulator_inspection_resolves_per_call_budget():
    sess = _host(n_nodes=2, threads_per_node=2)
    out = sess.new_array("g", (64,))
    sess.run(lambda ctx: out.accumulate(torch.ones(64), mode="sparse", k=8))
    accu = sess.accumulator("g", "sparse")
    assert accu.k == 8 and accu.bytes_transferred > 0
    assert sess.accumulator("g") is accu


def test_delete_redeclare_no_stale_read():
    sess = _host(n_nodes=1, threads_per_node=1)
    v = sess.def_global("v", torch.full((4,), 1.0))
    assert sess.run(lambda ctx: float(v.get()[0])) == [1.0]   # node 0 caches it
    v.delete()
    with pytest.raises(KeyError):
        sess.ref("v")
    v2 = sess.def_global("v", torch.full((4,), 7.0))
    assert sess.run(lambda ctx: float(v2.get()[0])) == [7.0]
    sess.new_array("g", (8,), sparse_k=4)
    assert sess.sparse_k("g") == 4
    sess.delete("g")
    sess.new_array("g", (8,))
    assert sess.sparse_k("g") is None


def test_inc_is_atomic_under_contention():
    sess = _host(n_nodes=4, threads_per_node=1)
    counter = sess.def_global("counter", 0.0)

    def proc(ctx):
        for _ in range(50):
            counter.inc(1.0)

    sess.run(proc)
    assert float(counter.get()) == 200.0


def test_cache_hits_and_invalidations():
    sess = _host(n_nodes=2, threads_per_node=1)
    x = sess.def_global("x", torch.zeros(4))
    barrier = sess.barrier()

    def proc(ctx):
        x.get()
        x.get()                            # second read: a replica hit
        barrier.enter()
        if ctx.tid == 0:
            x.set(torch.ones(4))           # invalidates node 1's replica
        barrier.enter()
        return float(x.get()[0])

    assert sess.run(proc) == [1.0, 1.0]
    st = sess.cache.stats
    assert st.hits >= 2 and st.invalidations == 1


def test_worker_failure_surfaces_at_join():
    sess = _host(n_nodes=1, threads_per_node=2)

    def proc(ctx):
        if ctx.tid == 1:
            raise ValueError("boom")

    with pytest.raises(RuntimeError, match="failed") as info:
        sess.run(proc, timeout=10)
    assert isinstance(info.value.__cause__, ValueError)


def test_tracing_spans_and_disable():
    sess = _host(n_nodes=1, threads_per_node=2, trace=True)
    try:
        out = sess.new_array("out", (8,))
        sess.run(lambda ctx: ctx.iterate(lambda c: out.accumulate(torch.ones(8)), None, 3))
        assert len(sess.tracer.spans("accumulate-round", "accumulate")) == 2 * 3
        assert sess.metrics()["trace"]["enabled"]
    finally:
        sess.tracer.disable()
    assert telemetry.armed_count() == 0


@pytest.mark.parametrize("kwargs", [dict(check=True),
                                    dict(record=True), dict(cold_tier="host"),
                                    dict(cold_budget=1024)])
def test_features_of_later_slices_raise(kwargs):
    """step.check, step.obs and step.tiers are ported: check=True and
    record=True arm (and disarm); cold_tier and cold_budget plumb into the
    store and report its tiers as repro's session does."""
    from repro_torch.check import checker as stepcheck

    if "check" in kwargs:
        sess = Session(device=CPU, **kwargs)
        assert sess.checker.enabled and stepcheck.armed_count() == 1
        assert sess.findings() == []
        sess.checker.disable()
        assert stepcheck.armed_count() == 0
    elif "record" in kwargs:
        sess = Session(device=CPU, **kwargs)
        assert sess.recorder.armed and sess.tracer.record_only
        assert telemetry.armed_count() == 1
        sess.recorder.close()
        assert telemetry.armed_count() == 0
    else:
        sess, jsess = Session(device=CPU, **kwargs), JSession(**kwargs)
        for ses, arr in ((sess, torch.as_tensor), (jsess, jnp.asarray)):
            for i in range(3):
                ses.new_array(f"t{i}", (256,)).set(arr(np.full(256, i, np.float32)))
        assert sess.metrics()["tiers"] == jsess.metrics()["tiers"]
        assert (sess.store.cold_tier is None) == ("cold_tier" not in kwargs)
        assert sess.metrics()["tiers"]["budget_bytes"] == kwargs.get("cold_budget")


def test_session_methods_of_later_slices_raise():
    """lower() stays a non-goal; findings, watchdog and openmetrics answer."""
    from repro_torch.obs import Watchdog

    sess = _host()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sess.lower(lambda ctx: None)
    assert sess.findings() == []
    assert isinstance(sess.watchdog(), Watchdog)
    text = sess.openmetrics()
    assert isinstance(text, str) and text.endswith("# EOF\n")


def test_adopted_store_device_and_fused_backend():
    store = GlobalStore(CPU)
    sess = Session(backend=HostBackend(1, 2, fused=False), store=store)
    assert sess.device == store.device and sess.backend.fused is False
