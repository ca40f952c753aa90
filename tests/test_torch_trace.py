"""The port's step.trace (``repro_torch.core.telemetry``) on the session's
hot paths, mirroring ``tests/test_trace.py`` case by case, its FT cases
(recovery re-arming the tracer, the heartbeat payload) included.  Where a
count is the program's and not the clock's, it is held equal to repro's on
the same program."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.analytics import logreg as jlogreg  # noqa: E402
from repro.core import Session as JSession  # noqa: E402
from repro_torch.analytics import logreg  # noqa: E402
from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.core import Session, telemetry  # noqa: E402
from repro_torch.core.shards import ShardedStore  # noqa: E402
from repro_torch.core.telemetry import (  # noqa: E402
    CACHE_METRIC_KEYS, SESSION_METRIC_KEYS, STORE_METRIC_KEYS, Tracer)

CPU = "cpu"


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
    yield
    leaked = (telemetry.armed_count(), stepcheck.armed_count())
    telemetry.reset()
    stepcheck.reset()
    assert leaked == (0, 0), f"test left (tracers, checkers) armed: {leaked}"


def _logreg_data(n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    return x, y


# -- no-op by default ---------------------------------------------------------


def test_noop_by_default():
    assert telemetry.armed_count() == 0
    x, y = _logreg_data()
    theta, sess = logreg.fit(x, y, iters=2, n_nodes=1, threads_per_node=2,
                             device=CPU)
    assert not sess.tracer.enabled
    assert telemetry.TRACING is False
    snap = sess.tracer.snapshot()
    assert snap["events"] == 0
    assert snap["counters"] == {}
    assert snap["spans_by_category"] == {}
    assert sess.metrics()["trace"]["enabled"] is False


def test_arm_disarm_scoping():
    t1, t2 = Tracer(enabled=True), Tracer(enabled=True)
    try:
        assert telemetry.TRACING and telemetry.armed_count() == 2
        t1.disable()
        assert telemetry.TRACING and telemetry.armed_count() == 1
        t2.disable()
        assert not telemetry.TRACING and telemetry.armed_count() == 0
    finally:
        telemetry.reset()


# -- export round-trip from a 2-thread logreg run -----------------------------


def test_chrome_export_roundtrip_logreg(tmp_path):
    x, y = _logreg_data()
    sess = Session(backend="host", n_nodes=2, threads_per_node=1, trace=True,
                   device=CPU)
    try:
        logreg.fit(x, y, iters=3, session=sess)
        path = sess.tracer.export(str(tmp_path / "trace.json"))
        with open(path) as f:
            trace = json.load(f)
        events = trace["traceEvents"]
        cats = {e.get("cat") for e in events if e.get("ph") == "X"}
        for required in ("store-op", "barrier-wait", "accumulate-round",
                         "app-round"):
            assert required in cats, f"missing {required} spans in export"
        names = {(e["pid"], e["tid"]) for e in events
                 if e.get("ph") == "M" and e["name"] == "thread_name"}
        assert {(0, 0), (1, 1)} <= names
        for e in events:
            if e.get("ph") == "X":
                assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
    finally:
        sess.tracer.disable()


# -- span correctness under concurrency ---------------------------------------


def test_accumulate_span_counts_and_thread_attribution():
    N_NODES, TPN, R = 2, 2, 3
    N = N_NODES * TPN
    sess = Session(backend="host", n_nodes=N_NODES, threads_per_node=TPN,
                   trace=True, device=CPU)
    try:
        ref = sess.new_array("v", (32,))

        def proc(ctx, xs):
            def step(c):
                return c + ref.accumulate(xs.sum(0)).sum()
            return ctx.iterate(step, torch.tensor(0.0), R)

        sess.run(proc, data=(torch.ones((N * 2, 32)),))
        per_thread = sess.tracer.spans("accumulate-round", "accumulate")
        assert len(per_thread) == N * R
        reduces = sess.tracer.spans("accumulate-round", "accumulate.round")
        assert len(reduces) == R
        assert all(r["args"]["threads"] == N for r in reduces)
        by_tid = {}
        for e in per_thread:
            by_tid.setdefault((e["pid"], e["tid"]), []).append(e)
        assert len(by_tid) == N
        for timeline in by_tid.values():
            assert len(timeline) == R
            timeline.sort(key=lambda e: e["ts"])
            for a, b in zip(timeline, timeline[1:]):
                assert b["ts"] >= a["ts"] + a["dur"] - 1e-3
        waits = sess.tracer.spans("barrier-wait", "accumulate.barrier")
        assert len(waits) == N * R
        counters = sess.tracer.counters()
        assert counters["accumulate.rounds"] == R
        assert counters["accumulate.wire_elements"] == sess.wire_traffic()
    finally:
        sess.tracer.disable()


def test_barrier_semaphore_ssp_instrumentation():
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, trace=True,
                   device=CPU)
    try:
        bar = sess.barrier()
        sem = sess.semaphore(1)
        clock = sess.ssp_clock(staleness=0, n_workers=4)

        def proc(ctx, xs):
            sem.acquire()
            sem.release()
            ctx.barrier()          # backend run barrier (tracer attached)
            bar.enter()            # session-factory barrier
            clock.tick(ctx.tid)
            clock.wait(ctx.tid)
            return None

        sess.run(proc, data=(torch.ones((4, 4)),))
        snap = sess.tracer.snapshot()
        assert snap["ops"]["barrier.wait"]["count"] == 8
        assert len(sess.tracer.spans("barrier-wait", "barrier.wait")) == 8
        assert snap["ops"]["semaphore.queue_depth"]["count"] == 4
        assert snap["ops"]["semaphore.queue_depth"]["max"] >= 1
        assert len(sess.tracer.spans("sync", "semaphore.acquire")) == 4
        skew = snap["ops"]["ssp.skew"]
        assert skew["count"] == 4 and skew["max"] <= 1
    finally:
        sess.tracer.disable()


def test_store_op_shard_attribution_and_lock_wait():
    store = ShardedStore(CPU, shards=4)
    trc = Tracer(enabled=True)
    store.tracer = trc
    try:
        for i in range(32):
            store.def_global(f"n{i}", float(i))
            store.get(f"n{i}")
            store.inc(f"n{i}", 1.0)
        store.mget([f"n{i}" for i in range(32)])
        snap = trc.snapshot()
        assert snap["ops"]["store.get"]["count"] == 32
        assert snap["ops"]["store.inc"]["count"] == 32
        assert snap["ops"]["store.mget"]["count"] == 1
        per_shard = snap["ops_by_shard"]["store.get"]
        assert set(per_shard) == set(store.shard_ids())
        assert sum(row["count"] for row in per_shard.values()) == 32
        assert snap["ops"]["store.lock_wait"]["count"] > 0
        assert store.metrics()["gets"] >= 32
        assert set(store.metrics()) == set(STORE_METRIC_KEYS)
    finally:
        trc.disable()


# -- host <-> SPMD parity through metrics() -----------------------------------


def test_metrics_collective_bytes_parity_host_spmd():
    V, R = 128, 3
    rows = np.ones((2, V), np.float32)

    def run(backend):
        sess = Session(backend=backend, n_nodes=1, threads_per_node=1,
                       trace=True, device=CPU)
        try:
            out = sess.new_array("o", (V,))

            def proc(ctx, xs):
                def step(c):
                    return c + out.accumulate(xs.sum(0)).sum()
                return ctx.iterate(step, torch.tensor(0.0), R)

            res = sess.run(proc, data=(rows,))
            return res[0].numpy(), sess.metrics(), sess.tracer.counters()
        finally:
            sess.tracer.disable()

    r_h, m_h, c_h = run("host")
    r_s, m_s, c_s = run("spmd")
    np.testing.assert_allclose(r_h, r_s, rtol=1e-6)
    assert m_h["wire_traffic"] == m_s["wire_traffic"] == 2 * V * R
    assert c_h["accumulate.wire_elements"] == m_h["wire_traffic"]
    assert c_s["spmd.collective_elements"] == m_s["wire_traffic"]
    assert c_s["spmd.scan_trips"] == R and c_s["spmd.scan_sites"] == 1


def test_trace_counters_match_repro():
    """The program's own counts (rounds, wire elements, kernel paths, store
    ops) are the same in both packages for the same traced logreg run."""
    x, y = _logreg_data()
    counters, ops = [], []
    for sess, fit in ((JSession(backend="host", n_nodes=2, threads_per_node=2,
                                trace=True), jlogreg.fit),
                      (Session(backend="host", n_nodes=2, threads_per_node=2,
                               trace=True, device=CPU), logreg.fit)):
        try:
            fit(x, y, iters=3, mode="sparse", k=4, session=sess)
            counters.append({k: v for k, v in sess.tracer.counters().items()
                             if not k.startswith("store.owner")})
            snap = sess.tracer.snapshot()["ops"]
            ops.append({k: snap[k]["count"] for k in snap
                        if k.startswith("store.") and k != "store.lock_wait"})
        finally:
            sess.tracer.disable()
    assert counters[0] == counters[1] and counters[1]["accumulate.rounds"] == 3
    assert ops[0] == ops[1]


# -- stats unification: pinned key sets --------------------------------------


def test_metric_key_sets_pinned():
    x, y = _logreg_data()
    theta, sess = logreg.fit(x, y, iters=2, n_nodes=2, threads_per_node=1,
                             backend="host", device=CPU)
    m = sess.metrics()
    assert set(m) == set(SESSION_METRIC_KEYS)
    assert set(m["store"]) == set(STORE_METRIC_KEYS)
    assert set(m["cache"]) == set(CACHE_METRIC_KEYS)
    assert m["backend"] == "host"
    for sid, row in m["shards"].items():
        assert set(row) == {"store", "cache", "wire_traffic"}
        assert set(row["store"]) == set(STORE_METRIC_KEYS) | {"names"}
        assert set(row["cache"]) == set(CACHE_METRIC_KEYS)
    raw = sess.store.stats
    assert m["store"]["gets"] == raw["get"]
    assert m["store"]["bytes_written"] == raw["bytes_set"]
    assert m["cache"]["hits"] == sess.cache.stats.hits
    assert m["wire_traffic"] == sess.wire_traffic()


def test_cache_stats_attributes():
    """The cache's raw counters, which ``metrics()["cache"]`` is made from."""
    x, y = _logreg_data()
    theta, sess = logreg.fit(x, y, iters=2, n_nodes=2, threads_per_node=1,
                             device=CPU)
    cs = sess.cache.stats
    for attr in ("hits", "misses", "invalidations", "write_messages",
                 "missing_messages", "evictions", "hit_rate"):
        assert hasattr(cs, attr)
    assert cs.as_dict()["hits"] == cs.hits
    assert sess.metrics()["cache"] == cs.as_dict()


# -- recorder robustness ------------------------------------------------------


def test_event_cap_drops_counted():
    trc = Tracer(enabled=True, max_events=10)
    try:
        for i in range(25):
            t0 = trc.now()
            trc.add_span("store-op", "store.get", t0, t0)
        snap = trc.snapshot()
        assert snap["events"] == 10
        assert snap["dropped_events"] == 15
        assert snap["spans_by_category"]["store-op"] == 25
    finally:
        trc.disable()


def test_tracer_thread_safety_counters():
    trc = Tracer(enabled=True)
    try:
        def work():
            for _ in range(500):
                trc.count("x")
                trc.observe("y", 1.0, shard=0)
        ts = [threading.Thread(target=work) for _ in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        snap = trc.snapshot()
        assert snap["counters"]["x"] == 4000
        assert snap["ops"]["y"]["count"] == 4000
        assert snap["ops_by_shard"]["y"][0]["count"] == 4000
    finally:
        trc.disable()


def test_armed_checker_and_recorder_together():
    """check=True and record=True on one session: the checker's hooks and
    the record-only tracer run side by side, and both disarm."""
    x, y = _logreg_data()
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU,
                   check=True, record=True)
    try:
        logreg.fit(x, y, iters=3, mode="sparse", k=4, session=sess)
        assert sess.findings() == []
        snap = sess.tracer.snapshot()
        assert snap["record_only"] and snap["counters"]["accumulate.rounds"] == 3
        assert snap["events"] == 0            # record-only: the ring alone
    finally:
        sess.checker.disable()
        sess.recorder.close()


# -- FT integration -----------------------------------------------------------


def test_recovery_rearms_tracer():
    """session_recovery's replacement session adopts the dead session's
    tracer (still armed) and keeps recording into the same timeline."""
    from repro_torch.ft import session_recovery

    sess = Session(backend="host", n_nodes=2, threads_per_node=1, shards=2,
                   trace=True, device=CPU)
    try:
        ref = sess.new_array("w", (16,))
        sess.run(lambda ctx, xs: ref.accumulate(xs.sum(axis=0)), data=(torch.ones(2, 16),))
        before = sess.tracer.snapshot()["events"]
        assert before > 0
        plan, new_sess = session_recovery(sess, [1])
        assert new_sess.tracer is sess.tracer and new_sess.tracer.enabled
        assert new_sess.store.tracer is sess.tracer
        ref2 = new_sess.ref("w")
        new_sess.run(lambda ctx, xs: ref2.accumulate(xs.sum(axis=0)), data=(torch.ones(1, 16),))
        assert new_sess.tracer.snapshot()["events"] > before
    finally:
        sess.tracer.disable()


def test_heartbeat_metrics_payload():
    """metrics_payload over the same program in both packages: the same
    keys, wire traffic and barrier-wait count (the latencies are clocks)."""
    from repro.ft import metrics_payload as jmetrics_payload
    from repro_torch.ft import metrics_payload

    payloads = []
    for sess, ones in ((Session(backend="host", n_nodes=1, threads_per_node=2, trace=True,
                                device=CPU), torch.ones),
                       (JSession(backend="host", n_nodes=1, threads_per_node=2, trace=True),
                        jnp.ones)):
        try:
            ref = sess.new_array("v", (8,))

            def proc(ctx, xs):
                ref.accumulate(xs.sum(axis=0))
                ctx.barrier()
                return None

            sess.run(proc, data=(ones((2, 8)),))
            fn = metrics_payload if isinstance(sess, Session) else jmetrics_payload
            payloads.append(fn(sess))
        finally:
            sess.tracer.disable()
    ours, theirs = payloads
    assert ours["trace_enabled"] is True
    assert ours["barrier_wait_us"]["count"] >= 2
    assert ours["barrier_wait_us"]["p99"] >= ours["barrier_wait_us"]["p50"]
    assert ours["op_rates"]["store.set"] > 0
    assert list(ours) == list(theirs) and set(ours["op_rates"]) == set(theirs["op_rates"])
    for key in ("wire_traffic", "rebalance", "record_armed"):
        assert ours[key] == theirs[key], key
    assert ours["barrier_wait_us"]["count"] == theirs["barrier_wait_us"]["count"]
