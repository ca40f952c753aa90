"""The port's step.obs (``repro_torch.obs``) against repro's.

Mirrors ``tests/test_obs.py`` case by case: the flight recorder over the
port's tracer, the watchdog's detectors (a stalled migration window on a
real store, tier thrash on a fake store as repro's test has it and on a real
cold tier, heartbeats through the port's ``HeartbeatMonitor``), the FT layer
(session recovery's flight dump, heartbeat payloads, metrics during an open
migration window and with a cold tier), the OpenMetrics export and
step_top's render.  The export and the render must give the same bytes as
repro's for one metrics dict, with and without anomalies and under a custom
prefix.  Every test leaves no tracer and no checker armed.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core.session import Session as JSession  # noqa: E402
from repro.obs import Anomaly as JAnomaly  # noqa: E402
from repro.obs import openmetrics as jopenmetrics  # noqa: E402
from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.core import SpmdBackend, make_mesh, telemetry  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.telemetry import Hist, RingSink, Tracer  # noqa: E402
from repro_torch.obs import (ANOMALY_KINDS, SEVERITIES, Anomaly,  # noqa: E402
                             FlightRecorder, Watchdog, as_recorder, openmetrics, top)

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
    """TRACING and CHECKING are process-wide: a test that arms a recorder,
    a tracer or a checker of the port disarms it before returning."""
    yield
    leaked = (telemetry.armed_count(), stepcheck.armed_count())
    telemetry.reset()
    stepcheck.reset()
    assert leaked == (0, 0), f"test left (tracers, checkers) armed: {leaked}"


def _host(**kw):
    return Session(backend="host", device=CPU, **kw)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_recorder_arms_record_only_and_close_disarms():
    trc = Tracer(enabled=False)
    rec = FlightRecorder(capacity=64)
    rec.attach(trc)
    assert trc.enabled and trc.record_only and rec.armed
    assert trc.ring is not None and trc.ring.capacity == 64
    assert telemetry.armed_count() == 1
    rec.close()
    assert not trc.enabled and not trc.record_only and not rec.armed
    assert telemetry.armed_count() == 0


def test_recorder_leaves_user_enabled_tracer_running():
    trc = Tracer(enabled=True)
    try:
        rec = FlightRecorder()
        rec.attach(trc)
        assert not trc.record_only          # full tracing continues
        assert rec.armed                    # but the ring is hung off it
        rec.close()
        assert trc.enabled                  # close only undoes what it did
    finally:
        trc.disable()


def test_ring_sink_bounded_overwrite_oldest():
    ring = RingSink(capacity=4)
    for i in range(6):
        ring.append({"i": i})
    assert len(ring) == 4 and ring.total == 6
    assert [e["i"] for e in ring.snapshot()] == [2, 3, 4, 5]
    with pytest.raises(ValueError):
        RingSink(capacity=0)


def test_record_only_fast_ops_leave_no_events():
    trc = Tracer(enabled=False)
    rec = FlightRecorder()
    rec.attach(trc)
    try:
        t0 = trc.now()
        trc.store_op("get", 0, t0)          # microseconds: under slow_us
        snap = trc.snapshot()
        assert snap["events"] == 0          # unbounded list never grows
        assert snap["ops"]["store.get"]["count"] == 1  # hist still fed
        trc.mark("migration", "window.open", pending=3)
        names = [e["name"] for e in rec.events()]
        assert "window.open" in names       # marks always reach the ring
    finally:
        rec.close()


def test_record_only_slow_span_reaches_ring():
    trc = Tracer(enabled=False)
    rec = FlightRecorder(slow_us=10.0)      # 10µs threshold for the test
    rec.attach(trc)
    try:
        t0 = trc.now()
        time.sleep(0.005)
        trc.add_span("store-op", "store.get", t0, trc.now())
        assert any(e["name"] == "store.get" for e in rec.events())
        assert trc.snapshot()["events"] == 0
    finally:
        rec.close()


def test_dump_round_trips_json():
    trc = Tracer(enabled=False)
    rec = FlightRecorder()
    rec.attach(trc)
    try:
        trc.mark("lifecycle", "hello", n=1)
        back = json.loads(json.dumps(rec.dump(reason="unit")))
        assert back["reason"] == "unit"
        assert back["ring"]["held"] >= 1
        assert any(e["name"] == "hello" for e in back["events"])
    finally:
        rec.close()


def test_recorder_export_writes_json(tmp_path):
    trc = Tracer(enabled=False)
    rec = FlightRecorder()
    rec.attach(trc)
    try:
        trc.mark("anomaly", "synthetic")
        path = rec.export(str(tmp_path / "dump.json"), reason="export-test")
        data = json.load(open(path))
        assert data["reason"] == "export-test"
        assert data["events"]
    finally:
        rec.close()


def test_disabled_recorder_dumps_no_events():
    rec = FlightRecorder(enabled=False).attach(Tracer(enabled=False))
    dump = rec.dump()
    assert not rec.armed and dump["events"] == []
    assert dump["ring"] == {"capacity": 4096, "held": 0, "total": 0}


def test_as_recorder_resolution():
    assert as_recorder(True).enabled
    assert not as_recorder(False).enabled
    assert not as_recorder(None).enabled
    rec = FlightRecorder(capacity=8)
    assert as_recorder(rec) is rec


def test_session_record_true_end_to_end():
    sess = _host(shards=2, record=True)
    try:
        ref = sess.new_array("obs_x", (32,))
        ref.set(torch.ones(32))
        ref.get()
        m = sess.metrics()
        assert m["trace"]["record_only"]
        assert m["trace"]["ring"] is not None
        assert m["trace"]["ops"]["store.set"]["count"] >= 1
    finally:
        sess.recorder.close()
    assert telemetry.armed_count() == 0


def test_record_only_lock_wait_keeps_true_waits_alone():
    """Under an armed recorder the store records a shard lock's wait only
    when it waited (>= 1 µs), as repro's store does; full tracing records
    every acquisition."""
    for record, trace in ((True, None), (None, True)):
        sess = _host(record=record, trace=trace)
        try:
            ref = sess.new_array("lw", (4,))
            for _ in range(50):
                ref.get()
            waits = sess.tracer.hist("store.lock_wait")
            count = 0 if waits is None else waits["count"]
            assert (count < 51) if record else (count >= 51)
        finally:
            sess.recorder.close()
            sess.tracer.disable()


# ---------------------------------------------------------------------------
# Hist reservoir: late-run outliers must still move p99 (same as repro's)
# ---------------------------------------------------------------------------


def test_hist_reservoir_late_outliers_move_p99():
    h, jh = Hist(), jtelemetry.Hist()
    for _ in range(100_000):
        h.add(100.0)
        jh.add(100.0)
    assert h.snapshot()["p99"] == 100.0
    for _ in range(5_000):
        h.add(10_000.0)
        jh.add(10_000.0)
    snap = h.snapshot()
    assert snap["p99"] == 10_000.0 and snap["p50"] == 100.0
    assert snap["count"] == 105_000 and snap["max"] == 10_000.0
    assert snap == jh.snapshot()


def test_hist_reservoir_deterministic():
    a, b = Hist(), jtelemetry.Hist()
    for v in (float((i * 37) % 1013) for i in range(20_000)):
        a.add(v)
        b.add(v)
    assert a.snapshot() == b.snapshot()     # seeded xorshift: no run jitter


# ---------------------------------------------------------------------------
# watchdog: live sync waits
# ---------------------------------------------------------------------------


def _poll_until(wd, seconds=5.0):
    deadline = time.monotonic() + seconds
    fired = []
    while not fired and time.monotonic() < deadline:
        time.sleep(0.05)
        fired = wd.poll_once()
    return fired


def test_watchdog_detects_slow_barrier_straggler():
    sess = _host(record=True)
    try:
        bar = sess.barrier(2)                       # seeded straggler: one
        done = threading.Event()                    # enter, partner never comes

        def straggler():
            bar.enter(timeout=10.0)
            done.set()

        t = threading.Thread(target=straggler, daemon=True)
        t.start()
        wd = sess.watchdog(min_barrier_slo_us=20_000.0)  # 20ms SLO
        fired = _poll_until(wd)
        assert fired, "straggler not detected within deadline"
        a = fired[0]
        assert a.kind == "slow-barrier"
        assert a.details["wait_us"] >= 20_000.0
        assert a.details["waiters"] == 1
        assert a.dump is not None and a.dump["events"]  # anomaly mark at least
        json.dumps(a.as_dict())
        bar.enter(timeout=1.0)                      # release the straggler
        assert done.wait(2.0)
        t.join(timeout=2.0)
        assert bar.oldest_wait_start() is None
    finally:
        sess.recorder.close()


def test_watchdog_slow_semaphore():
    sess = _host(record=True)
    try:
        sem = sess.semaphore(1)
        sem.acquire()
        blocked = threading.Thread(
            target=lambda: (sem.acquire(timeout=10.0), sem.release()),
            daemon=True)
        blocked.start()
        wd = sess.watchdog(min_semaphore_slo_us=20_000.0)
        fired = _poll_until(wd)
        assert fired and fired[0].kind == "slow-semaphore"
        sem.release()
        blocked.join(timeout=2.0)
    finally:
        sess.recorder.close()


def test_watchdog_sees_the_run_barrier_and_drops_dead_primitives():
    sess = _host(n_nodes=1, threads_per_node=2)
    assert sess.backend.run_barrier in set(sess._watch_prims)
    b = sess.barrier()
    assert b in set(sess._watch_prims)
    del b
    import gc
    gc.collect()
    assert len(sess._watch_prims) == 1     # weak: only the run barrier


# ---------------------------------------------------------------------------
# watchdog: remaining detectors (fake sessions keep these deterministic, as in repro's)
# ---------------------------------------------------------------------------


class _FakeStore:
    def __init__(self):
        self.migration_window = None
        self._tiers = {"promotions": 0, "demotions": 0}

    def tier_stats(self):
        return dict(self._tiers)


class _FakeSession:
    def __init__(self, record=False):
        self.store = _FakeStore()
        self.tracer = Tracer(enabled=False)
        self.recorder = FlightRecorder().attach(self.tracer) if record else None
        self._watch_prims = set()


def test_watchdog_detects_stalled_migration_window():
    sess = _host(shards=2, record=True)
    try:
        for i in range(48):
            sess.new_array(f"mig{i}", (16,))
        sess.store.add_shard(drain=False)           # seed the stall
        win = sess.store.migration_window
        assert win is not None and win.remaining > 0
        wd = sess.watchdog(migration_deadline_s=0.15)
        assert wd.poll_once() == []                 # first poll: baseline
        fired = _poll_until(wd)
        assert fired, "stalled window not detected within deadline"
        a = fired[0]
        assert a.kind == "stalled-migration" and a.severity == "error"
        assert a.details["remaining"] == win.remaining > 0
        assert a.dump is not None and a.dump["events"]
        assert any(e["name"] == "window.open" for e in a.dump["events"])
        assert json.loads(json.dumps(a.as_dict()))["kind"] == "stalled-migration"
        sess.store.migrate_step(1)                  # progress resets the clock
        wd._seen.clear()
        assert wd.poll_once() == []
        sess.store.drain_window()
        assert sess.store.migration_window is None and wd.poll_once() == []
    finally:
        sess.store.drain_window()
        sess.recorder.close()


def test_watchdog_dump_dir_writes_anomaly_files(tmp_path):
    sess = _host(record=True)
    try:
        for i in range(48):
            sess.new_array(f"dd{i}", (8,))
        sess.store.add_shard(drain=False)
        wd = sess.watchdog(migration_deadline_s=0.05, dump_dir=str(tmp_path))
        wd.poll_once()
        time.sleep(0.1)
        fired = wd.poll_once()
        assert fired
        path = fired[0].details["dump_path"]
        assert os.path.exists(path)
        data = json.load(open(path))
        assert data["kind"] == "stalled-migration"
        assert data["dump"]["events"]               # the anomaly mark
    finally:
        sess.store.drain_window()
        sess.recorder.close()


def test_watchdog_tier_thrash():
    sess = _FakeSession()
    wd = Watchdog(sess, thrash_min_moves=16, cooldown_s=0.0)
    assert wd.poll_once() == []                     # baseline window
    sess.store._tiers = {"promotions": 40, "demotions": 38}
    fired = wd.poll_once()
    assert [a.kind for a in fired] == ["tier-thrash"]
    assert fired[0].details["promotions"] == 40
    # one-sided movement (a legitimate spill) is NOT thrash
    sess.store._tiers = {"promotions": 40, "demotions": 138}
    assert wd.poll_once() == []


def test_watchdog_tier_thrash_on_a_real_cold_tier():
    """Reads cycling over more entries than the hot budget holds: each read
    promotes one entry and demotes another, and the watchdog calls it
    thrash; a one-sided spill of fresh declarations is not."""
    sess = _host(cold_tier="host", cold_budget=4 * 1024)
    refs = [sess.new_array(f"tt{i}", (256,)) for i in range(8)]   # 1 KiB each
    wd = sess.watchdog(thrash_min_moves=16, cooldown_s=0.0)
    assert wd.poll_once() == []                     # baseline: the spill
    for _ in range(4):
        for r in refs:
            r.get()
    fired = wd.poll_once()
    tiers = sess.store.tier_stats()
    assert [a.kind for a in fired] == ["tier-thrash"], tiers
    assert fired[0].details["promotions"] >= 16
    assert tiers["hot"]["bytes"] <= 4 * 1024 and tiers["cold_entries"] == 4
    for i in range(8, 24):                          # new names only spill
        sess.new_array(f"tt{i}", (256,))
    assert wd.poll_once() == []


def test_watchdog_lock_wait_outlier():
    sess = _FakeSession()
    trc = sess.tracer
    for sid in range(3):                            # three quiet shards
        for _ in range(50):
            trc.observe("store.lock_wait", 10.0, shard=sid)
    for _ in range(50):                             # one hot shard
        trc.observe("store.lock_wait", 90_000.0, shard=3)
    wd = Watchdog(sess, min_lock_wait_us=1_000.0, lock_wait_factor=8.0)
    fired = wd.poll_once()
    assert [a.kind for a in fired] == ["lock-wait-outlier"]
    assert fired[0].details["shard"] == 3
    assert fired[0].details["p99_us"] >= 90_000.0


def test_watchdog_cooldown_dedups_repeat_fires():
    sess = _FakeSession()
    wd = Watchdog(sess, thrash_min_moves=16, cooldown_s=60.0)
    wd.poll_once()
    sess.store._tiers = {"promotions": 40, "demotions": 38}
    assert len(wd.poll_once()) == 1
    sess.store._tiers = {"promotions": 80, "demotions": 76}
    assert wd.poll_once() == []                     # same incident, cooled down


def test_watchdog_daemon_thread_lifecycle():
    sess = _FakeSession()
    with Watchdog(sess, interval_s=0.01) as wd:
        time.sleep(0.05)
        assert wd._thread is not None and wd._thread.is_alive()
    assert wd._thread is None
    assert wd.polls >= 1 and wd.errors == []


def test_watchdog_daemon_keeps_a_failed_poll():
    """A poll that raises neither kills the daemon nor vanishes."""
    sess = _FakeSession()
    sess.store.tier_stats = lambda: 1 / 0
    with Watchdog(sess, interval_s=0.01) as wd:
        deadline = time.monotonic() + 5.0
        while len(wd.errors) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(wd.errors) >= 2 and wd.errors[0].startswith("ZeroDivisionError")


def test_watchdog_heartbeat_escalation():
    """The port's HeartbeatMonitor, beating metrics_payload: each dead node
    fires before the monitor's own on_failure runs."""
    from repro_torch.ft import HeartbeatMonitor, metrics_payload

    sess = _host(record=True)
    try:
        recovered = []
        mon = HeartbeatMonitor([0, 1], timeout=10.0, on_failure=recovered.append)
        wd = sess.watchdog()
        assert wd.watch_heartbeats(mon) is mon
        mon.beat(1, metrics_payload(sess))
        mon.declare_dead(1)
        assert recovered == [[1]]                   # original callback ran
        assert [a.kind for a in wd.anomalies] == ["dead-heartbeat"]
        a = wd.anomalies[0]
        assert a.severity == "critical" and a.details["node"] == 1
        assert a.details["last_payload"]["record_armed"] is True
        assert a.dump is not None
    finally:
        sess.recorder.close()


def test_session_recovery_attaches_flight_dump():
    from repro_torch.ft import session_recovery

    sess = _host(n_nodes=2, threads_per_node=1, record=True)
    new_sess = None
    try:
        sess.new_array("theta", (16,)).set(torch.zeros(16))
        plan, new_sess = session_recovery(sess, [1])
        assert plan.flight_dump is not None
        assert plan.flight_dump["reason"] == "session-recovery"
        assert any(e["name"] == "session_recovery" for e in plan.flight_dump["events"])
        json.dumps(plan.flight_dump)
        assert new_sess.recorder is sess.recorder and new_sess.recorder.armed
    finally:
        (new_sess or sess).recorder.close()
    assert telemetry.armed_count() == 0


def test_session_recovery_without_recorder_has_no_dump():
    from repro_torch.ft import session_recovery

    sess = _host(n_nodes=2, threads_per_node=1)
    plan, new_sess = session_recovery(sess, [1])
    assert plan.flight_dump is None
    assert not new_sess.recorder.armed


def test_metrics_payload_keys_pinned():
    from repro.ft import metrics_payload as jmetrics_payload
    from repro_torch.ft import PAYLOAD_KEYS, REBALANCE_KEYS, metrics_payload

    sess = _host(shards=2)
    payload = metrics_payload(sess)
    assert tuple(payload.keys()) == PAYLOAD_KEYS
    assert tuple(payload["rebalance"].keys()) == REBALANCE_KEYS
    assert payload["trace_enabled"] is False and payload["record_armed"] is False
    assert payload["rebalance"]["windows"] == 0 and payload["rebalance"]["open"] is False
    assert payload == jmetrics_payload(JSession(backend="host", shards=2))


def test_metrics_payload_rebalance_keys_without_migration_support():
    from repro_torch.ft import REBALANCE_KEYS, metrics_payload

    class _BareStore:                      # no migration_totals at all
        pass

    class _BareSession:
        store = _BareStore()
        tracer = Tracer(enabled=False)
        recorder = None

        def wire_traffic(self):
            return 0

    payload = metrics_payload(_BareSession())
    assert tuple(payload["rebalance"].keys()) == REBALANCE_KEYS
    assert payload["rebalance"]["pending"] == 0


def test_metrics_concurrent_with_open_migration_window():
    sess = _host(shards=4, trace=True)
    try:
        for i in range(64):
            sess.new_array(f"cw{i}", (32,))
        sess.store.add_shard(drain=False)
        assert sess.store.migration_window is not None
        moved_seq, errors = [], []

        def poller():
            try:
                for _ in range(200):
                    m = sess.metrics()
                    mig = m["tiers"]["migration"]
                    moved_seq.append((mig["entries_moved"], mig["pulled"]))
                    assert isinstance(m["shards"], dict)
            except Exception as e:  # pragma: no cover - the failure signal
                errors.append(e)

        t = threading.Thread(target=poller)
        t.start()
        while sess.store.migration_window is not None:
            sess.store.migrate_step(2)              # drain concurrently
        t.join(timeout=30)
        assert not t.is_alive() and not errors, errors[:1]
        assert moved_seq == sorted(moved_seq)       # monotonic across the drain
        m = sess.metrics()
        assert m["tiers"]["migration"]["open"] is False
        assert m["tiers"]["migration"]["entries_moved"] >= 1
    finally:
        sess.tracer.disable()


def test_metrics_tiers_section_with_cold_tier():
    """The hot budget is per shard: 1 KiB holds one 256-float entry, so a
    shard owning two or more names has spilled; the section equals repro's
    for the same ops."""
    tiers = []
    for sess, arr in ((_host(shards=2, cold_tier="host", cold_budget=1 << 10), torch.ones),
                      (JSession(backend="host", shards=2, cold_tier="host",
                                cold_budget=1 << 10), jnp.ones)):
        for i in range(8):
            sess.new_array(f"tz{i}", (256,)).set(arr(256))
        tiers.append(sess.metrics()["tiers"])
    assert tiers[0]["kind"] == "host"
    assert tiers[0]["demotions"] >= 1 and tiers[0]["cold_entries"] >= 1
    assert tiers[0]["hot"]["bytes"] <= 2 * (1 << 10)
    assert tiers[0] == tiers[1]


def test_anomaly_catalogue_is_stable():
    from repro.obs import ANOMALY_KINDS as J_KINDS, SEVERITIES as J_SEVERITIES

    assert ANOMALY_KINDS == J_KINDS == (
        "stalled-migration", "slow-barrier", "slow-semaphore", "tier-thrash",
        "lock-wait-outlier", "dead-heartbeat")
    assert SEVERITIES == J_SEVERITIES == ("warning", "error", "critical")
    a = Anomaly(kind="tier-thrash", severity="warning", message="m",
                detected_at=0.0)
    assert a.as_dict()["dump"] is None


# ---------------------------------------------------------------------------
# OpenMetrics exporter
# ---------------------------------------------------------------------------


def test_openmetrics_from_live_session():
    sess = _host(shards=2, record=True)
    try:
        ref = sess.new_array("om", (64,))
        ref.set(torch.ones(64))
        ref.get()
        text = sess.openmetrics()
        assert text.endswith("# EOF\n")
        assert "# TYPE step_store_gets counter" in text
        assert "step_store_gets_total " in text
        assert 'step_shard_store_gets_total{shard="0"}' in text
        assert "step_trace_record_only 1" in text
        assert "step_recorder_ring_capacity" in text
        assert 'step_op_latency_us{op="store.set",quantile="0.99"}' in text
        assert text.count("# TYPE step_shard_store_gets counter") == 1
    finally:
        sess.recorder.close()


def test_openmetrics_of_spmd_session():
    sess = Session(backend=SpmdBackend(mesh=make_mesh((2,), ("data",), device=CPU)))
    g = sess.new_array("g", (4,))
    sess.run(lambda ctx, xs: g.accumulate(xs.sum(0)), data=(torch.ones(4, 4),))
    text = sess.openmetrics(prefix="spmd")
    assert 'spmd_info{backend="spmd"} 1' in text
    assert "spmd_wire_traffic_elements_total 12" in text    # (2+1)·4


def test_openmetrics_defensive_on_empty_metrics():
    text = openmetrics({})
    assert text.endswith("# EOF\n")
    assert "step_store_gets_total 0" in text
    assert "step_migration_open 0" in text


def test_openmetrics_anomaly_counter_and_escaping():
    text = openmetrics({}, anomalies=[
        Anomaly(kind="tier-thrash", severity="warning", message="m",
                detected_at=0.0),
        {"kind": 'we"ird\nkind'},
        {"kind": "tier-thrash"},
    ])
    assert 'step_anomalies_total{kind="tier-thrash"} 2' in text
    assert r'step_anomalies_total{kind="we\"ird\nkind"} 1' in text


def test_openmetrics_custom_prefix():
    text = openmetrics({}, prefix="acme")
    assert "# TYPE acme_info gauge" in text
    assert "step_" not in text


def _repro_metrics():
    """One metrics dict from a repro session with tracing on, so every
    family (per-shard rows, latency summaries, the ring) is in it."""
    sess = JSession(backend="host", shards=3, record=True)
    try:
        for i in range(6):
            ref = sess.new_array(f"m{i}", (16,))
            ref.set(jnp.ones(16) * i)
            ref.get()
        sess.ref("m0").inc(jnp.ones(16))
        return sess.metrics()
    finally:
        sess.recorder.close()


@pytest.mark.parametrize("kw", [{}, {"prefix": "acme"}, {"anomalies": "both"}])
def test_openmetrics_is_byte_identical_to_repro(kw):
    metrics = _repro_metrics()
    kw = dict(kw)
    if kw.get("anomalies") == "both":
        kw["anomalies"] = [
            {"kind": "tier-thrash"}, {"kind": 'we"ird\nkind'},
            JAnomaly(kind="slow-barrier", severity="warning", message="m",
                     detected_at=0.0)]
        ours = openmetrics(metrics, anomalies=kw["anomalies"][:2] + [
            Anomaly(kind="slow-barrier", severity="warning", message="m",
                    detected_at=0.0)])
    else:
        ours = openmetrics(metrics, **kw)
    theirs = jopenmetrics(metrics, **kw)
    assert ours == theirs
    assert ours.count("\n") > 60


def test_openmetrics_of_same_ops_matches_repro_session():
    """The same declarations and ops in both packages, tracing off: the
    scrape pages agree byte for byte (counters, shards, tiers)."""
    pages = []
    for sess, arr in ((JSession(backend="host", shards=2), jnp.asarray),
                      (_host(shards=2), torch.as_tensor)):
        for i in range(5):
            sess.new_array(f"p{i}", (8,)).set(arr(np.full(8, i, np.float32)))
            sess.ref(f"p{i}").get()
        sess.def_global("g", arr(np.float32(1.0))).inc(arr(np.float32(2.0)))
        pages.append(sess.openmetrics())
    assert pages[0] == pages[1]


# ---------------------------------------------------------------------------
# step_top renderer (pure function of snapshots)
# ---------------------------------------------------------------------------


def _load_step_top():
    path = os.path.join(ROOT, "scripts", "step_top.py")
    spec = importlib.util.spec_from_file_location("step_top", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _top_metrics():
    return {
        "backend": "host", "wire_traffic": 5,
        "trace": {"enabled": True, "record_only": True,
                  "ring": {"held": 7, "capacity": 64, "total": 7},
                  "ops": {"store.get": {"count": 300, "p50": 10.0,
                                        "p99": 50.0, "max": 80.0,
                                        "rate_per_s": 10.0},
                          "accumulate": {"count": 12, "p50": 1500.0,
                                         "p99": 2500.0, "max": 3000.0,
                                         "rate_per_s": 3.0},
                          "accumulate.barrier": {"count": 12, "p50": 900.0,
                                                 "p99": 1900.0}},
                  "ops_by_shard": {"store.lock_wait": {
                      0: {"count": 5, "p50": 1.0, "p99": 2.0}}}},
        "tiers": {"hot": {"entries": 3, "bytes": 2048.0}, "cold": {"bytes": 0},
                  "cold_entries": 0, "promotions": 1, "demotions": 2,
                  "migration": {"open": True, "pending": 4, "windows": 1,
                                "entries_moved": 9, "bytes_moved": 100,
                                "pulled": 2}},
    }


def test_step_top_render_is_pure():
    cur = _top_metrics()
    prev = json.loads(json.dumps(cur))
    prev["trace"]["ops"]["store.get"]["count"] = 100
    frame = top.render(cur, prev, dt=2.0,
                       anomalies=[{"kind": "tier-thrash", "message": "churn"}])
    assert "obs=record ring=7/64" in frame
    assert "store.get" in frame and "100.0" in frame   # (300-100)/2 ops/s
    assert "OPEN pending=4" in frame
    assert "[tier-thrash] churn" in frame
    assert cur["trace"]["ops"]["store.get"]["count"] == 300


def test_step_top_render_empty_metrics():
    frame = top.render({})
    assert "step_top" in frame and "obs=off" in frame


def test_step_top_rate_falls_back_to_lifetime():
    cur = {"trace": {"ops": {"store.get": {"count": 10, "p50": 1.0,
                                           "p99": 2.0, "max": 3.0,
                                           "rate_per_s": 42.0}}}}
    assert top._rate(cur, None, "store.get", 1.0) == 42.0
    prev = {"trace": {"ops": {"store.get": {"count": 4}}}}
    assert top._rate(cur, prev, "store.get", 2.0) == 3.0


def test_step_top_render_is_byte_identical_to_the_script():
    st = _load_step_top()
    cur = _top_metrics()
    prev = json.loads(json.dumps(cur))
    prev["trace"]["ops"]["store.get"]["count"] = 100
    anomalies = [{"kind": "tier-thrash", "message": "churn"},
                 Anomaly(kind="slow-barrier", severity="warning",
                         message="late", detected_at=0.0)]
    for args in ((cur, prev, 2.0, anomalies), (cur,), ({},),
                 (_repro_metrics(), None, 1.0, anomalies[:1])):
        assert top.render(*args) == st.render(*args)


def test_torch_step_top_cli_one_frame():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_step_top.py"),
         "--demo", "--once", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step_top — backend=host obs=record" in proc.stdout
    assert "store.get" in proc.stdout
