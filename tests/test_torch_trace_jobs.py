"""The port's job spans and device-sync spans, on ``torch.profiler``'s clock.

A traced app job (``pagerank.fit``, ``nmf.fit`` at the benchmark's small CPU
sizes, ``stepbench/tests/small.py``) records its set-up, join and tear-down
as ``job`` spans on the calling thread, and each AUTO round's decision as a
``device-sync`` span.  On a thread the profiler records, a span is also a
host-only profiler range of the same name (function-scoped, so no device-side
annotation on CUDA); on any other thread, or with the tracer or the profiler
off, no range is entered.  The tracer's Unix anchor
places a span where the profiler put it.  The benchmark's readers of these
spans are checked on hand-made observations."""

import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.core import Session, telemetry  # noqa: E402
from repro_torch.core.compat import make_mesh  # noqa: E402
from stepbench import manifest  # noqa: E402
from stepbench.runner import Observation, job_seed  # noqa: E402
from stepbench.tests.small import SEED, SMALL  # noqa: E402

CPU = torch.device("cpu")
BENCH = manifest.benchmark(manifest.HERE.parent)
CELLS = sorted(SMALL)                      # pagerank-g500.auto, nmf-netflix.auto
CHILDREN = {"pagerank": {"session.spawn"}, "nmf": {"nmf.init", "session.spawn"}}
JOB = ("job.setup", "session.join", "job.teardown")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
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


@pytest.fixture(scope="module")
def cells():
    """Each small cell's configuration, traffic, app and inputs on the CPU."""
    out = {}
    for workload in CELLS:
        cell = manifest.cell(BENCH, workload)
        cfg = {**manifest.config(BENCH, manifest.HERE.parent, cell["config"]),
               **SMALL[workload]}
        traffic = manifest.traffic(cell["traffic"])
        inputs = manifest.module("generators", cfg["generator"]).make(
            cfg, torch.Generator(CPU).manual_seed(SEED), CPU)
        out[workload] = (cfg, traffic, manifest.module("apps", cfg["app"]), inputs)
    return out


def _job(cells, workload, trace=True, **session_kw):
    """One job of ``workload`` through the benchmark's app driver; returns
    the job's session, its tracer disabled."""
    cfg, traffic, app, inputs = cells[workload]
    s = cfg["session"]
    sess = Session(backend=session_kw.pop("backend", s["backend"]),
                   n_nodes=int(s["n_nodes"]), threads_per_node=int(s["threads_per_node"]),
                   device=CPU, trace=True if trace else None, **session_kw)
    try:
        app.run_job(inputs, cfg, traffic, sess, job_seed(SEED, 0))
    finally:
        sess.tracer.disable()
    return sess


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` on the CPU; returns (fn's result,
    the profiler's events, its trace start in Unix ns)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, prof.events(), prof.profiler.kineto_results.trace_start_ns()


def _inside(inner, outer, slack_us=1.0):
    return (inner["ts"] >= outer["ts"] - slack_us
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + slack_us)


def _raising_range(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"profiler range entered for {name!r}")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


# -- the job's spans ----------------------------------------------------------


@pytest.mark.parametrize("workload", CELLS)
def test_job_spans_once_each_with_children(cells, workload):
    sess = _job(cells, workload)
    app = cells[workload][0]["app"]
    jobs = sess.tracer.spans("job")
    names = sorted(e["name"] for e in jobs)
    assert names == sorted(JOB + tuple(CHILDREN[app]))
    by = {e["name"]: e for e in jobs}
    assert len({(e["pid"], e["tid"]) for e in jobs}) == 1      # the calling thread
    for child in CHILDREN[app]:
        assert _inside(by[child], by["job.setup"])
    setup, join, teardown = (by[n] for n in JOB)
    assert setup["ts"] + setup["dur"] <= join["ts"] + 1.0
    assert join["ts"] + join["dur"] <= teardown["ts"] + 1.0
    # the workers' rounds run from the spawn to the join's end
    spawn = by["session.spawn"]
    workers = {"ts": spawn["ts"], "dur": join["ts"] + join["dur"] - spawn["ts"]}
    rounds = sess.tracer.spans("app-round")
    assert len(rounds) == 4 * 10 and all(_inside(r, workers) for r in rounds)


@pytest.mark.parametrize("workload", CELLS)
def test_each_auto_round_records_one_decision(cells, workload):
    sess = _job(cells, workload)
    decides = sess.tracer.spans("device-sync")
    assert [e["name"] for e in decides] == ["accumulate.decide"] * 10
    reduces = sess.tracer.spans("accumulate-round", "accumulate.round")
    assert len(reduces) == 10
    # the decision is read under the round lock, inside the closing
    # thread's reduce span
    for d in decides:
        assert any(_inside(d, r) and (d["pid"], d["tid"]) == (r["pid"], r["tid"])
                   for r in reduces)


def test_spmd_auto_round_records_one_decision_per_round():
    sess = Session(backend="spmd", mesh=make_mesh((4,), ("data",), device=CPU),
                   device=CPU, trace=True)
    try:
        out = sess.new_array("o", (512,), sparse_k=8)
        rows = torch.zeros((4, 512))
        for t in range(4):
            rows[t, 3 * t: 3 * t + 3] = float(t + 1)

        def proc(ctx, xs):
            return ctx.iterate(lambda c: c + out.accumulate(xs[0], mode="auto"),
                               torch.zeros(512), 3)
        sess.run(proc, data=(rows,))
        decides = sess.tracer.spans("device-sync", "accumulate.decide")
    finally:
        sess.tracer.disable()
    assert len(decides) == 3


def test_untraced_job_records_nothing(cells):
    sess = _job(cells, "nmf-netflix.auto", trace=False)
    assert sess.tracer.spans() == [] and sess.tracer.counters() == {}


def test_sparse_round_observes_no_compress_histogram():
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU, trace=True)
    try:
        out = sess.new_array("o", (256,), sparse_k=16)
        sess.run(lambda ctx, xs: out.accumulate(xs[0], mode="sparse"),
                 data=(torch.ones((4, 256)),))
        ops = sess.tracer.snapshot()["ops"]
    finally:
        sess.tracer.disable()
    assert "accumulate.compress" not in ops and "accumulate" in ops


# -- profiler ranges ----------------------------------------------------------


@pytest.mark.parametrize("workload", CELLS)
def test_job_spans_are_profiler_ranges_on_the_calling_thread(cells, workload):
    sess, events, _ = _profiled(lambda: _job(cells, workload))
    app = cells[workload][0]["app"]
    ranges = [e for e in events if e.name in set(JOB) | CHILDREN[app]]
    assert sorted(e.name for e in ranges) == sorted(JOB + tuple(CHILDREN[app]))
    assert not any(e.is_user_annotation for e in ranges)
    # worker threads' spans are not recorded by the profiler: no range
    names = {e.name for e in events}
    assert not names & {"pagerank.round", "nmf.round", "accumulate.decide"}
    assert len(sess.tracer.spans("app-round")) == 40


def test_span_range_is_host_only_unlike_a_user_range():
    """A span's range is function-scoped: the profiler reports it as no user
    annotation, the kind that CUDA's profiler mirrors as a device-side event
    over the operations launched inside it.  ``record_function`` beside it
    is one."""
    trc = telemetry.Tracer(enabled=True)

    def ranges():
        with trc.span("job", "job.teardown"):
            torch.ones(8).sum()
        with torch.profiler.record_function("user.range"):
            torch.ones(8).sum()
    try:
        _, events, _ = _profiled(ranges)
    finally:
        trc.disable()
    by = {e.name: e for e in events if e.name in ("job.teardown", "user.range")}
    assert by["user.range"].is_user_annotation
    assert not by["job.teardown"].is_user_annotation
    assert by["job.teardown"].device_type == torch.autograd.DeviceType.CPU
    assert any(e.name.startswith("aten::") and _within(e, by["job.teardown"])
               for e in events)
    assert len(trc.spans("job", "job.teardown")) == 1


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _worker_spans_program():
    """A session whose spans are all opened on worker threads: an app-round
    span and an AUTO round (its device-sync span) in each of 4 threads."""
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, device=CPU, trace=True)
    out = sess.new_array("o", (64,))

    def proc(ctx, xs):
        def step(c):
            with ctx.span("worker.round"):
                return c + out.accumulate(xs[0], mode="auto")
        return ctx.iterate(step, torch.zeros(64), 2)
    try:
        sess.run(proc, data=(torch.ones((4, 64)),))
    finally:
        sess.tracer.disable()
    return sess


@pytest.mark.parametrize("case", ["tracer_off", "profiler_off", "worker_thread"])
def test_no_range_where_none_is_recorded(cells, monkeypatch, case):
    _raising_range(monkeypatch)
    if case == "tracer_off":
        sess, events, _ = _profiled(lambda: _job(cells, "pagerank-g500.auto", trace=False))
        assert sess.tracer.spans() == []
        assert any(e.name.startswith("aten::") for e in events)
    elif case == "profiler_off":
        assert not torch._C._autograd._profiler_enabled()
        sess = _job(cells, "pagerank-g500.auto")
        assert len(sess.tracer.spans("job")) == 4
    else:
        sess, events, _ = _profiled(_worker_spans_program)
        assert len(sess.tracer.spans("app-round", "worker.round")) == 8
        assert len(sess.tracer.spans("device-sync", "accumulate.decide")) == 2


def test_worker_thread_is_not_recorded_by_the_profiler():
    """The premise of the range rule: the profiler reports itself off on a
    thread started inside its window, and on for the thread that started it."""
    seen = {}

    def probe():
        seen["worker"] = torch._C._autograd._profiler_enabled()

    def run():
        seen["main"] = torch._C._autograd._profiler_enabled()
        th = threading.Thread(target=probe)
        th.start()
        th.join(timeout=30)
        return th
    th, _, _ = _profiled(run)
    assert not th.is_alive()
    assert seen == {"main": True, "worker": False}


# -- the anchor ---------------------------------------------------------------


def test_chrome_trace_carries_the_anchor():
    trc = telemetry.Tracer(enabled=True)
    try:
        with trc.span("job", "job.setup"):
            pass
        trace = trc.chrome_trace()
    finally:
        trc.disable()
    anchor = trace["otherData"]["epoch_unix_ns"]
    assert anchor == trc.epoch_unix_ns
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"][0]
    assert trc.unix_ns(ev["ts"]) == anchor + round(ev["ts"] * 1e3)
    assert trc.unix_ns(0.0) == anchor


@pytest.mark.parametrize("workload", CELLS)
def test_anchor_places_spans_on_the_profilers_clock(cells, workload):
    _profiled(lambda: torch.ones(8) + 1)          # the profiler's first start
    sess, events, start_ns = _profiled(lambda: _job(cells, workload))
    ranges = {e.name: e for e in events if e.name in JOB}
    starts = []
    for span in sess.tracer.spans("job"):
        if span["name"] not in ranges:
            continue
        at_us = (sess.tracer.unix_ns(span["ts"]) - start_ns) / 1e3
        end_us = at_us + span["dur"]
        rng = ranges[span["name"]].time_range
        # the span encloses its range: placed by the anchor, to within 1 ms
        # of the profiler's clock, whatever the scheduler delays in between
        assert at_us - 1000.0 <= rng.start and rng.end <= end_us + 1000.0, (
            span["name"], (rng.start, rng.end), (at_us, end_us))
        starts.append(abs(rng.start - at_us))
    assert len(starts) == len(JOB) and min(starts) < 1000.0, starts
    # every aten op the profiler saw in the set-up's range lies inside the
    # set-up span placed by the anchor
    setup = sess.tracer.spans("job", "job.setup")[0]
    lo = (sess.tracer.unix_ns(setup["ts"]) - start_ns) / 1e3
    hi = lo + setup["dur"]
    rng = ranges["job.setup"].time_range
    inner = [e for e in events if e.name.startswith("aten::")
             and rng.start <= e.time_range.start <= rng.end]
    assert inner
    assert all(lo - 1000.0 <= e.time_range.start <= hi + 1000.0 for e in inner)


# -- the benchmark's readers --------------------------------------------------


def _obs(spans, iters=20):
    return Observation(cfg={}, traffic={}, roofline=None, setup_s=0.0, iters=iters,
                       spans=spans)


SPANS = [("job", "job.setup", 0.50), ("job", "nmf.init", 0.40),
         ("job", "session.spawn", 0.05), ("job", "session.join", 1.00),
         ("job", "job.teardown", 0.10),
         ("job", "job.setup", 0.30), ("job", "job.teardown", 0.14),
         ("device-sync", "accumulate.decide", 0.004),
         ("device-sync", "accumulate.decide", 0.006),
         ("device-sync", "spmd.other", 0.010),
         ("app-round", "job.setup", 9.0), ("barrier-wait", "accumulate.barrier", 9.0)]


@pytest.mark.parametrize("metric, want", [
    ("job_setup_ms", (0.50 + 0.30) / 20 * 1e3),
    ("job_teardown_ms", (0.10 + 0.14) / 20 * 1e3),
    ("sync_wait_ms", (0.004 + 0.006 + 0.010) / 20 * 1e3),
])
def test_readers_on_hand_made_observations(metric, want):
    read = manifest.module("metrics", metric).read
    assert read(_obs(SPANS)) == pytest.approx(want, rel=1e-12)
    # a program without the spans (the parent of this change): no reading
    assert read(_obs([s for s in SPANS if s[0] not in ("job", "device-sync")])) is None
    assert read(_obs([])) is None
    assert read(_obs(SPANS, iters=0)) is None


def test_readers_are_in_the_benchmark_for_every_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    for name, layer in (("job_setup_ms", "app"), ("job_teardown_ms", "app"),
                        ("sync_wait_ms", "accumulator")):
        entry = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert len(entry) == 1 and "workloads" not in entry[0]
        assert entry[0]["source"] == "program_span" and entry[0]["moves"] == "iter_ms"
        assert entry[0]["layer"] == layer
        assert all(entry[0] in manifest.metrics_of(BENCH, "per_layer", c) for c in cells)
