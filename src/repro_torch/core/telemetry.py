"""step.trace — end-to-end tracing & metrics for the DSM, threads and collectives.

You can't control what you can't see: STEP's pitch is fine-grained control
over distributed threads and shared data, and until this module the repo's
only introspection was ``wire_traffic()`` byte counts plus ad-hoc counter
dicts.  ``step.trace`` is the measurement substrate every perf decision is
judged against: a low-overhead, thread-safe event/metric layer threaded
through every hot path —

* **store ops** (`ShardedStore` get/set/inc/mget): spans + per-shard latency
  histograms + shard-lock wait time;
* **DSM cache**: replica hit/miss/invalidation/eviction counters;
* **sync** (`DBarrier` / `DSemaphore` / `SSPClock`): per-thread entry→release
  wait spans, queue depth, clock skew and stall time;
* **accumulator rounds** (`DAddAccumulator`): per-thread round spans, barrier
  wait, pair counts and the dense-vs-sparse branch taken;
* **SPMD backend**: per-``lax.scan`` trip accounting plus trace/compile/
  execute timing — device code cannot emit host events mid-program, so
  collective counters settle at ``join()`` exactly like AUTO traffic does;
* **jobs** (category ``job``): an app's ``fit`` marks its set-up
  (``job.setup``, with ``session.spawn`` and the app's own draws inside),
  ``session.join`` and ``job.teardown`` (the copies back to the host) on
  the thread that calls it;
* **device syncs** (category ``device-sync``): each host read of a device
  value on the round path, such as the AUTO rule's decision
  (``accumulate.decide``), which blocks until the device has run every
  kernel queued before it.

Two access levels:

* ``Session(trace=True)`` arms a :class:`Tracer`; ``session.tracer`` records,
  ``session.metrics()`` snapshots (superseding and wrapping ``stats()`` /
  ``shard_stats()`` without breaking them), and
  ``session.tracer.export("trace.json")`` writes a Chrome-trace /
  Perfetto-loadable JSON where a fit run renders as per-thread timelines of
  store / barrier / accumulate spans.
* **No-op by default**: every instrumented object holds a (disabled) tracer
  and every hot path is guarded by the module-level :data:`TRACING` flag
  first — when no tracer is armed the added cost is one module-attribute
  load and a falsy branch: no dict, no event, no timestamp is allocated.

One clock with ``torch.profiler``: a span opened with :meth:`Tracer.span`
also enters a profiler range of the same name when the tracer is armed and
the profiler records the calling thread's host ops
(``torch._C._autograd._profiler_enabled()``: true on the thread that
started the profiler, false on a thread started inside its window, whose
spans so never become ranges).  The range is a function-scoped record
(``torch._C._profiler._RecordFunctionFast``), not the user-scoped
``torch.profiler.record_function``: on CUDA the profiler turns a user range
into a device-side annotation event from the first to the last operation
launched inside it, which a reader of device events would count as device
time; a function-scoped range is a host event only.  The profiler's
idle-gap labels then carry the program's own span names.  Every span, a worker thread's included, is
placed against the profiler's events by the tracer's anchor,
:attr:`Tracer.epoch_unix_ns`: the Unix clock, which the profiler's host
events use too, read beside the ``perf_counter`` epoch
(:meth:`Tracer.unix_ns`; ``otherData.epoch_unix_ns`` in the Chrome trace).

The recording side is intentionally dumb — append-only event list (bounded,
drops counted), flat counters, fixed-size-sample histograms — so one lock
suffices and recording never calls back into store/sync code (the tracer
lock is a leaf in the locking order).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch

# ---------------------------------------------------------------------------
# Module-level fast path: TRACING is True iff at least one Tracer is armed.
# Hot paths check `telemetry.TRACING` BEFORE touching their tracer, so the
# disabled-by-default cost is a module attribute load + branch.
# ---------------------------------------------------------------------------

TRACING = False

_armed: set = set()
_armed_lock = threading.Lock()


def _arm(tracer: "Tracer") -> None:
    global TRACING
    with _armed_lock:
        _armed.add(tracer)
        TRACING = True


def _disarm(tracer: "Tracer") -> None:
    global TRACING
    with _armed_lock:
        _armed.discard(tracer)
        TRACING = bool(_armed)


def armed_count() -> int:
    """How many tracers are currently enabled (the leak-check hook: tier-1
    tests must leave this at 0, enforced by an autouse conftest fixture)."""
    with _armed_lock:
        return len(_armed)


def reset() -> int:
    """Disable every armed tracer; returns how many were disabled.  Test
    hygiene only — a leaked enabled tracer would slow (and cross-pollute)
    every later test in the process."""
    with _armed_lock:
        leaked = list(_armed)
    for t in leaked:
        t.disable()
    return len(leaked)


# ---------------------------------------------------------------------------
# Histograms: bounded-sample latency/derived-value distributions
# ---------------------------------------------------------------------------


class Hist:
    """Count/total/max plus a bounded reservoir of observations for
    percentile estimation.  Values are unit-free (store ops record
    microseconds; queue depth and clock skew record plain counts).

    The reservoir is Vitter's Algorithm R over the full observation stream:
    once SAMPLE values are held, the i-th observation replaces a uniformly
    chosen slot with probability SAMPLE/i, so every observation — first or
    last — has equal weight in the quantiles.  (The previous most-recent-ring
    retention made long-run p99 a recency window; pure first-N would bias it
    toward warm-up.)  Randomness comes from a per-hist xorshift64 stream with
    a fixed seed: identical observation sequences give identical quantiles,
    and there is no cross-hist or cross-run jitter to chase in tests.

    ``add`` is called without the tracer lock (see ``Tracer.observe``) and is
    written to be GIL-race-tolerant: concurrent adds may lose an occasional
    increment or reservoir slot (stats-grade undercounting) but can never
    raise or corrupt the sample — every index used is bounded by SAMPLE,
    which ``_sample`` can only grow past, never shrink below."""

    __slots__ = ("count", "total", "max", "_sample", "_rng")
    SAMPLE = 4096
    _SEED = 0x9E3779B97F4A7C15  # any odd non-zero constant works

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._sample: List[float] = []
        self._rng = self._SEED

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self._sample) < self.SAMPLE:
            self._sample.append(v)
        else:                       # Algorithm R: keep slot j with p=SAMPLE/i
            x = self._rng
            x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
            x ^= x >> 7
            x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
            self._rng = x
            j = x % self.count
            if j < self.SAMPLE:
                self._sample[j] = v

    def snapshot(self) -> Dict[str, float]:
        s = sorted(self._sample)
        q = (lambda p: s[min(len(s) - 1, int(p * len(s)))]) if s else (lambda p: 0.0)
        return {
            "count": self.count,
            "total": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
            "max": self.max,
        }


# ---------------------------------------------------------------------------
# Ring sink: the flight-recorder backing store (step.obs)
# ---------------------------------------------------------------------------


class RingSink:
    """Fixed-capacity overwrite-oldest event buffer.

    The bounded counterpart of the tracer's unbounded ``_events`` list: a
    :class:`~repro.obs.FlightRecorder` hangs one of these off a tracer
    (``tracer.ring``) so the last ``capacity`` events are always available
    for a post-incident dump, at O(capacity) memory no matter how long the
    session runs.  ``append`` is called under the tracer lock; ``snapshot``
    must be too (the tracer's ``ring_events`` wraps it)."""

    __slots__ = ("capacity", "_buf", "_next", "total")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._next = 0
        self.total = 0  # lifetime appends; total - len(self) were overwritten

    def append(self, ev: dict) -> None:
        self._buf[self._next] = ev
        self._next = (self._next + 1) % self.capacity
        self.total += 1

    def __len__(self) -> int:
        return min(self.total, self.capacity)

    def snapshot(self) -> List[dict]:
        """Held events oldest→newest (shallow copies, safe to mutate/json)."""
        if self.total < self.capacity:
            rows = self._buf[:self.total]
        else:
            rows = self._buf[self._next:] + self._buf[:self._next]
        return [dict(e) for e in rows if e is not None]


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


#: Span categories always materialised into the ring in record-only mode,
#: regardless of duration: rare lifecycle edges (migration windows, SPMD
#: trace/execute) and anomaly breadcrumbs are exactly what a post-incident
#: dump is for, and none of them sit on a per-op hot path.
ALWAYS_RECORD = frozenset({"migration", "anomaly", "spmd", "lifecycle"})


class _SpanCM:
    """Context-manager span: records one complete ('X') event on exit, and
    encloses a host-only profiler range of the same name where the tracer is
    armed and the profiler records this thread (the module docstring's range
    rule)."""

    __slots__ = ("_trc", "cat", "name", "args", "t0", "_range")

    def __init__(self, trc: "Tracer", cat: str, name: str, args: Optional[dict]):
        self._trc = trc
        self.cat = cat
        self.name = name
        self.args = args
        self._range = None

    def __enter__(self) -> "_SpanCM":
        self.t0 = time.perf_counter()
        if self._trc.enabled and torch._C._autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._trc.add_span(self.cat, self.name, self.t0, time.perf_counter(),
                           self.args)


class _NullCM:
    """Reusable no-op context manager (``ctx.span`` when tracing is off or
    the step body is traced rather than executed)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullCM()


class Tracer:
    """Thread-safe structured span/counter/histogram recorder with a
    Chrome-trace (``chrome://tracing`` / Perfetto) exporter.

    Span categories used by the built-in instrumentation:

    ========================  ====================================================
    ``store-op``              every ``ShardedStore`` get/set/inc/mget
    ``barrier-wait``          ``DBarrier.enter`` and the accumulator round barrier
    ``accumulate-round``      one span per thread per accumulator round (name
                              ``accumulate``) + one reduce span per round (name
                              ``accumulate.round``, carrying the branch taken)
    ``sync``                  semaphore acquire waits, SSP stalls
    ``app-round``             workload round boundaries via ``ctx.span(...)``
    ``spmd``                  SPMD trace / compile+execute / lower timing
    ``job``                   an app's ``job.setup`` (``session.spawn`` and
                              the app's draws, such as ``nmf.init``, inside),
                              ``session.join`` and ``job.teardown``, on the
                              thread that calls ``fit``
    ``device-sync``           a host read of a device value on the round path
                              (``accumulate.decide``: the AUTO rule's branch)
    ========================  ====================================================

    A span opened with :meth:`span` is also a host-only ``torch.profiler``
    range when the profiler records the calling thread (the module
    docstring's range rule); any span is placed on the profiler's clock by
    :attr:`epoch_unix_ns` (:meth:`unix_ns`).

    Recording methods are cheap but not free: callers on hot paths must guard
    with ``telemetry.TRACING and tracer.enabled`` (every built-in call site
    does), so a disabled tracer costs one branch.
    """

    def __init__(self, *, enabled: bool = False, max_events: int = 200_000):
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        # the anchor: the Unix clock (torch.profiler's) beside the epoch
        self._epoch = time.perf_counter()
        self.epoch_unix_ns = time.time_ns()
        self._events: List[dict] = []
        self.dropped_events = 0
        # step.obs flight-recorder hooks.  `ring` (a RingSink) additionally
        # receives every materialised event.  `record_only` is the armed-
        # recorder mode: counters/hists accumulate as usual, but span events
        # are materialised ONLY into the ring, and only when slow (duration
        # >= slow_us) or in an ALWAYS_RECORD category — the unbounded
        # `_events` list stays empty and fast ops allocate nothing, which is
        # what makes `Session(record=True)` cheap enough to leave on.
        self.ring: Optional[RingSink] = None
        self.record_only = False
        self.slow_us = 1000.0
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, Hist] = {}
        self._shard_hists: Dict[str, Dict[int, Hist]] = {}
        self._span_counts: Dict[str, int] = {}
        self._threads: Dict[tuple, str] = {}   # (pid, tid) -> display label
        self._tls = threading.local()
        self.enabled = False
        if enabled:
            self.enable()

    # -- arming ---------------------------------------------------------------

    def enable(self) -> "Tracer":
        if not self.enabled:
            self.enabled = True
            _arm(self)
        return self

    def disable(self) -> "Tracer":
        if self.enabled:
            self.enabled = False
            _disarm(self)
        return self

    def __enter__(self) -> "Tracer":
        return self.enable()

    def __exit__(self, *exc) -> None:
        self.disable()

    # -- thread identity ------------------------------------------------------

    def bind_thread(self, tid: int, node_id: int, label: Optional[str] = None) -> None:
        """Attach the calling OS thread to a STEP (tid, node): its spans land
        on that timeline (pid=node, tid=tid) in the exported trace."""
        self._tls.tid = int(tid)
        self._tls.pid = int(node_id)
        with self._lock:
            self._threads[(int(node_id), int(tid))] = label or f"step-thread-{tid}"

    def _ids(self) -> tuple:
        tid = getattr(self._tls, "tid", None)
        if tid is not None:
            return self._tls.pid, tid
        # unbound (driver / helper) threads: a stable per-thread display id
        return 0, 100_000 + (threading.get_ident() % 100_000)

    # -- recording ------------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter()

    def unix_ns(self, ts_us: float) -> int:
        """An event's ``ts`` (µs after this tracer's epoch) on the Unix clock,
        in ns: the clock of ``torch.profiler``'s host events, so that
        ``unix_ns(ts) - trace_start_ns()`` places the event in a profiled
        window, whichever thread recorded it."""
        return self.epoch_unix_ns + round(ts_us * 1e3)

    def add_span(self, cat: str, name: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        if (self.record_only and (t1 - t0) * 1e6 < self.slow_us
                and cat not in ALWAYS_RECORD):
            # armed-recorder fast path: fast ops leave no event (their latency
            # still lands in the histograms via observe/store_op/wait_span).
            # Skipping the lock here means `spans_by_category` undercounts
            # fast spans in record-only mode — a documented trade for not
            # serialising every hot op on the tracer lock twice.
            return
        pid, tid = self._ids()
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6, "dur": (t1 - t0) * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            self._span_counts[cat] = self._span_counts.get(cat, 0) + 1
            if self.ring is not None:
                self.ring.append(ev)
            if self.record_only:
                return              # ring only: `_events` must stay bounded
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped_events += 1

    def mark(self, cat: str, name: str, **args) -> None:
        """Record an instant ('i') event.  Marks are never filtered by
        ``record_only``/``slow_us`` — they are the lifecycle breadcrumbs
        (window opened, anomaly fired, node died) a flight-recorder dump must
        contain even when every op around them was fast."""
        pid, tid = self._ids()
        ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
              "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            self._span_counts[cat] = self._span_counts.get(cat, 0) + 1
            if self.ring is not None:
                self.ring.append(ev)
            if not self.record_only:
                if len(self._events) < self.max_events:
                    self._events.append(ev)
                else:
                    self.dropped_events += 1

    def count(self, name: str, amount: float = 1) -> None:
        # Lock-free like observe(): a get + set is GIL-atomic per step, and a
        # lost concurrent increment is stats-grade noise.  Counters that must
        # be exact (accumulator rounds, wire elements) are incremented from
        # exactly one thread per round, where no race exists.
        self._counters[name] = self._counters.get(name, 0) + amount

    def count_exact(self, name: str, amount: float = 1) -> None:
        """:meth:`count` under the tracer's lock: for a counter that several
        threads add to at once and that must come out exact (an app's
        per-thread counts)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def observe(self, name: str, value: float, shard: Optional[int] = None) -> None:
        # Deliberately lock-free: observe() fires 2-3× per store op — often
        # while the caller holds a shard lock — and serialising all worker
        # threads on the tracer lock here is what pushed the armed-recorder
        # overhead past its ≤5% budget.  Under the GIL every step below is
        # safe (setdefault is atomic; Hist.add mutates only per-hist state),
        # and a lost `count += 1` race is a benign sub-ppm undercount in a
        # stats-grade histogram, never a crash or a non-monotonic read.
        h = self._hists.get(name)
        if h is None:
            h = self._hists.setdefault(name, Hist())
        h.add(value)
        if shard is not None:
            per = self._shard_hists.get(name)
            if per is None:
                per = self._shard_hists.setdefault(name, {})
            hs = per.get(shard)
            if hs is None:
                hs = per.setdefault(shard, Hist())
            hs.add(value)

    def span(self, cat: str, name: str, **args) -> _SpanCM:
        return _SpanCM(self, cat, name, args or None)

    # fused helpers for the built-in instrumentation (span + histogram in one
    # call, so hot call sites stay one line)

    def store_op(self, op: str, shard: int, t0: float, **args) -> None:
        t1 = time.perf_counter()
        name = "store." + op
        us = (t1 - t0) * 1e6
        # record-only fast ops skip add_span entirely (no args dict, no call)
        if not self.record_only or us >= self.slow_us:
            self.add_span("store-op", name, t0, t1,
                          dict(args, shard=shard) if args else {"shard": shard})
        self.observe(name, us, shard=shard)

    def wait_span(self, cat: str, name: str, t0: float, **args) -> None:
        t1 = time.perf_counter()
        us = (t1 - t0) * 1e6
        if (not self.record_only or us >= self.slow_us
                or cat in ALWAYS_RECORD):
            self.add_span(cat, name, t0, t1, args or None)
        self.observe(name, us)

    # -- introspection --------------------------------------------------------

    def spans(self, cat: Optional[str] = None, name: Optional[str] = None) -> List[dict]:
        """Recorded span events, optionally filtered by category / name."""
        with self._lock:
            evs = list(self._events)
        if cat is not None:
            evs = [e for e in evs if e["cat"] == cat]
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def ring_events(self) -> List[dict]:
        """Events currently held by the attached ring, oldest→newest (empty
        when no recorder ever attached a ring)."""
        with self._lock:
            return self.ring.snapshot() if self.ring is not None else []

    def hist(self, name: str) -> Optional[Dict[str, float]]:
        """One histogram's snapshot (None if never observed) — the watchdog's
        SLO source; cheaper than a full :meth:`snapshot`."""
        with self._lock:
            h = self._hists.get(name)
            return h.snapshot() if h is not None else None

    def shard_hist(self, name: str) -> Dict[int, Dict[str, float]]:
        """Per-shard snapshots of one histogram (empty if never observed)."""
        with self._lock:
            per = self._shard_hists.get(name)
            # list() first: observe() inserts without the lock, and the
            # comprehension runs bytecode (h.snapshot()) between iterations.
            return {sid: h.snapshot() for sid, h in list(per.items())} if per else {}

    def snapshot(self) -> Dict[str, Any]:
        """Structured metrics snapshot: span counts per category, counters,
        and per-op histograms (with rates) — the ``trace`` section of
        ``Session.metrics()`` and the heartbeat payload."""
        elapsed = max(time.perf_counter() - self._epoch, 1e-9)
        with self._lock:
            # Writers (observe/count) skip the lock, so iterate atomic list()
            # copies — a concurrent insert mid-comprehension would otherwise
            # raise "dictionary changed size during iteration".
            ops = {name: h.snapshot() for name, h in list(self._hists.items())}
            for name, snap in ops.items():
                snap["rate_per_s"] = snap["count"] / elapsed
            by_shard = {name: {sid: h.snapshot() for sid, h in list(per.items())}
                        for name, per in list(self._shard_hists.items())}
            return {
                "enabled": self.enabled,
                "record_only": self.record_only,
                "elapsed_s": elapsed,
                "events": len(self._events),
                "dropped_events": self.dropped_events,
                "ring": (None if self.ring is None else
                         {"capacity": self.ring.capacity,
                          "held": len(self.ring),
                          "total": self.ring.total}),
                "spans_by_category": dict(self._span_counts),
                "counters": dict(self._counters),
                "ops": ops,
                "ops_by_shard": by_shard,
            }

    # -- Chrome-trace export ---------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The ``chrome://tracing`` / Perfetto JSON object: every recorded
        span as a complete ('X') event plus thread/process name metadata."""
        with self._lock:
            events = [dict(e) for e in self._events]
            threads = dict(self._threads)
        meta: List[dict] = []
        for pid in sorted({p for p, _ in threads} | {p["pid"] for p in events}):
            meta.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                         "args": {"name": f"node{pid}"}})
        for (pid, tid), label in sorted(threads.items()):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "args": {"name": label}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"producer": "step.trace",
                              "dropped_events": self.dropped_events,
                              "epoch_unix_ns": self.epoch_unix_ns}}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (load it in Perfetto or
        ``chrome://tracing`` for per-thread timelines).  Returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Tracer(enabled={self.enabled}, events={len(self._events)}, "
                f"counters={len(self._counters)})")


#: Shared default for instrumented objects constructed outside a Session.
#: Never enable this one directly — arm a fresh ``Tracer`` (or pass
#: ``Session(trace=True)``) so disabling it is scoped to your run.
NULL_TRACER = Tracer(enabled=False)


def guarded_span(tracer: Tracer, cat: str, name: str, **args):
    """``tracer.span(cat, name, **args)`` where ``tracer`` is armed, else
    :data:`NULL_SPAN`: the one guarded way to open a span."""
    if TRACING and tracer.enabled:
        return tracer.span(cat, name, **args)
    return NULL_SPAN


def as_tracer(trace) -> Tracer:
    """Resolve ``Session(trace=...)``: a :class:`Tracer` is adopted as-is
    (recovery re-arms the dead session's tracer this way), ``True`` arms a
    fresh one, ``None``/``False`` give a fresh *disabled* tracer that can be
    armed later via ``session.tracer.enable()``."""
    if isinstance(trace, Tracer):
        return trace
    return Tracer(enabled=bool(trace))


# ---------------------------------------------------------------------------
# Stats normalization (the unified-key-shape half of step.trace)
# ---------------------------------------------------------------------------

#: Canonical store counter keys (plural nouns, plain ints) — the normalized
#: form of the raw per-shard ``Shard.stats`` / ``ShardedStore.stats`` dicts,
#: whose legacy singular-verb keys remain available as deprecated views.
STORE_METRIC_KEYS = ("gets", "sets", "incs", "bytes_read", "bytes_written",
                     "transfers", "migrated_in", "migrated_out",
                     "migrated_bytes", "hot_hits", "cold_hits",
                     "promotions", "demotions")

_STORE_KEY_MAP = {"get": "gets", "set": "sets", "inc": "incs",
                  "bytes_get": "bytes_read", "bytes_set": "bytes_written",
                  "transfers": "transfers", "migrated_in": "migrated_in",
                  "migrated_out": "migrated_out",
                  "migrated_bytes": "migrated_bytes",
                  "hot_hits": "hot_hits", "cold_hits": "cold_hits",
                  "promotions": "promotions", "demotions": "demotions"}

#: Canonical cache counter keys (``CacheStats.as_dict()``).
CACHE_METRIC_KEYS = ("hits", "misses", "invalidations", "write_messages",
                     "missing_messages", "evictions", "hit_rate")

#: Top-level key set of ``Session.metrics()``.
SESSION_METRIC_KEYS = ("backend", "store", "cache", "wire_traffic", "shards",
                       "tiers", "trace")


def normalize_store_stats(raw: Dict[str, int]) -> Dict[str, Any]:
    """Map a raw store/shard counter dict onto the canonical key set.  Every
    canonical key is present (0 when the source lacks it); a per-shard row's
    ``names`` entry count rides along when the source has one."""
    out: Dict[str, Any] = {new: int(raw.get(old, 0))
                           for old, new in _STORE_KEY_MAP.items()}
    if "names" in raw:
        out["names"] = int(raw["names"])
    return out
