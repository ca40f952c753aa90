"""OpenMetrics / Prometheus text exporter for ``Session.metrics()`` (port of
:mod:`repro.obs.export`: the same text for the same metrics dict).

One pure function: :func:`openmetrics` renders the unified metrics snapshot
(the :data:`~repro_torch.core.telemetry.SESSION_METRIC_KEYS` shape) into the
OpenMetrics text exposition format — ``# TYPE``/``# HELP`` headers, counter
families with ``_total`` suffixes, latency histograms as quantile summaries,
per-shard families labelled ``{shard="N"}``, terminated by ``# EOF``.  No
HTTP server ships here: the text is what a scrape endpoint, a pushgateway
hook, or a test asserts on, and ``Session.openmetrics()`` is the one-call
wrapper.

The renderer is defensive by construction (``.get`` with zero defaults
everywhere): a metrics dict from an older/newer session, or one missing the
``tiers``/``trace`` sections entirely, still renders — dashboards get a
stable family set, not a KeyError.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from repro_torch.core import telemetry

#: quantile keys of a Hist snapshot → OpenMetrics quantile label values
_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))


def _escape(value: Any) -> str:
    """Escape a label value per the exposition format."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _num(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Renderer:
    """Accumulates families so TYPE/HELP headers emit once per family."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.lines: List[str] = []
        self._declared: set = set()

    def _declare(self, family: str, mtype: str, help_text: str) -> None:
        if family not in self._declared:
            self._declared.add(family)
            self.lines.append(f"# TYPE {family} {mtype}")
            self.lines.append(f"# HELP {family} {help_text}")

    def sample(self, name: str, mtype: str, help_text: str, value: Any,
               labels: Optional[Dict[str, Any]] = None,
               suffix: str = "") -> None:
        family = f"{self.prefix}_{name}"
        self._declare(family, mtype, help_text)
        self.lines.append(f"{family}{suffix}{_labels(labels)} {_num(value)}")

    def counter(self, name: str, help_text: str, value: Any,
                labels: Optional[Dict[str, Any]] = None) -> None:
        # counter families use the _total sample suffix per OpenMetrics
        family = f"{self.prefix}_{name}"
        self._declare(family, "counter", help_text)
        self.lines.append(f"{family}_total{_labels(labels)} {_num(value)}")

    def gauge(self, name: str, help_text: str, value: Any,
              labels: Optional[Dict[str, Any]] = None) -> None:
        self.sample(name, "gauge", help_text, value, labels)

    def summary(self, name: str, help_text: str, snap: Dict[str, float],
                labels: Optional[Dict[str, Any]] = None) -> None:
        """A Hist snapshot (count/total/p50/p90/p99) as a summary family."""
        family = f"{self.prefix}_{name}"
        self._declare(family, "summary", help_text)
        base = dict(labels) if labels else {}
        for key, q in _QUANTILES:
            self.lines.append(
                f"{family}{_labels({**base, 'quantile': q})} "
                f"{_num(snap.get(key, 0.0))}")
        self.lines.append(f"{family}_count{_labels(base)} "
                          f"{_num(snap.get('count', 0))}")
        self.lines.append(f"{family}_sum{_labels(base)} "
                          f"{_num(snap.get('total', 0.0))}")

    def render(self) -> str:
        return "\n".join(self.lines + ["# EOF"]) + "\n"


def openmetrics(metrics: Dict[str, Any], *, prefix: str = "step",
                anomalies: Optional[Iterable[Any]] = None) -> str:
    """Render a ``Session.metrics()`` snapshot as OpenMetrics text.

    ``anomalies`` (an iterable of :class:`~repro_torch.obs.watchdog.Anomaly` or
    plain dicts with a ``kind``) adds a ``<prefix>_anomalies`` counter
    family labelled by kind — pass ``watchdog.anomalies`` to expose watchdog
    state on the same scrape."""
    r = _Renderer(prefix)
    r.gauge("info", "session backend (labels carry the string facts)", 1,
            {"backend": metrics.get("backend", "unknown")})

    store = metrics.get("store", {})
    for key in telemetry.STORE_METRIC_KEYS:
        r.counter(f"store_{key}", f"store {key.replace('_', ' ')}",
                  store.get(key, 0))

    cache = metrics.get("cache", {})
    for key in telemetry.CACHE_METRIC_KEYS:
        if key == "hit_rate":
            r.gauge("cache_hit_ratio", "cache hit ratio", cache.get(key, 0.0))
        else:
            r.counter(f"cache_{key}", f"DSM cache {key.replace('_', ' ')}",
                      cache.get(key, 0))

    r.counter("wire_traffic_elements",
              "accumulator wire traffic in vector elements",
              metrics.get("wire_traffic", 0))

    for sid, row in sorted(metrics.get("shards", {}).items()):
        labels = {"shard": sid}
        srow = row.get("store", {})
        for key in telemetry.STORE_METRIC_KEYS:
            r.counter(f"shard_store_{key}",
                      f"per-shard store {key.replace('_', ' ')}",
                      srow.get(key, 0), labels)
        r.counter("shard_wire_traffic_elements",
                  "per-shard accumulator wire traffic (elements)",
                  row.get("wire_traffic", 0), labels)

    tiers = metrics.get("tiers", {})
    hot = tiers.get("hot", {})
    cold = tiers.get("cold", {})
    r.gauge("tier_hot_entries", "entries resident in the hot tier",
            hot.get("entries", 0))
    r.gauge("tier_hot_bytes", "bytes resident in the hot tier",
            hot.get("bytes", 0))
    r.gauge("tier_cold_entries", "entries demoted to the cold tier",
            tiers.get("cold_entries", 0))
    r.gauge("tier_cold_bytes", "bytes held by the cold backend",
            cold.get("bytes", 0))
    for key in ("hot_hits", "cold_hits", "promotions", "demotions"):
        r.counter(f"tier_{key}", f"tier {key.replace('_', ' ')}",
                  tiers.get(key, 0))

    mig = tiers.get("migration", {})
    for key in ("windows", "entries_moved", "bytes_moved", "pulled"):
        r.counter(f"migration_{key}", f"migration {key.replace('_', ' ')}",
                  mig.get(key, 0))
    r.counter("migration_window_seconds", "cumulative open-window time",
              mig.get("window_s", 0.0))
    r.gauge("migration_open", "1 while a migration window is open",
            1 if mig.get("open") else 0)
    r.gauge("migration_pending", "entries still pending in the open window",
            mig.get("pending", 0))

    trace = metrics.get("trace", {})
    r.gauge("trace_enabled", "1 when the session tracer is armed",
            1 if trace.get("enabled") else 0)
    r.gauge("trace_record_only", "1 when the tracer runs in record-only "
            "(flight recorder) mode", 1 if trace.get("record_only") else 0)
    ring = trace.get("ring")
    if ring:
        r.counter("recorder_events", "events ever appended to the flight "
                  "recorder ring", ring.get("total", 0))
        r.gauge("recorder_ring_held", "events currently held by the ring",
                ring.get("held", 0))
        r.gauge("recorder_ring_capacity", "flight recorder ring capacity",
                ring.get("capacity", 0))
    for op, snap in sorted(trace.get("ops", {}).items()):
        r.summary("op_latency_us", "per-op latency distribution "
                  "(microseconds; unit-free hists ride along)",
                  snap, {"op": op})
    for op, per in sorted(trace.get("ops_by_shard", {}).items()):
        for sid, snap in sorted(per.items()):
            r.summary("shard_op_latency_us",
                      "per-shard per-op latency distribution (microseconds)",
                      snap, {"op": op, "shard": sid})

    if anomalies is not None:
        by_kind: Dict[str, int] = {}
        for a in anomalies:
            kind = a.get("kind") if isinstance(a, dict) else getattr(a, "kind", "unknown")
            by_kind[kind] = by_kind.get(kind, 0) + 1
        for kind in sorted(by_kind):
            r.counter("anomalies", "watchdog anomalies by kind",
                      by_kind[kind], {"kind": kind})

    return r.render()
