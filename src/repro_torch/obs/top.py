"""step_top's render path — a terminal frame over ``Session.metrics()``.

The pure half of ``scripts/step_top.py``, copied into the port so that the
port's own live view (``scripts/torch_step_top.py``) imports nothing of the
script: one frame per call, a pure function of two metrics snapshots (rates
come from counter deltas over the refresh interval), the same text as the
script's ``render`` for the same snapshots.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

#: redraw a frame in place (clear the screen, cursor home)
#: redraws a frame in place: clear the screen, cursor home
CLEAR = "\x1b[2J\x1b[H"

#: store-op hist names whose rates headline the view
_OP_NAMES = ("store.get", "store.set", "store.inc", "store.mget")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - unreachable


def _fmt_us(us: float) -> str:
    return f"{us / 1000:.2f}ms" if us >= 1000 else f"{us:.0f}us"


def _rate(cur: Dict[str, Any], prev: Optional[Dict[str, Any]], op: str,
          dt: float) -> float:
    """ops/s for one hist: counter delta over dt when a previous snapshot
    exists, else the tracer's lifetime rate."""
    ops = cur.get("trace", {}).get("ops", {})
    row = ops.get(op)
    if row is None:
        return 0.0
    if prev is None or dt <= 0:
        return row.get("rate_per_s", 0.0)
    prow = prev.get("trace", {}).get("ops", {}).get(op, {})
    return max(0.0, (row.get("count", 0) - prow.get("count", 0)) / dt)


def render(metrics: Dict[str, Any], prev: Optional[Dict[str, Any]] = None,
           dt: float = 1.0, anomalies: Sequence[Any] = ()) -> str:
    """One step_top frame as a plain string (no ANSI codes)."""
    lines: List[str] = []
    trace = metrics.get("trace", {})
    ring = trace.get("ring") or {}
    mode = ("trace" if trace.get("enabled") and not trace.get("record_only")
            else "record" if trace.get("record_only") else "off")
    lines.append(
        f"step_top — backend={metrics.get('backend', '?')} "
        f"obs={mode} ring={ring.get('held', 0)}/{ring.get('capacity', 0)} "
        f"wire={metrics.get('wire_traffic', 0)} elems")
    lines.append("")

    # ops/s + latency per store verb
    lines.append(f"{'op':<12}{'ops/s':>10}{'p50':>10}{'p99':>10}{'max':>10}")
    ops = trace.get("ops", {})
    for op in _OP_NAMES:
        row = ops.get(op)
        if row is None:
            continue
        lines.append(f"{op:<12}{_rate(metrics, prev, op, dt):>10.1f}"
                     f"{_fmt_us(row.get('p50', 0)):>10}"
                     f"{_fmt_us(row.get('p99', 0)):>10}"
                     f"{_fmt_us(row.get('max', 0)):>10}")

    # accumulator round latency (per-thread round + its barrier share)
    acc = ops.get("accumulate")
    bar = ops.get("accumulate.barrier") or ops.get("barrier.wait")
    if acc or bar:
        lines.append("")
        if acc:
            lines.append(
                f"accum round  p50={_fmt_us(acc.get('p50', 0))} "
                f"p99={_fmt_us(acc.get('p99', 0))} "
                f"rounds={int(acc.get('count', 0))} "
                f"rate={_rate(metrics, prev, 'accumulate', dt):.1f}/s")
        if bar:
            lines.append(f"barrier wait p50={_fmt_us(bar.get('p50', 0))} "
                         f"p99={_fmt_us(bar.get('p99', 0))}")

    # per-shard lock wait
    per = trace.get("ops_by_shard", {}).get("store.lock_wait", {})
    if per:
        lines.append("")
        lines.append(f"{'shard':<8}{'lock p50':>10}{'lock p99':>10}"
                     f"{'waits':>8}")
        for sid in sorted(per):
            row = per[sid]
            lines.append(f"{sid:<8}{_fmt_us(row.get('p50', 0)):>10}"
                         f"{_fmt_us(row.get('p99', 0)):>10}"
                         f"{int(row.get('count', 0)):>8}")

    # tiers + migration
    tiers = metrics.get("tiers", {})
    hot, cold = tiers.get("hot", {}), tiers.get("cold", {})
    lines.append("")
    lines.append(
        f"tiers  hot={hot.get('entries', 0)} entries/"
        f"{_fmt_bytes(hot.get('bytes', 0))} "
        f"cold={tiers.get('cold_entries', 0)} entries/"
        f"{_fmt_bytes(cold.get('bytes', 0))} "
        f"promote={tiers.get('promotions', 0)} "
        f"demote={tiers.get('demotions', 0)}")
    mig = tiers.get("migration", {})
    state = (f"OPEN pending={mig.get('pending', 0)}" if mig.get("open")
             else "idle")
    lines.append(
        f"migration  {state}  windows={mig.get('windows', 0)} "
        f"moved={mig.get('entries_moved', 0)} "
        f"({_fmt_bytes(mig.get('bytes_moved', 0))}) "
        f"pulled={mig.get('pulled', 0)}")

    if anomalies:
        lines.append("")
        lines.append(f"anomalies ({len(anomalies)}):")
        for a in list(anomalies)[-5:]:
            kind = a.get("kind") if isinstance(a, dict) else getattr(a, "kind", "?")
            msg = a.get("message") if isinstance(a, dict) else getattr(a, "message", "")
            lines.append(f"  [{kind}] {msg}")
    return "\n".join(lines)
