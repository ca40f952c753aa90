"""Trace-time lint over thread procs (step.check layer 3; port of
:mod:`repro.check.lint`).

``Session.spawn`` with an armed checker runs every thread proc once against a
:class:`LintCtx` **before any real thread starts**: reads come from a shadow
copy of the store, writes/incs stay in the shadow, ``accumulate`` records the
call (weighted by the enclosing ``ctx.iterate`` trip count) and returns the
local contribution as a shape-correct proxy, and sync primitives are absorbed
by the checker's lint hooks (recorded, never blocked on, never mutated).
Nothing escapes into the store, the sync objects or the real thread pool.

What the dry run catches, at check time instead of as a runtime hang or a
mid-round ``ValueError``:

* ``barrier-arity`` — a ``DBarrier`` reached by a set of threads that does
  not match its ``count`` (the classic everyone-waits-forever bug);
* ``ragged-accumulate`` — per-name accumulate call counts or contribution
  shapes that diverge across threads (would strand a round);
* ``spmd-host-sync`` — ``DBarrier``/``DSemaphore``/``SSPClock`` reached
  under SPMD lowering, where they are host-side Python effects the traced
  program cannot honour;
* ``sparse-overbudget`` — a declared or per-call top-k budget exceeding the
  blocked layout's :func:`~repro_torch.core.sparse.pair_capacity` (silently lossier
  than asked);
* ``lint-trace-error`` (warning) — the proc raised under the dry run, so the
  structural checks for that thread are incomplete.

A strict checker (the default) raises :class:`~repro_torch.check.findings.CheckError`
from ``spawn`` when any error-severity lint finding exists.

The shadow store is a copy in the port: JAX values are immutable, so the JAX
package shares the store's values with the dry run, but a torch
``thread_proc`` that writes in place into a value it read would then change
the real store.  Each thread's dry run gets its own clone of every stored
value (on the store's device); the dry run's kernel launches and the store
reads that take the copies are real, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.check.findings import Finding, call_site
from repro_torch.device import to_tensor


def _clone(value):
    """A private copy of a stored value: a tensor, or a dict of tensor fields."""
    if isinstance(value, dict):
        return {f: t.clone() for f, t in value.items()}
    return value.clone()


def _on_device(value, device: torch.device):
    """What the dry run keeps for a written value: the store's canonical
    tensor (or dict of tensors) on its device, as a real write would hold."""
    if isinstance(value, dict):
        return {f: to_tensor(v, device) for f, v in value.items()}
    return to_tensor(value, device)


class LintRun:
    """Everything one dry run of a spawn records, across all thread ids."""

    def __init__(self):
        # sync kind -> id(obj) -> (obj, tids that reached it, first site)
        self.sync: Dict[str, Dict[int, Tuple[Any, Set[Any], str]]] = {}
        # name -> tid -> trip-weighted accumulate call count
        self.acc_counts: Dict[str, Dict[Any, int]] = {}
        # name -> set of contribution shapes seen
        self.acc_shapes: Dict[str, Set[tuple]] = {}
        # (name, size, k) sparse budgets referenced by accumulate calls
        self.sparse: Dict[str, Tuple[int, int]] = {}
        self.trace_errors: List[Tuple[Any, str]] = []

    def reach_sync(self, kind: str, obj, tid) -> None:
        slot = self.sync.setdefault(kind, {}).get(id(obj))
        if slot is None:
            self.sync[kind][id(obj)] = (obj, {tid}, call_site(extra_skip=1))
        else:
            slot[1].add(tid)


class LintCtx:
    """Duck-typed WorkerCtx substitute for the dry run.  Mirrors the ctx
    surface the analytics apps use: tid/n_threads/node_id,
    guard/barrier/span/count, iterate/fori, and the read/write/inc/accumulate
    transport — all against shadow state."""

    def __init__(self, session, checker, run: LintRun, tid, n_threads: int,
                 node_id, values: Dict[str, Any]):
        self._session = session
        self._checker = checker
        self._run = run
        self.tid = tid
        self.n_threads = n_threads
        self.node_id = node_id
        self.values = values
        self._repeat = 1

    @property
    def device(self) -> torch.device:
        return self._session.device

    # -- sync / tracing surface (no-ops under the dry run) -------------------

    def guard(self) -> None:
        return None

    def barrier(self, timeout: Optional[float] = None) -> bool:
        return True

    def span(self, name: str, **args):
        from repro_torch.core import telemetry
        return telemetry.NULL_SPAN

    def count(self, name: str, amount: float = 1) -> None:
        return None

    # -- iteration: run the body once, weight records by the trip count ------

    def iterate(self, step: Callable, carry, iters: int):
        return self.fori(lambda i, c: step(c), carry, iters)

    def fori(self, step: Callable, carry, iters: int):
        iters = int(iters)
        if iters <= 0:
            return carry
        outer = self._repeat
        self._repeat = outer * iters
        try:
            return step(0, carry)
        finally:
            self._repeat = outer

    # -- shadow transport (owner handles have nothing to shortcut here) ------

    def read(self, name: str, owner=None):
        return self.values[name]

    def write(self, name: str, value, owner=None) -> None:
        self.values[name] = _on_device(value, self.device)

    def inc(self, name: str, amount, owner=None):
        # out of place: the shadow value may be the one a read handed out
        self.values[name] = self.values[name] + _on_device(amount, self.device)
        return self.values[name]

    def accumulate(self, name: str, local, mode, k: Optional[int]):
        counts = self._run.acc_counts.setdefault(name, {})
        counts[self.tid] = counts.get(self.tid, 0) + self._repeat
        self._run.acc_shapes.setdefault(name, set()).add(tuple(local.shape))
        mode_s = getattr(mode, "value", str(mode))
        if mode_s in ("sparse", "auto") and k is not None:
            self._run.sparse[name] = (int(local.numel()), int(k))
        self.values[name] = local
        return local


def run_lint(checker, session, thread_proc: Callable, data: Sequence,
             broadcast: Sequence) -> List[Finding]:
    """Dry-run ``thread_proc`` once per thread id and evaluate the structural
    checks.  Called from ``Session.spawn`` (through the checker) before the
    backend spawns anything."""
    from repro_torch.data.pipeline import partition_rows

    backend = session.backend
    n = backend.n_threads
    kind = backend.kind
    tpn = getattr(getattr(backend, "pool", None), "threads_per_node", 1)
    shared0 = {m: session.store.get(m) for m in session.store.names()}
    run = LintRun()
    for tid in range(n):
        if kind == "host":
            lo_hi = [partition_rows(a.shape[0], tid, n) for a in data]
        else:   # SPMD trims ragged rows and splits evenly
            lo_hi = [((a.shape[0] // n) * tid, (a.shape[0] // n) * (tid + 1))
                     for a in data]
        shards = [a[lo:hi] for a, (lo, hi) in zip(data, lo_hi)]
        node_id = tid // tpn if kind == "host" else tid
        ctx = LintCtx(session, checker, run, tid, n, node_id,
                      {m: _clone(v) for m, v in shared0.items()})
        prev = getattr(session._tls, "ctx", None)
        session._tls.ctx = ctx
        checker._begin_lint(run, tid)
        try:
            thread_proc(ctx, *shards, *broadcast)
        except Exception as exc:
            run.trace_errors.append((tid, f"{type(exc).__name__}: {exc}"))
        finally:
            checker._end_lint()
            session._tls.ctx = prev
    return evaluate(run, n_threads=n, backend_kind=kind)


def evaluate(run: LintRun, *, n_threads: int, backend_kind: str) -> List[Finding]:
    findings: List[Finding] = []

    if backend_kind == "spmd":
        for slots in run.sync.values():
            for _, (obj, tids, site) in slots.items():
                findings.append(Finding(
                    "lint", "spmd-host-sync", "error",
                    f"host-only sync primitive {type(obj).__name__} reached "
                    f"under SPMD lowering at {site} (thread ids {sorted(tids, key=str)}) "
                    "— barriers are implicit in the collectives; host "
                    "barriers/semaphores/SSP clocks are Python-side effects "
                    "the traced program cannot honour",
                    sites=(site,), tids=tuple(sorted(tids, key=str))))
    else:
        for _, (obj, tids, site) in run.sync.get("barrier", {}).items():
            count = getattr(obj, "count", None)
            if count is not None and len(tids) != count:
                findings.append(Finding(
                    "lint", "barrier-arity", "error",
                    f"DBarrier(count={count}) at {site} is reached by "
                    f"{len(tids)} of {n_threads} spawned thread(s) "
                    f"{sorted(tids, key=str)} — arity must match the threads "
                    "that enter it or the program deadlocks",
                    sites=(site,), tids=tuple(sorted(tids, key=str))))

    for name, counts in run.acc_counts.items():
        per_tid = [counts.get(tid, 0) for tid in range(n_threads)]
        if len(set(per_tid)) > 1:
            findings.append(Finding(
                "lint", "ragged-accumulate", "error",
                f"accumulate({name!r}) call counts diverge across threads "
                f"({dict(enumerate(per_tid))}) — every round blocks for all "
                f"{n_threads} contributions, so the program strands mid-round",
                name=name, tids=tuple(range(n_threads))))
        shapes = run.acc_shapes.get(name, set())
        if len(shapes) > 1:
            findings.append(Finding(
                "lint", "ragged-accumulate", "error",
                f"accumulate({name!r}) contribution shapes diverge across "
                f"threads ({sorted(shapes)}) — a round would abort with the "
                "runtime ragged-contribution ValueError",
                name=name))

    for name, (size, k) in run.sparse.items():
        findings.extend(check_sparse_budget(name, size, k))

    for tid, err in run.trace_errors:
        findings.append(Finding(
            "lint", "lint-trace-error", "warning",
            f"thread proc raised under the lint dry run for tid {tid}: {err} "
            "— structural checks for this thread are incomplete",
            tids=(tid,)))
    return findings


def check_sparse_budget(name: str, size: int, k: int) -> List[Finding]:
    """Flag a top-k budget the blocked pair layout cannot actually ship."""
    from repro_torch.core.sparse import pair_capacity

    try:
        cap = pair_capacity(size, k)
    except (ValueError, ZeroDivisionError):
        return []
    if k > cap:
        return [Finding(
            "lint", "sparse-overbudget", "warning",
            f"sparse budget k={k} for {name!r} (length {size}) exceeds "
            f"pair_capacity={cap} — the blocked top-k layout ships at most "
            f"{cap} pairs, so compression is silently lossier than asked",
            name=name)]
    return []
