"""Distributed threads — STEP §4.2, host form.

:class:`DThread` wraps a ``thread_proc(tid, param)`` entry function;
:class:`DThreadPool` plays the master — it places threads on logical *nodes*,
starts them, joins them, and can kill a node to simulate failure.  State
mirrors the paper (``GetState`` → alive/completed, plus ``lost`` after a
simulated node failure).  The SPMD adapter (:func:`spmd_threads`) runs one
STEP thread per position of an in-process mesh
(:mod:`repro_torch.core.compat`).
"""

from __future__ import annotations

import threading
import traceback
from enum import Enum
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.core.compat import Mesh


class ThreadState(str, Enum):
    CREATED = "created"
    ALIVE = "alive"
    COMPLETED = "completed"
    FAILED = "failed"    # raised an exception
    LOST = "lost"        # node failure (simulated)


class DThread:
    """Paper API: ``DThread(func, node_id, param)`` with ``GetState()``."""

    def __init__(self, func: Callable, node_id: int, param: Any = None, tid: Optional[int] = None):
        self.func = func
        self.node_id = node_id
        self.param = param
        self.tid = tid
        self.state = ThreadState.CREATED
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._kill_event = threading.Event()

    def start(self) -> None:
        def runner():
            self.state = ThreadState.ALIVE
            try:
                self.result = self.func(self.tid, self.param)
                if self._kill_event.is_set():
                    self.state = ThreadState.LOST
                else:
                    self.state = ThreadState.COMPLETED
            except _NodeKilled:
                self.state = ThreadState.LOST
            except BaseException as e:  # noqa: BLE001 — faithfully record
                self.error = e
                self.state = ThreadState.FAILED
                traceback.print_exc()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def get_state(self) -> ThreadState:
        return self.state

    GetState = get_state


class _NodeKilled(Exception):
    """Raised inside a thread whose node was failed by the pool."""


class DThreadPool:
    """The master's thread-management role: create/start/join/kill threads.

    ``checkpoint_guard(tid)`` should be called by thread_procs at barrier
    boundaries; it raises inside threads whose node has been killed, which is
    how a node failure manifests to the program (the FT layer then recovers).
    """

    def __init__(self, n_nodes: int, threads_per_node: int):
        self.n_nodes = n_nodes
        self.threads_per_node = threads_per_node
        self.threads: List[DThread] = []
        self._killed_nodes: set[int] = set()

    @property
    def n_threads(self) -> int:
        return self.n_nodes * self.threads_per_node

    def create_threads(self, func: Callable, param: Any = None) -> List[DThread]:
        self.threads = []
        tid = 0
        for node in range(self.n_nodes):
            for _ in range(self.threads_per_node):
                self.threads.append(DThread(func, node, param, tid=tid))
                tid += 1
        return self.threads

    def start_all(self) -> None:
        for t in self.threads:
            if t.node_id not in self._killed_nodes:
                t.start()

    def join_all(self, timeout: Optional[float] = None) -> None:
        for t in self.threads:
            t.join(timeout)

    def kill_node(self, node_id: int) -> List[int]:
        """Simulate a node failure; returns the tids lost."""
        self._killed_nodes.add(node_id)
        lost = []
        for t in self.threads:
            if t.node_id == node_id and t.state in (ThreadState.ALIVE, ThreadState.CREATED):
                t._kill_event.set()
                lost.append(t.tid)
        return lost

    def checkpoint_guard(self, tid: int) -> None:
        t = self.threads[tid]
        if t._kill_event.is_set() or t.node_id in self._killed_nodes:
            raise _NodeKilled(f"node {t.node_id} failed")

    def healthy_nodes(self) -> List[int]:
        return [n for n in range(self.n_nodes) if n not in self._killed_nodes]

    def states(self) -> Dict[int, ThreadState]:
        return {t.tid: t.state for t in self.threads}


# ---------------------------------------------------------------------------
# SPMD adapter
# ---------------------------------------------------------------------------


def spmd_threads(
    thread_proc: Callable,
    mesh: Mesh,
    axis_names: Sequence[str],
    in_specs,
    out_specs,
):
    """Run ``thread_proc(tid, *locals) -> outputs`` as one STEP thread per mesh
    position over ``axis_names``, via :func:`~repro_torch.core.compat.shard_map`.

    Inside, ``tid`` is the linearised mesh index over ``axis_names`` — the
    distributed analogue of the paper's thread identifier argument.
    """
    # compat runs its positions on DThreads, so it imports this module
    from repro_torch.core.compat import axis_index, shard_map

    def body(*local_args):
        return thread_proc(axis_index(tuple(axis_names)), *local_args)

    return shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
