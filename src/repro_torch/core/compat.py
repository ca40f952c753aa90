"""An in-process mesh: the port's counterpart of :mod:`repro.core.compat`.

Where the JAX package runs a ``shard_map`` program once per device of a
mesh, the port runs each *mesh position* as a Python thread on one device
(the session's), and the collectives meet in this process.  That keeps
``Session.run``'s single controller: one program drives every position, the
``thread_proc`` closures of the apps run as they are, and every collective's
operands stay on the device.

* :func:`make_mesh` — a :class:`Mesh` of named axes on one device;
* :func:`shard_map` — split the inputs by :class:`PartitionSpec`, run ``f``
  once per position on its own thread, put the outputs back together;
* :func:`axis_size` / :func:`axis_index` — the calling position's view of a
  named axis (or tuple of axes), read from thread-local state;
* :func:`all_gather`, :func:`psum`, :func:`pmean`, :func:`psum_scatter`,
  :func:`all_to_all` — the collectives under ``jax.lax``'s names and
  semantics, and :func:`all_gather_reduce`, an all_gather whose reduction
  runs once for the whole group;
* :func:`record_collectives` — each collective a position calls adds its
  operand bytes, its ring-model wire bytes and one count to that position's
  :class:`~repro_torch.utils.hlo.CollectiveStats`, under the per-op rules of
  :func:`~repro_torch.utils.hlo.collective_bytes_from_hlo`;
* :func:`in_positions` — a context (a counting dispatch mode, say) entered
  in every position the caller's mesh runs start.

A collective over some axes meets the positions that share every other
coordinate, in the order of the linearised index over the named axes — the
order ``shard_map``'s collectives give.  Each position keys its calls on a
group by its own call counter (a generation), so a fast position never
folds its next round into the current one.  The group's last position to
arrive computes the result once and hands the same tensor to every member,
so a collective's result is never written in place.  Autograd sees each
collective as the torch ops that combined the members' tensors, so a
backward pass through a mesh run needs no collective of its own.  A position
runs under the caller's grad mode (PyTorch keeps it per thread), the
caller's collective recorder and the caller's :func:`in_positions`
contexts.  A position that raises breaks the mesh: every position waiting in
a collective then raises too, and :func:`run_positions` raises a
``RuntimeError`` from the first failure.

``cost_analysis`` is not ported: nothing here is traced or compiled.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.threads import DThreadPool, ThreadState
from repro_torch.utils.hlo import CollectiveStats

# ---------------------------------------------------------------------------
# Mesh and partition specs
# ---------------------------------------------------------------------------


class Mesh:
    """Named axes of positions on one device.

    ``shape`` maps each axis name to its size, in order (as ``jax``'s
    ``Mesh.shape``); ``device`` is where the positions run (``None``: the
    device of the session or of the tensors handed to :func:`shard_map`).
    """

    def __init__(self, shape: Sequence[int], names: Sequence[str], device=None):
        shape, names = tuple(int(s) for s in shape), tuple(names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axes must be positive, got {shape}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, linear: int) -> Dict[str, int]:
        """The coordinates of position ``linear`` (row-major over the axes)."""
        out: Dict[str, int] = {}
        for name in reversed(self.axis_names):
            linear, out[name] = divmod(linear, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` positions with axes ``names`` on one
    device (``None``: whatever device the program runs on)."""
    return Mesh(shape, names, device)


def _canonical_part(part):
    """``jax.sharding.PartitionSpec``'s form of one dimension's entry: a
    tuple or list of one name is that name, an empty one ``None``."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """Per dimension: ``None`` (whole), an axis name, or a tuple of names
    (split over their linearised index), as ``jax.sharding.PartitionSpec``
    (which holds a tuple of one name as the name)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_canonical_part(p) for p in parts))


P = PartitionSpec


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


# ---------------------------------------------------------------------------
# One run of positions: thread-local position, rendezvous by generation
# ---------------------------------------------------------------------------


class MeshBroken(RuntimeError):
    """Raised in a position waiting in a collective that can never complete:
    another position failed, or left the program without joining."""


class _Slot:
    __slots__ = ("values", "arrived", "done", "result", "taken")

    def __init__(self, size: int):
        self.values: List[Any] = [None] * size
        self.arrived = 0
        self.done = False
        self.result: Any = None
        self.taken = 0


class _Run:
    """The rendezvous state of one run of every position of a mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.cond = threading.Condition()
        self.slots: Dict[tuple, _Slot] = {}
        self.error: Optional[BaseException] = None
        self.exited: set = set()

    def fail(self, error: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = error
            self.cond.notify_all()

    def leave(self, linear: int) -> None:
        with self.cond:
            self.exited.add(linear)
            self.cond.notify_all()


class _Position:
    """What a position's thread knows of itself."""

    def __init__(self, run: _Run, linear: int, recorder: Optional["CollectiveRecorder"]):
        self.run = run
        self.mesh = run.mesh
        self.linear = linear
        self.coords = run.mesh.coords(linear)
        self.generation: Dict[tuple, int] = {}
        self.recorder = recorder

    def group(self, axes: Tuple[str, ...]) -> Tuple[tuple, List[int], int]:
        """``(key, members, index)`` of the group a collective over ``axes``
        meets: the positions sharing every other coordinate, ordered by the
        linearised index over ``axes``; ``index`` is this position's."""
        mesh = self.mesh
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"mesh has axes {mesh.axis_names}, no {a!r}")
        fixed = tuple((n, c) for n, c in self.coords.items() if n not in axes)
        sizes = [mesh.shape[a] for a in axes]
        members = []
        for j in range(math.prod(sizes)):
            coords = dict(fixed)
            for a, s in zip(reversed(axes), reversed(sizes)):
                j, coords[a] = divmod(j, s)
            linear = 0
            for n in mesh.axis_names:
                linear = linear * mesh.shape[n] + coords[n]
            members.append(linear)
        return (axes, fixed), members, _linear_index(self.coords, axes, mesh)


def _linear_index(coords: Dict[str, int], axes: Tuple[str, ...], mesh: Mesh) -> int:
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


_local = threading.local()


def _position() -> _Position:
    pos = getattr(_local, "position", None)
    if pos is None:
        raise RuntimeError("a mesh collective or axis query runs only inside a "
                           "mesh position (shard_map / Session(backend='spmd'))")
    return pos


class CollectiveRecorder:
    """The collective traffic of mesh runs, position by position: a
    :class:`~repro_torch.utils.hlo.CollectiveStats` for each linear index,
    summed over every run made under :func:`record_collectives`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_position: Dict[int, CollectiveStats] = {}

    def add(self, linear: int, op: str, operand: float, wire: float) -> None:
        with self._lock:
            st = self.by_position.setdefault(linear, CollectiveStats())
            st.bytes_by_op[op] = st.bytes_by_op.get(op, 0.0) + operand
            st.wire_bytes_by_op[op] = st.wire_bytes_by_op.get(op, 0.0) + wire
            st.count_by_op[op] = st.count_by_op.get(op, 0) + 1

    def stats(self, linear: int) -> CollectiveStats:
        """Position ``linear``'s traffic (empty if it called no collective)."""
        return self.by_position.get(linear, CollectiveStats())

    def mean(self, n_positions: Optional[int] = None) -> CollectiveStats:
        """The traffic per position: the sum over positions over
        ``n_positions`` (default: the positions that called a collective);
        counts are the largest any position made."""
        n = n_positions or max(1, len(self.by_position))
        out = CollectiveStats()
        for st in self.by_position.values():
            for op, b in st.bytes_by_op.items():
                out.bytes_by_op[op] = out.bytes_by_op.get(op, 0.0) + b / n
                out.wire_bytes_by_op[op] = (out.wire_bytes_by_op.get(op, 0.0)
                                            + st.wire_bytes_by_op[op] / n)
                out.count_by_op[op] = max(out.count_by_op.get(op, 0), st.count_by_op[op])
        return out


@contextlib.contextmanager
def record_collectives(recorder: Optional[CollectiveRecorder] = None):
    """Record the collectives of every mesh run this thread starts inside
    the block: yields the :class:`CollectiveRecorder` (a new one unless
    ``recorder`` is given)."""
    recorder = CollectiveRecorder() if recorder is None else recorder
    before = getattr(_local, "recorder", None)
    _local.recorder = recorder
    try:
        yield recorder
    finally:
        _local.recorder = before


@contextlib.contextmanager
def in_positions(make: Callable[[], Any]):
    """Enter ``make()`` (a context manager) in every position of each mesh
    run this thread starts inside the block — the way a thread-local
    ``TorchDispatchMode`` reaches the positions' threads."""
    before = tuple(getattr(_local, "contexts", ()))
    _local.contexts = before + (make,)
    try:
        yield
    finally:
        _local.contexts = before


def axis_size(axis) -> int:
    """Size of a named mesh axis (or the product over a tuple of axes)."""
    mesh = _position().mesh
    return math.prod(mesh.shape[a] for a in _axes(axis))


def axis_index(axis) -> int:
    """The calling position's index along ``axis`` (linearised over a tuple)."""
    pos = _position()
    return _linear_index(pos.coords, _axes(axis), pos.mesh)


def _rendezvous(axis, value, combine: Callable[[List[Any]], Any], *,
                per_member: bool = False):
    """Meet the group over ``axis`` with ``value``; the last to arrive runs
    ``combine`` on the members' values in axis-index order, once.  Each
    member gets the result, or its own entry of it with ``per_member``."""
    pos = _position()
    run = pos.run
    gkey, members, index = pos.group(_axes(axis))
    gen = pos.generation.get(gkey, 0)
    pos.generation[gkey] = gen + 1
    key = (gkey, gen)
    with run.cond:
        if run.error is not None:
            raise MeshBroken("the mesh is broken: another position failed") from run.error
        slot = run.slots.get(key)
        if slot is None:
            slot = run.slots[key] = _Slot(len(members))
        slot.values[index] = value
        slot.arrived += 1
        last = slot.arrived == len(members)
    if last:
        try:
            result = combine(slot.values)
        except BaseException as e:
            run.fail(e)
            raise
        with run.cond:
            slot.result, slot.done, slot.values = result, True, None
            run.cond.notify_all()
    else:
        with run.cond:
            while not slot.done:
                if run.error is not None:
                    raise MeshBroken("the mesh is broken: another position "
                                     "failed") from run.error
                if any(m in run.exited for m in members):
                    raise MeshBroken("a position of this collective's group left "
                                     "the program without joining it")
                run.cond.wait()
    with run.cond:
        slot.taken += 1
        if slot.taken == len(members):
            del run.slots[key]
    return slot.result[index] if per_member else slot.result


def run_positions(mesh: Mesh, fn: Callable[[int], Any],
                  timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(linear)`` once per position of ``mesh``, each a
    :class:`~repro_torch.core.threads.DThread` (one node a position) with the
    position bound; return the results in linear order.

    If any position raises, the others' collectives raise too and this
    raises a ``RuntimeError`` from the first failure.  A position still
    running ``timeout`` seconds after the start breaks the mesh the same
    way; one that is not in a collective then cannot be stopped, and is left
    running (a daemon thread).  Each position runs under the caller's grad
    and inference mode and current CUDA device, the caller's
    :func:`record_collectives` recorder and its :func:`in_positions`
    contexts."""
    run = _Run(mesh)
    # PyTorch keeps grad mode and dispatch modes per thread: a position
    # starts under the caller's
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    # and a new thread has no current CUDA device (cuBLAS would warn)
    card = torch.cuda.current_device() if torch.cuda.is_initialized() else None
    recorder = getattr(_local, "recorder", None)
    contexts = tuple(getattr(_local, "contexts", ()))

    def entry(linear: int, _param) -> Any:
        threading.current_thread().name = f"mesh-position-{linear}"
        _local.position = _Position(run, linear, recorder)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                if card is not None:
                    stack.enter_context(torch.cuda.device(card))
                for make in contexts:
                    stack.enter_context(make())
                return fn(linear)
        except BaseException as e:  # DThread records it; the mesh breaks
            run.fail(e)
            raise
        finally:
            _local.position = None
            run.leave(linear)

    pool = DThreadPool(mesh.size, 1)
    pool.create_threads(entry)
    pool.start_all()
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in pool.threads:
        t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))
    stuck = [t.tid for t in pool.threads
             if t.state in (ThreadState.CREATED, ThreadState.ALIVE)]
    if stuck:
        run.fail(TimeoutError(f"mesh positions {stuck} still running after {timeout} s"))
        for t in pool.threads:      # those waiting in a collective now raise
            t.join(1.0)
    failed = [t for t in pool.threads if t.state is ThreadState.FAILED]
    if failed:
        # the first to fail broke the mesh; the rest raised MeshBroken after it
        first = next((t for t in failed if t.error is run.error), failed[0])
        raise RuntimeError(f"{len(failed)} mesh position(s) failed; first: position "
                           f"{first.tid} {mesh.coords(first.tid)}") from first.error
    if stuck:
        raise RuntimeError(f"mesh positions {stuck} did not finish within {timeout} s")
    return [t.result for t in pool.threads]


# ---------------------------------------------------------------------------
# Collectives (``jax.lax``'s names)
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` over the leaves of a tuple / list / dict tree (``None`` stays)."""
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t) for t in tree)
    if isinstance(tree, list):
        return [tree_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def _transpose(values: List[Any], fn):
    """``fn`` of the list of each leaf across ``values`` (same structures)."""
    first = values[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_transpose([v[i] for v in values], fn) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _transpose([v[k] for v in values], fn) for k in first}
    if first is None:
        return None
    return fn(values)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _nbytes(x) -> float:
    total = 0.0

    def add(leaf):
        nonlocal total
        t = _as_tensor(leaf)
        total += t.numel() * t.element_size()
    tree_map(add, x)
    return total


def _record(op: str, axis_name, x) -> None:
    """Add a collective over ``axis_name`` of operand ``x`` to the calling
    position's recorder, if the run has one: ``repro.utils.hlo``'s operand
    rules (all-reduce, all-to-all: the operand; all-gather: the output over
    g, the operand again; reduce-scatter: the input) and its ring model of
    the wire bytes (all-reduce 2 (g-1)/g of the operand; all-gather (g-1)/g
    of the output; reduce-scatter and all-to-all (g-1)/g of the operand)."""
    pos = _position()
    if pos.recorder is None:
        return
    g = math.prod(pos.mesh.shape[a] for a in _axes(axis_name))
    operand = _nbytes(x)
    if op == "all-reduce":
        wire = 2.0 * operand * (g - 1) / g
    elif op == "all-gather":
        wire = operand * g * (g - 1) / g
    else:  # reduce-scatter, all-to-all
        wire = operand * (g - 1) / g
    pos.recorder.add(pos.linear, op, operand, wire)


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """Every member's ``x`` stacked (``tiled``: concatenated) along ``axis``
    in axis-index order; a tuple, list or dict of tensors gathers leafwise."""
    def gather(leaves):
        leaves = [_as_tensor(v) for v in leaves]
        return torch.cat(leaves, axis) if tiled else torch.stack(leaves, axis)
    _record("all-gather", axis_name, x)
    return _rendezvous(axis_name, x, lambda vs: _transpose(vs, gather))


def all_gather_reduce(x, axis_name, fn: Callable):
    """``fn(all_gather(x, axis_name))``, computed once for the group and the
    same result handed to every member — a replicated reduction of the
    gathered stack (the dense sum, the densified sparse pairs); recorded as
    the all-gather it is."""
    def gather(leaves):
        return torch.stack([_as_tensor(v) for v in leaves])
    _record("all-gather", axis_name, x)
    return _rendezvous(axis_name, x, lambda vs: fn(_transpose(vs, gather)))


def _sum(leaves):
    total = _as_tensor(leaves[0])
    for v in leaves[1:]:
        total = total + _as_tensor(v)
    return total


def psum(x, axis_name):
    """The sum of every member's ``x`` (leafwise for a tuple, list or dict)."""
    _record("all-reduce", axis_name, x)
    return _rendezvous(axis_name, x, lambda vs: _transpose(vs, _sum))


def pmean(x, axis_name):
    """The mean of every member's ``x``: :func:`psum` over the group size."""
    n = axis_size(axis_name)
    _record("all-reduce", axis_name, x)
    return _rendezvous(axis_name, x, lambda vs: _transpose(vs, lambda l: _sum(l) / n))


def psum_scatter(x: torch.Tensor, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """Member ``i``'s share of the sum: chunk ``i`` of ``scatter_dimension``
    (``tiled``), or its entry ``i`` along a dimension of the group's size."""
    def scatter(values):
        total = _sum(values)
        n = len(values)
        size = total.shape[scatter_dimension]
        if tiled:
            if size % n:
                raise ValueError(f"psum_scatter: dimension {scatter_dimension} of size "
                                 f"{size} does not split over {n} positions")
            return list(torch.chunk(total, n, scatter_dimension))
        if size != n:
            raise ValueError(f"psum_scatter: dimension {scatter_dimension} has size "
                             f"{size}, the group has {n} positions")
        return list(torch.unbind(total, scatter_dimension))
    _record("reduce-scatter", axis_name, x)
    return _rendezvous(axis_name, x, scatter, per_member=True)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int, concat_axis: int, *,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_to_all``: member ``j`` receives block ``j`` of every
    member's ``x`` along ``split_axis``, in axis-index order, and places them
    along ``concat_axis``.  ``tiled``: ``x``'s ``split_axis`` is cut into
    one chunk a member and the chunks concatenated (no dimension added or
    removed); otherwise ``split_axis`` must have the group's size, is
    removed, and the blocks are stacked at ``concat_axis`` of the output
    (``np.insert(np.delete(x.shape, split_axis), concat_axis, n)``)."""
    n = axis_size(axis_name)
    size = x.shape[split_axis]
    if tiled and size % n:
        raise ValueError(f"all_to_all: split_axis {split_axis} of size {size} does not "
                         f"split over {n} positions")
    if not tiled and size != n:
        raise ValueError(f"all_to_all: split_axis {split_axis} has size {size}, the group "
                         f"has {n} positions")

    def exchange(values):
        values = [_as_tensor(v) for v in values]
        if tiled:
            parts = [torch.chunk(v, n, split_axis) for v in values]
            return [torch.cat([p[j] for p in parts], concat_axis) for j in range(n)]
        parts = [torch.unbind(v, split_axis) for v in values]
        return [torch.stack([p[j] for p in parts], concat_axis) for j in range(n)]
    _record("all-to-all", axis_name, x)
    return _rendezvous(axis_name, x, exchange, per_member=True)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _prefix_map(fn, specs, tree):
    """``fn(spec, leaf)`` over ``tree``; ``specs`` is one
    :class:`PartitionSpec` for every leaf, or a tuple of them, one per
    entry of ``tree`` (each for every leaf beneath it)."""
    if isinstance(specs, PartitionSpec):
        return tree_map(lambda leaf: fn(specs, leaf), tree)
    if isinstance(specs, (tuple, list)):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(specs):
            raise ValueError(f"specs {specs} do not match the structure of {type(tree)}")
        return type(tree)(_prefix_map(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"a spec must be a PartitionSpec or a tuple/list of them, got {specs!r}")


def _split(spec: PartitionSpec, x, mesh: Mesh, coords: Dict[str, int]):
    """Position ``coords``' block of ``x`` under ``spec``."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = _axes(part)
        n = math.prod(mesh.shape[a] for a in axes)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not split evenly "
                             f"over mesh axes {axes} ({n} positions)")
        m = size // n
        i = _linear_index(coords, axes, mesh)
        x = x.narrow(dim, i * m, m)
    return x


def _assemble(spec: PartitionSpec, outs: List[Any], mesh: Mesh):
    """The global value from every position's block under ``spec``; axes the
    spec does not name are replicated, so their position 0 is taken."""
    named = {a for part in spec if part is not None for a in _axes(part)}
    chosen = [i for i in range(mesh.size)
              if all(c == 0 for a, c in mesh.coords(i).items() if a not in named)]
    if not named:
        return outs[chosen[0]]
    first = _as_tensor(outs[chosen[0]])
    shape = list(first.shape)
    for dim, part in enumerate(spec):
        if part is not None:
            shape[dim] *= math.prod(mesh.shape[a] for a in _axes(part))
    full = first.new_empty(shape)
    for i in chosen:
        block = full
        coords = mesh.coords(i)
        for dim, part in enumerate(spec):
            if part is not None:
                m = first.shape[dim]
                block = block.narrow(dim, _linear_index(coords, _axes(part), mesh) * m, m)
        block.copy_(_as_tensor(outs[i]))
    return full


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``f`` run once per position of ``mesh``, each on its own thread.

    Each argument is split by its entry of ``in_specs`` (one spec for all
    arguments, or one per argument); the outputs of the positions are put
    back together by ``out_specs`` — along the named axes, and from
    position 0 of the others, which ``f`` must leave replicated."""
    def mapped(*args):
        specs = in_specs if isinstance(in_specs, PartitionSpec) else tuple(in_specs)

        def body(linear: int):
            coords = mesh.coords(linear)
            local = _prefix_map(lambda s, x: _split(s, x, mesh, coords), specs, args)
            return f(*local)

        return _gather_outputs(out_specs, run_positions(mesh, body), mesh)

    return mapped


def _gather_outputs(specs, outs: List[Any], mesh: Mesh):
    if isinstance(specs, PartitionSpec):
        return _transpose(outs, lambda leaves: _assemble(specs, leaves, mesh))
    if isinstance(specs, (tuple, list)):
        return type(specs)(_gather_outputs(s, [o[i] for o in outs], mesh)
                           for i, s in enumerate(specs))
    raise TypeError(f"out_specs must be a PartitionSpec or a tuple/list of them, got {specs!r}")
