"""Sharded, prefetching data pipeline (port of :mod:`repro.data.pipeline`).

Batches are generated on the host as numpy, placed on the device — the
card unless the caller asks for the CPU — and prefetched on a background
thread, so the host→device copy of step k+1 overlaps step k's compute (the
paper's "one thread per node fetches and shares locally" discussion, §4.5,
turned into an input pipeline).  With the port's in-process
:class:`~repro_torch.core.compat.Mesh`, a batch goes whole onto the mesh's
device once its batch dimension is checked to split over the data axes, as
a ``NamedSharding`` would check it; a ``shard_map`` with ``P("data")`` then
hands each position its rows.

The stream is stateless in (seed, step) — restart-exactness for FT: restoring
a checkpoint at step k and re-iterating reproduces the same batches.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import TYPE_CHECKING, Callable, Iterator, Optional

from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device, to_tensor
from repro_torch.utils.tree import tree_leaves, tree_map

if TYPE_CHECKING:      # core's Session imports partition_rows from here
    from repro_torch.core.compat import Mesh


def _axes(data_axes) -> tuple:
    return tuple(data_axes) if isinstance(data_axes, (tuple, list)) else (data_axes,)


def shard_batch(batch, mesh: Optional[Mesh] = None, data_axes=("data",), device=None):
    """Place a host batch dict on the device, split along the batch dim.

    ``mesh=None``: on ``device`` (``None``: the card).  With a mesh: on the
    mesh's device (else ``device``), after checking that every leaf's batch
    dimension divides by the size of ``data_axes``."""
    if mesh is not None:
        n = math.prod(mesh.shape[a] for a in _axes(data_axes))
        for leaf in tree_leaves(batch):
            if leaf.shape[0] % n:
                raise ValueError(f"shard_batch: batch dimension {leaf.shape[0]} does not "
                                 f"split over data axes {_axes(data_axes)} ({n} positions)")
        if mesh.device is not None:
            device = mesh.device
    dev = resolve_device(device)
    return tree_map(lambda x: to_tensor(x, dev), batch)


def partition_rows(n_rows: int, tid: int, n_threads: int):
    """The paper's ``LoadTrainPoint`` — thread tid's contiguous row range."""
    per = n_rows // n_threads
    extra = n_rows % n_threads
    start = tid * per + min(tid, extra)
    stop = start + per + (1 if tid < extra else 0)
    return start, stop


class Prefetcher:
    """Background prefetcher of ``depth`` batches: overlaps batch build +
    host→device copy with compute."""

    def __init__(self, make_batch: Callable[[int], object], start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


class LMDataPipeline:
    """End-to-end LM pipeline: synthetic stream → batches on the device
    (``device=None``: the card), prefetched."""

    def __init__(self, global_batch: int, seq_len: int, vocab: int,
                 mesh: Optional[Mesh] = None, seed: int = 0, start_step: int = 0,
                 data_axes=("data",), prefetch: bool = True, device=None):
        self.stream = SyntheticLM(global_batch, seq_len, vocab, seed)
        self.mesh = mesh
        self.data_axes = data_axes
        self.device = (mesh.device if mesh is not None and mesh.device is not None
                       else resolve_device(device))
        self._prefetcher = None
        if prefetch:
            self._prefetcher = Prefetcher(self._build, start_step)
        self._step = start_step

    def _build(self, step: int):
        return shard_batch(self.stream.batch(step), self.mesh, self.data_axes, self.device)

    def next(self):
        if self._prefetcher is not None:
            step, batch = next(self._prefetcher)
        else:
            step, batch = self._step, self._build(self._step)
        self._step = step + 1
        return step, batch

    def close(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
