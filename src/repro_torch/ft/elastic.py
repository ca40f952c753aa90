"""Elastic recovery — STEP §5.4's single-/multi-node recovery (port of
:mod:`repro.ft.elastic`).

The paper recreates failed threads on healthy nodes and rolls everyone back
to the latest DSM state; *multi-node recovery* spreads the failed node's
work across several survivors (Fig. 11).  ``session_recovery`` does that on
the Session facade: the replacement session adopts the surviving store, and
with the shards-per-node convention the dead node's shard leaves the ring
(only its names move, epochs kept).

``elastic_restore`` restores a checkpoint onto a mesh.  The port's mesh
(:class:`~repro_torch.core.compat.Mesh`) is positions as threads on one
device, so "onto the survivors' mesh" means: every leaf whole on the mesh's
device, its :class:`~repro_torch.core.compat.PartitionSpec` checked against
the mesh here, and each position slicing its share when ``shard_map``
enters — where the JAX package places each shard on its own device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import telemetry
from repro_torch.core.compat import Mesh, PartitionSpec
from repro_torch.core.session import HostBackend, Session
from repro_torch.device import resolve_device, to_tensor
from repro_torch.ft.checkpoint import restore_checkpoint


@dataclass
class RecoveryPlan:
    """Which survivor takes over each failed worker's partition."""

    mode: str                      # "single" | "multi"
    reassignment: Dict[int, int]   # failed worker tid -> survivor node id
    new_world: List[int]           # surviving node ids
    migration: Optional[Any] = None  # ShardMigration when the DSM rebalanced
    # step.obs: the dead session's flight-recorder dump, taken when recovery
    # started (before an open window drains), when its recorder was armed
    flight_dump: Optional[Dict[str, Any]] = None


def rebalance_shards(store, *, join: Sequence[int] = (), leave: Sequence[int] = ()):
    """Elastic ring rebalance on node join/leave (the store half of §5.4
    recovery).  Joining nodes get a shard arc; leaving nodes' shards hand
    their arcs to the survivors, each topology change as an incremental
    migration window.  Returns the merged
    :class:`~repro_torch.core.shards.ShardMigration` (``bytes_moved`` and
    ``window_s`` summed), or ``None`` when the topology did not change."""
    merged = None
    for sid in join:
        if sid in store.shard_ids():
            continue
        merged = _merge_migrations(merged, store.add_shard(sid))
    for sid in leave:
        if sid not in store.shard_ids() or store.n_shards == 1:
            continue
        merged = _merge_migrations(merged, store.remove_shard(sid))
    return merged


def _merge_migrations(a, b):
    if a is None:
        return b
    # a name moved twice reports its original source and final destination
    moved = dict(a.moved)
    epochs = dict(a.epochs)
    for name, (src, dst) in b.moved.items():
        moved[name] = (moved[name][0] if name in moved else src, dst)
        epochs[name] = b.epochs[name]
    return type(b)(a.added + b.added, a.removed + b.removed, moved, epochs,
                   b.total_names, a.bytes_moved + b.bytes_moved,
                   a.window_s + b.window_s, a.pulled + b.pulled)


def plan_recovery(failed_nodes: Sequence[int], all_nodes: Sequence[int],
                  tids_by_node: Dict[int, List[int]], mode: str = "multi") -> RecoveryPlan:
    survivors = [n for n in all_nodes if n not in set(failed_nodes)]
    if not survivors:
        raise RuntimeError("no survivors — unrecoverable")
    reassignment: Dict[int, int] = {}
    lost_tids = [t for n in failed_nodes for t in tids_by_node.get(n, [])]
    if mode == "single":
        target = survivors[0]
        for t in lost_tids:
            reassignment[t] = target
    elif mode == "multi":
        for i, t in enumerate(lost_tids):
            reassignment[t] = survivors[i % len(survivors)]
    else:
        raise ValueError(f"unknown recovery mode {mode}")
    return RecoveryPlan(mode, reassignment, survivors)


def session_recovery(session, failed_nodes: Sequence[int], mode: str = "multi",
                     threads_per_node: Optional[int] = None,
                     rebalance: bool | str = "auto"):
    """STEP §5.4 on the Session facade: plan the reassignment of a failed
    node's threads and build a replacement host Session over the survivors,
    adopting the old session's store — the paper's "roll back to the latest
    DSM state": shared data survives, only the thread placement changes.

    In order: the flight recorder's dump (when armed) before anything moves;
    an open migration window drained; the ring rebalanced (``"auto"``: the
    failed nodes' shards leave only when ``store.n_shards == n_nodes``, so
    shard ids are node ids; ``True`` forces it, ``False`` never); then the
    new session adopts the store, tracer, checker and recorder as they are."""
    if session.backend.kind != "host":
        raise ValueError("session_recovery drills node failure on the host "
                         "backend; SPMD recovery goes through elastic_restore")
    recorder = getattr(session, "recorder", None)
    flight_dump = None
    if recorder is not None and getattr(recorder, "armed", False):
        trc = session.tracer
        if telemetry.TRACING and trc.enabled:
            trc.mark("lifecycle", "session_recovery",
                     failed=list(failed_nodes), mode=mode)
        flight_dump = recorder.dump(reason="session-recovery")
    # a crash can land mid-migration: the window lives on the store (which
    # survives the session), so recovery first drains it — every entry
    # settles at its ring owner exactly once
    if session.store.migration_window is not None:
        session.store.drain_window()
    pool = session.backend.pool
    tids_by_node = {n: [n * pool.threads_per_node + i
                        for i in range(pool.threads_per_node)]
                    for n in range(pool.n_nodes)}
    plan = plan_recovery(failed_nodes, list(range(pool.n_nodes)),
                         tids_by_node, mode=mode)
    shards_follow_nodes = session.store.n_shards == pool.n_nodes
    if rebalance is True or (rebalance == "auto" and shards_follow_nodes):
        plan.migration = rebalance_shards(session.store, leave=failed_nodes)
    plan.flight_dump = flight_dump
    tpn = threads_per_node or pool.threads_per_node
    new_session = Session(backend=HostBackend(len(plan.new_world), tpn),
                          store=session.store, accum_mode=session.accum_mode,
                          trace=session.tracer, check=session.checker,
                          record=recorder)
    return plan, new_session


def _check_spec(spec, leaf: torch.Tensor, mesh: Mesh) -> None:
    """Raise unless ``spec`` can split ``leaf`` over ``mesh``: as many parts
    as dimensions at most, axes of the mesh, dimensions that split evenly."""
    if spec is None:
        return
    if not isinstance(spec, PartitionSpec):
        raise TypeError(f"a spec must be a PartitionSpec or None, got {spec!r}")
    if len(spec) > leaf.dim():
        raise ValueError(f"spec {spec} has more parts than the leaf's "
                         f"{leaf.dim()} dimensions")
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = tuple(part) if isinstance(part, (tuple, list)) else (part,)
        unknown = [a for a in axes if a not in mesh.shape]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} the mesh "
                             f"{mesh.axis_names} does not have")
        n = math.prod(mesh.shape[a] for a in axes)
        if leaf.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {leaf.shape[dim]} does not "
                             f"split evenly over mesh axes {axes} ({n} positions)")


def reshard_tree(tree: Any, mesh: Mesh, specs: Any):
    """Place a tree on ``mesh``'s device (``None``: the card) under
    ``specs``: one :class:`PartitionSpec` (or ``None``) for every leaf, or a
    tree of them over ``tree``'s structure.  Each spec is checked against
    its leaf and the mesh; the leaf is placed whole (a mesh position takes
    its share when ``shard_map`` enters)."""
    dev = resolve_device(mesh.device)

    def place(spec, node):
        if node is None:
            return None
        if isinstance(node, (dict, list, tuple)):
            one = spec is None or isinstance(spec, PartitionSpec)   # for the subtree
            if isinstance(node, dict):
                return {k: place(spec if one else spec[k], v) for k, v in node.items()}
            if not one and len(spec) != len(node):
                raise ValueError(f"{len(spec)} specs for a sequence of {len(node)}")
            return type(node)(place(spec if one else s, v)
                              for s, v in zip(spec if not one else node, node))
        leaf = node.to(dev) if isinstance(node, torch.Tensor) else to_tensor(node, dev)
        _check_spec(spec, leaf, mesh)
        return leaf

    return place(specs, tree)


def elastic_restore(root: str, template: Any, mesh: Mesh, specs: Any,
                    step: Optional[int] = None):
    """Restore the newest (or a given) checkpoint onto ``mesh`` — multi-node
    recovery (the survivors' mesh) and elastic rescale alike; checkpoints
    are mesh-agnostic, so no conversion pass is needed."""
    tree, extra, got_step = restore_checkpoint(root, template, step=step,
                                               device=mesh.device)
    return reshard_tree(tree, mesh, specs), extra, got_step


def rebalance_batch(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Keep the global batch stable across a DP-degree change where possible;
    otherwise round down to a multiple of the new degree (logged by caller)."""
    if global_batch % new_dp == 0:
        return global_batch
    return max(new_dp, (global_batch // new_dp) * new_dp)
