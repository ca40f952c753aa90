"""ZeRO-1: the paper's accumulator as a sharded optimizer (port of
:mod:`repro.optim.zero`).

STEP §5.2: chunk *i* of every thread's gradient goes to node *i*, which reduces
locally and updates the output shared array.  If the optimizer state for
chunk *i* also lives with its owner, "update the shared array" becomes a full
optimizer step on 1/N of the parameters: ZeRO stage 1.  Inside a mesh
position (:mod:`repro_torch.core.compat`, positions as threads on one
device), per step:

  1. pack the gradient tree into one package-aligned fp32 buffer
     (:func:`~repro_torch.core.dsm.pack_tree`),
  2. ``accumulate_scatter`` (``psum_scatter``) → this position's chunk of the
     sum, divided by N: the data-parallel mean,
  3. the owner updates its optimizer-state chunk and fp32 master chunk,
  4. ``all_gather`` → the full updated parameters, unpacked and cast.

fp32 master weights and moments exist only as 1/N chunks per position.  The
step is a Python int (the JAX package's is a 0-dim int32 array).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.accumulator import accumulate_scatter
from repro_torch.core.addressing import align_up
from repro_torch.core.compat import all_gather
from repro_torch.core.compat import axis_size as compat_axis_size
from repro_torch.core.dsm import PackSpec, pack_spec, pack_tree, unpack_tree
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import tree_map


class Zero1State(NamedTuple):
    """Per-position chunk of the sharded optimizer/master state."""

    master_chunk: torch.Tensor   # fp32 master params, this position's chunk
    opt_state: object            # optimizer state over the chunk (fp32)
    step: int


def _chunk_len(total: int, n_shards: int) -> int:
    return align_up(total, n_shards) // n_shards


def zero1_init(params, opt: Optimizer, axis_size: int, axis_index: int,
               spec: Optional[PackSpec] = None) -> Zero1State:
    """This position's Zero1State chunk from (replicated) initial params.

    ``axis_index`` is the position's index on the data axis.  The chunk is
    a copy, so the packed buffer of the whole tree is not kept alive."""
    spec = spec or pack_spec(params)
    with torch.no_grad():
        flat = pack_tree(params, spec, dtype=torch.float32)
    clen = _chunk_len(spec.total, axis_size)
    if flat.numel() < clen * axis_size:
        flat = torch.nn.functional.pad(flat, (0, clen * axis_size - flat.numel()))
    chunk = flat[axis_index * clen:(axis_index + 1) * clen].clone()
    return Zero1State(chunk, opt.init(chunk), 0)


def zero1_update(grads, state: Zero1State, opt: Optimizer, axis,
                 spec: PackSpec, compute_dtype=torch.bfloat16):
    """One accumulator-sharded optimizer step; returns (new_params, new_state).

    Runs inside a mesh position over ``axis`` (the data/"node" axis).
    ``grads`` is this position's local gradient tree (already averaged over
    its microbatch)."""
    n = compat_axis_size(axis)

    # (1) coarse-grained packing: one fused package-aligned buffer
    flat_g = pack_tree(grads, spec, dtype=torch.float32)

    # (2) reduce-scatter: the paper's chunk-i-to-node-i, then the mean
    grad_chunk = accumulate_scatter(flat_g, axis) / n
    del flat_g

    # (3) owner updates its optimizer shard + master chunk
    updates, new_opt = opt.update(grad_chunk, state.opt_state, state.master_chunk, state.step)
    new_master = state.master_chunk + updates

    # (4) republish: all-gather the updated chunks, unpack, cast to compute dtype
    full = all_gather(new_master, axis, axis=0, tiled=True)[:spec.total]
    new_params = tree_map(lambda a, ref: a.to(ref.dtype), unpack_tree(full.float(), spec), grads)
    if compute_dtype is not None:
        new_params = tree_map(lambda p: p.to(compute_dtype), new_params)
    return new_params, Zero1State(new_master, new_opt, state.step + 1)


def zero1_gather_params(state: Zero1State, axis, spec: PackSpec, dtype=torch.bfloat16):
    """Materialise full params from the sharded master chunks (for eval/ckpt)."""
    full = all_gather(state.master_chunk, axis, axis=0, tiled=True)[:spec.total]
    return tree_map(lambda p: p.to(dtype), unpack_tree(full, spec))
