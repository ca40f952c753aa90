"""Carry a JAX parameter tree into the port's modules.

``repro``'s models keep their parameters as nested dicts whose layer stacks
carry a leading layer axis; the port keeps the same names in
``nn.ModuleDict`` / ``nn.ParameterDict``\\ s with one ``nn.ModuleList``
entry per layer.  :func:`load_jax_params` copies the first into the second,
so both packages compute the same function on the same weights (the tests
hold one against the other that way).  :func:`load_jax_opt_state` carries
the optimizer state of a JAX run across beside them, so that a run stopped
at step k in ``repro`` goes on in the port.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def load_jax_params(module: nn.Module, tree: Mapping[str, Any], path: str = "") -> nn.Module:
    """Copy ``tree`` — nested dicts of numpy arrays, what
    ``jax.tree.map(np.asarray, model.init(key))`` gives — into ``module``
    in place, on its device and in its dtypes.  Names must match exactly and
    shapes must agree; a node's leaves (its own parameters) and sub-trees
    (its children) may sit side by side, as in an MoE layer's ``router``
    beside its ``shared`` FFN; a stacked leaf of a ``ModuleList`` is split
    along its leading layer axis, and a list of lists takes the next axis in
    turn (``repro``'s hybrid superblocks, ``segments/mamba/<leaf>`` of shape
    ``(n_super, period, ...)``).  Returns ``module``."""
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            load_jax_params(child, _layer(tree, i), f"{path}/{i}")
        return module
    leaves = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    _same_keys(path, set(leaves) | set(children), set(tree))
    for name, p in leaves.items():
        value = np.asarray(tree[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{path}/{name}: shape {value.shape} does not match the "
                             f"port's {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)).to(p.dtype))
    for name, child in children.items():
        load_jax_params(child, tree[name], f"{path}/{name}")
    return module


def _layer(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _same_keys(path: str, ours: set, theirs: set) -> None:
    if ours != theirs:
        raise KeyError(f"{path or '/'}: the port has {sorted(ours - theirs)} that the JAX "
                       f"tree lacks, and lacks {sorted(theirs - ours)}")


def _jax_leaf(tree: Mapping[str, Any], name: str) -> np.ndarray:
    """The leaf of ``tree`` under the port's dotted parameter ``name``: a
    numeric part that is no key of its dict indexes the stacked layer axis
    of the leaf below it (two such parts, a doubly stacked leaf's two)."""
    node, layers = tree, []
    for part in name.split("."):
        if part.isdigit() and part not in node:
            layers.append(int(part))
        else:
            node = node[part]
    arr = np.asarray(node)
    for i in layers:
        arr = arr[i]
    return arr


def jax_tree_to_params(module: nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree shaped like ``repro``'s parameters (stacked layer axes, numpy
    leaves) as the port's parameter tree (``module.param_tree()``'s keys),
    fp32 on the module's parameters' devices, shapes checked."""
    out = {}
    for name, p in module.named_parameters():
        arr = _jax_leaf(tree, name)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} does not match the port's "
                             f"{tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(p.device)
    return out


def load_jax_opt_state(module: nn.Module, state):
    """``repro``'s optimizer state over ``module``'s parameters as the port's:
    an ``AdamState`` (``mu``/``nu`` trees with stacked layer axes, numpy
    leaves) becomes the port's ``AdamState`` over ``param_tree()``'s names,
    fp32 on the module's devices; SGD's momentum tree likewise, and its
    empty state stays empty.  With :func:`load_jax_params` it lets a JAX
    run's (params, opt_state) at step k go on in the port from step k + 1."""
    from repro_torch.optim.optimizers import AdamState
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return AdamState(jax_tree_to_params(module, state.mu),
                         jax_tree_to_params(module, state.nu))
    if isinstance(state, tuple) and not state:
        return ()
    return jax_tree_to_params(module, state)
