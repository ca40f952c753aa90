"""Carry a JAX parameter tree into the port's modules.

``repro``'s models keep their parameters as nested dicts whose layer stacks
carry a leading layer axis; the port keeps the same names in
``nn.ModuleDict`` / ``nn.ParameterDict``\\ s with one ``nn.ModuleList``
entry per layer.  :func:`load_jax_params` copies the first into the second,
so both packages compute the same function on the same weights (the tests
hold one against the other that way).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def load_jax_params(module: nn.Module, tree: Mapping[str, Any], path: str = "") -> nn.Module:
    """Copy ``tree`` — nested dicts of numpy arrays, what
    ``jax.tree.map(np.asarray, model.init(key))`` gives — into ``module``
    in place, on its device and in its dtypes.  Names must match exactly and
    shapes must agree; a stacked leaf of a ``ModuleList`` is split along its
    leading layer axis.  Returns ``module``."""
    if isinstance(module, nn.ParameterDict):
        _same_keys(path, set(module.keys()), set(tree))
        for name, p in module.items():
            value = np.asarray(tree[name])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{path}/{name}: shape {value.shape} does not match the "
                                 f"port's {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)).to(p.dtype))
    elif isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            load_jax_params(child, _layer(tree, i), f"{path}/{i}")
    else:
        children = dict(module.named_children())
        _same_keys(path, set(children), set(tree))
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
