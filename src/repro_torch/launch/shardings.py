"""Partition rules: parameter/activation PartitionSpecs for DP/FSDP/TP/EP.

Port of :mod:`repro.launch.shardings`.  Rules pattern-match on leaf *paths*
(the naming contract of models/) and give a spec for the **trailing** dims;
leading dims are padded with ``None``.  ``fsdp=True`` additionally shards
the d_model-ish dims over the data axis.  The port's dotted names carry a
layer index where ``repro``'s leaves carry a leading stack dim
(``segments.seg1.0.moe.w_up`` against ``segments.seg1.moe.w_up``), so each
port leaf's spec is ``repro``'s with the stacked dims dropped.

A spec tree has a :class:`~repro_torch.core.compat.PartitionSpec` where the
value tree has a leaf.  :func:`to_shardings` gives :class:`NamedSharding`\\ s
whose ``shard`` is a position's view of a tensor (no copy): the mesh's
positions share one device, so a spec says what each position reads and
what it would hold, not where the bytes live.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

import torch

from repro_torch.core.compat import Mesh, PartitionSpec as P, _split
from repro_torch.utils.tree import (tree_flatten_with_paths, tree_leaves,
                                    tree_unflatten)


def _rules(fsdp_axis) -> List[Tuple[str, Tuple]]:
    f = fsdp_axis  # None or "data"
    return [
        # embeddings / heads
        (r"embed\.table$", ("model", f)),
        (r"head\.w$", (f, "model")),
        (r"in_proj\.w$", (None, f)),          # audio frontend proj
        (r"vision_proj\.w$", (None, f)),
        # attention (GQA)
        (r"attn\.wq$", (f, "model", None)),
        (r"attn\.wk$", (f, "model", None)),
        (r"attn\.wv$", (f, "model", None)),
        (r"attn\.wo$", ("model", None, f)),
        (r"attn\.b[qkv]$", ("model", None)),
        (r"attn\.[qk]_norm$", (None,)),
        # attention (MLA)
        (r"attn\.w_dq$", (f, None)),
        (r"attn\.w_uq$", (None, "model", None)),
        (r"attn\.w_dkv$", (f, None)),
        (r"attn\.w_kr$", (f, None)),
        (r"attn\.w_uk$", (None, "model", None)),
        (r"attn\.w_uv$", (None, "model", None)),
        (r"attn\.kv_norm$", (None,)),
        # dense ffn
        (r"ffn\.w_gate$", (f, "model")),
        (r"ffn\.w_up$", (f, "model")),
        (r"ffn\.w_down$", ("model", f)),
        (r"ffn\.w_in$", (f, "model")),
        (r"ffn\.w_out$", ("model", f)),
        (r"ffn\.b_in$", ("model",)),
        (r"ffn\.b_out$", (None,)),
        # MoE: experts over the model axis (EP), optional fsdp on d_model dim
        (r"moe\.router$", (f, None)),
        (r"moe\.w_gate$", ("model", f, None)),
        (r"moe\.w_up$", ("model", f, None)),
        (r"moe\.w_down$", ("model", None, f)),
        (r"moe\.shared\.w_gate$", (f, "model")),
        (r"moe\.shared\.w_up$", (f, "model")),
        (r"moe\.shared\.w_down$", ("model", f)),
        # mamba2
        (r"mamba\.in_proj$", (f, "model")),
        (r"mamba\.conv_w$", (None, "model")),
        (r"mamba\.conv_b$", ("model",)),
        (r"mamba\.(A_log|dt_bias|D)$", (None,)),
        (r"mamba\.norm$", ("model",)),
        (r"mamba\.out_proj$", ("model", f)),
        # mtp
        (r"mtp\.proj$", (f, None)),
        # norms and anything small: replicated
        (r"(norm|norm1|norm2|final_norm|norm_h|norm_e)\.(scale|bias)$", None),
    ]


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _spec_leaves(specs: Any) -> list:
    """The specs of a spec tree, in the value tree's flattening order (a
    :class:`PartitionSpec` is a tuple, so a plain walk would enter it)."""
    if _is_spec(specs):
        return [specs]
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for child in specs for s in _spec_leaves(child)]


def param_specs(params: Any, *, fsdp: bool = False) -> Any:
    """Tree of PartitionSpecs matching ``params`` (meta tensors too)."""
    rules = _rules("data" if fsdp else None)
    specs = []
    for path, leaf in tree_flatten_with_paths(params):
        spec = None
        for pat, trailing in rules:
            if re.search(pat, path):
                if trailing is None:
                    spec = P()
                else:
                    ndim = len(leaf.shape)
                    pad = (None,) * (ndim - len(trailing))
                    dims = pad + tuple(trailing)
                    # drop axes that don't divide the dim size
                    fixed = []
                    for size, ax in zip(leaf.shape, dims):
                        if ax is not None and size % _axis_div(ax) != 0:
                            fixed.append(None)
                        else:
                            fixed.append(ax)
                    spec = P(*fixed)
                break
        if spec is None:
            spec = P()  # replicate by default
        specs.append(spec)
    return tree_unflatten(params, specs)


_AXIS_SIZES = {"model": 16, "data": 16, "pod": 2}
CURRENT_MESH = None  # registered by set_mesh_axis_sizes; used by the EP MoE


def _axis_div(ax) -> int:
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= _AXIS_SIZES.get(a, 1)
        return n
    return _AXIS_SIZES.get(ax, 1)


def set_mesh_axis_sizes(mesh: Mesh) -> None:
    """Record mesh axis sizes so rules can drop non-dividing axes, and the
    mesh the EP MoE runs its positions on."""
    global _AXIS_SIZES, CURRENT_MESH
    _AXIS_SIZES = {name: int(mesh.shape[name]) for name in mesh.axis_names}
    CURRENT_MESH = mesh


def batch_spec(mesh: Mesh, *, seq_axis=None) -> P:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return P(dp, seq_axis)


def _axis_size_in(mesh: Mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= int(mesh.shape[a])
        return n
    return int(mesh.shape[ax])


def sanitize_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop sharding on dims the mesh axes don't divide (e.g. batch=1 decode)."""
    dims = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    fixed = []
    for size, ax in zip(shape, dims):
        fixed.append(ax if (ax is None or size % _axis_size_in(mesh, ax) == 0) else None)
    return P(*fixed)


def sanitize_tree(specs, tree, mesh: Mesh):
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, [sanitize_spec(s, x.shape, mesh)
                                 for s, x in zip(_spec_leaves(specs), leaves)])


def cache_specs(cache: Any, mesh: Mesh) -> Any:
    """KV/SSM caches: batch dim over data axes, head-ish dims over model.

    Cache leaves look like (B, S, KH, hd) / (B, S, r) / mamba conv (B, K, C)
    / ssm (B, H, N, P), after any leading dims.  The batch dim goes over
    data, and any KH/H/C dim over model when divisible, by the leaf's name.
    """
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    model_n = int(mesh.shape["model"])

    specs = []
    for path, leaf in tree_flatten_with_paths(cache):
        nd = len(leaf.shape)
        if path.endswith(".k") or path.endswith(".v") or \
                path.endswith(".k_q") or path.endswith(".v_q") or \
                path.endswith(".k_s") or path.endswith(".v_s"):
            # (..., B, S, KH, hd|1)
            lead = (None,) * (nd - 4)
            kh = leaf.shape[-2]
            specs.append(P(*lead, dp, None, "model" if kh % model_n == 0 else None, None))
        elif path.endswith(".c_kv") or path.endswith(".k_rope"):
            lead = (None,) * (nd - 3)
            specs.append(P(*lead, dp, None, None))
        elif path.endswith(".conv"):
            # (..., B, K, C)
            lead = (None,) * (nd - 3)
            c = leaf.shape[-1]
            specs.append(P(*lead, dp, None, "model" if c % model_n == 0 else None))
        elif path.endswith(".ssm"):
            # (..., B, H, N, P)
            lead = (None,) * (nd - 4)
            h = leaf.shape[-3]
            specs.append(P(*lead, dp, "model" if h % model_n == 0 else None, None, None))
        else:
            specs.append(P())
    return tree_unflatten(cache, specs)


class NamedSharding:
    """``jax.sharding.NamedSharding``'s counterpart: ``spec`` over ``mesh``.
    :meth:`shard` is position ``linear``'s block of a tensor, a view
    (``narrow``, as :func:`~repro_torch.core.compat.shard_map` splits its
    inputs)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def shard(self, x: torch.Tensor, linear: int) -> torch.Tensor:
        return _split(self.spec, x, self.mesh, self.mesh.coords(linear))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"NamedSharding({self.mesh!r}, {tuple(self.spec)})"


def to_shardings(specs: Any, mesh: Mesh) -> Any:
    """The spec tree as a tree of :class:`NamedSharding`."""
    if _is_spec(specs):
        return NamedSharding(mesh, specs)
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(to_shardings(v, mesh) for v in specs))
    return type(specs)(to_shardings(v, mesh) for v in specs)


def local_bytes(tree: Any, specs: Any, mesh: Mesh) -> int:
    """Bytes of ``tree`` one position holds under ``specs``: each leaf's
    bytes over the positions that split it."""
    total = 0
    for x, s in zip(tree_leaves(tree), _spec_leaves(specs)):
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
        else:
            n = 0
        total += n // math.prod(_axis_size_in(mesh, ax) for ax in s)
    return total
