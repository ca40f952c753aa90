"""Step builders: train_step, prefill_step and decode_step, and the cell.

Port of :mod:`repro.launch.steps`.  The model holds its own weights, so the
serving steps take only the batch, and the train step differentiates the
model's own parameter tree (``model.param_tree()``) and updates it in place
— what the JAX step's donated params and optimizer state stand in for.

``build_cell`` assembles everything a dry run or a real run needs for one
(arch × shape × mesh) cell: the model (with ``data_groups`` the mesh's dp
degree), the step, its inputs and their PartitionSpecs.  On
``device="meta"`` nothing is allocated, as ``repro``'s ShapeDtypeStructs
allocate nothing: the model is built on meta and the inputs are meta
tensors of every input's shape and dtype.  On the card or the CPU the cell
holds the model with its weights and inputs drawn from ``generator``'s
seed, the same on every device.  The
mesh's positions share one device, so the specs give each position's bytes
(``Cell.local_bytes``), not where the bytes live.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.compat import Mesh, P
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.models.common import InitStream, Seed, init_stream
from repro_torch.optim import Optimizer, adamw, clip_by_global_norm
from repro_torch.utils.tree import tree_bytes, tree_count, tree_leaves, tree_unflatten


def make_train_step(model, opt: Optimizer, *, clip_norm: Optional[float] = 1.0):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    loss, metrics)``, ``params`` being ``model.param_tree()``.

    Gradients come from ``torch.autograd.grad`` of ``model.loss_fn`` over the
    tree's leaves; they are cast to ``grad_reduce_dtype`` where the config
    sets one and clipped to ``clip_norm`` (``metrics["grad_norm"]``).  The
    updates are added to the parameters in place, under ``torch.no_grad()``,
    in each parameter's dtype: the bits ``apply_updates`` would give.  Turns
    on gradients for the model's parameters."""
    grad_dtype = getattr(model.cfg, "grad_reduce_dtype", "") or None
    grad_dtype = getattr(torch, grad_dtype) if grad_dtype else None
    model.requires_grad_(True)

    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        loss, metrics = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, leaves)
        if grad_dtype is not None:
            # paper-beyond: reduce DP gradients in bf16 (half the wire
            # bytes); optimizer moments stay fp32
            grads = [g.to(grad_dtype) for g in grads]
        grads = tree_unflatten(params, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            if clip_norm is not None:
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
                metrics["grad_norm"] = gnorm
            updates, opt_state = opt.update(grads, opt_state, params, step)
            del grads
            for p, u in zip(leaves, tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        return params, opt_state, loss.detach(), metrics

    return train_step


def make_prefill_step(model):
    """``prefill_step(batch) -> logits``: the model's forward on the whole
    batch dict (tokens; the vlm's ``vision_embeds``, the audio family's
    ``frames``), with no gradient recorded."""

    @torch.no_grad()
    def prefill_step(batch):
        return model.forward(batch)

    return prefill_step


def make_decode_step(model):
    @torch.no_grad()
    def decode_step(batch):
        logits, cache = model.decode_step(batch["cache"], batch["tokens"], batch["pos"])
        return logits, cache

    return decode_step


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------


def abstract_params(model) -> Dict[str, torch.Tensor]:
    """The model's parameter tree as meta tensors (shapes and dtypes only)."""
    return {name: torch.empty_like(t, device="meta") for name, t in model.param_tree().items()}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, model) -> dict:
    """Meta stand-ins for every model input of this cell (``repro``'s
    ShapeDtypeStructs); a decode cell's cache is the model's own
    ``init_cache`` on meta."""
    B, T = shape.global_batch, shape.seq_len
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    act = bf16 if cfg.dtype != "float32" else f32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"frames": sds((B, T, cfg.frame_dim), act), "labels": sds((B, T), i32)}
        else:
            batch = {"tokens": sds((B, T), i32), "labels": sds((B, T), i32)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = sds((B, cfg.vision_tokens, cfg.vision_dim or cfg.d_model),
                                         act)
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token against a seq_len-deep cache
    batch = {"cache": _meta_cache(model, B, T), "tokens": sds((B, 1), i32),
             "pos": sds((), i32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = sds((B, cfg.vision_tokens, cfg.vision_dim or cfg.d_model), act)
    return batch


def _meta_cache(model, batch: int, max_len: int):
    """``model.init_cache(batch, max_len)`` made on meta whatever the
    model's device, so that no cache is allocated beside the one
    ``_materialize`` makes (long_500k's caches hold 48 GB for zamba2)."""
    device, model.device = model.device, torch.device("meta")
    try:
        return model.init_cache(batch, max_len)
    finally:
        model.device = device


def batch_shard_specs(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, model, batch_sds) -> Any:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if shape.kind in ("train", "prefill"):
        specs = {k: P(dp, *([None] * (len(v.shape) - 1))) for k, v in batch_sds.items()}
        return sh.sanitize_tree(specs, batch_sds, mesh)
    specs = {"cache": sh.cache_specs(batch_sds["cache"], mesh),
             "tokens": P(dp, None),
             "pos": P()}
    if "vision_embeds" in batch_sds:
        specs["vision_embeds"] = P(dp, None, None)
    return sh.sanitize_tree(specs, batch_sds, mesh)


def _materialize(batch_sds: dict, cfg: ArchConfig, shape: ShapeSpec, model, device,
                 stream: InitStream) -> dict:
    """Inputs of the stand-ins' shapes and dtypes on ``device``, drawn from
    ``stream`` after the model's weights (the same on every device):
    integer tokens and labels below the vocabulary, float inputs N(0, 1), a
    decode cell's cache the model's zeros and its position the last slot."""
    out = {}
    for name, x in batch_sds.items():
        if name == "cache":
            out[name] = model.init_cache(shape.global_batch, shape.seq_len)
        elif name == "pos":
            out[name] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
        elif x.dtype.is_floating_point:
            out[name] = stream.draw(x.shape, dtype=x.dtype, device=device)
        else:
            out[name] = stream.draw(x.shape, kind="integers", high=cfg.vocab, dtype=x.dtype,
                                    device=device)
    return out


@dataclass
class Cell:
    """One (arch × shape × mesh) cell.  ``step(*args)`` runs the train,
    prefill or decode step with the cell's mesh registered
    (:func:`~repro_torch.launch.shardings.set_mesh_axis_sizes`); ``args``
    are meta tensors on a meta cell, the real inputs otherwise.
    ``local_bytes`` holds one position's bytes under the specs:
    ``params``, ``opt`` (the optimizer state), ``batch``, ``out`` (the
    step's outputs) and ``alias`` (outputs that reuse an input's memory, as
    the JAX step's donated buffers do)."""

    cfg: ArchConfig
    shape: ShapeSpec
    mesh: Mesh
    model: Any
    step_fn: Callable
    args: tuple
    param_count: int
    param_bytes: int
    specs: dict = field(default_factory=dict)
    local_bytes: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def step(self, *args):
        sh.set_mesh_axis_sizes(self.mesh)
        return self.step_fn(*args)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, *, fsdp: bool = False,
               opt: Optional[Optimizer] = None, device=None,
               generator: Seed = None) -> Cell:
    """Assemble the model, step and inputs for one (arch × shape × mesh) on
    ``device`` (``None``: the card; ``"meta"``: allocating nothing), the
    weights and then the inputs drawn from ``generator``'s seed (as
    ``build_model``'s: the same on every device)."""
    from repro_torch.models.build import build_model

    device = resolve_device(device)
    sh.set_mesh_axis_sizes(mesh)
    dp_axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    dp = 1
    for ax in dp_axes:
        dp *= int(mesh.shape[ax])
    cfg = cfg.replace(batch_axes=dp_axes)
    stream = init_stream(generator)
    model = build_model(cfg, device, stream, data_groups=dp)

    params = model.param_tree()
    p_specs = sh.param_specs(params, fsdp=fsdp)
    batch_sds = input_specs(cfg, shape, model)
    b_specs = batch_shard_specs(cfg, shape, mesh, model, batch_sds)
    batch = batch_sds if device.type == "meta" else _materialize(
        batch_sds, cfg, shape, model, device, stream)

    vocab_ax = "model" if cfg.vocab % int(mesh.shape["model"]) == 0 else None
    B, T = shape.global_batch, shape.seq_len
    out_T = T if (shape.kind == "prefill" and not cfg.prefill_last_only) else 1
    logits_shape = (B, out_T, cfg.vocab)
    logits_spec = sh.sanitize_spec(P(dp_axes, None, vocab_ax), logits_shape, mesh)
    logits_local = sh.local_bytes([torch.empty(logits_shape, device="meta",
                                               dtype=getattr(torch, cfg.dtype))],
                                  [logits_spec], mesh)
    local = {"params": sh.local_bytes(params, p_specs, mesh),
             "batch": sh.local_bytes(batch_sds, b_specs, mesh), "opt": 0}
    specs = {"params": p_specs, "batch": b_specs, "logits": logits_spec}

    if shape.kind == "train":
        opt = opt or adamw(lr=3e-4)
        opt_state = opt.init(params)
        o_specs = sh.param_specs(opt_state, fsdp=fsdp)
        local["opt"] = sh.local_bytes(opt_state, o_specs, mesh)
        # new params and state, the loss and the grad norm (fp32 scalars)
        local["out"] = local["params"] + local["opt"] + 8
        local["alias"] = local["params"] + local["opt"]        # donated
        specs["opt"] = o_specs
        train_step = make_train_step(model, opt)

        def step_fn(params, opt_state, batch, step):
            return train_step(params, opt_state, batch, _as_int(step, 0))

        step = torch.empty((), dtype=torch.int32, device="meta") if device.type == "meta" \
            else torch.tensor(0, dtype=torch.int32)
        args = (params, opt_state, batch, step)
    elif shape.kind == "prefill":
        prefill_step = make_prefill_step(model)
        local["out"], local["alias"] = logits_local, 0

        def step_fn(params, batch):
            return prefill_step(batch)

        args = (params, batch)
    else:  # decode
        decode_step = make_decode_step(model)
        cache_local = sh.local_bytes(batch_sds["cache"], b_specs["cache"], mesh)
        local["out"] = logits_local + cache_local
        local["alias"] = cache_local                          # updated in place

        def step_fn(params, batch):
            return decode_step(dict(batch, pos=_as_int(batch["pos"], T - 1)))

        args = (params, batch)

    return Cell(cfg, shape, mesh, model, step_fn, args, tree_count(params), tree_bytes(params),
                specs, local)


def _as_int(x, meta_value: int) -> int:
    """A step's scalar input as an int; a meta scalar has no value, so it
    stands for ``meta_value``."""
    if isinstance(x, torch.Tensor):
        return meta_value if x.device.type == "meta" else int(x)
    return int(x)
