"""The step functions: train_step, prefill_step and decode_step.

Port of :mod:`repro.launch.steps`.  The model holds its own weights, so the
serving steps take only the batch, and the train step differentiates the
model's own parameter tree (``model.param_tree()``) and updates it in place
— what the JAX step's donated params and optimizer state stand in for.
Sharding and ``build_cell`` belong to a later slice (ROADMAP Queue 1 item 11,
deferred item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_unflatten


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
