"""Optimizers on PyTorch tensors: SGD / momentum / Adam / AdamW.

Port of :mod:`repro.optim.optimizers`, with its functional protocol over any
tree :mod:`repro_torch.utils.tree` walks:

    opt = adamw(lr=3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The JAX package's arithmetic is the contract: moments in fp32, Adam's bias
correction and schedule at ``step + 1`` (SGD's schedule at ``step``), the
clip's ``1e-9``.  Scalars (the learning rate, the bias corrections) are fp32
0-dim tensors on the host, as the JAX package's are fp32 arrays; a step may
be an int or a 0-dim tensor.  ``update`` builds new state and new updates,
as in JAX; the train step (:mod:`repro_torch.launch.steps`) applies them to
its parameters in place, which stands in for the JAX step's donated
buffers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]
LR = Union[float, Schedule]


def _lr_at(lr: LR, step) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)


def _step_tensor(step, dtype) -> torch.Tensor:
    return torch.as_tensor(step).to("cpu", dtype)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)
    name: str = "optimizer"


def apply_updates(params, updates):
    """``p + u`` in ``p``'s dtype, leaf by leaf (a new tree)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# -- SGD / momentum -----------------------------------------------------------


def sgd(lr: LR = 1e-2, momentum: Optional[float] = None, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum is None:
            return ()
        return tree_map(_zeros_f32, params)

    def update(grads, state, params=None, step=0):
        lr_t = _lr_at(lr, step)
        if momentum is None:
            return tree_map(lambda g: -lr_t * g.float(), grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr_t * (momentum * m + g.float()), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, new_m)
        return upd, new_m

    return Optimizer(init, update, "sgd")


# -- Adam / AdamW ---------------------------------------------------------------


class AdamState(NamedTuple):
    mu: object
    nu: object


def adam(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, name: str = "adam") -> Optimizer:
    def init(params):
        return AdamState(tree_map(_zeros_f32, params), tree_map(_zeros_f32, params))

    def update(grads, state: AdamState, params=None, step=0):
        step = _step_tensor(step, torch.int32) + 1
        lr_t = _lr_at(lr, step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m, v, p):
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.float()
            return u

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(mu, nu)

    return Optimizer(init, update, name)


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, name="adamw")


# -- schedules -------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    def sched(step):
        step = _step_tensor(step, torch.float32)
        warm = peak_lr * step / max(1.0, warmup_steps)
        frac = torch.clamp((step - warmup_steps) / max(1.0, total_steps - warmup_steps), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in fp32, summed in leaf order."""
    total = sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-9)), norm)``; a leaf narrower
    than fp32 comes back in fp32, as JAX promotes it by the fp32 scale."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale,
                    grads), norm
