"""Optimizers, ZeRO-1 and error-feedback compression on PyTorch (port of
:mod:`repro.optim`)."""

from repro_torch.optim.compression import EFState, compressed_accumulate, compression_ratio, ef_init
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
    warmup_cosine,
)
from repro_torch.optim.zero import Zero1State, zero1_gather_params, zero1_init, zero1_update

__all__ = [
    "EFState", "compressed_accumulate", "compression_ratio", "ef_init",
    "AdamState", "Optimizer", "adam", "adamw", "apply_updates",
    "clip_by_global_norm", "global_norm", "sgd", "warmup_cosine",
    "Zero1State", "zero1_gather_params", "zero1_init", "zero1_update",
]
