"""Step builders for serving: prefill_step and decode_step.

Port of the serving half of :mod:`repro.launch.steps`.  The model holds its
own weights, so a step takes only the batch.  Sharding, ``build_cell`` and
the train step belong to later slices (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import torch


def make_prefill_step(model):
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
