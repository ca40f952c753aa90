"""Feed-forward layers: dense SwiGLU and GELU MLPs.

Port of the dense half of :mod:`repro.models.ffn`; Mixture-of-Experts waits
for a later slice (ROADMAP Queue 1 item 11, deferred item 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.common import dense_init, params


def init_dense_ffn(d_model: int, d_ff: int, *, kind: str = "swiglu", bias: bool = False,
                   dtype=torch.float32, device=None,
                   generator: Optional[torch.Generator] = None) -> nn.ParameterDict:
    kw = dict(in_axis=0, dtype=dtype, device=device, generator=generator)
    if kind == "swiglu":
        p = {
            "w_gate": dense_init((d_model, d_ff), **kw),
            "w_up": dense_init((d_model, d_ff), **kw),
            "w_down": dense_init((d_ff, d_model), **kw),
        }
    else:  # gelu MLP (starcoder2 / hubert)
        p = {
            "w_in": dense_init((d_model, d_ff), **kw),
            "w_out": dense_init((d_ff, d_model), **kw),
        }
        if bias:
            p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
            p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return params(p)


def dense_ffn(p, x: torch.Tensor, *, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    h = nn.functional.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out
