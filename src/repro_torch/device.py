"""Device resolution for the port: the card unless the caller asks for the CPU.

Every entry point of :mod:`repro_torch` takes ``device=None`` and resolves it
here.  ``None`` means ``"cuda"``; on a host with no visible GPU that raises
instead of silently running on the CPU — a CPU run is always asked for by
name (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: repro_torch runs on the card by "
                "default — pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_tensor(value, device: torch.device) -> torch.Tensor:
    """``value`` as a tensor on ``device``, with JAX's default dtypes.

    The JAX package runs with 64-bit types disabled, so its ``asarray`` turns
    float64 into float32 and int64 into int32.  Canonicalising the same way
    keeps stored shapes, dtypes and wire-byte counts equal across the two
    packages.  A tensor already on ``device`` with a 32-bit type is returned
    as is (no copy).  A numpy array is never aliased: the caller may go on
    mutating it, while stored values are treated as immutable."""
    borrowed = isinstance(value, np.ndarray)
    if isinstance(value, torch.Tensor):
        t = value
    elif borrowed:
        arr = np.ascontiguousarray(value)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    else:
        t = torch.as_tensor(value)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    t = t.to(device)
    if borrowed and t.device.type == "cpu":
        t = t.clone()
    return t


def card_info() -> str:
    """``name, power.limit`` of every visible card, as ``nvidia-smi`` prints
    them — the line written beside every number measured on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
