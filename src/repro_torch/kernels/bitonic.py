"""The (|x| desc, index asc) order of the top-k kernels, as packed sort keys.

:mod:`repro.kernels.bitonic` sorts (magnitude, index) pairs with a bitonic
network, -1 marking invalid lanes and -inf the pad lanes.  The port packs
each lane into one integer key that orders the same way::

    key = ((valid ? float_bits(|x|) + 1 : 0) << 32) | (0xFFFFFFFF - pos)

``|x|`` has no sign bit, so its bits order like the float, and ``+1`` lifts
every valid magnitude above the invalid lanes' 0; the low half breaks ties
toward the lower position, and a pad lane (``pos`` past the block) ranks
below every invalid lane, as -inf ranks below -1.  The high half stays below
2**31, so the key fits a non-negative int64.  Keys are unique, so any sort
of them gives the one strict order.

The CUDA kernels run the network itself, on the same keys, in shared memory
(``csrc/bitonic.cuh``).  This module is the plain version they are held
against: ``torch.sort`` of the keys.
"""

from __future__ import annotations

import torch

_LOW = 0xFFFFFFFF


def topk_keys(x: torch.Tensor, valid: torch.Tensor, pos=None) -> torch.Tensor:
    """int64 sort keys of ``x`` along its last axis.  ``valid`` broadcasts
    against ``x``; ``pos`` (default: the last-axis position) is each lane's
    position within its block."""
    if pos is None:
        pos = torch.arange(x.shape[-1], device=x.device)
    mag_bits = x.float().abs().view(torch.int32).to(torch.int64) + 1
    hi = torch.where(valid, mag_bits, torch.zeros((), dtype=torch.int64,
                                                  device=x.device))
    return (hi << 32) | (_LOW - pos.to(torch.int64))


def sort_desc(keys: torch.Tensor) -> torch.Tensor:
    """Keys sorted descending along the last axis: (|x| desc, index asc),
    valid lanes first, then invalid lanes, then pad lanes."""
    return torch.sort(keys, dim=-1, descending=True).values


def key_pos(keys: torch.Tensor) -> torch.Tensor:
    """The within-block position each key was made from (int64)."""
    return _LOW - (keys & _LOW)


def key_valid(keys: torch.Tensor) -> torch.Tensor:
    """True where the key belongs to a valid lane (a real entry of x)."""
    return (keys >> 32) != 0
