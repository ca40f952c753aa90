"""STEP on PyTorch and CUDA: the host-backend port of :mod:`repro`.

The package mirrors :mod:`repro`'s layout module by module, so each piece has
an obvious counterpart; the JAX package stays the reference the tests hold
this one against.  Entry points run on the card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).  The hand-written Hopper
kernels live in ``csrc/`` and are built on first use by
:mod:`repro_torch.kernels.build`.
"""

from repro_torch.device import card_info, resolve_device

__all__ = ["card_info", "resolve_device"]
