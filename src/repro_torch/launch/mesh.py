"""Mesh construction: the port's counterpart of :mod:`repro.launch.mesh`.

A mesh of the port is positions as threads on one device
(:class:`~repro_torch.core.compat.Mesh`), so building one needs no device
count: the production mesh's 256 positions run as 256 threads.  The axis
contract is ``repro``'s:

  pod   — data parallel across pods
  data  — data parallel / FSDP / ZeRO shard axis within a pod
  model — tensor/expert parallel axis

The hardware constants keep ``repro``'s names; their values are one NVIDIA
H100 SXM's, from NVIDIA's published data sheet (no TPU figure survives).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.compat import Mesh, make_mesh


def _mk(shape: Sequence[int], names: Sequence[str], device=None) -> Mesh:
    """A mesh of ``shape`` positions named ``names``, on ``device`` (``None``:
    wherever the tensors handed to it live)."""
    return make_mesh(shape, names, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, pod: Optional[int] = None,
                   device=None) -> Mesh:
    """Small mesh (tests / examples / one card)."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device)
    return _mk((data, model), ("data", "model"), device)


def data_axes(mesh: Mesh) -> tuple:
    """Axes the batch is sharded over (pod folds into data parallel)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_degree(mesh: Mesh) -> int:
    d = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        d *= mesh.shape["pod"]
    return d


# Hardware constants for the roofline (NVIDIA H100 SXM, one card)
PEAK_FLOPS_BF16 = 989.4e12     # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12               # bytes/s, HBM3
ICI_LINK_BW = 450e9            # bytes/s: NVLink 4, one direction (900 GB/s both);
                               # the name is repro's, the link NVLink, not ICI
HBM_BYTES = 80 * 10**9         # 80 GB
