"""K-means assignment: nearest center and its squared distance, per point.

Port of :mod:`repro.kernels.kmeans_assign`: points (N, D), centers (K, D) →
``(assign int32 (N,), dist² float32 (N,))`` with d² = ‖p‖² − 2p·c + ‖c‖² in
fp32 (bfloat16 inputs converted first), the first minimum winning.

On the card one CUDA launch does it (``csrc/kmeans_assign.cu``: sequential
IEEE fp32 FMAs, no tensor cores, the centers walked in tiles that fit shared
memory, so any K·D); a CPU tensor takes :func:`kmeans_assign_plain`, which
the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("kmeans_assign")

_SIGNATURES = {"kmeans_assign": (build.INT, build.PTR, build.PTR, build.PTR, build.PTR,
                                 build.LONG, build.INT, build.INT, build.PTR)}


def kmeans_assign_plain(points: torch.Tensor, centers: torch.Tensor):
    """The plain PyTorch version: the full d² matrix and its argmin.  On the
    card the product runs in full fp32 only while TF32 matmul is off (the
    PyTorch default, ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    pts = points.float()
    ctr = centers.float()
    d2 = ((pts * pts).sum(1, keepdim=True) - 2.0 * (pts @ ctr.T)
          + (ctr * ctr).sum(1)[None, :])
    return d2.argmin(1).to(torch.int32), d2.min(1).values


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor):
    """``(assign, dist²)`` of every point against ``centers``.

    On the card this launches the CUDA kernel (points and centers both
    float32 or both bfloat16); on the CPU it runs the plain version."""
    if points.ndim != 2 or centers.ndim != 2 or points.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign wants points (N, D) and centers (K, D), "
                         f"got {tuple(points.shape)} and {tuple(centers.shape)}")
    if centers.shape[0] < 1:
        raise ValueError("kmeans_assign needs at least one center")
    if points.device.type == "cpu":
        return kmeans_assign_plain(points, centers)
    if points.device.type != "cuda" or centers.device != points.device:
        raise ValueError(f"kmeans_assign runs on cpu or cuda with both inputs on "
                         f"one device, got {points.device} and {centers.device}")
    dtype = build.dtype_code("kmeans_assign", points, centers)
    n, d = points.shape
    k = centers.shape[0]
    assign = torch.empty(n, dtype=torch.int32, device=points.device)
    dist = torch.empty(n, dtype=torch.float32, device=points.device)
    if n == 0:
        return assign, dist
    points = points.contiguous()
    centers = centers.contiguous()
    lib = build.library("kmeans_assign", _SIGNATURES)
    with torch.cuda.device(points.device):
        code = lib.kmeans_assign(dtype, points.data_ptr(), centers.data_ptr(),
                                 assign.data_ptr(), dist.data_ptr(), n, d, k,
                                 build.stream_of(points))
    build.check(lib, "kmeans_assign", code)
    launches.add()
    return assign, dist
