"""K-means assignment: nearest center and its squared distance, per point.

Port of :mod:`repro.kernels.kmeans_assign`: points (N, D), centers (K, D) →
``(assign int32 (N,), dist² float32 (N,))`` with d² = ‖p‖² − 2p·c + ‖c‖² in
fp32 (bfloat16 inputs converted first), the first minimum winning.

On the card one CUDA launch does it (``csrc/kmeans_assign.cu``: IEEE fp32
FMAs, no tensor cores, any K·D), by one of three bodies chosen by shape
(:func:`regime`): ``rows`` (few centers, narrow rows: a thread a point, the
points staged through shared memory), ``tiles`` (many centers: a
register-tiled product, the (d², index) minima merged across threads) and
``wide`` (wide rows: a CTA a point, D split across its threads).  A CPU
tensor takes :func:`kmeans_assign_plain`, which the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

# The regimes' bounds, mirrored from csrc/kmeans_assign.cu (kRowsMaxK,
# kRowsMaxD, kWideMinD, kWideMaxK, kTilesFill); the tests hold the two in step
ROWS_MAX_K = 16
ROWS_MAX_D = 64
WIDE_MIN_D = 2048
WIDE_MAX_K = 32
TILES_FILL = 264

launches = build.LaunchCounter("kmeans_assign")

_SIGNATURES = {"kmeans_assign": (build.INT, build.PTR, build.PTR, build.PTR, build.PTR,
                                 build.LONG, build.INT, build.INT, build.PTR),
               "kmeans_assign_regime": (build.LONG, build.INT, build.INT)}


def regime(n: int, d: int, k: int) -> tuple:
    """The body the kernel takes at points (n, d) and k centers, and its
    points a CTA: ``("rows", 128)``, ``("tiles", 64)`` (8 x 8 dots a
    thread) or ``("tiles", 16)`` (4 x 4), or ``("wide", 1)``
    (csrc/kmeans_assign.cu's ``regime`` and ``tile_points``)."""
    if k <= ROWS_MAX_K and d <= ROWS_MAX_D:
        return "rows", 128
    if d >= WIDE_MIN_D and k <= WIDE_MAX_K:
        return "wide", 1
    return "tiles", 64 if -(-n // 64) >= TILES_FILL else 16


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
    if not points.is_cuda:
        if points.device.type == "cpu":
            return kmeans_assign_plain(points, centers)
        raise ValueError(f"kmeans_assign runs on cpu or cuda, not {points.device}")
    index = points.get_device()
    if centers.get_device() != index:
        raise ValueError(f"kmeans_assign wants both inputs on one device, got "
                         f"{points.device} and {centers.device}")
    dtype = build.dtype_code("kmeans_assign", points, centers)
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return kmeans_assign(points, centers)
    n, d = points.shape
    k = centers.shape[0]
    assign = torch.empty(n, dtype=torch.int32, device=points.device)
    dist = torch.empty(n, dtype=torch.float32, device=points.device)
    if n == 0:
        return assign, dist
    points = points.contiguous()
    centers = centers.contiguous()
    lib = build.library("kmeans_assign", _SIGNATURES)
    # the stream asked for by device index: torch's shortest public path to it
    code = lib.kmeans_assign(dtype, points.data_ptr(), centers.data_ptr(), assign.data_ptr(),
                             dist.data_ptr(), n, d, k, torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "kmeans_assign", code)
    launches.add()
    return assign, dist
