"""Drive the PyTorch/CUDA port of STEP on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. env     — the card's name and power limit (nvidia-smi), torch and CUDA
             versions.  No visible GPU is a failure.
2. build   — compile every kernel of ``src/repro_torch/csrc`` (one nvcc per
             source, all at once) and print the build time.
3. kernels — hold each kernel body against its plain PyTorch version on the
             card: the edge shapes of the JAX package's kernel tests and the
             shapes the main path gives each kernel.  fused_topk_scatter and
             both topk_compress bodies must be bit-exact (and the two bodies
             equal to each other); kmeans_assign must give the same
             assignments and dist² within 1e-5 relative.  accumulate_blocked
             must be bit-exact in fp32 (within 3e-2 in bf16), and
             sparse_scatter_add bit-exact on the accumulator's pairs (within
             rtol 1e-5, atol 1e-6 where one row repeats an index), one
             launch per call whatever the number of rows.  Each is
             timed (median of CUDA-event timings of one call) beside its plain
             version, its bound and, where one PyTorch call computes the
             same function, that call; the short ones also by CUDA-graph
             replay, which leaves the host's part of a call out.
             flash_attention (fp32 and bf16) and ssd_scan are held to
             test_kernels.py's tolerances at its shapes and at the shapes
             the LM main path gives them; flash_attention also at the edges
             of its tiling (head dims 20, 80 and 192/128, T > S, a
             decode-shaped T = 1, the qwen3 shape at batch 1); both flash
             bodies', topk_compress's radix body's and sparse_scatter_add's
             -Xptxas -v lines (registers, spills) are printed; the fp32
             body's bound is the 3xTF32 tensor-core one (the fp32 pipes'
             printed beside it).  The bf16 (wgmma) body is timed at the
             qwen3-1.7b prefill shape beside SDPA in bf16 (a row of its
             own), its bound the flops at 989 TFLOP/s.  Then the
             inputs repro's kernels take off the float32 main path
             (A_INPUTS, C_INPUTS, D_INPUTS; bf16 at the main-path shapes;
             ssd_scan at chunk 256), each held and timed beside its plain
             version; and accumulate_blocked's and sparse_scatter_add's
             host cost split into the parts of their launch paths (g_split,
             1,000 calls each; h_split, 200).
4. apps    — the host Session (2 nodes x 2 threads, device left at its
             default) at realistic sizes: pagerank on a LiveJournal-scale
             graph (AUTO, SPARSE fused, SPARSE unfused; and one thread's
             fp64 credit scatter timed beside sparse_scatter_add in fp32),
             kmeans on the Covertype shape with the kernel (plus four
             uncounted runs from the default init, whose spread is printed),
             logreg with sparse_k fused and unfused, nmf on Netflix's 17,770
             movie columns (AUTO and reduce_scatter); one bf16 SPARSE round
             through DAddAccumulator at pagerank's V, fused and unfused,
             bit-exact with its plain path.  accumulate_blocked is timed per
             call inside the pagerank AUTO run.  Launch counters are
             zeroed just before each run and read just after; every kernel
             must have been launched, the counts each run must give are
             asserted.  A small run of each app is also held against its
             single-thread reference on the CPU.
5. lm      — qwen3-1.7b (flash attention) and mamba2-2.7b (SSD scan) at
             their full published configs, random weights from a fixed
             generator, device left at its default: (a) make_prefill_step on
             4 x 2048 tokens, which must launch the kernel once per layer;
             (b) forward on a 256-token prompt against 256 decode steps of
             it: max |dlogit| <= 1e-3 max |logit| and the same argmax at
             every position, the decode steps timed in four 64-step blocks;
             mamba2-2.7b's gap is printed for its plain chunked forward too,
             on the same weights; (c) serve(smoke=False) with 4 x 32 prompt
             tokens and 32 generated.  Each model is freed before the next.
             Last, qwen3-1.7b in bf16: one 4 x 2048 prefill, the flash
             kernel's bf16 body once per layer.
6. result  — one ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and
             the ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import card_info  # noqa: E402
from repro_torch.analytics import kmeans, logreg, nmf, pagerank  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import HostBackend, Session  # noqa: E402
from repro_torch.core.sparse import block_layout, blocked_topk_sparsify  # noqa: E402
from repro_torch.data import (  # noqa: E402
    kmeans_dataset, logreg_dataset, nmf_dataset, partition_rows, powerlaw_graph)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate.kernel import accumulate_blocked  # noqa: E402
from repro_torch.kernels.accumulate.ref import accumulate_plain  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import (  # noqa: E402
    fused_topk_scatter, fused_topk_scatter_plain)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd, gqa_plain, smem_bytes)
from repro_torch.kernels.flash_attention.ref import attention_bhsd_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign, kmeans_assign_plain)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add  # noqa: E402
from repro_torch.kernels.sparse_update.ref import sparse_scatter_add_plain  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402
from repro_torch.kernels.topk_compress.ops import (  # noqa: E402
    BITONIC_MIN_K, topk_compress, topk_compress_plain)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
BF16 = torch.bfloat16
DTYPE_NAMES = {torch.float32: "f32", BF16: "bf16"}
APP_TOL = dict(rtol=1e-5, atol=1e-6)
N_NODES, THREADS_PER_NODE = 2, 2
N_THREADS = N_NODES * THREADS_PER_NODE
ITERS = 10
SEED = 0

# pagerank: SNAP soc-LiveJournal1 has 4,847,571 vertices and 68,993,773 edges
LJ_VERTICES, LJ_DEGREE = 4_847_571, 14
# kmeans: the UCI Covertype (FOREST) shape, 581,012 rows x 54 features, 7 classes
COV_ROWS, COV_FEATURES, COV_K = 581_012, 54, 7
# logreg: 1M rows x 512 features, sparse gradients with a budget of 32; the
# gradient is a sum over rows, so the step shrinks with the row count (the
# JAX package's tests step 1e-3 over 400 rows)
LR_ROWS, LR_FEATURES, LR_K = 1_000_000, 512, 32
LR_STEP = 0.4 / LR_ROWS
# nmf: the Netflix prize matrix is 480,189 users x 17,770 movies; the movie
# columns are kept whole and the users cut to 50,000, so that the host can
# make R (3.55 GB of fp32) from the seed; rank 64
NETFLIX_USERS, NMF_ROWS, NMF_COLS, NMF_RANK = 480_189, 50_000, 17_770, 64
NMF_ROUND = NMF_RANK * NMF_COLS + NMF_RANK ** 2     # the Q round: k·m + k² floats
# nmf_dataset(seed) and fit(seed) draw P then Q from one stream: from the
# data's own seed the fit would start at the true factors
NMF_INIT_SEED = SEED + 1
ACC_TOL = {torch.float32: None, torch.bfloat16: 3e-2}      # test_kernels.py:13
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)                   # test_kernels.py:155

KERNELS = {
    "fused_topk_scatter": ("src/repro_torch/csrc/fused_scatter.cu",
                           "src/repro/kernels/accumulate/fused_scatter.py:61"),
    "topk_compress_argmax": ("src/repro_torch/csrc/topk_compress.cu",
                             "src/repro/kernels/topk_compress/kernel.py:33"),
    "topk_compress_bitonic": ("src/repro_torch/csrc/topk_compress.cu",
                              "src/repro/kernels/topk_compress/kernel.py:52"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kernel.py:31"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "flash_attention_bf16": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:70"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:62"),
    "accumulate_blocked": ("src/repro_torch/csrc/accumulate.cu",
                           "src/repro/kernels/accumulate/kernel.py:23"),
    "sparse_scatter_add": ("src/repro_torch/csrc/scatter_add.cu",
                           "src/repro/kernels/sparse_update/kernel.py:39"),
}

# the LM serving path: each model at its full published config, with the
# prefill implementation that runs its kernel; prefill batch x length
LM_MODELS = {"qwen3-1.7b": ({"attention_impl": "pallas"}, "flash_attention"),
             "mamba2-2.7b": ({"ssd_impl": "pallas"}, "ssd_scan")}
LM_BATCH, LM_PREFILL, LM_CONSISTENCY, DECODE_BLOCK = 4, 2048, 256, 64
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}   # test_kernels.py:13
SSD_TOL = dict(rtol=3e-4, atol=3e-4)                       # test_kernels.py:193
BF16_TOL = dict(rtol=3e-2, atol=3e-2)                      # the repo's bf16 tolerance
# inputs the JAX package's kernels take off the float32 main path
# (tests/test_torch_inputs.py's cuda shapes): A (N, V, k, block) and
# B/C (V, k, block) at blocks past 1,024 lanes, in shared memory (2,048,
# 16,384) and in device scratch (65,536); D (N, D, K): K 1,024 at D 64 (centers
# in tiles), K 9,000, D 60,000 (no center row fits shared memory; its points
# integer-valued, so that sums of 60,000 products are exact in fp32 in any
# order and kernel and plain agree exactly)
A_INPUTS = [(4, 16384, 512, 1024), (3, 900, 900, 256), (4, 30_000, 3000, 2048),
            (4, 40_000, 4000, 16_384), (2, 150_000, 9000, 65_536),
            (3, 70_000, 70_000, 65_536)]
C_INPUTS = [(4096, 256, 1024), (2048, 16, 512), (30_000, 40, 2048), (40_000, 300, 16_384),
            (150_000, 24, 65_536), (200_000, 100, 65_536)]
D_INPUTS = [(20_000, 64, 1024), (3000, 8, 9000), (300, 60_000, 3)]


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device time of one call: ``fn`` captured once in a CUDA graph, the
    graph replayed ``reps`` times between two CUDA events.  Where a call's
    host work (Python, the wrapper's checks, the launch) outlasts its device
    work, :func:`time_ms` reads the host; this reads the device alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float = 0.0, flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rng_sparse(rng, shape, density):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0.0
    return torch.from_numpy(x).cuda()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(rng) -> dict:
    results = {}

    # A: fused_topk_scatter — test_kernels.py's five shapes x four densities
    for n, v, k, block in [(4, 16384, 512, 1024), (8, 1000, 50, 256),
                           (1, 100, 10, 1024), (3, 900, 900, 256), (2, 7, 3, 1024)]:
        _, be, pb = block_layout(v, k, block)
        for density in (0.0, 0.01, 0.3, 1.0):
            x = rng_sparse(rng, (n, v), density)
            got = fused_topk_scatter(x, per_block=pb, block_eff=be)
            if not torch.equal(got, fused_topk_scatter_plain(x, pb, be)):
                raise AssertionError(f"fused_topk_scatter differs at {(n, v, k, block, density)}")
    # main paths: pagerank SPARSE (N=4 credit vectors of V=4,847,571,
    # k=V//4) and logreg SPARSE (N=4 gradients of V=512, k=32, one 512-lane
    # block); the pagerank shape is the one reported in the kernels line
    a_shapes = {"pagerank": (LJ_VERTICES, LJ_VERTICES // 4, (0.3,)),
                "logreg": (LR_FEATURES, LR_K, (0.3, 1.0))}
    per_shape, err = {}, 0.0
    for app, (v, kk, densities) in a_shapes.items():
        _, be, pb = block_layout(v, kk)
        for density in densities:
            x = rng_sparse(rng, (N_THREADS, v), density)
            got = fused_topk_scatter(x, per_block=pb, block_eff=be)
            ref = fused_topk_scatter_plain(x, pb, be)
            if not torch.equal(got, ref):
                raise AssertionError(f"fused_topk_scatter differs at the {app} shape "
                                     f"(density {density})")
            err = max(err, float((got - ref).abs().max()))
        t, by = bound_ms((N_THREADS + 1) * v * 4)
        per_shape[app] = dict(
            shape=f"x ({N_THREADS}, {v}) f32, block_eff={be}, per_block={pb}",
            ms=time_ms(lambda: fused_topk_scatter(x, per_block=pb, block_eff=be), 20),
            device_ms=graph_ms(lambda: fused_topk_scatter(x, per_block=pb, block_eff=be), 20),
            plain_ms=time_ms(lambda: fused_topk_scatter_plain(x, pb, be), 5),
            bound_ms=t, bound_by=by, library_ms=None)
    log("fused_topk_scatter per main-path shape:", json.dumps(per_shape))
    results["fused_topk_scatter"] = dict(per_shape["pagerank"], max_abs_err=err)

    # B and C: topk_compress — test_kernels.py's sweeps, ties at zero, k >= 65
    for v, k, bv in [(900, 4, 256), (2048, 16, 512), (100, 2, 64), (1000, 200, 256),
                     (4096, 256, 1024), (7, 3, 1024), (4096, BITONIC_MIN_K, 1024)]:
        x = rng_sparse(rng, (v,), 0.5)
        pi, pv = topk_compress_plain(x, k, min(bv, v))
        outs = [topk_compress(x, k_per_block=k, block_v=bv, method=m)
                for m in ("argmax", "bitonic")]
        for (i, val), m in zip(outs, ("argmax", "bitonic")):
            if not (torch.equal(i, pi) and torch.equal(val, pv)):
                raise AssertionError(f"topk_compress {m} differs at {(v, k, bv)}")
    # main paths: logreg unfused (V=512, k=32 -> argmax) and pagerank
    # unfused (V=4,847,571, k_per_block=256 -> bitonic); both bodies timed
    # at both shapes, so the BITONIC_MIN_K crossover can be read off
    shapes = {"topk_compress_argmax": (LR_FEATURES, LR_K),
              "topk_compress_bitonic": (LJ_VERTICES, LJ_VERTICES // 4)}
    crossover = {}
    for name, (v, kk) in shapes.items():
        nb, be, pb = block_layout(v, kk)
        x = rng_sparse(rng, (v,), 0.3)
        pi, pv = topk_compress_plain(x, pb, be)
        per_method, err = {}, {}
        for m in ("argmax", "bitonic"):
            i, val = topk_compress(x, k_per_block=pb, block_v=be, method=m)
            if not (torch.equal(i, pi) and torch.equal(val, pv)):
                raise AssertionError(f"topk_compress {m} differs at V={v}")
            err[m] = float((val - pv).abs().max())
            per_method[m] = time_ms(
                lambda m=m: topk_compress(x, k_per_block=pb, block_v=be, method=m), 20)
        crossover[f"V={v},k_per_block={pb}"] = per_method
        # yardstick: torch.topk of the blocked magnitudes (its tie order is
        # unspecified, so it is timed only, never used)
        mags = torch.nn.functional.pad(x.abs(), (0, nb * be - v)).reshape(nb, be)
        method = name.rsplit("_", 1)[1]
        t, by = bound_ms(v * 4 + nb * pb * 8)
        results[name] = dict(
            shape=f"x ({v},) f32, block_v={be}, k_per_block={pb}",
            max_abs_err=err[method], ms=per_method[method],
            plain_ms=time_ms(lambda: topk_compress_plain(x, pb, be), 5),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.topk(mags, pb, dim=1), 20),
            device_ms=graph_ms(lambda: topk_compress(x, k_per_block=pb, block_v=be,
                                                     method=method), 50),
            library_device_ms=graph_ms(lambda: torch.topk(mags, pb, dim=1), 50))
    # the BITONIC_MIN_K evidence: both bodies over k_per_block on 1024-lane
    # blocks of the pagerank-sized vector
    x = rng_sparse(rng, (LJ_VERTICES,), 0.3)
    for kpb in (4, 8, 16, 32, 64, 128, 256):
        crossover[f"V={LJ_VERTICES},k_per_block={kpb}"] = {
            m: time_ms(lambda m=m: topk_compress(x, k_per_block=kpb, block_v=1024,
                                                 method=m), 10)
            for m in ("argmax", "bitonic")}
    log("topk_compress crossover (ms, argmax vs bitonic):", json.dumps(crossover))

    # D: kmeans_assign — test_kernels.py's sweep, then one thread's share of
    # the Covertype-shaped data against the initial centers, as kmeans.fit
    # gives them on its first round
    for n, k, d in [(500, 11, 24), (1000, 3, 8)]:
        pts = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
        ctr = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).cuda()
        a, dist = kmeans_assign(pts, ctr)
        check_assign(pts, ctr, a, dist, *kmeans_assign_plain(pts, ctr))
    data, _, _ = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    n, k, d = COV_ROWS // N_THREADS, COV_K, COV_FEATURES
    pts = torch.from_numpy(data[:n]).cuda()
    ctr = torch.from_numpy(data[np.random.default_rng(SEED).choice(
        COV_ROWS, COV_K, replace=False)]).cuda()
    a, dist = kmeans_assign(pts, ctr)
    pa, pd = kmeans_assign_plain(pts, ctr)
    check_assign(pts, ctr, a, dist, pa, pd)
    t, by = bound_ms((n * d + k * d + 2 * n) * 4, 2.0 * n * k * d)
    results["kmeans_assign"] = dict(
        shape=f"points ({n}, {d}) f32, centers ({k}, {d})",
        max_abs_err=float((dist - pd).abs().max()),
        ms=time_ms(lambda: kmeans_assign(pts, ctr), 20),
        device_ms=graph_ms(lambda: kmeans_assign(pts, ctr), 50),
        plain_ms=time_ms(lambda: kmeans_assign_plain(pts, ctr), 20),
        bound_ms=t, bound_by=by, library_ms=None)
    return results


def check_receive(rng) -> dict:
    """accumulate_blocked and sparse_scatter_add against their plain versions
    at test_kernels.py's sweeps and at the shapes the main path gives them,
    each timed there (each also through the accumulator's entry, which skips
    the checks, as ``entry_ms``)."""
    from repro_torch.kernels.accumulate.kernel import accumulate_rows_unchecked
    from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add_unchecked

    results = {}
    # G: accumulate_blocked — the sweep in fp32 (bit-exact) and bf16, as the
    # (N, V) tensor and as N separate rows; 70 rows exceed the pointer list
    for n, v, bv in [(4, 1024, 256), (7, 3000, 512), (1, 128, 128), (70, 1001, 1024)]:
        x = cuda_normal(rng, (n, v))
        for dtype, tol in ACC_TOL.items():
            xd = x.to(dtype)
            ref = accumulate_plain(xd)
            for form in (xd, [r.clone() for r in xd]):
                got = accumulate_blocked(form, block_v=bv)
                if tol is not None:
                    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
                elif not torch.equal(got, ref):
                    raise AssertionError(f"accumulate_blocked differs at {(n, v, bv)}")
    # main paths: the dense round of pagerank AUTO (4 credit vectors of V =
    # 4,847,571) and of nmf AUTO (4 x k·m + k²), each as the accumulator
    # holds it — N separate tensors — and stacked
    per_shape = {}
    for app, v in (("pagerank", LJ_VERTICES), ("nmf", NMF_ROUND)):
        rows = [cuda_normal(rng, (v,)) for _ in range(N_THREADS)]
        x = torch.stack(rows)
        got, ref = accumulate_blocked(rows), accumulate_plain(rows)
        if not (torch.equal(got, ref) and torch.equal(accumulate_blocked(x), ref)
                and torch.equal(accumulate_rows_unchecked(rows), ref)):
            raise AssertionError(f"accumulate_blocked differs at the {app} shape")
        t, by = bound_ms((N_THREADS + 1) * v * 4)
        per_shape[app] = dict(
            shape=f"{N_THREADS} rows of ({v},) f32",
            max_abs_err=float((got - ref).abs().max()),
            ms=time_ms(lambda: accumulate_blocked(rows), 20),
            entry_ms=time_ms(lambda: accumulate_rows_unchecked(rows), 20),
            plain_ms=time_ms(lambda: accumulate_plain(rows), 20),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.sum(x, dim=0), 20),
            device_ms=graph_ms(lambda: accumulate_blocked(rows), 50),
            library_device_ms=graph_ms(lambda: torch.sum(x, dim=0), 50))
    log("accumulate_blocked per main-path shape:", json.dumps(per_shape))
    results["accumulate_blocked"] = per_shape["pagerank"]

    # H: sparse_scatter_add — the sweep's random indices repeat inside the
    # row (held to the tolerance), the duplicates case, indices out of range
    dev = torch.device("cuda")
    for m, v, bv in [(50, 700, 256), (200, 4096, 1024), (1, 64, 64)]:
        idx = torch.from_numpy(rng.integers(0, v, size=(m,)).astype(np.int32)).to(dev)
        vals = cuda_normal(rng, (m,))
        torch.testing.assert_close(sparse_scatter_add(idx, vals, v, block_v=bv),
                                   sparse_scatter_add_plain(idx, vals, v), **SCATTER_TOL)
    idx = torch.tensor([3, 3, 3, 0, -1, 8, 100], dtype=torch.int32, device=dev)
    vals = torch.tensor([1.0, 2.0, 3.0, 5.0, 7.0, 11.0, 13.0], device=dev)
    got = sparse_scatter_add(idx, vals, 8, block_v=8)
    if got.tolist() != [5.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0, 0.0]:
        raise AssertionError(f"sparse_scatter_add duplicates / out of range: {got.tolist()}")
    # the accumulator's pairs, bit-exact: (V, k) = (1030, 600) pads its last
    # block with 294 (0, 0.0) pairs per row; then the main paths, the
    # unfused rounds of pagerank (k = V/4) and logreg (k = 32), from real
    # compressions
    per_shape = {}
    for app, (v, kk, density) in (("padded", (1030, 600, 0.5)),
                                  ("pagerank", (LJ_VERTICES, LJ_VERTICES // 4, 0.3)),
                                  ("logreg", (LR_FEATURES, LR_K, 1.0))):
        pairs = [blocked_topk_sparsify(rng_sparse(rng, (v,), density), kk)
                 for _ in range(N_THREADS)]
        idx = torch.stack([p.idx for p in pairs])
        vals = torch.stack([p.vals for p in pairs])
        got, ref = sparse_scatter_add(idx, vals, v), sparse_scatter_add_plain(idx, vals, v)
        if not torch.equal(got, ref):
            raise AssertionError(f"sparse_scatter_add differs on the {app} pairs")
        if app == "padded":
            continue
        t, by = bound_ms(idx.numel() * (4 + 4) + v * 4)
        flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
        per_shape[app] = dict(
            shape=f"idx/vals ({N_THREADS}, {idx.shape[1]}) int32/f32 into {v} "
                  "(1 launch)",
            max_abs_err=float((got - ref).abs().max()),
            ms=time_ms(lambda: sparse_scatter_add(idx, vals, v), 20),
            entry_ms=time_ms(lambda: sparse_scatter_add_unchecked(idx, vals, v), 20),
            plain_ms=time_ms(lambda: sparse_scatter_add_plain(idx, vals, v), 5),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.zeros(v, device=dev).index_add_(
                0, flat_i, flat_v), 20),
            device_ms=graph_ms(lambda: sparse_scatter_add(idx, vals, v), 50),
            library_device_ms=graph_ms(lambda: torch.zeros(v, device=dev).index_add_(
                0, flat_i, flat_v), 50))
    log("sparse_scatter_add per main-path shape:", json.dumps(per_shape))
    results["sparse_scatter_add"] = per_shape["pagerank"]
    return results


def check_inputs(rng) -> dict:
    """Inputs the JAX package's kernels take off the float32 main path,
    each kernel held against its plain version on them:
    A and B/C bit-exact at bf16 and at blocks of 2,048, 16,384 and 65,536
    (A_INPUTS, C_INPUTS); D with the same assignments at bf16 (Covertype's
    shape) and at K 1,024 / D 64, K 9,000 and D 60,000; F within 3e-2 at
    bf16 (the mamba2-2.7b prefill shape) and within 3e-4 at chunk 256 (two
    sub-chunks of 128); A and C also at bf16 at pagerank's V.  Each is timed
    per call (CUDA events) beside its plain version and a bound (A past
    1,024 lanes; B and C at every C_INPUTS entry); the float32 main-path
    rows of phase 3 are the yardstick.  Returns the timings."""
    from repro_torch.kernels.ssd_scan.kernel import sub_chunk

    taken = {}

    def record(name, shape, fn, plain, nbytes, flops=0.0, reps=10, device=False):
        t, by = bound_ms(nbytes, flops)
        taken[name] = dict(shape=shape, ms=time_ms(fn, reps), plain_ms=time_ms(plain, 3),
                           bound_ms=t, bound_by=by)
        if device:
            taken[name]["device_ms"] = graph_ms(fn, 20)

    # A: fused_topk_scatter
    for n, v, k, block in A_INPUTS:
        _, be, pb = block_layout(v, k, block)
        for dtype in (torch.float32, BF16):
            x = rng_sparse(rng, (n, v), 0.3).to(dtype)
            if not torch.equal(fused_topk_scatter(x, per_block=pb, block_eff=be),
                               fused_topk_scatter_plain(x, pb, be)):
                raise AssertionError(f"fused_topk_scatter differs at {(n, v, k, block, dtype)}")
            if block > 1024:
                record(f"A {DTYPE_NAMES[dtype]} block {be}", f"x ({n}, {v}), per_block {pb}",
                       lambda: fused_topk_scatter(x, per_block=pb, block_eff=be),
                       lambda: fused_topk_scatter_plain(x, pb, be),
                       (n + 1) * v * x.element_size())
    _, be, pb = block_layout(LJ_VERTICES, LJ_VERTICES // 4)
    x = rng_sparse(rng, (N_THREADS, LJ_VERTICES), 0.3).to(BF16)
    if not torch.equal(fused_topk_scatter(x, per_block=pb, block_eff=be),
                       fused_topk_scatter_plain(x, pb, be)):
        raise AssertionError("fused_topk_scatter differs at bf16 at pagerank's V")
    record("A bf16 pagerank", f"x ({N_THREADS}, {LJ_VERTICES}) bf16, block {be}, "
           f"per_block {pb}", lambda: fused_topk_scatter(x, per_block=pb, block_eff=be),
           lambda: fused_topk_scatter_plain(x, pb, be), (N_THREADS + 1) * LJ_VERTICES * 2,
           reps=20, device=True)

    # B/C: topk_compress, both bodies
    for v, k, bv in C_INPUTS:
        for dtype in (torch.float32, BF16):
            x = rng_sparse(rng, (v,), 0.5).to(dtype)
            pi, pv = topk_compress_plain(x, k, min(bv, v))
            for m in ("argmax", "bitonic"):
                i, val = topk_compress(x, k_per_block=k, block_v=bv, method=m)
                if not (torch.equal(i, pi) and torch.equal(val, pv)):
                    raise AssertionError(f"topk_compress {m} differs at {(v, k, bv, dtype)}")
                nb = -(-v // bv)
                record(f"{'B' if m == 'argmax' else 'C'} {DTYPE_NAMES[dtype]} block {bv} k {k}",
                       f"x ({v},), k_per_block {k}",
                       lambda m=m: topk_compress(x, k_per_block=k, block_v=bv, method=m),
                       lambda: topk_compress_plain(x, k, bv),
                       v * x.element_size() + nb * k * (4 + x.element_size()))
    nb, be, pb = block_layout(LJ_VERTICES, LJ_VERTICES // 4)
    x = rng_sparse(rng, (LJ_VERTICES,), 0.3).to(BF16)
    pi, pv = topk_compress_plain(x, pb, be)
    i, val = topk_compress(x, k_per_block=pb, block_v=be, method="bitonic")
    if not (torch.equal(i, pi) and torch.equal(val, pv)):
        raise AssertionError("topk_compress bitonic differs at bf16 at pagerank's V")
    record("C bf16 pagerank", f"x ({LJ_VERTICES},) bf16, block {be}, k_per_block {pb}",
           lambda: topk_compress(x, k_per_block=pb, block_v=be, method="bitonic"),
           lambda: topk_compress_plain(x, pb, be), LJ_VERTICES * 2 + nb * pb * 6,
           reps=20, device=True)

    # D: kmeans_assign at bf16 (one thread's share of Covertype) and past
    # one CTA's shared memory
    data, _, _ = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    n, k, d = COV_ROWS // N_THREADS, COV_K, COV_FEATURES
    pts = torch.from_numpy(data[:n]).cuda().to(BF16)
    ctr = pts[torch.from_numpy(np.random.default_rng(SEED).choice(n, k, replace=False)).cuda()]
    check_assign(pts.float(), ctr.float(), *kmeans_assign(pts, ctr), *kmeans_assign_plain(pts, ctr))
    record("D bf16 covertype", f"points ({n}, {d}) bf16, centers ({k}, {d})",
           lambda: kmeans_assign(pts, ctr), lambda: kmeans_assign_plain(pts, ctr),
           (n * d + k * d) * 2 + 8 * n, 2.0 * n * k * d, reps=20, device=True)
    for n, d, k in D_INPUTS:
        for dtype in (torch.float32, BF16):
            if d > 10_000:
                pts = torch.from_numpy(rng.integers(-1, 2, size=(n, d)).astype(
                    np.float32)).cuda().to(dtype)
            else:
                pts = cuda_normal(rng, (n, d), dtype=dtype)
            ctr = pts[torch.from_numpy(rng.choice(n, k, replace=n < k)).cuda()].clone()
            got, want = kmeans_assign(pts, ctr), kmeans_assign_plain(pts, ctr)
            if d > 10_000 and not all(map(torch.equal, got, want)):
                raise AssertionError(f"kmeans_assign differs at D {d} ({dtype})")
            check_assign(pts.float(), ctr.float(), *got, *want)
            record(f"D {DTYPE_NAMES[dtype]} K {k} D {d}", f"points ({n}, {d}), centers ({k}, {d})",
                   lambda: kmeans_assign(pts, ctr), lambda: kmeans_assign_plain(pts, ctr),
                   (n * d + k * d) * pts.element_size() + 8 * n, 2.0 * n * k * d)

    # F: ssd_scan at bf16 and at chunk 256, at the mamba2-2.7b prefill shape
    b, t, h, p, g, n = LM_BATCH, LM_PREFILL, 80, 64, 1, 128
    xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
    for dtype, q in ((BF16, 128), (torch.float32, 256), (BF16, 256)):
        xq, bq, cq = (z.to(dtype) for z in (xbar, bm, cm))
        y = ssd_scan(xq, a, bq, cq, chunk=q)
        ref = ssd_scan_plain(xq, a, bq, cq, q)[0]
        torch.testing.assert_close(y.float(), ref.float(),
                                   **(SSD_TOL if dtype == torch.float32 else BF16_TOL))
        pairs = q * (q + 1) // 2
        flops = (2.0 * pairs * (n + p) + 4.0 * q * n * p) * (t // q) * b * h
        record(f"F {DTYPE_NAMES[dtype]} chunk {q} (walked as {sub_chunk(q, p, n)})",
               f"xbar ({b}, {t}, {h}, {p}), B/C ({b}, {t}, {g}, {n})",
               lambda: ssd_scan(xq, a, bq, cq, chunk=q),
               lambda: ssd_scan_plain(xq, a, bq, cq, q),
               xq.element_size() * (2 * xq.numel() + bq.numel() + cq.numel()) + 4 * a.numel(),
               flops, reps=5)
    log("newly taken inputs, ms per call:", json.dumps(taken))
    return taken


def check_flash_bf16(rng) -> dict:
    """flash_attention's bf16 (wgmma) body at the qwen3-1.7b prefill shape
    (q (4, 2048, 8, 2, 128), causal) against its plain version (limit
    3e-2), timed beside SDPA in bf16 on the same inputs (K/V expanded to the
    16 heads); its bound is the flops at 989 TFLOP/s of bf16."""
    b, t, kh, g, d = LM_BATCH, LM_PREFILL, 8, 2, 128
    q = cuda_normal(rng, (b, t, kh, g, d), dtype=BF16)
    k, v = (cuda_normal(rng, (b, t, kh, d), dtype=BF16) for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, causal=True)
    ref = gqa_plain(q, k, v, causal=True, q_offset=0)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    visible = t * (t + 1) // 2
    nbytes, flops = 2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * b * kh * g * visible * d
    tb, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"flash_attention bf16 bound at the qwen3 prefill shape: {tb:.4f} ms ({by}: "
        f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s); shared memory per CTA "
        f"{smem_bytes(d, d, BF16)} bytes")
    qs = q.reshape(b, t, kh * g, d).transpose(1, 2)
    ks, vs = (z.repeat_interleave(g, dim=2).transpose(1, 2) for z in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    return dict(
        shape=f"q ({b}, {t}, {kh}, {g}, {d}) bf16, k/v ({b}, {t}, {kh}, {d}), causal",
        max_abs_err=float((out.float() - ref.float()).abs().max()),
        ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        device_ms=graph_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        plain_ms=time_ms(lambda: gqa_plain(q, k, v, causal=True, q_offset=0), 5),
        bound_ms=tb, bound_by=by,
        library_ms=time_ms(sdpa, 20), library_device_ms=graph_ms(sdpa, 20))


def host_us(fn, reps: int = 1000) -> float:
    """Host time of one call, in µs: ``reps`` calls in a row on the host
    clock, after ten to warm up (the device is synchronised before and
    after, outside the timing)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / reps * 1e6


def g_split(rng) -> dict:
    """accumulate_blocked's host cost at nmf's round (4 rows of 1,141,376
    float32), split into the parts of its launch path, each called 1,000
    times in a row (host µs per call): the library lookup, a device context,
    the stream, the row checks, the ctypes pointer array, the output's
    allocation, the launch counter, the ctypes call that launches the kernel,
    and whole calls.  Imports what it times when it runs, so that a copy of
    this script beside an older package times that package's launch path."""
    import ctypes

    from repro_torch.kernels.accumulate import kernel as acc_kernel

    v = NMF_ROUND
    rows = [cuda_normal(rng, (v,)) for _ in range(N_THREADS)]
    out = torch.empty(v, device="cuda")
    sigs = acc_kernel._SIGNATURES
    lib = build.library("accumulate", sigs)
    ptrs = (ctypes.c_void_p * N_THREADS)(*[r.data_ptr() for r in rows])
    stream = torch.cuda.current_stream().cuda_stream

    x = torch.stack(rows)

    def device_context():
        with torch.cuda.device(out.device):
            pass

    parts = {
        "build.library": lambda: build.library("accumulate", sigs),
        "torch.cuda.device enter+exit": device_context,
        "build.stream_of": lambda: build.stream_of(out),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "torch.cuda.current_device": torch.cuda.current_device,
        "rows: contiguous, data_ptr": lambda: [r.contiguous().data_ptr() for r in rows],
        "_rows_of": lambda: acc_kernel._rows_of(rows),
        "ctypes pointer array": lambda: (ctypes.c_void_p * N_THREADS)(
            *[r.data_ptr() for r in rows]),
        "torch.empty(v)": lambda: torch.empty(v, device=out.device),
        "torch.empty_like(row)": lambda: torch.empty_like(rows[0]),
        "LaunchCounter.add": acc_kernel.launches.add,
        "ctypes call (the launch)": lambda: lib.accumulate_rows(
            0, ptrs, None, 0, N_THREADS, v, out.data_ptr(), 1, stream),
        "accumulate_blocked(rows)": lambda: acc_kernel.accumulate_blocked(rows),
        "torch.sum(x, 0)": lambda: torch.sum(x, dim=0),
    }
    if hasattr(acc_kernel, "accumulate_rows_unchecked"):
        parts["accumulate_rows_unchecked(rows)"] = \
            lambda: acc_kernel.accumulate_rows_unchecked(rows)
    split = {name: host_us(fn) for name, fn in parts.items()}
    log(f"accumulate_blocked host split at nmf's round ({N_THREADS} x {v} f32), us per "
        "call over 1,000 calls:", json.dumps(split))
    return split


def h_split(rng) -> dict:
    """sparse_scatter_add's host cost at pagerank's unfused round (4 rows of
    1,211,904 int32/float32 pairs into 4,847,571), split into the parts of
    its launch path, each called 200 times in a row (host µs per call; few
    enough that the launches queued never fill the device's queue):
    the output's allocation, the stream, the ctypes call that makes the
    cooperative launch, and whole calls, public and through the
    accumulator's entry, beside one index_add_ into fresh zeros.  Imports
    what it times when it runs, as g_split does."""
    from repro_torch.kernels.sparse_update import kernel as h_kernel

    v = LJ_VERTICES
    pairs = [blocked_topk_sparsify(rng_sparse(rng, (v,), 0.3), v // 4) for _ in range(N_THREADS)]
    idx = torch.stack([p.idx for p in pairs])
    vals = torch.stack([p.vals for p in pairs])
    acc = torch.empty(v, device="cuda")
    lib = build.library("scatter_add", h_kernel._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
    parts = {
        "torch.empty(v)": lambda: torch.empty(v, device="cuda"),
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "ctypes call (the cooperative launch)": lambda: lib.sparse_scatter_add_rows(
            0, 0, idx.data_ptr(), vals.data_ptr(), N_THREADS, idx.shape[1], v,
            acc.data_ptr(), None, stream),
        "sparse_scatter_add": lambda: h_kernel.sparse_scatter_add(idx, vals, v),
        "zeros + index_add_": lambda: torch.zeros(v, device="cuda").index_add_(
            0, flat_i, flat_v)}
    if hasattr(h_kernel, "sparse_scatter_add_unchecked"):
        parts["sparse_scatter_add_unchecked"] = \
            lambda: h_kernel.sparse_scatter_add_unchecked(idx, vals, v)
    split = {name: host_us(fn, 200) for name, fn in parts.items()}
    log(f"sparse_scatter_add host split at pagerank's unfused round ({N_THREADS} x "
        f"{idx.shape[1]} pairs), us per call over 200 calls:", json.dumps(split))
    return split


def time_g_in_pagerank(samples: list):
    """Wrap the accumulator's entry to accumulate_blocked so that each call
    in an app run appends to ``samples``: the host s of the call alone, CUDA
    events recorded just before and after it, and, timed in the same thread
    just before it, the host s of three of its parts (allocating the output,
    asking for the stream, a ctypes call that launches nothing).  Returns a
    function that puts the entry back."""
    import repro_torch.core.accumulator as acc_mod
    from repro_torch.kernels.accumulate import kernel as acc_kernel

    real = acc_mod.accumulate_rows
    lib = build.library("accumulate", acc_kernel._SIGNATURES)

    def timed(rows):
        parts = []
        for part in (lambda: torch.empty_like(rows[0]),
                     lambda: torch.cuda.current_stream(rows[0].get_device()).cuda_stream,
                     lambda: lib.repro_cuda_error_string(0)):
            t0 = time.perf_counter()
            part()
            parts.append(time.perf_counter() - t0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        out = real(rows)
        host = time.perf_counter() - t0
        end.record()
        samples.append((host, start, end, parts))
        return out

    acc_mod.accumulate_rows = timed
    return lambda: setattr(acc_mod, "accumulate_rows", real)


def bf16_sparse_round(rng, counts: dict) -> None:
    """One bf16 SPARSE round of 4 contributions through DAddAccumulator at
    pagerank's V (k = V/4, blocks of 1,024), fused (one fused_topk_scatter
    launch) and unfused (topk_compress per contribution, then the pairs
    added in bf16, as the JAX package adds them), each held bit-exact
    against the same round's plain path (the stable-sort selection)."""
    import threading

    from repro_torch.core import AccumMode, DAddAccumulator, GlobalStore
    from repro_torch.core.sparse import blocked_topk_accumulate

    v, k = LJ_VERTICES, LJ_VERTICES // 4
    vecs = [rng_sparse(rng, (v,), 0.3).to(BF16) for _ in range(N_THREADS)]

    def one_round(fused):
        store = GlobalStore(device="cuda")
        store.new_array("out", (v,), BF16)
        acc = DAddAccumulator(store, "out", N_THREADS, N_NODES, AccumMode.SPARSE, k=k,
                              fused=fused)
        threads = []
        for i, vec in enumerate(vecs):      # contributions arrive in list order
            threads.append(threading.Thread(target=acc.accumulate, args=(vec,)))
            threads[-1].start()
            while acc._count < i + 1 and i + 1 < N_THREADS:
                time.sleep(0.001)
        for th in threads:
            th.join()
        return store.get("out")

    for fused, expected in ((True, {"fused_topk_scatter": 1}),
                            (False, {"topk_compress_bitonic": N_THREADS,
                                     "fused_topk_scatter": 0})):
        label = f"bf16 sparse round {'fused' if fused else 'unfused'}"
        got, launched = run_app(label, counts, lambda: one_round(fused))
        expect_launches(label, launched, expected)
        ref = blocked_topk_accumulate(torch.stack(vecs), k, fused=fused, impl="torch")
        if got.dtype != BF16 or not torch.equal(got, ref):
            raise AssertionError(f"{label}: differs from its plain path")
    log(f"bf16 sparse rounds at V={v}, k={k}: fused and unfused bit-exact with their "
        "plain paths")


def check_assign(pts, ctr, a, dist, pa, pd) -> None:
    """Equal assignments except where the two best d² are within 1e-5
    relative (the sums run in other orders); dist² within rtol 1e-5, with an
    absolute margin of 1e-6·max‖p‖² (the expanded formula rounds relative to
    ‖p‖² + ‖c‖², so a distance near zero carries that much noise)."""
    diff = a.long() != pa.long()
    if bool(diff.any()):
        d2 = ((pts[diff, None, :] - ctr[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        gap = (two[:, 1] - two[:, 0]) / two[:, 1].abs().clamp_min(1e-30)
        if bool((gap > 1e-5).any()):
            raise AssertionError(f"kmeans_assign: {int(diff.sum())} assignments "
                                 "differ beyond the tie margin")
    torch.testing.assert_close(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((pts * pts).sum(1).max()))


def cuda_normal(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).cuda().to(dtype)


def ptxas_lines(log: str, marker: str) -> list:
    """The -Xptxas -v lines (registers, spills, stack) of each kernel whose
    mangled name contains ``marker``."""
    found, name = [], None
    for line in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = entry.group(1) if marker in entry.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            found.append(f"{name}: {line.strip()}")
    return found


def check_flash(rng) -> dict:
    """flash_attention against its plain version: test_kernels.py's four
    sweep shapes, the edges of the kernel's tiling (head dims 20, 80 and
    192/128; T > S with S no multiple of the KV tile) and, on the GQA layout,
    q_offset with T != S, a decode-shaped call (T = 1, q_offset = S - 1) and
    the qwen3-1.7b prefill shape at batch 1, each in fp32 and bf16; then the
    qwen3-1.7b prefill shape (B 4, T 2048, KH 8, G 2, d 128) in fp32, timed
    there beside SDPA on the same inputs (K/V expanded to the 16 heads)."""
    def held(out, ref, dtype, what):
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_attention {what}: {m}")

    for dtype in FLASH_TOL:
        for bh, t, s, d, dv, causal in [(2, 128, 128, 64, 64, True), (1, 96, 160, 32, 16, False),
                                        (3, 64, 64, 128, 128, True), (1, 17, 33, 16, 16, True),
                                        (2, 50, 70, 20, 20, True), (2, 130, 130, 80, 80, True),
                                        (2, 100, 150, 192, 128, False),
                                        (1, 200, 77, 64, 64, True), (1, 200, 77, 128, 128, False)]:
            q, k, v = (cuda_normal(rng, sh, dtype=dtype) for sh in ((bh, t, d), (bh, s, d),
                                                                    (bh, s, dv)))
            held(flash_attention_bhsd(q, k, v, causal=causal),
                 attention_bhsd_ref(q, k, v, causal=causal), dtype, (bh, t, s, d, dv, dtype))
        for b, t, s, kh, g, q_offset in [(2, 130, 200, 4, 2, 70), (2, 1, 300, 8, 2, 299),
                                         (1, LM_PREFILL, LM_PREFILL, 8, 2, 0)]:
            q = cuda_normal(rng, (b, t, kh, g, 128), dtype=dtype)
            k, v = (cuda_normal(rng, (b, s, kh, 128), dtype=dtype) for _ in range(2))
            held(fa_ops.flash_attention(q, k, v, causal=True, q_offset=q_offset),
                 gqa_plain(q, k, v, causal=True, q_offset=q_offset), dtype,
                 f"GQA {(b, t, s, kh, g)} q_offset={q_offset} {dtype}")

    b, t, kh, g, d = LM_BATCH, LM_PREFILL, 8, 2, 128
    q = cuda_normal(rng, (b, t, kh, g, d))
    k, v = (cuda_normal(rng, (b, t, kh, d)) for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, causal=True)
    ref = gqa_plain(q, k, v, causal=True, q_offset=0)
    held(out, ref, torch.float32, "qwen3-1.7b prefill shape")
    visible = t * (t + 1) // 2                       # causal (query, key) pairs per head
    nbytes, flops = 4 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * b * kh * g * visible * d
    # the fp32 body does each product as three TF32 products on the tensor
    # cores (3xTF32): its bound; the fp32 pipes' is printed beside it
    tb, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    fp32_tb, _ = bound_ms(nbytes, flops)
    qs = q.reshape(b, t, kh * g, d).transpose(1, 2)
    ks, vs = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    log(f"flash_attention fp32 bounds at the qwen3 prefill shape: {tb:.4f} ms ({by}; "
        f"3xTF32: 3 x the flops at 495 TFLOP/s on the tensor cores, the bound recorded), "
        f"{fp32_tb:.4f} ms (the flops on the fp32 pipes at 67 TFLOP/s); shared memory per "
        f"CTA {smem_bytes(d, d, torch.float32)} bytes")
    return dict(
        shape=f"q ({b}, {t}, {kh}, {g}, {d}) f32, k/v ({b}, {t}, {kh}, {d}), causal",
        max_abs_err=float((out - ref).abs().max()),
        ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        device_ms=graph_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        plain_ms=time_ms(lambda: gqa_plain(q, k, v, causal=True, q_offset=0), 5),
        bound_ms=tb, bound_by=by,
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20),
        library_device_ms=graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20))


def ssd_inputs(rng, b, t, h, p, g, n):
    """xbar, a, B, C as ops.ssd makes them from x, dt, A_log (A_log as
    init_mamba2 sets it; dt a softplus, as mamba2_forward makes it)."""
    x = cuda_normal(rng, (b, t, h, p), 0.5)
    dt = torch.nn.functional.softplus(cuda_normal(rng, (b, t, h)))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    a = (dt * -torch.exp(a_log)).float()
    return x * dt[..., None], a, cuda_normal(rng, (b, t, g, n), 0.3), \
        cuda_normal(rng, (b, t, g, n), 0.3)


def check_ssd(rng) -> dict:
    """ssd_scan against its plain version (the chunked algorithm):
    test_kernels.py's shapes at chunk 8/16/32, then the mamba2-2.7b prefill
    shape (b 4, T 2048, H 80, P 64, G 1, N 128, chunk 128), timed there."""
    for chunk in (8, 16, 32):
        xbar, a, bm, cm = ssd_inputs(rng, 2, 64, 4, 8, 2, 16)
        torch.testing.assert_close(ssd_scan(xbar, a, bm, cm, chunk=chunk),
                                   ssd_scan_plain(xbar, a, bm, cm, chunk)[0], **SSD_TOL)
    b, t, h, p, g, n, q = LM_BATCH, LM_PREFILL, 80, 64, 1, 128, 128
    xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
    y = ssd_scan(xbar, a, bm, cm, chunk=q)
    ref = ssd_scan_plain(xbar, a, bm, cm, q)[0]
    torch.testing.assert_close(y, ref, **SSD_TOL)
    # per chunk and head: the scores and their product with xbar over the
    # causal (row, key) pairs, the carried-state term and the state update
    pairs = q * (q + 1) // 2
    flops = (2.0 * pairs * (n + p) + 4.0 * q * n * p) * (t // q) * b * h
    tb, by = bound_ms(4 * (2 * xbar.numel() + a.numel() + bm.numel() + cm.numel()), flops)
    return dict(
        shape=f"xbar ({b}, {t}, {h}, {p}) f32, B/C ({b}, {t}, {g}, {n}), chunk {q}",
        max_abs_err=float((y - ref).abs().max()),
        ms=time_ms(lambda: ssd_scan(xbar, a, bm, cm, chunk=q), 20),
        plain_ms=time_ms(lambda: ssd_scan_plain(xbar, a, bm, cm, q), 5),
        bound_ms=tb, bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# Phase 4: the apps through the host Session
# ---------------------------------------------------------------------------


def run_app(label: str, counts: dict, fn):
    """Run ``fn`` with every launch counter zeroed just before and read just
    after; add the run's launches to ``counts``.  Prints wall time and peak
    device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = build.launch_counts()
    for name, c in launched.items():
        counts[name] = counts.get(name, 0) + c
    log(f"run {label}: wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
        f"{json.dumps({k: v for k, v in launched.items() if v})}")
    return out, launched


def expect_launches(label: str, launched: dict, expected: dict) -> None:
    for name, n in expected.items():
        if launched.get(name, 0) != n:
            raise AssertionError(f"{label}: {name} launched {launched.get(name, 0)} "
                                 f"times, expected {n}")


def close(a, b, what: str) -> None:
    np.testing.assert_allclose(a, b, err_msg=what, **APP_TOL)


def small_reference_checks() -> None:
    """Each app on the card at a small size against its single-thread
    reference on the CPU — the JAX package's tests hold threads against
    reference with these tolerances (the threaded sums run in another
    order).  Also: pagerank's credit scatter repeats on the card to within
    one fp32 ulp."""
    edges = powerlaw_graph(300, 5, seed=3)
    r, _ = pagerank.fit(edges, 300, iters=ITERS)
    np.testing.assert_allclose(r, pagerank.fit_reference(edges, 300, ITERS, device="cpu"),
                               rtol=1e-4, atol=1e-6, err_msg="pagerank small")
    x, y, _ = logreg_dataset(400, 24, seed=0)
    th, _ = logreg.fit(x, y, iters=ITERS, mode="sparse", k=24)
    np.testing.assert_allclose(th, logreg.fit_reference(x, y, ITERS, device="cpu"),
                               rtol=1e-4, atol=1e-5, err_msg="logreg small")
    xk, _, _ = kmeans_dataset(600, 8, 5, seed=1)
    c, _ = kmeans.fit(xk, 5, iters=6, seed=1, use_kernel=True)
    np.testing.assert_allclose(c, kmeans.fit_reference(xk, 5, 6, 1, device="cpu"),
                               rtol=1e-3, atol=1e-3, err_msg="kmeans small")
    r, _, _ = nmf_dataset(120, 32, 4, seed=2)
    p, q, _ = nmf.fit(r, 4, iters=ITERS, seed=3, mode="auto")
    pr, qr = nmf.fit_reference(r, 4, ITERS, 3, device="cpu")
    np.testing.assert_allclose(nmf.frob_loss(r, p, q), nmf.frob_loss(r, pr, qr, device="cpu"),
                               rtol=1e-2, err_msg="nmf small")      # test_analytics.py:53
    big = torch.from_numpy(powerlaw_graph(200_000, 14, seed=1)).long().cuda()
    ranks = torch.rand(200_000, generator=torch.Generator().manual_seed(SEED)).cuda()
    deg = torch.ones(200_000, device="cuda")
    runs = [pagerank._credits(big[:, 0], big[:, 1], ranks, deg, 200_000) for _ in range(3)]
    ulp = torch.finfo(torch.float32).eps
    for other in runs[1:]:
        torch.testing.assert_close(other, runs[0], rtol=ulp, atol=0.0)
    log("small reference checks: pagerank, logreg (sparse, lossless), kmeans "
        "(kernel), nmf (auto) agree with their CPU references; the credits "
        "scatter repeats to within one fp32 ulp")


def time_credits(edges) -> None:
    """One thread's share of a pagerank round at LiveJournal scale: its
    quarter of the edges through pagerank._credits (fp64 index_add_, then
    one rounding to fp32), the fp64 index_add_ alone, and the same (dst, w)
    in fp32 through index_add_ and through sparse_scatter_add.  Timing only:
    pagerank keeps its fp64 sum, and these launches are not counted."""
    dev = torch.device("cuda")
    lo, hi = partition_rows(edges.shape[0], 0, N_THREADS)
    e = torch.from_numpy(edges[lo:hi]).to(dev).long()
    src, dst = e[:, 0], e[:, 1]
    deg = pagerank._out_degree(torch.from_numpy(edges[:, 0]).to(dev).long(), LJ_VERTICES)
    ranks = torch.full((LJ_VERTICES,), 1.0 / LJ_VERTICES, device=dev)
    w32 = ranks[src] / deg[src]
    w64 = w32.double()
    f64 = torch.zeros(LJ_VERTICES, dtype=torch.float64, device=dev).index_add_(0, dst, w64)
    kern = sparse_scatter_add(dst, w32, LJ_VERTICES)
    top = int(torch.bincount(dst, minlength=LJ_VERTICES).max())
    times = {
        "credits (fp64 index_add_, whole function)": time_ms(
            lambda: pagerank._credits(src, dst, ranks, deg, LJ_VERTICES), 10),
        "fp64 index_add_": time_ms(lambda: torch.zeros(
            LJ_VERTICES, dtype=torch.float64, device=dev).index_add_(0, dst, w64), 10),
        "fp32 index_add_": time_ms(lambda: torch.zeros(
            LJ_VERTICES, device=dev).index_add_(0, dst, w32), 10),
        "fp32 sparse_scatter_add": time_ms(
            lambda: sparse_scatter_add(dst, w32, LJ_VERTICES), 10)}
    rel = float(((kern.double() - f64).abs() / f64.abs().clamp_min(1e-30)).max())
    log(f"pagerank credits, one thread ({e.shape[0]} edges, {top} into the most popular "
        f"vertex), ms: {json.dumps(times)}; sparse_scatter_add vs fp64 max rel diff {rel:.3e}")


def session(fused: bool = True) -> Session:
    return Session(backend=HostBackend(N_NODES, THREADS_PER_NODE, fused=fused))


def kmeans_seed0_spread(x, labels) -> None:
    """From fit's default init (seed 0): run the plain assignment twice and
    the kernel twice, and print how far the centers of each pair of runs lie
    apart.  Plain against plain shows what the dense accumulator's
    arrival-order fp32 sums alone do to the run; kernel against plain adds
    the two assignments' rounding.  Evidence only: these runs are not held to
    a limit and their launches are not counted."""
    init = np.random.default_rng(0).choice(COV_ROWS, COV_K, replace=False)
    runs = {f"{name}{i}": kmeans.fit(x, COV_K, iters=ITERS, seed=0, use_kernel=kern,
                                     session=session())[0]
            for name, kern in (("plain", False), ("kernel", True)) for i in (1, 2)}
    for c in runs.values():
        if c.shape != (COV_K, COV_FEATURES) or not np.all(np.isfinite(c)):
            raise AssertionError("kmeans seed 0: centers not finite or of the wrong shape")
    diff = {f"{a} vs {b}": float(np.abs(runs[a] - runs[b]).max())
            for a, b in (("plain1", "plain2"), ("kernel1", "kernel2"),
                         ("kernel1", "plain1"), ("kernel2", "plain2"))}
    log(f"kmeans seed 0 (true clusters hit by the init: {len(set(labels[init]))} of "
        f"{COV_K}): max abs center diff {json.dumps(diff)}")


def run_apps() -> dict:
    counts: dict = {}
    small_reference_checks()

    # -- pagerank, LiveJournal scale ------------------------------------------
    t0 = time.perf_counter()
    edges = powerlaw_graph(LJ_VERTICES, LJ_DEGREE, seed=SEED)
    log(f"pagerank graph: {LJ_VERTICES} vertices, {edges.shape[0]} edges "
        f"(made in {time.perf_counter() - t0:.1f} s)")
    time_credits(edges)
    traced = Session(n_nodes=N_NODES, threads_per_node=THREADS_PER_NODE, trace=True)
    g_calls: list = []
    restore = time_g_in_pagerank(g_calls)
    try:
        (r_auto, s_auto), launched = run_app("pagerank auto", counts, lambda: pagerank.fit(
            edges, LJ_VERTICES, iters=ITERS, mode="auto", session=traced))
        branches = [sp["args"]["mode"] for sp in
                    traced.tracer.spans("accumulate-round", "accumulate.round")]
    finally:
        restore()
        traced.tracer.disable()
    log(f"pagerank auto: branch per round {branches}, wire {s_auto.wire_traffic()}")
    log("pagerank auto: accumulate_blocked inside the run (4 worker threads), per call: "
        f"host us {[round(h * 1e6, 1) for h, _, _, _ in g_calls]}, CUDA-event ms "
        f"{[round(st.elapsed_time(en), 4) for _, st, en, _ in g_calls]}; just before each "
        "call, host us of torch.empty_like(row), torch.cuda.current_stream(index)"
        f".cuda_stream, a ctypes no-op: {[[round(t * 1e6, 1) for t in p] for *_, p in g_calls]}")
    if len(g_calls) != ITERS:
        raise AssertionError(f"pagerank auto: {len(g_calls)} accumulate_blocked calls timed")
    # every round at this scale takes the dense branch: one fold each
    expect_launches("pagerank auto", launched, {"accumulate_blocked": ITERS,
                                                "fused_topk_scatter": 0})
    if len(branches) != ITERS:
        raise AssertionError(f"pagerank auto: {len(branches)} rounds traced")
    r_ref = pagerank.fit_reference(edges, LJ_VERTICES, ITERS)
    close(r_auto, r_ref, "pagerank auto vs single-thread reference")
    rel = np.abs(r_auto - r_ref) / np.maximum(np.abs(r_ref), 1e-30)
    log(f"pagerank auto vs single-thread reference: max rel diff {rel.max():.3e}")
    k = LJ_VERTICES // 4
    (r_f, s_f), launched = run_app("pagerank sparse fused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(True)))
    expect_launches("pagerank sparse fused", launched, {"fused_topk_scatter": ITERS,
                                                        "sparse_scatter_add": 0})
    (r_u, s_u), launched = run_app("pagerank sparse unfused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(False)))
    # unfused: one compression per thread and one scatter launch for all
    # the threads' pairs each round
    expect_launches("pagerank sparse unfused", launched,
                    {"topk_compress_bitonic": ITERS * N_THREADS, "fused_topk_scatter": 0,
                     "sparse_scatter_add": ITERS})
    close(r_f, r_u, "pagerank sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("pagerank: fused and unfused wire traffic differ")
    for r in (r_auto, r_f, r_u):
        if r.shape != (LJ_VERTICES,) or not np.all(np.isfinite(r)):
            raise AssertionError("pagerank: ranks not finite or of the wrong shape")
    log(f"pagerank sparse: wire {s_f.wire_traffic()} (fused == unfused), "
        f"rank sum auto {r_auto.sum():.6f} sparse {r_f.sum():.6f}")
    del edges
    bf16_sparse_round(np.random.default_rng(SEED), counts)

    # -- kmeans, Covertype shape ----------------------------------------------
    x, _, labels = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    kmeans_seed0_spread(x, labels)
    # Lloyd's starts from one point of each true cluster (the first init seed
    # that gives that): from fit's default seed 0 two centers share a true
    # cluster and split it along a plane of near-tie points, where runs drift
    # apart (kmeans_seed0_spread above prints by how much, and between which
    # runs); without split clusters kernel and plain runs are held to 1e-4
    init_seed = next(s for s in range(100_000) if len(set(labels[
        np.random.default_rng(s).choice(COV_ROWS, COV_K, replace=False)])) == COV_K)
    (c_k, _), launched = run_app("kmeans kernel", counts, lambda: kmeans.fit(
        x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True, session=session()))
    expect_launches("kmeans kernel", launched, {"kmeans_assign": ITERS * N_THREADS})
    (c_p, _), _ = run_app("kmeans plain", counts, lambda: kmeans.fit(
        x, COV_K, iters=ITERS, seed=init_seed, use_kernel=False, session=session()))
    np.testing.assert_allclose(c_k, c_p, rtol=1e-4, atol=1e-5,
                               err_msg="kmeans kernel vs plain assignment")
    inertia_k, inertia_p = kmeans.inertia(x, c_k), kmeans.inertia(x, c_p)
    np.testing.assert_allclose(inertia_k, inertia_p, rtol=1e-5,
                               err_msg="kmeans inertia, kernel vs plain")
    log(f"kmeans (init seed {init_seed}): centers kernel vs plain max abs diff "
        f"{np.abs(c_k - c_p).max():.3e}, inertia {inertia_k:.3f} vs {inertia_p:.3f}")
    if c_k.shape != (COV_K, COV_FEATURES) or not np.all(np.isfinite(c_k)):
        raise AssertionError("kmeans: centers not finite or of the wrong shape")
    del x

    # -- logreg, sparse gradients ---------------------------------------------
    x, y, _ = logreg_dataset(LR_ROWS, LR_FEATURES, seed=SEED)
    (th_f, s_f), launched = run_app("logreg sparse fused", counts, lambda: logreg.fit(
        x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K, session=session(True)))
    expect_launches("logreg sparse fused", launched, {"fused_topk_scatter": ITERS})
    (th_u, s_u), launched = run_app("logreg sparse unfused", counts, lambda: logreg.fit(
        x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K, session=session(False)))
    expect_launches("logreg sparse unfused", launched,
                    {"topk_compress_argmax": ITERS * N_THREADS,
                     "sparse_scatter_add": ITERS})
    close(th_f, th_u, "logreg sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("logreg: fused and unfused wire traffic differ")
    loss0 = logreg.loss(np.zeros(LR_FEATURES, np.float32), x[:100_000], y[:100_000])
    loss1 = logreg.loss(th_f, x[:100_000], y[:100_000])
    if not (np.all(np.isfinite(th_f)) and loss1 < loss0):
        raise AssertionError(f"logreg: loss {loss1} not below the start's {loss0}")
    log(f"logreg: wire {s_f.wire_traffic()} (fused == unfused), loss {loss0:.4f} -> {loss1:.4f}")
    del x, y

    # -- nmf, Netflix's movie columns -----------------------------------------
    t0 = time.perf_counter()
    r, _, _ = nmf_dataset(NMF_ROWS, NMF_COLS, NMF_RANK, seed=SEED)
    log(f"nmf: R ({NMF_ROWS}, {NMF_COLS}) f32, {r.nbytes / 1e9:.2f} GB (made in "
        f"{time.perf_counter() - t0:.1f} s): Netflix's {NMF_COLS} movie columns in full, "
        f"its {NETFLIX_USERS} users cut to {NMF_ROWS}; rank {NMF_RANK}, "
        f"Q round {NMF_ROUND} floats")
    (p_a, q_a, s_a), launched = run_app("nmf auto", counts, lambda: nmf.fit(
        r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, mode="auto", session=session()))
    modes = {s_a.accumulator("q_partials").last_mode.value}
    expect_launches("nmf auto", launched, {"accumulate_blocked": ITERS})
    (p_d, q_d, s_d), launched = run_app("nmf reduce_scatter", counts, lambda: nmf.fit(
        r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, session=session()))
    expect_launches("nmf reduce_scatter", launched, {"accumulate_blocked": 0})
    np.testing.assert_allclose(q_a, q_d, rtol=1e-4, err_msg="nmf Q, auto vs reduce_scatter")
    if s_a.wire_traffic() != s_d.wire_traffic():
        raise AssertionError("nmf: auto and reduce_scatter wire traffic differ")
    for p, q in ((p_a, q_a), (p_d, q_d)):
        if p.shape != (NMF_ROWS, NMF_RANK) or q.shape != (NMF_RANK, NMF_COLS) or not (
                np.all(np.isfinite(p)) and np.all(np.isfinite(q))):
            raise AssertionError("nmf: factors not finite or of the wrong shape")
    p_r, q_r = nmf.fit_reference(r, NMF_RANK, ITERS, NMF_INIT_SEED)
    loss0 = nmf.frob_loss(r, *nmf._init(NMF_ROWS, NMF_COLS, NMF_RANK, NMF_INIT_SEED))
    loss_a, loss_r = nmf.frob_loss(r, p_a, q_a), nmf.frob_loss(r, p_r, q_r)
    if not loss_a < loss0:
        raise AssertionError(f"nmf: loss {loss_a} not below the start's {loss0}")
    np.testing.assert_allclose(loss_a, loss_r, rtol=1e-2,        # test_analytics.py:53
                               err_msg="nmf loss vs single-thread reference")
    log(f"nmf: branch {modes}, wire {s_a.wire_traffic()} (auto == reduce_scatter), Q auto vs "
        f"reduce_scatter max rel diff {float(np.max(np.abs(q_a - q_d) / np.abs(q_d))):.3e}, "
        f"loss {loss0:.6g} -> {loss_a:.6g} (reference {loss_r:.6g})")
    return counts


# ---------------------------------------------------------------------------
# Phase 5: the LM serving path at full width
# ---------------------------------------------------------------------------


def logit_gap(label: str, full, stepped) -> tuple:
    """Print and return max |dlogit| of a forward against the decode steps,
    max |logit| of the forward, and whether the argmax agrees everywhere."""
    delta = float((full - stepped).abs().max())
    scale = float(full.abs().max())
    same = bool(torch.equal(full.argmax(-1), stepped.argmax(-1)))
    log(f"lm {label} vs {LM_CONSISTENCY} decode steps: max |dlogit| {delta:.3e}, "
        f"max |logit| {scale:.3e}, ratio {delta / scale:.3e} (limit 1e-3), "
        f"argmax equal at every position: {same}")
    return delta, scale, same


def run_lm_bf16_prefill(counts: dict) -> None:
    """qwen3-1.7b at its full config in bf16, prefill 4 x 2048: the flash
    kernel's bf16 body once per layer; the logits finite, of the full
    shape."""
    cfg = get_arch("qwen3-1.7b").replace(attention_impl="pallas", dtype="bfloat16")
    model = build_model(cfg, generator=torch.Generator("cuda").manual_seed(SEED))
    prefill = make_prefill_step(model)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PREFILL), device="cuda",
                           dtype=torch.int32, generator=torch.Generator("cuda").manual_seed(SEED))
    prefill({"tokens": tokens[:, :LM_CONSISTENCY]})      # warm-up, not counted
    t0 = time.perf_counter()
    logits, launched = run_app(f"lm qwen3-1.7b bf16 prefill {LM_BATCH}x{LM_PREFILL}", counts,
                               lambda: prefill({"tokens": tokens}))
    log(f"lm qwen3-1.7b bf16 prefill: "
        f"{LM_BATCH * LM_PREFILL / (time.perf_counter() - t0):.1f} tokens/s")
    expect_launches("qwen3-1.7b bf16 prefill", launched,
                    {"flash_attention_bf16": cfg.n_layers, "flash_attention": cfg.n_layers})
    if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("qwen3-1.7b bf16 prefill: logits not finite or of the wrong shape")
    del model, prefill, logits
    torch.cuda.empty_cache()


def run_lm() -> dict:
    # the app phase's sessions hold device tensors in reference cycles: free
    # them, so the peak memory read here is the models'
    gc.collect()
    torch.cuda.empty_cache()
    counts: dict = {}
    for arch, (overrides, kernel) in LM_MODELS.items():
        cfg = get_arch(arch).replace(**overrides)
        gen = torch.Generator("cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        model = build_model(cfg, generator=gen)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"lm {arch}: {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32), "
            f"built in {time.perf_counter() - t0:.2f} s")
        prefill = make_prefill_step(model)
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PREFILL), generator=gen,
                               device="cuda", dtype=torch.int32)
        prefill({"tokens": tokens[:, :LM_CONSISTENCY]})      # warm-up, not counted

        # (a) prefill at B x T
        t0 = time.perf_counter()
        logits, launched = run_app(f"lm {arch} prefill {LM_BATCH}x{LM_PREFILL}", counts,
                                   lambda: prefill({"tokens": tokens}))
        log(f"lm {arch} prefill: {LM_BATCH * LM_PREFILL / (time.perf_counter() - t0):.1f} "
            "tokens/s")
        expect_launches(f"{arch} prefill", launched, {kernel: cfg.n_layers})
        if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} prefill: logits {tuple(logits.shape)} not finite "
                                 "or of the wrong shape")
        del logits

        # (b) forward vs decode steps on one prompt: the kernel inside the
        # model, with its causal mask or chunk carry, against the cache path
        prompt = tokens[:, :LM_CONSISTENCY]
        full, launched = run_app(f"lm {arch} forward {LM_BATCH}x{LM_CONSISTENCY}", counts,
                                 lambda: prefill({"tokens": prompt}))
        expect_launches(f"{arch} forward", launched, {kernel: cfg.n_layers})
        # the decode steps double as a decode-rate window: four blocks of
        # DECODE_BLOCK steps, each timed between two synchronisations
        rates = []
        with torch.no_grad():
            cache = model.init_cache(LM_BATCH, LM_CONSISTENCY)
            steps = []
            for pos in range(LM_CONSISTENCY):
                if pos % DECODE_BLOCK == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                step, cache = model.decode_step(cache, prompt[:, pos:pos + 1], pos)
                steps.append(step[:, 0])
                if (pos + 1) % DECODE_BLOCK == 0:
                    torch.cuda.synchronize()
                    rates.append(LM_BATCH * DECODE_BLOCK / (time.perf_counter() - t0))
            stepped = torch.stack(steps, dim=1)
        log(f"lm {arch} decode, batch {LM_BATCH}, tokens/s per {DECODE_BLOCK}-step block: "
            f"{[round(r, 1) for r in rates]} (median {statistics.median(rates):.1f})")
        delta, scale, same = logit_gap(f"{arch} prefill", full, stepped)
        if not delta <= 1e-3 * scale or not same:
            raise AssertionError(f"{arch}: prefill and decode disagree")
        if kernel == "ssd_scan":
            # the same check on the plain chunked algorithm, with the same
            # weights and prompt: a gap like the kernel's is the algorithm's
            model.ssm = model.ssm._replace(ssd_impl="chunked")
            plain = prefill({"tokens": prompt})
            logit_gap(f"{arch} chunked (plain) forward", plain, stepped)
            log(f"lm {arch} kernel vs chunked forward: max |dlogit| "
                f"{float((full - plain).abs().max()):.3e}")
            del plain
        del model, prefill, full, stepped, steps, cache
        torch.cuda.empty_cache()

        # (c) the serving loop at full width (prefill by decode + greedy)
        toks, _ = run_app(f"lm {arch} serve", counts, lambda: serve(
            arch, smoke=False, batch=LM_BATCH, prompt_len=32, gen=32, seed=SEED))
        if toks.shape != (LM_BATCH, 32) or toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"{arch} serve: tokens {toks.shape} out of range")
        torch.cuda.empty_cache()
    run_lm_bf16_prefill(counts)
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is visible")
    smi = card_info()
    log("card:", smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # the plain versions' matmuls must run in full fp32 (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} sources")
    for lib, label, marker in (("flash_attention", "flash_attention_f32", "flash_tf32_kernel"),
                               ("flash_attention", "flash_attention_bf16", "flash_wgmma_kernel"),
                               ("topk_compress", "topk_compress_bitonic", "topk_radix_kernel"),
                               ("scatter_add", "sparse_scatter_add", "scatter_rows_kernel")):
        for line in ptxas_lines(logs.get(lib, ""), marker):
            log(f"{label} ptxas:", line)

    rng = np.random.default_rng(SEED)
    measured = check_kernels(rng)
    measured["flash_attention"] = check_flash(rng)
    measured["ssd_scan"] = check_ssd(rng)
    measured.update(check_receive(rng))
    measured["flash_attention_bf16"] = check_flash_bf16(rng)
    check_inputs(rng)
    g_split(rng)
    h_split(rng)
    for name, m in measured.items():
        log(f"kernel {name} [{m['shape']}]: {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
            f"bound {m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}), "
            f"library {m['library_ms']} ms, max_abs_err {m['max_abs_err']}; device time by "
            f"graph replay {m.get('device_ms')} ms, library's {m.get('library_device_ms')} ms")

    counts = run_apps()
    for name, n in run_lm().items():
        counts[name] = counts.get(name, 0) + n
    missing = [name for name in KERNELS if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name],
         **{key: measured[name][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (src, replaces) in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
