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
             assignments and dist² within 1e-5 relative.  Each is timed
             (median of CUDA-event timings) beside its plain version, its
             bound and, where one PyTorch call computes the same function,
             that call.
4. apps    — the host Session (2 nodes x 2 threads, device left at its
             default) at realistic sizes: pagerank on a LiveJournal-scale
             graph (AUTO, SPARSE fused, SPARSE unfused), kmeans on the
             Covertype shape with the kernel (plus four uncounted runs from
             the default init, whose spread is printed), logreg with
             sparse_k fused and unfused.  Launch counters are zeroed just
             before each run and read just after; every kernel must have
             been launched.  A small run of each app is also held against
             its single-thread reference on the CPU.
5. result  — one ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and
             the ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import card_info  # noqa: E402
from repro_torch.analytics import kmeans, logreg, pagerank  # noqa: E402
from repro_torch.core import HostBackend, Session  # noqa: E402
from repro_torch.core.sparse import block_layout  # noqa: E402
from repro_torch.data import kmeans_dataset, logreg_dataset, powerlaw_graph  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import (  # noqa: E402
    fused_topk_scatter, fused_topk_scatter_plain)
from repro_torch.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign, kmeans_assign_plain)
from repro_torch.kernels.topk_compress.ops import (  # noqa: E402
    BITONIC_MIN_K, topk_compress, topk_compress_plain)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
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

KERNELS = {
    "fused_topk_scatter": ("src/repro_torch/csrc/fused_scatter.cu",
                           "src/repro/kernels/accumulate/fused_scatter.py:61"),
    "topk_compress_argmax": ("src/repro_torch/csrc/topk_compress.cu",
                             "src/repro/kernels/topk_compress/kernel.py:33"),
    "topk_compress_bitonic": ("src/repro_torch/csrc/topk_compress.cu",
                              "src/repro/kernels/topk_compress/kernel.py:52"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kernel.py:31"),
}


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


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
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
            library_ms=time_ms(lambda: torch.topk(mags, pb, dim=1), 20))
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
        plain_ms=time_ms(lambda: kmeans_assign_plain(pts, ctr), 20),
        bound_ms=t, bound_by=by, library_ms=None)
    return results


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
    log(f"app {label}: wall {wall:.3f} s, peak device memory "
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
    big = torch.from_numpy(powerlaw_graph(200_000, 14, seed=1)).long().cuda()
    ranks = torch.rand(200_000, generator=torch.Generator().manual_seed(SEED)).cuda()
    deg = torch.ones(200_000, device="cuda")
    runs = [pagerank._credits(big[:, 0], big[:, 1], ranks, deg, 200_000) for _ in range(3)]
    ulp = torch.finfo(torch.float32).eps
    for other in runs[1:]:
        torch.testing.assert_close(other, runs[0], rtol=ulp, atol=0.0)
    log("small reference checks: pagerank, logreg (sparse, lossless), kmeans "
        "(kernel) agree with their CPU references; the credits scatter "
        "repeats to within one fp32 ulp")


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
    traced = Session(n_nodes=N_NODES, threads_per_node=THREADS_PER_NODE, trace=True)
    try:
        (r_auto, s_auto), _ = run_app("pagerank auto", counts, lambda: pagerank.fit(
            edges, LJ_VERTICES, iters=ITERS, mode="auto", session=traced))
        branches = [sp["args"]["mode"] for sp in
                    traced.tracer.spans("accumulate-round", "accumulate.round")]
    finally:
        traced.tracer.disable()
    log(f"pagerank auto: branch per round {branches}, wire {s_auto.wire_traffic()}")
    if len(branches) != ITERS:
        raise AssertionError(f"pagerank auto: {len(branches)} rounds traced")
    r_ref = pagerank.fit_reference(edges, LJ_VERTICES, ITERS)
    close(r_auto, r_ref, "pagerank auto vs single-thread reference")
    rel = np.abs(r_auto - r_ref) / np.maximum(np.abs(r_ref), 1e-30)
    log(f"pagerank auto vs single-thread reference: max rel diff {rel.max():.3e}")
    k = LJ_VERTICES // 4
    (r_f, s_f), launched = run_app("pagerank sparse fused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(True)))
    expect_launches("pagerank sparse fused", launched, {"fused_topk_scatter": ITERS})
    (r_u, s_u), launched = run_app("pagerank sparse unfused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(False)))
    expect_launches("pagerank sparse unfused", launched,
                    {"topk_compress_bitonic": ITERS * N_THREADS, "fused_topk_scatter": 0})
    close(r_f, r_u, "pagerank sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("pagerank: fused and unfused wire traffic differ")
    for r in (r_auto, r_f, r_u):
        if r.shape != (LJ_VERTICES,) or not np.all(np.isfinite(r)):
            raise AssertionError("pagerank: ranks not finite or of the wrong shape")
    log(f"pagerank sparse: wire {s_f.wire_traffic()} (fused == unfused), "
        f"rank sum auto {r_auto.sum():.6f} sparse {r_f.sum():.6f}")
    del edges

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
                    {"topk_compress_argmax": ITERS * N_THREADS})
    close(th_f, th_u, "logreg sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("logreg: fused and unfused wire traffic differ")
    loss0 = logreg.loss(np.zeros(LR_FEATURES, np.float32), x[:100_000], y[:100_000])
    loss1 = logreg.loss(th_f, x[:100_000], y[:100_000])
    if not (np.all(np.isfinite(th_f)) and loss1 < loss0):
        raise AssertionError(f"logreg: loss {loss1} not below the start's {loss0}")
    log(f"logreg: wire {s_f.wire_traffic()} (fused == unfused), loss {loss0:.4f} -> {loss1:.4f}")
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
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} sources")

    rng = np.random.default_rng(SEED)
    measured = check_kernels(rng)
    for name, m in measured.items():
        log(f"kernel {name} [{m['shape']}]: {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
            f"bound {m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}), "
            f"library {m['library_ms']} ms, max_abs_err {m['max_abs_err']}")

    counts = run_apps()
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
