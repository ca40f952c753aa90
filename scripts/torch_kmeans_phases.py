"""kmeans_assign (D) on the card: the kernel against its parent commit, and
where a CTA's cycles go in each of its three bodies.

    python3 scripts/torch_kmeans_phases.py --unpack REV   # needs git: REV's tree
                                                          # into build/kmeans_parent
    python3 scripts/torch_kmeans_phases.py                # on the card

1. A/B.  The parent tree's ``kmeans_assign`` and this tree's, each in a
   process of its own (both packages are named ``repro_torch``), in turns
   parent, change, change, parent, at every shape of ``SHAPES``: Covertype's
   rows (581,012 x 54, 7 centers) split over the four threads of
   ``kmeans.fit`` — thread 0's share ``data[:n]`` and thread 1's ``data[n:2n]``,
   whose pointer is only 8-byte (f32) or 4-byte (bf16) aligned — then K 1,024
   at D 64, K 9,000 at D 8 and K 3 at D 60,000 (integer points), each in f32
   and bf16.  Each run times a call (CUDA events around one call, median of
   50) and the device time (the call captured in a CUDA graph, 50 replays),
   holds its outputs to the plain version by chip_smoke.py's contract, and
   saves them; the two trees' outputs must then be equal (``torch.equal``)
   where this tree's body keeps the parent's FMA chains in j order (rows and
   tiles) — at D 60,000 the integer points make every order exact, so they
   must be equal there too.  The first change run also times the plain
   version.  Each shape's bound is printed beside it.
2. Phases.  A copy of ``csrc/kmeans_assign.cu`` with clock64 probes, read by
   thread 0 of each CTA: rows — the tile's loads (to the barrier), the
   centers' norms, the dots and the argmin; tiles — each step's wait (the
   stores of the loaded slab and the barrier), the products (with the next
   step's loads issued), the epilogues, the merge; wide — streaming D, the
   tree, the argmin.  Printed as mean cycles a CTA at each shape.
3. Variants.  Copies with one design choice changed each: rows with an
   even row stride (D, not D | 1), rows with one 16-byte load in flight a
   thread (not four), tiles with 64 points (8 x 8 dots a thread) at any N,
   tiles with 16 (4 x 4) at any N, tiles without the 128-register cap (8 x 8
   then takes ~150 and one CTA an SM), wide with element loads only.  Each build and the library are checked against the
   plain version and timed through ctypes (50 launches back to back between
   CUDA events, median of 5), in turns.  The probes and variants go in by
   text substitution; the script stops if the source no longer holds an
   anchor.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
PARENT = os.path.join(ROOT, "build", "kmeans_parent")
OUT_DIR = os.path.join(ROOT, "build", "phases")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
COV_ROWS, COV_FEATURES, COV_K, N_THREADS = 581_012, 54, 7, 4
COV_N = COV_ROWS // N_THREADS
# (name, n, d, k, dtype, kind): kind "cov0" / "cov1" is thread 0's / 1's
# share of the Covertype-shaped data, "normal" normal points, "int" integer
# points in {-1, 0, 1}; the centers are points of the same input
SHAPES = [("covertype thread 0", COV_N, COV_FEATURES, COV_K, "f32", "cov0"),
          ("covertype thread 1", COV_N, COV_FEATURES, COV_K, "f32", "cov1"),
          ("covertype thread 0", COV_N, COV_FEATURES, COV_K, "bf16", "cov0"),
          ("covertype thread 1", COV_N, COV_FEATURES, COV_K, "bf16", "cov1"),
          ("K 1,024 D 64", 20_000, 64, 1024, "f32", "normal"),
          ("K 1,024 D 64", 20_000, 64, 1024, "bf16", "normal"),
          ("K 9,000 D 8", 3000, 8, 9000, "f32", "normal"),
          ("K 9,000 D 8", 3000, 8, 9000, "bf16", "normal"),
          ("K 3 D 60,000", 300, 60_000, 3, "f32", "int"),
          ("K 3 D 60,000", 300, 60_000, 3, "bf16", "int")]

PROBE_DEFS = """
__device__ unsigned long long g_probe[3][8];  // [body][phase], slot 7: CTAs
#define PROBE_START long long probe_t = clock64(), probe_acc[7] = {0, 0, 0, 0, 0, 0, 0};
#define PROBE(i) { const long long now_ = clock64(); probe_acc[i] += now_ - probe_t; probe_t = now_; }
#define PROBE_END(b) if (threadIdx.x == 0) { \\
  for (int i_ = 0; i_ < 7; ++i_) atomicAdd(&g_probe[b][i_], (unsigned long long)probe_acc[i_]); \\
  atomicAdd(&g_probe[b][7], 1ull); }
extern "C" int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
extern "C" int probe_reset() {
  static const unsigned long long zero[3][8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe)));
}
"""
PHASES = {0: ("rows", ["load", "norms", "dots + argmin"]),
          1: ("tiles", ["slab wait", "products", "epilogue", "merge"]),
          2: ("wide", ["stream D", "tree", "argmin"])}
# (anchor, replacement): each anchor must occur once in the source
PROBES = [
    ('#include "dtype.cuh"\n', '#include "dtype.cuh"\n' + PROBE_DEFS),
    # rows
    ("  const int np = static_cast<int>(n - p0 < kRowsPoints ? n - p0 : kRowsPoints);\n",
     "  const int np = static_cast<int>(n - p0 < kRowsPoints ? n - p0 : kRowsPoints);\n"
     "  PROBE_START\n"),
    ("sc[threadIdx.x + i * kRowsPoints] = cv[i];\n  __syncthreads();\n",
     "sc[threadIdx.x + i * kRowsPoints] = cv[i];\n  __syncthreads();\n  PROBE(0)\n"),
    ("  __syncthreads();\n  if (static_cast<int>(threadIdx.x) >= np) return;\n",
     "  __syncthreads();\n  PROBE(1)\n  if (static_cast<int>(threadIdx.x) >= np) return;\n"),
    ("  assign[p0 + threadIdx.x] = best;\n",
     "  PROBE(2)\n  PROBE_END(0)\n  assign[p0 + threadIdx.x] = best;\n"),
    # tiles
    ("  const int nsteps = (k + BC - 1) / BC * nslabs;\n",
     "  const int nsteps = (k + BC - 1) / BC * nslabs;\n  PROBE_START\n"),
    ("    if (s + 1 < nsteps) fetch(next_tile, next_slab);\n",
     "    PROBE(0)\n    if (s + 1 < nsteps) fetch(next_tile, next_slab);\n"),
    ("    if (last) {  // the tile's d2", "    PROBE(1)\n    if (last) {  // the tile's d2"),
    ("    tile = next_tile, slab = next_slab;\n",
     "    PROBE(2)\n    tile = next_tile, slab = next_slab;\n"),
    ("    dist[p0 + t] = bd;\n  }\n}\n",
     "    dist[p0 + t] = bd;\n  }\n  PROBE(3)\n  PROBE_END(1)\n}\n"),
    # wide
    ("  float p2 = 0.0f, best_d2 = CUDART_INF_F;\n",
     "  PROBE_START\n  float p2 = 0.0f, best_d2 = CUDART_INF_F;\n"),
    ("    cta_sums(v, part, sums);\n",
     "    PROBE(0)\n    cta_sums(v, part, sums);\n    PROBE(1)\n"),
    ("  if (threadIdx.x == 0) {\n    assign[p] = best;\n",
     "  PROBE(2)\n  PROBE_END(2)\n  if (threadIdx.x == 0) {\n    assign[p] = best;\n"),
]
FILL = "static int tile_points(long long n) { return (n + 63) / 64 >= kTilesFill ? 64 : 16; }\n"
BOUNDS = "__global__ void __launch_bounds__(kTileThreads, 2)"
# name: ([(anchor, replacement)], the shapes it is timed at)
VARIANTS = {
    "rows, even row stride": ([("  const int stride = d | 1;\n", "  const int stride = d;\n")],
                              "covertype"),
    "rows, one load in flight a thread": ([("  constexpr int kBatch = 4;", "  constexpr int kBatch = 1;")],
                                          "covertype"),
    "tiles, 64 points (8 x 8) at any N": ([(FILL, FILL.replace("? 64 : 16", "? 64 : 64"))],
                                          "K "),
    "tiles, 16 points (4 x 4) at any N": ([(FILL, FILL.replace("? 64 : 16", "? 16 : 16"))],
                                          "K "),
    "tiles, no register cap (8 x 8: one CTA an SM)": (
        [(BOUNDS, BOUNDS.replace("(kTileThreads, 2)", "(kTileThreads)"))], "K "),
    "wide, element loads": ([("  const bool vec = aligned16(row) && aligned16(ctr) && d % V == 0;\n",
                              "  const bool vec = false;\n")], "D 60,000"),
}


def bound(n, d, k, esize):
    t_bytes = ((n * d + k * d) * esize + 8 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n * k * d / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def inputs(torch, kmeans_dataset):
    """Every shape's (points, centers) on the card, the same in every run."""
    data, _, _ = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=0)
    cov = torch.from_numpy(data).cuda()
    cov_ctr = torch.from_numpy(data[np.random.default_rng(0).choice(COV_ROWS, COV_K,
                                                                    replace=False)]).cuda()
    out = []
    for i, (name, n, d, k, dt, kind) in enumerate(SHAPES):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        if kind.startswith("cov"):
            lo = int(kind[-1]) * n
            pts, ctr = cov.to(dtype)[lo:lo + n], cov_ctr.to(dtype)
        else:
            rng = np.random.default_rng(100 + i)
            x = (rng.integers(-1, 2, size=(n, d)) if kind == "int"
                 else rng.normal(size=(n, d))).astype(np.float32)
            pts = torch.from_numpy(x).cuda().to(dtype)
            ctr = pts[torch.from_numpy(rng.choice(n, k, replace=n < k)).cuda()].clone()
        out.append((pts, ctr))
    return out


def held(torch, pts, ctr, a, dist, pa, pd, exact):
    """chip_smoke.py's check_assign: equal assignments except where the two
    best d2 are within 1e-5 relative; dist2 within rtol 1e-5 plus
    1e-6 max|p|^2; exactly equal where ``exact``."""
    p32, c32 = pts.float(), ctr.float()
    if exact and not (torch.equal(a, pa) and torch.equal(dist, pd)):
        raise AssertionError("not exactly equal to the plain version")
    diff = a.long() != pa.long()
    if bool(diff.any()):
        d2 = ((p32[diff, None, :] - c32[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        if bool(((two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()).any()):
            raise AssertionError(f"{int(diff.sum())} assignments differ beyond the tie margin")
    torch.testing.assert_close(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((p32 * p32).sum(1).max()))


def child(tree: str, out_path: str, plain: bool) -> None:
    """One tree's run: time and save every shape's outputs."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.data import kmeans_dataset
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign, kmeans_assign_plain

    torch.backends.cuda.matmul.allow_tf32 = False

    def time_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def graph_ms(fn, reps=50):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    rows, saved = [], {}
    for (name, n, d, k, dt, kind), (pts, ctr) in zip(SHAPES, inputs(torch, kmeans_dataset)):
        a, dist = kmeans_assign(pts, ctr)
        pa, pd = kmeans_assign_plain(pts, ctr)
        held(torch, pts, ctr, a, dist, pa, pd, exact=kind == "int")
        saved[f"{name} {dt}"] = (a.cpu(), dist.cpu())
        row = dict(shape=f"{name} {dt}", ptr_mod16=pts.data_ptr() % 16,
                   ms=time_ms(lambda: kmeans_assign(pts, ctr)),
                   device_ms=graph_ms(lambda: kmeans_assign(pts, ctr)))
        if plain:
            row["plain_ms"] = time_ms(lambda: kmeans_assign_plain(pts, ctr), 10)
        rows.append(row)
    torch.save(saved, out_path)
    print(json.dumps(rows))


def ab(torch) -> None:
    """Parent, change, change, parent; then the trees' outputs compared."""
    if not os.path.isdir(os.path.join(PARENT, "src", "repro_torch")):
        raise SystemExit(f"no parent tree in {PARENT}: run with --unpack REV where git is")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.kmeans_assign.ops import regime

    tmp = tempfile.mkdtemp()
    runs = []
    for i, (label, tree) in enumerate((("parent", PARENT), ("change", ROOT),
                                       ("change", ROOT), ("parent", PARENT))):
        out = os.path.join(tmp, f"{i}.pt")
        args = [sys.executable, os.path.abspath(__file__), "--child", tree, out]
        if i == 1:
            args.append("--plain")
        res = subprocess.run(args, capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{label} run failed:\n{res.stdout}\n{res.stderr}")
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1]), torch.load(out)))
    for j, (name, n, d, k, dt, kind) in enumerate(SHAPES):
        key = f"{name} {dt}"
        body, points = regime(n, d, k)
        t, by = bound(n, d, k, 4 if dt == "f32" else 2)
        times = " / ".join(f"{r[j]['ms']:.4f} ({r[j]['device_ms']:.4f})" for _, r, _ in runs)
        print(f"{key}: points ({n}, {d}), {k} centers, pointer mod 16 = {runs[1][1][j]['ptr_mod16']};"
              f" body {body} ({points} points a CTA); bound {t:.4f} ms ({by}); plain "
              f"{runs[1][1][j]['plain_ms']:.4f} ms; call (device) ms, parent / change / change / "
              f"parent: {times}")
        pa, pd = runs[0][2][key]
        ca, cd = runs[1][2][key]
        same = torch.equal(pa, ca) and torch.equal(pd.view(torch.int32), cd.view(torch.int32))
        if body in ("rows", "tiles") or kind == "int":
            if not same:
                raise AssertionError(f"{key}: the change's outputs differ from the parent's")
        print(f"  outputs bit-equal to the parent's: {same}")
    shutil.rmtree(tmp, ignore_errors=True)


def substituted(src: str, subs) -> str:
    for anchor, new in subs:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in kmeans_assign.cu: {anchor[:70]!r}")
        src = src.replace(anchor, new)
    return src


def start_build(build, src: str, name: str):
    """nvcc with kernels/build.py's flags (-Xptxas -v among them) on a copy."""
    d = os.path.join(OUT_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "kmeans_assign.cu"), "w") as f:
        f.write(src)
    lib = os.path.join(d, f"lib{name}.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib,
                             os.path.join(d, "kmeans_assign.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def ptxas_summary(log: str) -> dict:
    """{kernel: "registers, spill stores / loads, shared memory"} from -Xptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)(EvPK\w*)?' for", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(, \d+ bytes smem)?", line)
        if m and name:
            out[name] = f"{m.group(1)} registers{m.group(2) or ''}, " + out.get(name, "")
    return out


def phases(torch) -> None:
    """The probed copy and the variants at the shapes, in turns."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import kmeans_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.kmeans_assign import ops

    with open(os.path.join(build.CSRC, "kmeans_assign.cu")) as f:
        src = f.read()
    copies = {"as is": src, "probed": substituted(src, PROBES)}
    copies.update({name: substituted(src, subs) for name, (subs, _) in VARIANTS.items()})
    builds = {name: start_build(build, s, f"kmeans_{i}") for i, (name, s) in
              enumerate(copies.items())}
    libs = {"library": build.library("kmeans_assign", ops._SIGNATURES)}
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the {name} copy:\n{log}")
        if name == "as is" or name.startswith("tiles, no register cap"):
            print(f"ptxas, {name}: {json.dumps(ptxas_summary(log))}")
        lib = ctypes.CDLL(path)
        lib.kmeans_assign.argtypes = list(ops._SIGNATURES["kmeans_assign"])
        libs[name] = lib
    probe = libs["probed"]
    probe.probe_read.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    for (name, n, d, k, dt, kind), (pts, ctr) in zip(SHAPES, inputs(torch, kmeans_dataset)):
        a = torch.empty(n, dtype=torch.int32, device="cuda")
        dist = torch.empty(n, dtype=torch.float32, device="cuda")
        pa, pd = ops.kmeans_assign_plain(pts, ctr)
        code = build.DTYPES[pts.dtype]

        def run(lib):
            err = lib.kmeans_assign(code, pts.data_ptr(), ctr.data_ptr(), a.data_ptr(),
                                    dist.data_ptr(), n, d, k, stream)
            if err:
                raise RuntimeError(f"kmeans_assign: CUDA error {err}")

        body, _ = ops.regime(n, d, k)
        ids = {"rows": 0, "tiles": 1, "wide": 2}
        timed = [v for v, (_, where) in VARIANTS.items() if where in name
                 and v.startswith(body)]
        order = ["library", "probed"] + timed
        for v in order:
            a.fill_(-1)
            if v == "probed":
                probe.probe_reset()
            run(libs[v])
            torch.cuda.synchronize()
            held(torch, pts, ctr, a, dist, pa, pd, exact=kind == "int")
        buf = np.zeros((3, 8), dtype=np.uint64)
        if probe.probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe_read failed")
        b = ids[body]
        ctas = int(buf[b, 7])
        labels = PHASES[b][1]
        per_cta = {lab: round(float(buf[b, i]) / ctas, 1) for i, lab in enumerate(labels)}
        print(f"{name} {dt}: body {body}, {ctas} CTAs; cycles a CTA (thread 0, mean): {per_cta}")

        def launches_ms(lib, reps=50):
            times = []
            for _ in range(5):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(reps):
                    run(lib)
                e.record()
                e.synchronize()
                times.append(s.elapsed_time(e) / reps)
            return statistics.median(times)

        turns = ["library"] + timed + timed[::-1] + ["library"]
        times = [(v, round(launches_ms(libs[v]), 4)) for v in turns]
        print(f"  ms a launch, in turns: {times}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unpack", metavar="REV", help="unpack REV's tree into build/kmeans_parent")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.unpack:
        shutil.rmtree(PARENT, ignore_errors=True)
        os.makedirs(PARENT)
        archive = subprocess.run(["git", "-C", ROOT, "archive", args.unpack], check=True,
                                 capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", PARENT], input=archive, check=True)
        print(f"{args.unpack} unpacked into {PARENT}")
        return
    if args.child:
        child(*args.child, args.plain)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    ab(torch)
    phases(torch)


if __name__ == "__main__":
    main()
