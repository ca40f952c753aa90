"""topk_compress's argmax body (B) on the card: the body against its parent
commit's, where a CTA's cycles go, and copies with one design choice changed.

    python3 scripts/torch_topk_argmax_phases.py --unpack REV   # needs git: REV's tree
                                                               # into build/topk_parent
    python3 scripts/torch_topk_argmax_phases.py                # on the card

1. A/B.  The parent tree's ``topk_compress(method="argmax")`` and this
   tree's, each in a process of its own (both packages are named
   ``repro_torch``), in turns parent, change, change, parent, at logreg's
   shape (x (512,) f32, block 512, k 32), at every entry of chip_smoke.py's
   ``C_INPUTS`` in f32 and bf16, and at 1,024-lane blocks of pagerank's V
   (k 4, 32, 256): a call (CUDA events around one call, median of 50) and
   the device time (the call captured in a CUDA graph, 50 replays).  Each
   run holds its pairs equal to the plain version and saves them; the two
   trees' pairs must then be equal.  The change runs also time the radix
   body (``method="bitonic"``) and ``torch.topk`` of the blocked
   magnitudes the same way, and the first one the plain version.
2. Phases.  A copy of ``csrc/topk_compress.cu`` with clock64 probes in the
   argmax body, summed by thread 0 of each CTA (warp 0, which takes part in
   every level of the merge): the loads and the filter of each group (to
   the filter's ballots), the few-keys way (compaction, the sort of 32, the
   merge), a group's network, the list's store or the merge into it, the
   barrier after the lists, the pairwise merges of the lists, and the
   writing of the pairs.  Printed as mean cycles a CTA.
3. Variants.  Copies with one choice changed each: up to 132 CTAs, 8 or
   16 lanes a thread from the smallest block (where the library takes 4:
   4 warps at logreg's 512); past 132 CTAs, 16 lanes a thread (where the
   library takes 32), or the few-CTA layout (4 lanes a thread at block
   1,024: 8 warps of one group, no group to filter); a list cap of 128 keys (k past
   128 in segments of 128); no threshold filter (every later group
   sorted whole and merged); every later group through the network, however
   few of its keys enter; the warps' lists merged at 8 keys a lane whatever
   kp (where the library takes max(1, kp / 32)); keys compared as 64-bit
   integers (two ISETP, where the library compares them as doubles of
   their bits, one DSETP).  Each build and the library are checked against
   the plain version and timed through ctypes on the device (20 launches
   captured in a CUDA graph, replayed between CUDA events, median of 5), in
   turns.  The probes and variants go in by text substitution; the script
   stops if the source no longer holds an anchor.
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
PARENT = os.path.join(ROOT, "build", "topk_parent")
OUT_DIR = os.path.join(ROOT, "build", "phases")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
LJ_VERTICES = 4_847_571       # pagerank's V (soc-LiveJournal1)
# (V, k, block): logreg's, chip_smoke.py's C_INPUTS, the crossover's
LOGREG = (512, 32, 512)
C_INPUTS = [(4096, 256, 1024), (2048, 16, 512), (30_000, 40, 2048), (40_000, 300, 16_384),
            (150_000, 24, 65_536), (200_000, 100, 65_536)]
CROSSOVER = [(LJ_VERTICES, k, 1024) for k in (4, 32, 256)]
AB_SHAPES = ([(LOGREG, "f32")] + [(s, dt) for s in C_INPUTS for dt in ("f32", "bf16")]
             + [(s, "f32") for s in CROSSOVER])
PHASE_SHAPES = [LOGREG, (2048, 16, 512), (30_000, 40, 2048), (LJ_VERTICES, 32, 1024),
                (LJ_VERTICES, 4, 1024), (40_000, 300, 16_384),
                (150_000, 24, 65_536), (200_000, 100, 65_536)]

PROBE_DEFS = """
__device__ unsigned long long g_probe[8];  // phases, then CTAs
#define PROBE(i) { const long long now_ = clock64(); probe_acc[i] += now_ - probe_t; probe_t = now_; }
extern "C" int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)));
}
extern "C" int probe_reset() {
  static const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe)));
}
"""
PHASES = ["load + filter", "few keys: compact, sort 32, merge", "network", "list store or merge",
          "barrier", "merge of the lists", "write pairs"]
# (anchor, replacement): each anchor must occur once in the source
PROBES = [
    ('#include "radix_select.cuh"\n', '#include "radix_select.cuh"\n' + PROBE_DEFS),
    ("  const int span = blockDim.x * kGroup;\n",
     "  const int span = blockDim.x * kGroup;\n"
     "  long long probe_t = clock64(), probe_acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"),
    ("      if (g > 0 && count == 0) continue;",
     "      PROBE(0)\n      if (g > 0 && count == 0) continue;"),
    ("        merge_into(mine, stage_keys, 32, lane, kp);\n",
     "        merge_into(mine, stage_keys, 32, lane, kp);\n        PROBE(1)\n"),
    ("        warp_top<kGroup>(key, lane, kp);\n",
     "        warp_top<kGroup>(key, lane, kp);\n        PROBE(2)\n"),
    ("          merge_into(mine, stage_keys, R, lane, kp);\n        }\n",
     "          merge_into(mine, stage_keys, R, lane, kp);\n        }\n        PROBE(3)\n"),
    ("      theta = mine[n - 1];\n    }\n    __syncthreads();\n",
     "      theta = mine[n - 1];\n    }\n    __syncthreads();\n    PROBE(4)\n"),
    ("      __syncthreads();\n    }\n    for (int r = threadIdx.x; r < n; r += blockDim.x) {\n",
     "      __syncthreads();\n    }\n    PROBE(5)\n"
     "    for (int r = threadIdx.x; r < n; r += blockDim.x) {\n"),
    ("    if (done + n < k) {\n      bound = lists[n - 1];\n",
     "    PROBE(6)\n    if (done + n < k) {\n      bound = lists[n - 1];\n"),
    ("      __syncthreads();  // every thread has read the lists before they are rewritten\n"
     "    }\n  }\n}\n",
     "      __syncthreads();  // every thread has read the lists before they are rewritten\n"
     "    }\n  }\n  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 7; ++i) atomicAdd(&g_probe[i], (unsigned long long)probe_acc[i]);\n"
     "    atomicAdd(&g_probe[7], 1ull);\n  }\n}\n"),
]
LAYOUT = "    for (int c = 4; c <= 16; c <<= 1) {\n"
WIDE = "constexpr int kWideLanes = 32;"
FILL = "  if (nblocks > kFillCtas) {\n"
DOUBLE_GT = """__device__ __forceinline__ bool key_gt(u64 a, u64 b) {
  return __longlong_as_double(static_cast<long long>(a)) >
         __longlong_as_double(static_cast<long long>(b));
}
"""
INTEGER_GT = "__device__ __forceinline__ bool key_gt(u64 a, u64 b) { return a > b; }\n"
TREE = """  if (kp <= 32) merge_lists<1>(mine, other, n_other, lane, kp);
  else if (kp <= 64) merge_lists<2>(mine, other, n_other, lane, kp);
  else if (kp <= 128) merge_lists<4>(mine, other, n_other, lane, kp);
  else merge_lists<8>(mine, other, n_other, lane, kp);
"""
FILTER = "        key[r] = key[r] < bound && key[r] > theta ? key[r] : 0ull;\n"
FEW = "      if (g > 0 && count <= 32) {  // few enter"
VARIANTS = {
    "8 lanes a thread from the smallest block": [(LAYOUT, LAYOUT.replace("c = 4;", "c = 8;"))],
    "16 lanes a thread from the smallest block": [(LAYOUT, LAYOUT.replace("c = 4;", "c = 16;"))],
    "16 lanes a thread past 132 CTAs": [(WIDE, WIDE.replace("32", "16"))],
    "the few-CTA layout at any count": [(FILL, "  if (false) {\n")],
    "list cap 128": [("constexpr int kListCap = 256;", "constexpr int kListCap = 128;")],
    "no threshold filter": [(FILTER, FILTER.replace(" && key[r] > theta", ""))],
    "every later group through the network": [(FEW, FEW.replace("g > 0 &&", "false &&"))],
    "lists merged at 8 keys a lane": [(TREE, "  merge_lists<8>(mine, other, n_other, lane, kp);\n")],
    "keys compared as 64-bit integers": [(DOUBLE_GT, INTEGER_GT)],
}


def bound_ms(v, k, block, esize):
    nb = -(-v // block)
    return (v * esize + nb * k * (4 + esize)) / HBM_BYTES_PER_S * 1e3


def sparse_x(torch, v, seed, dtype):
    """chip_smoke.py's rng_sparse: normal entries kept at density 0.3."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=v).astype(np.float32)
    x[rng.random(v) >= 0.3] = 0.0
    return torch.from_numpy(x).cuda().to(dtype)


def timers(torch):
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

    return time_ms, graph_ms


def child(tree: str, out_path: str, extra: bool, plain: bool) -> None:
    """One tree's run: time and save the argmax body's pairs at every shape."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.kernels.topk_compress.ops import topk_compress, topk_compress_plain

    time_ms, graph_ms = timers(torch)
    rows, saved = [], {}
    for i, ((v, k, block), dt) in enumerate(AB_SHAPES):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        x = sparse_x(torch, v, 100 + i, dtype)
        pi, pv = topk_compress_plain(x, k, block)
        call = {m: (lambda m=m: topk_compress(x, k_per_block=k, block_v=block, method=m))
                for m in ("argmax", "bitonic")}
        i_, val = call["argmax"]()
        if not (torch.equal(i_, pi) and torch.equal(val, pv)):
            raise AssertionError(f"argmax differs from the plain version at {(v, k, block, dt)}")
        name = f"V {v} k {k} block {block} {dt}"
        saved[name] = (i_.cpu(), val.cpu())
        row = dict(shape=name, ms=time_ms(call["argmax"]), device_ms=graph_ms(call["argmax"]),
                   bound_ms=bound_ms(v, k, block, x.element_size()))
        if extra:
            row["bitonic_ms"] = time_ms(call["bitonic"])
            row["bitonic_device_ms"] = graph_ms(call["bitonic"])
            nb = -(-v // block)
            mags = torch.nn.functional.pad(x.abs(), (0, nb * block - v)).reshape(nb, block)
            row["topk_ms"] = time_ms(lambda: torch.topk(mags, k, dim=1))
            row["topk_device_ms"] = graph_ms(lambda: torch.topk(mags, k, dim=1))
        if plain:
            row["plain_ms"] = time_ms(lambda: topk_compress_plain(x, k, block), 5)
        rows.append(row)
    torch.save(saved, out_path)
    print(json.dumps(rows))


def ab(torch) -> None:
    """Parent, change, change, parent; then the trees' pairs compared."""
    if not os.path.isdir(os.path.join(PARENT, "src", "repro_torch")):
        raise SystemExit(f"no parent tree in {PARENT}: run with --unpack REV where git is")
    tmp = tempfile.mkdtemp()
    runs = []
    for i, (label, tree) in enumerate((("parent", PARENT), ("change", ROOT),
                                       ("change", ROOT), ("parent", PARENT))):
        out = os.path.join(tmp, f"{i}.pt")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, out]
        if label == "change":
            cmd.append("--extra")
        if i == 1:
            cmd.append("--plain")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"the {label} run failed:\n{proc.stdout}\n{proc.stderr}")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, out, rows))
        print(f"{label}: " + json.dumps(rows))
    first = torch.load(runs[0][1])
    for label, out, _ in runs[1:]:
        other = torch.load(out)
        for name, (i_, v_) in first.items():
            if not (torch.equal(i_, other[name][0]) and torch.equal(v_, other[name][1])):
                raise AssertionError(f"the {label} run's pairs differ from the parent's at {name}")
    print("pairs equal across the four runs at every shape")
    table = {}
    for label, _, rows in runs:
        for row in rows:
            table.setdefault(row["shape"], []).append(
                f"{label} {row['ms']:.4f} ({row['device_ms']:.4f})")
    for name, cells in table.items():
        print(f"  {name}: " + " / ".join(cells))
    shutil.rmtree(tmp)


def substituted(src: str, subs) -> str:
    for anchor, new in subs:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in topk_compress.cu: {anchor[:70]!r}")
        src = src.replace(anchor, new)
    return src


def start_build(build, text: str, name: str):
    out_dir = os.path.join(OUT_DIR, name)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "topk_compress.cu")
    with open(src, "w") as f:
        f.write(text)
    path = os.path.join(out_dir, f"lib{name}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", path, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), path


def ptxas_summary(log: str) -> dict:
    """Registers and spills of the argmax body's kernels."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S*topk_list_kernel\S*)'", line)
        if m:
            name = m.group(1)
            continue
        if "entry function" in line:
            name = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = out.get(name, "") + f" spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers," + out.get(name, "")
    return out


def phases(torch) -> None:
    """The probed copy and the variants at the shapes, in turns."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_compress import ops

    with open(os.path.join(build.CSRC, "topk_compress.cu")) as f:
        src = f.read()
    copies = {"as is": src, "probed": substituted(src, PROBES)}
    copies.update({name: substituted(src, subs) for name, subs in VARIANTS.items()})
    builds = {name: start_build(build, s, f"topk_argmax_{i}") for i, (name, s) in
              enumerate(copies.items())}
    libs = {"library": build.library("topk_compress", ops._SIGNATURES)}
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the {name} copy:\n{log}")
        if name in ("as is", "keys compared as 64-bit integers"):
            print(f"ptxas, {name}: {json.dumps(ptxas_summary(log))}")
        lib = ctypes.CDLL(path)
        lib.topk_compress.argtypes = list(ops._SIGNATURES["topk_compress"])
        libs[name] = lib
    probe = libs["probed"]
    probe.probe_read.argtypes = [ctypes.c_void_p]

    for i, (v, k, block) in enumerate(PHASE_SHAPES):
        x = sparse_x(torch, v, 200 + i, torch.float32)
        nb = -(-v // block)
        idx = torch.empty(nb * k, dtype=torch.int32, device="cuda")
        vals = torch.empty(nb * k, device="cuda")
        pi, pv = ops.topk_compress_plain(x, k, block)

        def run(lib):
            err = lib.topk_compress(0, x.data_ptr(), idx.data_ptr(), vals.data_ptr(), v, block,
                                    k, 0, None, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"topk_compress: CUDA error {err}")

        for name, lib in libs.items():
            idx.fill_(-1)
            if name == "probed":
                probe.probe_reset()
            run(lib)
            torch.cuda.synchronize()
            if not (torch.equal(idx, pi) and torch.equal(vals, pv)):
                raise AssertionError(f"the {name} build differs from the plain version at "
                                     f"{(v, k, block)}")
        buf = np.zeros(8, dtype=np.uint64)
        if probe.probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe_read failed")
        ctas = int(buf[7])
        per_cta = {p: round(float(buf[j]) / ctas, 1) for j, p in enumerate(PHASES)}
        print(f"V {v} k {k} block {block} f32, {ctas} CTAs; cycles a CTA (thread 0, mean): "
              f"{per_cta}")

        def launches_ms(lib, reps=20):
            """Device ms a launch: ``reps`` launches captured in a CUDA graph,
            the graph replayed 5 times between CUDA events, median of 5 (a
            launch through ctypes costs the host more than a one-CTA body
            costs the card)."""
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(lib)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    run(lib)
            graph.replay()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(5):
                    graph.replay()
                e.record()
                e.synchronize()
                times.append(s.elapsed_time(e) / (5 * reps))
            return statistics.median(times)

        names = list(VARIANTS)
        turns = ["library"] + names + names[::-1] + ["library"]
        print("  ms a launch, in turns: " +
              json.dumps([(n, round(launches_ms(libs[n]), 4)) for n in turns]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unpack", metavar="REV", help="unpack REV's tree into build/topk_parent")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--extra", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--plain", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--skip-ab", action="store_true", help="phases and variants only")
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
        child(*args.child, args.extra, args.plain)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    if not args.skip_ab:
        ab(torch)
    phases(torch)


if __name__ == "__main__":
    main()
