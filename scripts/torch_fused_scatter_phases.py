"""Where the time of fused_topk_scatter's radix-select kernel goes, on the card.

    python3 scripts/torch_fused_scatter_phases.py

Builds copies of ``src/repro_torch/csrc/fused_scatter.cu`` (with
``radix_select.cuh``) into ``build/phases/`` (nvcc with kernels/build.py's
flags, all at once):

- one with clock64 probes at the phase boundaries, read by thread 0 of each
  CTA right after a barrier: the group's loads (each thread first consumes
  its values, so that the loads have landed), each digit pass of the rows'
  select, the tie scan, and the fold with the store; also the digit passes
  each CTA ran;
- two that take rows in groups of 1 (row-serial) and of 16, where the
  library takes groups of 4 (kRowGroup);
- one of 128-thread CTAs of 8 lanes a thread where the library runs 256 of 4;
- one whose 256-thread CTAs are held to 40 registers, so that 6 share an SM;
- one that groups a warp's lanes by bin first (__match_any_sync, one
  atomic per distinct bin of a warp), where the library counts each lane
  into the histograms by its own shared atomic;
- two that count the lanes of the exact zeros' bin in a register at every
  layout, and at none, where the library does so only from 8 lanes a thread
  (Lanes::kZerosApart).

It runs them, and the library's own, at pagerank's fused shape (x (4,
4,847,571) float32 at density 0.3, block 1,024, per_block 256), at the same
with 16 rows, at logreg's (x (4, 512), one block, per_block 32) and at
block 65,536 (x (3, 70,000), per_block 35,000: the cut falls among the
zeros, which match it in all four passes), each build first checked
bit-exact against the plain version, and prints the mean cycles a CTA spends
in each phase (summed over its row groups), the passes, and the time per
launch (CUDA events, median of 20, through ctypes without the wrapper) of
every build in turns.  The probes and the variants go in by text
substitution; the script stops if the source no longer holds an anchor.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.sparse import block_layout  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate import fused_scatter  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "phases")
PHASES = ["load", "pass 1", "pass 2", "pass 3", "pass 4", "tie scan", "fold + store"]
NSLOTS = len(PHASES) + 1          # + the digit passes run
MAX_CTAS = 8192
GROUP = "constexpr int kRowGroup = 4;  // rows whose selects run together\n"
CTA = "    if (t <= 256) {\n"
BOUNDS = "__global__ void __launch_bounds__(C == 0 ? 512 : 256)\n"
ATOMIC = ("          if (active && (hi & c.mask) == c.prefix)\n"
          "            atomicAdd(hist + ((hi >> shift) & (kBins - 1)), 1u);\n")
GROUPED = """\
          const unsigned bin = (hi >> shift) & (kBins - 1);
          const bool counted = active && (hi & c.mask) == c.prefix;
          const unsigned act = __ballot_sync(kFull, counted);
          if (counted) {
            const unsigned peers = __match_any_sync(act, bin);
            if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
              atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
          }
"""  # every lane of a warp calls the lambda alike: RegRows (kZerosApart false) does
FEW_LANES = "  static constexpr bool kZerosApart = false;  // a few lanes a thread\n"
MANY_LANES = "  static constexpr bool kZerosApart = true;  // 8 lanes a thread or more\n"
# (name, rows, V, k, block): the fused shapes of pagerank and logreg, the
# pagerank shape with 16 rows (16 threads a round), and a 65,536-lane block
# whose cut falls among the zeros
SHAPES = [("pagerank", 4, 4_847_571, 4_847_571 // 4, 1024), ("logreg", 4, 512, 32, 1024),
          ("pagerank, 16 rows", 16, 4_847_571, 4_847_571 // 4, 1024),
          ("block 65,536", 3, 70_000, 70_000, 65_536)]


def groups_of(g: int) -> tuple:
    return ("fused_scatter.cu", GROUP, GROUP.replace("4", str(g), 1))

PROBE_DEFS = """
__device__ long long g_probe[%d][%d];
__shared__ long long probe_acc[%d];
__shared__ long long probe_last;
// thread 0, right after a barrier: the cycles since the last probe into slot
#define PROBE(slot)                                   \\
  if (threadIdx.x == 0) {                             \\
    const long long now_ = clock64();                 \\
    probe_acc[slot] += now_ - probe_last;             \\
    probe_last = now_;                                \\
  }
""" % (MAX_CTAS, NSLOTS + 1, NSLOTS)

# (file, anchor, replacement); each anchor must occur once
PROBES = [
    ("radix_select.cuh", "#pragma once\n", "#pragma once\n" + PROBE_DEFS),
    ("radix_select.cuh", "    __syncthreads();\n    bool open = false;\n",
     "    __syncthreads();\n    PROBE(1 + p);\n"
     "    if (threadIdx.x == 0) probe_acc[%d] += 1;\n    bool open = false;\n" % len(PHASES)),
    ("fused_scatter.cu",
     "    __syncthreads();  // tie_thr[r] written; warp_sum free for the next row's scan\n  }\n}\n",
     "    __syncthreads();  // tie_thr[r] written; warp_sum free for the next row's scan\n  }\n"
     "  PROBE(5);\n}\n"),
    ("fused_scatter.cu",
     "  if (!select_all) __syncthreads();  // the cuts read before the next group resets them\n}\n",
     "  __syncthreads();\n  PROBE(6);\n}\n"),
    ("fused_scatter.cu", "  const int ntiles = C > 0 ? 1 : (per + kTile - 1) / kTile;\n",
     "  const int ntiles = C > 0 ? 1 : (per + kTile - 1) / kTile;\n"
     "  if (threadIdx.x == 0) {\n    for (int i = 0; i < %d; ++i) probe_acc[i] = 0;\n"
     "    probe_last = clock64();\n  }\n" % NSLOTS),
    ("fused_scatter.cu", "        const RegRows<T, C> rows(xg, v, g, first, own, nvalid);\n",
     "        const RegRows<T, C> rows(xg, v, g, first, own, nvalid);\n"
     "        float sink = 0.0f;  // wait for the loads\n"
     "#pragma unroll\n        for (int r = 0; r < kRowGroup; ++r)\n"
     "#pragma unroll\n          for (int j = 0; j < C; ++j)\n"
     "            if (r < g) sink += rows.val[r][j];\n"
     "        if (sink == 1.2345e-30f) out[0] = from_f<T>(sink);\n"
     "        __syncthreads();\n        PROBE(0);\n"),
    ("fused_scatter.cu",
     "o[j] = from_f<T>(acc[j]);\n      }\n    }\n  }\n}\n",
     "o[j] = from_f<T>(acc[j]);\n      }\n    }\n  }\n"
     "  __syncthreads();\n  PROBE(6);\n"
     "  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
     "    for (int i = 0; i < %d; ++i) g_probe[blockIdx.x][i] = probe_acc[i];\n"
     "    g_probe[blockIdx.x][%d] = 1;\n  }\n}\n" % (MAX_CTAS, NSLOTS, NSLOTS)),
]
READER = """
extern "C" int probe_read(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, n * sizeof(long long)));
}
"""


def sources() -> dict:
    out = {}
    for name in ("fused_scatter.cu", "radix_select.cuh"):
        with open(os.path.join(build.CSRC, name)) as f:
            out[name] = f.read()
    return out


def substituted(src: dict, subs) -> dict:
    src = dict(src)
    for name, anchor, new in subs:
        if src[name].count(anchor) != 1:
            raise SystemExit(f"anchor not found once in {name}: {anchor[:60]!r}")
        src[name] = src[name].replace(anchor, new)
    return src


def start_build(src: dict, name: str):
    """nvcc on a copy: its own directory holds its fused_scatter.cu and
    radix_select.cuh (found first, beside the source), the other headers
    come from csrc."""
    d = os.path.join(OUT_DIR, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for fname, text in src.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    lib = os.path.join(d, f"lib{name}.so")
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    proc = subprocess.Popen([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", lib,
                             os.path.join(d, "fused_scatter.cu")])
    return proc, lib


def time_ms(fn, reps: int = 20) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    src = sources()
    probed = substituted(src, PROBES)
    probed["fused_scatter.cu"] += READER
    variants = {
        "probed": probed,
        "row-serial (groups of 1)": substituted(src, [groups_of(1)]),
        "groups of 16": substituted(src, [groups_of(16)]),
        "128-thread CTAs": substituted(src, [("fused_scatter.cu", CTA,
                                              CTA.replace("t <= 256", "t <= 128"))]),
        "6 CTAs an SM": substituted(src, [("fused_scatter.cu", BOUNDS, BOUNDS.replace(
            "256)", "256, C == 0 ? 1 : 6)"))]),
        "grouped atomics": substituted(src, [("radix_select.cuh", ATOMIC, GROUPED)]),
        "zeros apart at every layout": substituted(src, [(
            "fused_scatter.cu", FEW_LANES, FEW_LANES.replace("false", "true"))]),
        "zeros by their own atomics at every layout": substituted(src, [(
            "fused_scatter.cu", MANY_LANES, MANY_LANES.replace("true", "false"))]),
    }
    builds = {name: start_build(s, f"fused_scatter_{i}") for i, (name, s) in
              enumerate(variants.items())}
    libs = {"library": build.library("fused_scatter", fused_scatter._SIGNATURES)}
    for name, (proc, path) in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for the {name} copy")
        lib = ctypes.CDLL(path)
        lib.fused_topk_scatter.argtypes = list(fused_scatter._SIGNATURES["fused_topk_scatter"])
        libs[name] = lib
    libs["probed"].probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0))
    for app, n, v, k, block in SHAPES:
        _, be, pb = block_layout(v, k, block)
        nblocks = -(-v // be)
        x = rng.normal(size=(n, v)).astype(np.float32)
        x[rng.random((n, v)) >= 0.3] = 0.0
        xc = torch.from_numpy(x).cuda()
        out = torch.empty(v, device="cuda")
        ref = fused_scatter.fused_topk_scatter_plain(xc, pb, be)

        def run(lib):
            code = lib.fused_topk_scatter(0, xc.data_ptr(), out.data_ptr(), n, v, be, pb, stream)
            if code != 0:
                raise RuntimeError(f"fused_topk_scatter: CUDA error {code}")

        for name, lib in libs.items():
            out.fill_(float("nan"))
            run(lib)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"the {name} build differs from the plain version ({app})")
        buf = np.zeros(MAX_CTAS * (NSLOTS + 1), dtype=np.int64)
        if libs["probed"].probe_read(buf.ctypes.data, buf.size) != 0:
            raise RuntimeError("probe_read failed")
        probes = buf.reshape(MAX_CTAS, NSLOTS + 1)[:min(nblocks, MAX_CTAS)]
        assert int(probes[:, NSLOTS].sum()) == len(probes)
        per_cta = {p: round(float(probes[:, i].mean()), 1) for i, p in enumerate(PHASES)}
        passes = np.bincount(probes[:, len(PHASES)]).tolist()
        print(f"{app}: x ({n}, {v}) f32, block {be}, per_block {pb}, {nblocks} CTAs; cycles per "
              f"CTA (thread 0, mean over {len(probes)} CTAs): {per_cta}; CTAs by digit passes "
              f"run over their groups (0, 1, ...): {passes}")
        order = list(libs) + ["library"]
        times = {}
        for name in order:
            key = name if name not in times else f"{name} again"
            times[key] = round(time_ms(lambda lib=libs[name]: run(lib)), 4)
        print(f"{app}: ms per launch: {times}")


if __name__ == "__main__":
    main()
