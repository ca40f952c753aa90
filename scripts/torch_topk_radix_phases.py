"""Where the time of topk_compress's bitonic (radix-select) body goes, on the card.

    python3 scripts/torch_topk_radix_phases.py

Builds copies of ``src/repro_torch/csrc/topk_compress.cu`` into
``build/phases/`` (nvcc with kernels/build.py's flags):

- one with clock64 probes at the phase boundaries of the radix body, read by
  thread 0 of each CTA after a barrier: the digit passes of the selection
  (their first pass also waits for the block's loads), the CTA-wide scan
  and the compaction of the k selected keys, and their ordering with the
  writing of the pairs; also the number of digit passes each CTA ran;
- one that sorts the k selected keys with bitonic_sort_desc in shared
  memory (a barrier a stage) where the library sorts them in registers
  (warp shuffles, shared memory only past a warp);
- one that groups a warp's lanes by bin before it counts them into the
  digit passes' histograms (__match_any_sync, one atomic per distinct bin
  of a warp), where the library counts each lane by its own atomic;
- one that counts the lanes of the exact zeros' bin in a register and adds
  them once (Lanes::kZerosApart, as fused_scatter.cu does from 8 lanes a
  thread).

It runs them, and the library's own, at pagerank's unfused shape (x
(4,847,571,) float32 at density 0.3, block 1,024, k 256, each build checked
against the plain version first) and prints the mean cycles a CTA spends in
each phase, the passes, and the time per launch (CUDA events, median of 20,
through ctypes without the wrapper) of every build: what the probes cost,
what the sort in registers buys over the one in shared memory, and what
each way of counting costs.  The counting copies are timed again at two of
chip_smoke.py's C_INPUTS, block 16,384 (16 lanes a thread in registers) and
65,536 (read from x).  The probes and the variants go in by text
substitution; the script stops if the source no longer holds an anchor.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.topk_compress import ops  # noqa: E402
from torch_fused_scatter_phases import ATOMIC, GROUPED  # noqa: E402  (one radix_select.cuh)

PHASES = ["select (loads, digit passes)", "scan + compaction", "sort + write"]
MAX_CTAS = 8192
NETWORK = "  const bool in_registers = kp <= static_cast<int>(blockDim.x);\n"
# the counting of both lane types
COUNT = ("  static constexpr bool kZerosApart = false;  "
         "// radix::select_rows counts a lane an atomic\n")
# (V, block, k): pagerank's unfused shape, then two of chip_smoke.py's C_INPUTS
SHAPES = [(4_847_571, 1024, 256), (40_000, 16_384, 300), (200_000, 65_536, 100)]
PROBES = [  # (anchor, text put in front of it, text put behind it)
    ("using u64 = unsigned long long;\n", "",
     f"__device__ long long g_probe[{MAX_CTAS}][5];\n"),
    ("  radix::select_rows(lanes, 1, static_cast<unsigned>(k), sm);\n",
     "  const long long c0 = clock64();\n", "  const long long c1 = clock64();\n"),
    ("  __syncthreads();\n  auto write = [&](int r, u64 key) {",
     "", None),  # after the compaction's barrier (filled in below)
    ("    for (int r = threadIdx.x; r < k; r += blockDim.x) write(r, keys[r]);\n  }\n}\n",
     "", None),  # the end of the body (filled in below)
]
AFTER_COMPACTION = ("  __syncthreads();\n  const long long c2 = clock64();\n"
                    "  auto write = [&](int r, u64 key) {")
END = ("    for (int r = threadIdx.x; r < k; r += blockDim.x) write(r, keys[r]);\n  }\n"
       "  __syncthreads();\n  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
       "    long long* p = g_probe[blockIdx.x];\n"
       "    p[0] = c1 - c0;\n    p[1] = c2 - c1;\n    p[2] = clock64() - c2;\n"
       "    p[3] = __popc(cut.mask) / radix::kDigitBits;\n    p[4] = 1;\n  }\n}\n") % MAX_CTAS
READER = """
extern "C" int probe_read(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, n * sizeof(long long)));
}
"""


def probed_source(src: str) -> str:
    for anchor, before, after in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in topk_compress.cu: {anchor[:60]!r}")
        if after is None:
            new = AFTER_COMPACTION if anchor.startswith("  __syncthreads") else END
        else:
            new = before + anchor + after
        src = src.replace(anchor, new)
    return src + READER


def build_copy(text: str, name: str, header: str | None = None) -> ctypes.CDLL:
    """nvcc on a copy in its own directory; `header`, if given, is its
    radix_select.cuh (found first, beside the source), else csrc's."""
    out_dir = os.path.join(ROOT, "build", "phases", name)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "topk_compress.cu")
    with open(src, "w") as f:
        f.write(text)
    if header is not None:
        with open(os.path.join(out_dir, "radix_select.cuh"), "w") as f:
            f.write(header)
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    subprocess.run([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.topk_compress.argtypes = list(ops._SIGNATURES["topk_compress"])
    return lib


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
    with open(os.path.join(build.CSRC, "topk_compress.cu")) as f:
        source = f.read()
    with open(os.path.join(build.CSRC, "radix_select.cuh")) as f:
        header = f.read()
    if source.count(NETWORK) != 1 or source.count(COUNT) != 2 or header.count(ATOMIC) != 1:
        raise SystemExit("anchor not found: the network or the counting")
    probed = build_copy(probed_source(source), "topk_compress_probed")
    probed.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    shared = build_copy(source.replace(NETWORK, "  const bool in_registers = false;\n"),
                        "topk_compress_shared_sort")
    grouped = build_copy(source, "topk_compress_grouped", header.replace(ATOMIC, GROUPED))
    zeros = build_copy(source.replace(COUNT, COUNT.replace("false", "true")),
                       "topk_compress_zeros_apart")
    own = build.library("topk_compress", ops._SIGNATURES)
    libs = {"library (sort in registers)": own, "probed": probed, "sort in shared memory": shared,
            "grouped by warp": grouped, "zeros apart": zeros}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (v, block, k) in enumerate(SHAPES):
        nblocks = -(-v // block)
        x = rng.normal(size=v).astype(np.float32)
        x[rng.random(v) >= 0.3] = 0.0
        xc = torch.from_numpy(x).cuda()
        idx = torch.empty(nblocks * k, dtype=torch.int32, device="cuda")
        vals = torch.empty(nblocks * k, device="cuda")
        pi, pv = ops.topk_compress_plain(xc, k, block)
        print(torch.cuda.get_device_name(0), f"x ({v},) f32, block {block}, k {k}, "
              f"{nblocks} CTAs")

        def run(lib):
            code = lib.topk_compress(0, xc.data_ptr(), idx.data_ptr(), vals.data_ptr(), v,
                                     block, k, 1, None, stream)
            if code != 0:
                raise RuntimeError(f"topk_compress: CUDA error {code}")

        for name, lib in libs.items():
            idx.zero_()
            run(lib)
            torch.cuda.synchronize()
            if not (torch.equal(idx, pi) and torch.equal(vals, pv)):
                raise AssertionError(f"the {name} build differs from the plain version")
        order = list(libs)
        if shape == 0:
            buf = np.zeros(MAX_CTAS * 5, dtype=np.int64)
            if probed.probe_read(buf.ctypes.data, buf.size) != 0:
                raise RuntimeError("probe_read failed")
            probes = buf.reshape(MAX_CTAS, 5)[:nblocks]
            assert int(probes[:, 4].sum()) == nblocks
            per_cta = {p: round(float(probes[:, i].mean()), 1) for i, p in enumerate(PHASES)}
            passes = np.bincount(probes[:, 3], minlength=5).tolist()
            print(f"cycles per CTA (thread 0, mean over {nblocks} CTAs): {per_cta}; CTAs by "
                  f"digit passes run (0..4): {passes}")
        else:
            order = [order[0], "grouped by warp", "zeros apart"]
        times = {}
        for name in order + [order[0]]:
            key = name if name not in times else f"{name} again"
            times[key] = round(time_ms(lambda lib=libs[name]: run(lib)), 4)
        print(f"ms per launch: {times}")


if __name__ == "__main__":
    main()
