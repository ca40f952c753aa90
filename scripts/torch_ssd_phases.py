"""Where the time of the ssd_scan kernel goes, on the card.

    python3 scripts/torch_ssd_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` into ``build/phases/``
(nvcc with kernels/build.py's flags) with clock64 probes at the phase
boundaries of a work item, each phase that ends at a barrier closed by one
(a barrier is added after S_c's first tile and at the end of an item):

    ticket   the previous item's end to this item's ticket (atomic, barrier)
    stage    the copies issued, thread 0's check of the predecessor's count,
             cum's scan, xbar and B waited for
    S_c      h_{c-1}'s copy issued where the predecessor had published, the
             warp's first 32 x 32 tile of the chunk state
    wait     thread 0's spin on the predecessor's count (where it had not)
    C, h copy  the wait for the copies of C and h_{c-1}
    publish  h_c formed and stored, the barrier, the release
    y        the warp's scores, scores . xbar, exp(cum) C . h_{c-1} and
             stores, partial sums handed between warps included (per warp)
    imbalance  the wait for the slowest warp at the item's last barrier

Each warp's lane 0 sums its cycles per phase over the items its CTA took.
It runs the copy at the mamba2-2.7b prefill shape (xbar (4, 2048, 80, 64)
f32, B/C (4, 2048, 1, 128), chunk 128), checks it against the plain version,
and prints per phase the mean cycles an item spends (the per-warp phases:
the mean and the slowest warp of the CTA), the items a CTA took, and the
time per launch (CUDA events, median of 20, through ctypes without the
wrapper) of the probed copy and of the library: what the probes cost.  The
probes go in by text substitution; the script stops if the source no longer
holds an anchor.

Two more copies show what two choices of the design buy, timed beside the
library in turns: one whose warps take one m-tile each (no pairs splitting
the triangle's keys), and one that copies h_{c-1} only after S_c (no read
of the predecessor's count at the item's start).

Last, the ceiling the kernel's products run under: the rate of
mma.sync.m16n8k8 TF32 alone (8 warps a SM, 8 independent accumulators a
warp, the same operands over and over), in TFLOP/s and in ns per mma per
SM sub-partition.
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
from repro_torch.kernels.ssd_scan import kernel as ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402

PHASES = ["ticket", "stage", "S_c", "wait", "C, h copy", "publish", "y", "imbalance"]
PER_WARP = ("y",)
MAX_CTAS = 1024
WARPS = 8
SLOTS = len(PHASES) + 1    # the phases, then the items taken


def probe(i: int) -> str:
    return (f"{{ const long long now_ = clock64(); prb[{i}] += now_ - prb_last; "
            "prb_last = now_; }\n")


PROBES = [  # (anchor, replacement)
    ("namespace {\n", f"__device__ long long g_probe[{MAX_CTAS}][{WARPS}][{SLOTS}];\n"
                      "namespace {\n"),
    ("  const int mtiles = Qp / 16;\n",
     "  const int mtiles = Qp / 16;\n"
     f"  long long prb[{SLOTS}] = {{0}};\n  long long prb_last = clock64();\n"),
    ("    if (ticket >= items) break;\n",
     "    if (ticket >= items) break;\n    " + probe(0) + f"    ++prb[{SLOTS - 1}];\n"),
    ("  // xbar and B\n    __syncthreads();\n", "  // xbar and B\n    __syncthreads();\n    "
     + probe(1)),
    ("      state_tile(sacc, bs, xs, sdec, Qp, Np, Pp, warp, pblocks, g, t);\n\n",
     "      state_tile(sacc, bs, xs, sdec, Qp, Np, Pp, warp, pblocks, g, t);\n"
     "    __syncthreads();\n    " + probe(2) + "\n"),
    ("      __syncthreads();\n      copy_state(", "      __syncthreads();\n      " + probe(3)
     + "      copy_state("),
    ("  // C, h_{c-1}\n    __syncthreads();\n", "  // C, h_{c-1}\n    __syncthreads();\n    "
     + probe(4)),
    ("c + 1);\n    }\n", "c + 1);\n    }\n    " + probe(5)),
    ("\n    }\n  }\n}\n\n// CTAs of ssd_chunk_kernel",
     "\n    }\n    " + probe(6) + "    __syncthreads();\n    " + probe(7) + "  }\n"
     f"  if (lane == 0 && blockIdx.x < {MAX_CTAS})\n#pragma unroll\n"
     f"    for (int i = 0; i < {SLOTS}; ++i) g_probe[blockIdx.x][warp][i] = prb[i];\n"
     "}\n\n// CTAs of ssd_chunk_kernel"),
]
MMA_RATE = """
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_loop(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = 3 * threadIdx.x, b1 = 5 * threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  if (s == 1.2345f) out[0] = s;
}

// ms of one launch of blocks x 256 threads, `iters` rounds of 8 mma a warp
extern "C" float mma_rate_ms(float* out, int blocks, int iters) {
  mma_loop<<<blocks, 256>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  mma_loop<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}
"""
# (name, anchor, replacement): the copies without one choice of the design
WITHOUT = [
    ("one m-tile a warp", "  if (pos >= 8 || mtiles < 8 || mtiles >= 16) {", "  if (true) {"),
    ("h copied after S_c",
     "    if (tid == 0) *ready_s = c == 0 || ld_acquire(sync + 1 + bh) >= c;",
     "    if (tid == 0) *ready_s = c == 0;"),
]

READER = """
extern "C" int probe_read(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe, n * sizeof(long long)));
}
"""


def probed_source(src: str) -> str:
    for anchor, new in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ssd_scan.cu: {anchor[:60]!r}")
        src = src.replace(anchor, new)
    return src + READER


def mma_rate() -> str:
    """mma.sync TF32's rate on this card: TFLOP/s, ns per mma per SM
    sub-partition."""
    out_dir = os.path.join(ROOT, "build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "mma_rate.cu"), os.path.join(out_dir, "libmma_rate.so")
    with open(src, "w") as f:
        f.write(MMA_RATE)
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    subprocess.run([build._nvcc(), *flags, "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_rate_ms.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.mma_rate_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(1, device="cuda")
    iters = 20000
    ms = lib.mma_rate_ms(out.data_ptr(), sms, iters)
    mmas = sms * 8 * iters * 8
    return (f"{mmas * 2 * 16 * 8 * 8 / ms / 1e9:.1f} TFLOP/s, "
            f"{ms * 1e6 / (mmas / (4 * sms)):.3f} ns per mma per SM sub-partition")


def build_copy(text: str, name: str) -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    subprocess.run([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.ssd_scan.argtypes = list(ssd._SIGNATURES["ssd_scan"])
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
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(build.CSRC, "ssd_scan.cu")) as f:
        source = f.read()
    probed = build_copy(probed_source(source), "ssd_scan_probed")
    probed.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    own = build.library("ssd_scan", ssd._SIGNATURES)
    without = {}
    for i, (name, anchor, new) in enumerate(WITHOUT):
        if source.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ssd_scan.cu: {anchor[:60]!r}")
        without[name] = build_copy(source.replace(anchor, new), f"ssd_scan_without_{i}")

    b, t, h, p, g, n, q = 4, 2048, 80, 64, 1, 128, 128
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(b, t, h, p, device="cuda", generator=gen) * 0.5
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, device="cuda", generator=gen))
    a = (dt * -torch.linspace(1.0, 16.0, h, device="cuda")).float()
    xbar = x * dt[..., None]
    bm, cm = (torch.randn(b, t, g, n, device="cuda", generator=gen) * 0.3 for _ in range(2))
    y = torch.empty_like(xbar)
    sync = torch.zeros(1 + b * h, dtype=torch.int32, device="cuda")
    states = torch.empty(b * h * 2 * n * p, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), f"xbar ({b}, {t}, {h}, {p}) f32, B/C ({b}, {t}, "
          f"{g}, {n}), chunk {q}: {b * h * t // q} items")

    def run(lib):
        sync.zero_()
        code = lib.ssd_scan(0, xbar.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                            y.data_ptr(), b, t, h, g, p, n, q, states.data_ptr(),
                            sync.data_ptr(), stream)
        if code != 0:
            raise RuntimeError(f"ssd_scan: CUDA error {code}")

    ref = ssd_scan_plain(xbar, a, bm, cm, q)[0]
    for name, lib in (("probed", probed), ("library", own), *without.items()):
        y.zero_()
        run(lib)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, ref, rtol=3e-4, atol=3e-4,
                                   msg=lambda m, name=name: f"the {name} build: {m}")
    run(probed)
    torch.cuda.synchronize()
    buf = np.zeros(MAX_CTAS * WARPS * SLOTS, dtype=np.int64)
    if probed.probe_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("probe_read failed")
    probes = buf.reshape(MAX_CTAS, WARPS, SLOTS)
    probes = probes[probes[:, 0, SLOTS - 1] > 0]          # the CTAs that ran
    items = probes[:, 0, SLOTS - 1].astype(np.float64)
    per_item = {}
    for i, name in enumerate(PHASES):
        cyc = probes[:, :, i] / items[:, None]             # (CTA, warp) cycles an item
        if name in PER_WARP:
            per_item[name] = {"mean warp": round(float(cyc.mean()), 1),
                              "slowest warp": round(float(cyc.max(1).mean()), 1)}
        else:
            per_item[name] = round(float(cyc[:, 0].mean()), 1)
    print(f"cycles per item (thread 0 / lane 0 of each warp, mean over {len(probes)} CTAs, "
          f"{items.mean():.1f} items a CTA): {per_item}")
    times = {name: round(time_ms(lambda lib=lib: run(lib)), 4)
             for name, lib in (("library", own), ("probed", probed), ("library again", own))}
    print(f"ms per launch (with the counts' memset): {times}")
    turns = {}
    for _ in range(4):
        for name, lib in (("library", own), *without.items()):
            turns.setdefault(name, []).append(round(time_ms(lambda lib=lib: run(lib)), 4))
    print(f"ms per launch, four turns each, the library beside copies without: {turns}")
    print(f"mma.sync.m16n8k8 TF32 alone, 8 warps a SM, 8 accumulators a warp: {mma_rate()}")


if __name__ == "__main__":
    main()
