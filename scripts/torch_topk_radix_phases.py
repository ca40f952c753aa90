"""Where the time of topk_compress's bitonic (radix-select) body goes, on the card.

    python3 scripts/torch_topk_radix_phases.py

Builds two copies of ``src/repro_torch/csrc/topk_compress.cu`` into
``build/phases/`` (nvcc with kernels/build.py's flags):

- one with clock64 probes at the phase boundaries of the radix body, read by
  thread 0 of each CTA after a barrier: the digit passes of the selection
  (their first pass also waits for the block's loads), the CTA-wide scan
  and the compaction of the k selected keys, and their ordering with the
  writing of the pairs; also the number of digit passes each CTA ran;
- one that sorts the k selected keys with bitonic_sort_desc in shared
  memory (a barrier a stage) where the library sorts them in registers
  (warp shuffles, shared memory only past a warp).

It runs both, and the library's own, at pagerank's unfused shape (x
(4,847,571,) float32 at density 0.3, block 1,024, k 256, each build checked
against the plain version first) and prints the mean cycles a CTA spends in
each phase, the passes, and the time per launch (CUDA events, median of 20,
through ctypes without the wrapper) of the three builds: what the probes
cost, and what the sort in registers buys over the one in shared memory.
The probes go in by text substitution; the script stops if the source no
longer holds an anchor.
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

PHASES = ["select (loads, digit passes)", "scan + compaction", "sort + write"]
MAX_CTAS = 8192
NETWORK = "  const bool in_registers = kp <= static_cast<int>(blockDim.x);\n"
PROBES = [  # (anchor, text put in front of it, text put behind it)
    ("using u64 = unsigned long long;\n", "",
     f"__device__ long long g_probe[{MAX_CTAS}][5];\n"),
    ("  const radix::Cut cut = radix::select(lanes, static_cast<unsigned>(k), sm);\n",
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
    if source.count(NETWORK) != 1:
        raise SystemExit(f"anchor not found once in topk_compress.cu: {NETWORK!r}")
    probed = build_copy(probed_source(source), "topk_compress_probed")
    probed.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    shared = build_copy(source.replace(NETWORK, "  const bool in_registers = false;\n"),
                        "topk_compress_shared_sort")
    own = build.library("topk_compress", ops._SIGNATURES)

    v, block, k = 4_847_571, 1024, 256
    nblocks = -(-v // block)
    rng = np.random.default_rng(0)
    x = rng.normal(size=v).astype(np.float32)
    x[rng.random(v) >= 0.3] = 0.0
    xc = torch.from_numpy(x).cuda()
    idx = torch.empty(nblocks * k, dtype=torch.int32, device="cuda")
    vals = torch.empty(nblocks * k, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    pi, pv = ops.topk_compress_plain(xc, k, block)
    print(torch.cuda.get_device_name(0), f"x ({v},) f32, block {block}, k {k}, "
          f"{nblocks} CTAs")

    def run(lib):
        code = lib.topk_compress(0, xc.data_ptr(), idx.data_ptr(), vals.data_ptr(), v, block,
                                 k, 1, None, stream)
        if code != 0:
            raise RuntimeError(f"topk_compress: CUDA error {code}")

    for name, lib in (("probed", probed), ("shared-memory sort", shared), ("library", own)):
        idx.zero_()
        run(lib)
        torch.cuda.synchronize()
        if not (torch.equal(idx, pi) and torch.equal(vals, pv)):
            raise AssertionError(f"the {name} build differs from the plain version")
    buf = np.zeros(MAX_CTAS * 5, dtype=np.int64)
    if probed.probe_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("probe_read failed")
    probes = buf.reshape(MAX_CTAS, 5)[:nblocks]
    assert int(probes[:, 4].sum()) == nblocks
    per_cta = {p: round(float(probes[:, i].mean()), 1) for i, p in enumerate(PHASES)}
    passes = np.bincount(probes[:, 3], minlength=5).tolist()
    print(f"cycles per CTA (thread 0, mean over {nblocks} CTAs): {per_cta}; CTAs by digit "
          f"passes run (0..4): {passes}")
    times = {name: round(time_ms(lambda lib=lib: run(lib)), 4)
             for name, lib in (("library (sort in registers)", own),
                               ("probed", probed), ("sort in shared memory", shared),
                               ("library again", own))}
    print(f"ms per launch: {times}")


if __name__ == "__main__":
    main()
