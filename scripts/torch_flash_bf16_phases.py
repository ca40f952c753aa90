"""Where the time of flash attention's bf16 (wgmma) body goes, on the card.

    python3 scripts/torch_flash_bf16_phases.py

Builds a copy of ``src/repro_torch/csrc/flash_attention.cu`` with clock64
probes around each phase of the bf16 body's KV-tile loop into
``build/phases/`` (nvcc with kernels/build.py's flags), runs it at
qwen3-1.7b's prefill shape (q (4, 2048, 8, 2, 128)), causal and not, and
prints the cycles one warpgroup spends per KV tile in each phase: the copy
wait and the barrier, issuing the next tile's copies, S = Q.K^T (issue to
wait), the mask, softmax and P's packing, O += P.V (issue to wait).  Both
warpgroups of a CTA run the phases in step, so a phase's cycles include
the other warpgroup's share of the tensor cores.  Also prints the time per
launch (CUDA events, median of 20, through ctypes without the wrapper) of
the probed build and of the library's own, which says what the probes
cost.  The probes go in by text substitution; the script stops if the
source no longer holds an anchor.
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
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402

PHASES = ["wait + barrier", "copy issue", "S = Q.K^T", "softmax + pack", "O += P.V"]
LAUNCH = ("\ntemplate <int DMAX>\nint launch(const void* q, const void* k, const void* v, "
          "void* o, int batch, int seq_q,\n           int seq_k, int kv_heads, int group, "
          "int dk, int dv, int causal, int q_offset,\n           float scale, void* stream) {\n"
          "  constexpr size_t smem = smem_bytes<DMAX>();")
PROBES = [  # (anchor, text put in front of it, text put behind it)
    ("namespace wg {\n", "", "__device__ long long g_probe[1 << 12][2][8];\n"),
    ("  const int tid = threadIdx.x;\n  const int wg = tid >> 7;",
     "  long long pr[8] = {};\n  const long long c_start = clock64();\n", ""),
    ("    cp_async_wait_all();   // this tile's copies", "    long long c0 = clock64();\n", ""),
    ("    __syncthreads();       // ... for every thread, and both warpgroups are done with "
     "tile - 1\n", "", "    long long c1 = clock64();\n    pr[0] += c1 - c0;\n"),
    ("    if (qg >= seq_q || (causal && k0 > q_offset + qg + 63)) continue;\n",
     "    long long c2 = clock64();\n    pr[1] += c2 - c1;\n", ""),
    ("    qk_steps<BK, 1, DMAX / 16>(pk / 16, s, q_desc, k_desc + (stage >> 4), Q_SLAB, "
     "KV_SLAB);\n    pin(s);\n", "", "    long long c3 = clock64();\n    pr[2] += c3 - c2;\n"),
    ("    wgmma_fence();\n#pragma unroll\n    for (int p = 0; p < NP; ++p)",
     "    long long c4 = clock64();\n    pr[3] += c4 - c3;\n", ""),
    ("    wgmma_wait_all();\n#pragma unroll\n    for (int h = 0; h < NH; ++h) pin(acc[h]);\n",
     "", "    pr[4] += clock64() - c4;\n    pr[5] += 1;\n"),
    ("  }\n}\n" + LAUNCH, "",
     None),  # the kernel's end: record this warpgroup's sums (filled in below)
]
END = ("  }\n  pr[6] = clock64() - c_start;\n  if ((tid & 127) == 0)\n"
       "    for (int i = 0; i < 8; ++i) g_probe[blockIdx.y * gridDim.x + blockIdx.x][wg][i] = "
       "pr[i];\n}\n" + LAUNCH)
READER = """
extern "C" int probe_read(long long* out, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, wg::g_probe, n * sizeof(long long)));
}
"""


def probed_source(src: str) -> str:
    for anchor, before, after in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in flash_attention.cu: {anchor[:60]!r}")
        new = END if after is None else before + anchor + after
        src = src.replace(anchor, new)
    return src + READER


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
    out_dir = os.path.join(ROOT, "build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "flash_attention_probed.cu")
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        text = probed_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, "libflash_probed.so")
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    subprocess.run([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    probed = lib.flash_attention_bf16
    probed.argtypes = list(fa._ENTRY)
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    b, t, kh, g, d = 4, 2048, 8, 2, 128
    gen = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(b, t, kh, g, d, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(b, t, kh, d, device="cuda", generator=gen).bfloat16() for _ in range(2))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), fa.smem_bytes(d, d, torch.bfloat16), "bytes of "
          "shared memory per CTA")
    own = build.library("flash_attention", fa._SIGNATURES).flash_attention_bf16
    for causal in (True, False):
        def run(fn=probed):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, t, kh, g,
                      d, d, int(causal), 0, d ** -0.5, stream)
            if code != 0:
                raise RuntimeError(f"flash_attention_bf16: CUDA error {code}")
        n_cta = b * kh * g * (t // 128)
        run()
        torch.cuda.synchronize()
        buf = np.zeros((1 << 12) * 2 * 8, dtype=np.int64)
        if lib.probe_read(buf.ctypes.data, buf.size) != 0:
            raise RuntimeError("probe_read failed")
        probes = buf.reshape(1 << 12, 2, 8)[:n_cta]
        tiles = probes[:, :, 5].sum()
        per_tile = {name: round(float(probes[:, :, i].sum() / tiles), 1)
                    for i, name in enumerate(PHASES)}
        print(f"causal={causal}: cycles per warpgroup per KV tile {per_tile}; "
              f"{int(tiles)} warpgroup-tiles; cycles per CTA mean "
              f"{float(probes[:, 0, 6].mean()):.0f}, max {int(probes[:, 0, 6].max())}")
        print(f"causal={causal}: ms per launch, probed {time_ms(run):.4f}, library "
              f"{time_ms(lambda: run(own)):.4f}")


if __name__ == "__main__":
    main()
