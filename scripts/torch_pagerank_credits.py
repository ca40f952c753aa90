"""PageRank's credit path at the benchmark cell's size, on the card: the
binned kernel (``kernels/pagerank_credits``) beside the plain ``_credits``
it replaces there, and the set-up pass that bins each thread's slice.

The graph is the ``pagerank-g500`` configuration's (Graph500 Kronecker,
``--scale`` 26 by default), made on the card from ``--seed`` by the
benchmark's generator and cut into the host backend's four row slices.
Printed, as one JSON object (also written to ``--out``): the set-up pass
over the four slices (host clock, ending in a synchronise), the round's four
launches with ``w = ranks / out_deg`` (CUDA events, mean of ``--reps``), the
kernel alone, the plain path's four calls over int64 copies made outside
the clock, the largest relative gap between the two over fp32's epsilon, the plans' split
bins, the streamed-bytes bound, and the card.

    python3 scripts/torch_pagerank_credits.py --scale 26 --reps 20
"""

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))

from repro_torch import card_info  # noqa: E402
from repro_torch.analytics import pagerank  # noqa: E402
from repro_torch.data.pipeline import partition_rows  # noqa: E402
from repro_torch.kernels.pagerank_credits.ops import bin_edges, binned_credits  # noqa: E402
from stepbench.generators import kronecker  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
THREADS = 4


def events_ms(fn, reps: int) -> float:
    fn()                                          # warm (and the first build)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain-reps", type=int, default=3)
    ap.add_argument("--out", default="build/pagerank_credits.json")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cfg = {"graph": {"scale": args.scale, "edgefactor": 16,
                     "initiator": [0.57, 0.19, 0.19, 0.05], "permute_labels": True}}
    g = kronecker.make(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    edges, v = g["edges"], g["n_vertices"]
    n = edges.shape[0]
    deg = pagerank._out_degree(edges[:, 0].long(), v)
    ranks = (torch.rand(v, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
             + 0.5) / v
    slices = [edges[lo:hi] for lo, hi in (partition_rows(n, t, THREADS) for t in range(THREADS))]

    bin_edges(slices[0][:1024], v)                # the build, outside the clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    binned = [bin_edges(s, v) for s in slices]
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    w = ranks / deg
    round_ms = events_ms(lambda: [binned_credits(b, ranks / deg) for b in binned], args.reps)
    kernel_ms = events_ms(lambda: [binned_credits(b, w) for b in binned], args.reps)

    got = [binned_credits(b, w) for b in binned]
    plan = binned[0].plan
    del binned
    torch.cuda.empty_cache()
    ulps, plain = 0.0, []
    for s, mine in zip(slices, got):
        src, dst = s[:, 0].long(), s[:, 1].long()
        want = pagerank._credits(src, dst, ranks, deg, v)
        gap = (mine.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)
        ulps = max(ulps, float(gap.max()) / torch.finfo(torch.float32).eps)
        plain.append(events_ms(lambda: pagerank._credits(src, dst, ranks, deg, v),
                               args.plain_reps))
        del src, dst
    sizes = plan.items[:, 1] - plan.items[:, 0]
    streamed = 8 * n + THREADS * 8 * v            # pairs, then w and the credits a slice
    out = {"card": card_info(), "scale": args.scale, "vertices": v, "edges": n,
           "setup_ms_4_slices": round(setup_ms, 3),
           "round_ms_4_slices": round(round_ms, 4), "kernel_ms_4_slices": round(kernel_ms, 4),
           "plain_ms_4_slices": round(sum(plain), 4),
           "bound_ms_streamed": round(streamed / HBM_BYTES_PER_S * 1e3, 4),
           "max_gap_eps": round(ulps, 3),
           "slice0_split_bins": plan.n_split, "slice0_items": int(sizes.size),
           "slice0_largest_item": int(sizes.max()),
           "slice0_mean_bin": int(plan.starts[-1]) // (plan.starts.size - 1)}
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
