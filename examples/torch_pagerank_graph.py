"""PageRank over a power-law graph (paper §6.7) with the auto accumulator,
on the PyTorch port.

Shows the paper's sparse/auto accumulator decision in action: threads owning
edges with concentrated destinations produce sparse credit vectors, and the
``auto`` mode ships (index, value) pairs only when cheaper.  Everything runs
through the Session facade with the iteration written via ``ctx.iterate``;
each run prints its wire traffic and the branch its last round took.  On
the card by default.

    PYTHONPATH=src python examples/torch_pagerank_graph.py
    PYTHONPATH=src python examples/torch_pagerank_graph.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.analytics import pagerank
from repro_torch.core import AccumMode
from repro_torch.data import powerlaw_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    n_vertices = 2000
    edges = powerlaw_graph(n_vertices, avg_degree=8, seed=0)
    print(f"graph: {n_vertices} vertices, {edges.shape[0]} edges")

    ref = pagerank.fit_reference(edges, n_vertices, iters=15, device=args.device)
    for mode in (AccumMode.GATHER_ALL, AccumMode.REDUCE_SCATTER, AccumMode.AUTO):
        ranks, sess = pagerank.fit(edges, n_vertices, backend="host", n_nodes=2,
                                   threads_per_node=2, iters=15, mode=mode,
                                   device=args.device)
        drift = float(np.max(np.abs(ranks - ref)))
        branch = sess.accumulator("credits").last_mode.value
        print(f"[{mode.value:>14s}] top vertex {int(np.argmax(ranks))} "
              f"drift {drift:.2e} wire {sess.wire_traffic():>9d} elems branch {branch}")
    print("top-5 ranked vertices:", np.argsort(-ref)[:5].tolist())


if __name__ == "__main__":
    main()
