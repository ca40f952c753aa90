"""The dry-run matrix and roofline tables from the port's records, and the
sample trace and findings report run through the port.

    PYTHONPATH=src python scripts/torch_make_report.py [--out experiments/dryrun]
    PYTHONPATH=src python scripts/torch_make_report.py --export-trace PATH [--device cpu]
    PYTHONPATH=src python scripts/torch_make_report.py --export-check PATH [--device cpu]

Port of ``scripts/make_report.py`` over ``repro_torch``'s
:class:`~repro_torch.launch.roofline.RooflineRecord` JSONs, which
``python -m repro_torch.launch.dryrun ... --out DIR`` writes (one step of a
cell on ``device="meta"``, its counts turned into terms on one H100's
published constants: counts, not measurements).  ``--export-trace`` and
``--export-check`` run the analytics apps through ``repro_torch`` on the
card, or on the CPU with ``--device cpu``.  Nothing here imports JAX or
``repro``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

ARCH_ORDER = ["deepseek-v3-671b", "moonshot-v1-16b-a3b", "starcoder2-3b",
              "qwen3-4b", "qwen2-72b", "qwen3-1.7b", "llama-3.2-vision-90b",
              "zamba2-2.7b", "hubert-xlarge", "mamba2-2.7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
NOT_PORTED = ("The step.trace and step.check overhead sections of make_report.py read the JAX "
              "package's benchmarks/BENCH_trace.json and BENCH_check.json; the port's own "
              "benchmark files do not exist yet, so those sections are not printed here.")


def load(out_dir):
    """``(records, skips)`` keyed by (arch, shape, mesh, variant), each
    record's MODEL_FLOPS and useful ratio recomputed with the current
    formula, as ``make_report.py`` does."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.roofline import model_flops

    recs, skips = {}, {}
    for fn in os.listdir(out_dir):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            r = json.load(f)
        key = (r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
        if r.get("skipped"):
            skips[key] = r
        else:
            mf = model_flops(get_arch(r["arch"]), SHAPES[r["shape"]])
            r["model_flops_total"] = mf
            if r["hlo_flops"]:
                r["useful_ratio"] = (mf / r["n_devices"]) / r["hlo_flops"]
            recs[key] = r
    return recs, skips


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def improvement_note(r):
    """One sentence on what moves the dominant term down on the H100."""
    b = r["bottleneck"]
    if b == "memory":
        if "decode" in r["shape"] or "long" in r["shape"]:
            return ("decode is cache-read bound: shrink the bytes a token reads from its cache "
                    "(MLA/SSM already small; the int8 KV cache)")
        return ("the memory term counts each aten op's inputs and outputs unfused: fusing "
                "attention into the flash kernel (scores kept on chip) and bf16 intermediates "
                "cut the HBM traffic")
    if b == "collective":
        return ("the collectives counted are expert parallelism's only: cut the all-to-alls' "
                "bytes (fewer slots a position, bf16 dispatch)")
    return ("compute-bound: raise tensor-core use (larger GEMM tiles a card, skip "
            "causal-masked tiles, fewer remat recomputes)")


def matrix_lines(recs, skips, variant="baseline"):
    """The dry-run matrix: one row an (arch, shape), a cell a mesh."""
    lines = ["### Dry-run matrix (meta step status, bytes/device)\n",
             "| arch | shape | single-pod (256) | multi-pod (512) |",
             "|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            cells = []
            for mesh in ("single", "multi"):
                k = (a, s, mesh, variant)
                if k in recs:
                    r = recs[k]
                    coll = "+".join(sorted(r["collective_by_op"])) or "no-coll"
                    cells.append(f"OK — peak {fmt_bytes(r['peak_bytes'])} GiB, {coll}")
                elif k in skips:
                    cells.append(f"SKIP ({skips[k]['reason'].split(':')[0]})")
                else:
                    cells.append("—")
            lines.append(f"| {a} | {s} | {cells[0]} | {cells[1]} |")
    return lines


def roofline_lines(recs, skips, variant="baseline"):
    """The single-pod roofline table, per device."""
    lines = [f"### Roofline (single-pod, per device, {variant}; H100 constants)\n",
             "| arch | shape | compute (ms) | memory (ms) | collective (ms) | bottleneck | "
             "MODEL_FLOPS | useful | peak GiB | note |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            k = (a, s, "single", variant)
            if k in recs:
                r = recs[k]
                lines.append(
                    f"| {a} | {s} | {r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} | "
                    f"{r['collective_s']*1e3:.2f} | **{r['bottleneck']}** | "
                    f"{r['model_flops_total']:.2e} | {r['useful_ratio']:.3f} | "
                    f"{fmt_bytes(r['peak_bytes'])} | {improvement_note(r)} |")
            elif k in skips:
                lines.append(f"| {a} | {s} | — | — | — | skipped | — | — | — | "
                             f"{skips[k]['reason']} |")
    return lines


def export_check_report(path, device=None):
    """The four analytics apps under an armed checker and the seeded race of
    ``examples/torch_race_demo.py``, on ``device`` (``None``: the card), in
    one findings JSON: zero findings on the apps, the race caught.
    Returns the report."""
    import numpy as np
    import torch

    from repro_torch.analytics import kmeans, logreg, nmf, pagerank
    from repro_torch.check import Checker
    from repro_torch.core import Session

    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 16)).astype(np.float32)
    y = (rng.random(128) > 0.5).astype(np.float32)
    pts = rng.normal(size=(96, 4)).astype(np.float32)
    r = np.abs(rng.normal(size=(32, 16))).astype(np.float32)
    edges = np.stack([rng.integers(0, 24, 80), rng.integers(0, 24, 80)],
                     axis=1).astype(np.int32)

    report = {"apps": {}, "seeded_race": None}
    for name, call in (
            ("logreg", lambda s: logreg.fit(x, y, iters=3, session=s)),
            ("kmeans", lambda s: kmeans.fit(pts, 3, iters=3, session=s)),
            ("nmf", lambda s: nmf.fit(r, 4, iters=3, session=s)),
            ("pagerank", lambda s: pagerank.fit(edges, 24, iters=3, session=s))):
        sess = Session(backend="host", n_nodes=2, threads_per_node=2,
                       shards=8, check=True, device=device)
        try:
            call(sess)
            report["apps"][name] = sess.checker.report()
        finally:
            sess.checker.disable()

    ck = Checker(enabled=True)
    try:
        sess = Session(backend="host", n_nodes=1, threads_per_node=2,
                       check=ck, device=device)
        counter = sess.def_global("counter", torch.tensor(0.0))

        def proc(ctx):
            for _ in range(4):
                v = counter.get()
                counter.set(v + torch.tensor(ctx.tid + 1.0, device=ctx.device))
            return None

        sess.run(proc)
        report["seeded_race"] = ck.report()
    finally:
        ck.disable()

    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    clean = all(rep["count"] == 0 for rep in report["apps"].values())
    caught = report["seeded_race"]["count"] > 0
    print(f"wrote {path}: apps clean={clean}, "
          f"seeded race caught={caught} "
          f"({report['seeded_race']['count']} finding(s)) on {sess.device}")
    return report


def export_sample_trace(path, device=None):
    """A traced 2-thread logreg fit on ``device`` (``None``: the card),
    exported as Chrome-trace JSON for https://ui.perfetto.dev.  Returns the
    tracer's snapshot."""
    import numpy as np

    from repro_torch.analytics import logreg
    from repro_torch.core import Session

    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 32)).astype(np.float32)
    y = (rng.random(128) > 0.5).astype(np.float32)
    sess = Session(backend="host", n_nodes=2, threads_per_node=1, trace=True,
                   device=device)
    try:
        logreg.fit(x, y, iters=5, session=sess)
        sess.tracer.export(path)
        snap = sess.tracer.snapshot()
        print(f"wrote {path}: {snap['events']} events, "
              f"categories {sorted(snap['spans_by_category'])} on {sess.device}")
    finally:
        sess.tracer.disable()
    return snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], epilog=NOT_PORTED)
    ap.add_argument("--out", default="experiments/dryrun",
                    help="the dry run's records (python -m repro_torch.launch.dryrun --out)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--export-trace", default=None, metavar="PATH",
                    help="run a traced 2-thread logreg fit and write the "
                         "Perfetto-loadable trace JSON to PATH, then exit")
    ap.add_argument("--export-check", default=None, metavar="PATH",
                    help="run the four analytics apps and a seeded race "
                         "under an armed checker and write the findings "
                         "JSON to PATH, then exit")
    ap.add_argument("--device", default=None,
                    help="where --export-trace / --export-check run (default: the card)")
    args = ap.parse_args(argv)
    if args.export_trace:
        export_sample_trace(args.export_trace, args.device)
        return 0
    if args.export_check:
        export_check_report(args.export_check, args.device)
        return 0
    if not os.path.isdir(args.out):
        print(f"# no dry-run records at {args.out}; skipping dryrun/roofline")
        return 0
    recs, skips = load(args.out)
    print("\n".join(matrix_lines(recs, skips, args.variant)))
    print()
    print("\n".join(roofline_lines(recs, skips, args.variant)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
