"""Print baseline vs hillclimb variants for the §Perf cells from the port's
dry-run records.

    PYTHONPATH=src python scripts/torch_compare_variants.py [experiments/dryrun]

Port of ``scripts/compare_variants.py`` over ``repro_torch``'s
``RooflineRecord`` JSONs (``python -m repro_torch.launch.dryrun --variant
NAME --override key=value --out DIR``): each cell's terms on one H100's
published constants, counts and not measurements.  Nothing here imports JAX
or ``repro``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

CELLS = [
    ("qwen3-1.7b", "train_4k"),
    ("qwen2-72b", "prefill_32k"),
    ("moonshot-v1-16b-a3b", "train_4k"),
]


def main(out_dir="experiments/dryrun"):
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.roofline import model_flops

    for arch, shape in CELLS:
        rows = []
        for fn in sorted(os.listdir(out_dir)):
            if not fn.startswith(f"{arch}__{shape}__single__") or not fn.endswith(".json"):
                continue
            if "skip" in fn:
                continue
            with open(os.path.join(out_dir, fn)) as f:
                r = json.load(f)
            mf = model_flops(get_arch(arch), SHAPES[shape])
            useful = (mf / r["n_devices"]) / r["hlo_flops"] if r["hlo_flops"] else 0
            rows.append((r.get("variant", "baseline"), r, useful))
        rows.sort(key=lambda x: (x[0] != "baseline", x[0]))
        print(f"\n=== {arch} × {shape} (single-pod, per device) ===")
        print(f"{'variant':<16s} {'C(ms)':>10s} {'M(ms)':>10s} {'X(ms)':>10s} "
              f"{'dominant':>10s} {'Δdom%':>7s} {'useful':>7s} {'peak GiB':>9s}")
        base = None
        for name, r, useful in rows:
            dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
            if name == "baseline":
                base = dom
            delta = f"{(dom-base)/base*100:+.1f}" if base else ""
            print(f"{name:<16s} {r['compute_s']*1e3:10.1f} {r['memory_s']*1e3:10.1f} "
                  f"{r['collective_s']*1e3:10.1f} {r['bottleneck']:>10s} {delta:>7s} "
                  f"{useful:7.3f} {r['peak_bytes']/2**30:9.2f}")


if __name__ == "__main__":
    main(*sys.argv[1:])
