"""The two readings each limit of a cell is set from, on the card at the
cell's own size: the program's readings over many seeds (one window job
each, through the same entry the window drives) and the control's (the
reference in the program's place at the precision below the one the
configuration states).  The benchmark's runs do not run this.

    python3 stepbench/readings.py --workload <cell> --seeds 1 2 3 --control-seeds 1 2 3

prints one JSON line a seed and side, ``{"seed", "side", <reading>: value}``,
and writes them to ``--out`` when given.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(workload: str, seeds, control_seeds, *, root: Path = ROOT,
             device: str = "cuda", overrides=None):
    """Yield one dict a seed and side (``program`` or ``control``)."""
    from stepbench import manifest
    from stepbench.runner import Sample, job_seed, make_session, sync

    bench = manifest.benchmark(root)
    cell = manifest.cell(bench, workload)
    cfg = {**manifest.config(bench, root, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    app = manifest.module("apps", cfg["app"])
    generator = manifest.module("generators", cfg["generator"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        inputs = generator.make(cfg, torch.Generator(dev).manual_seed(int(seed)), dev)
        samples, sides = [], []
        if seed in seeds:
            sess = make_session(cfg, dev, False)
            out = app.run_job(inputs, cfg, traffic, sess, job_seed(seed, 0))
            sync(dev)
            del sess
            gc.collect()
            samples.append(Sample(job_seed(seed, 0), out))
            sides.append("program")
        if seed in control_seeds:
            out = app.control(inputs, cfg, traffic, job_seed(seed, 0))
            samples.append(Sample(job_seed(seed, 0), out))
            sides.append("control")
        for side, r in zip(sides, app.readings(inputs, cfg, traffic, samples)):
            yield {"seed": seed, "side": side, **r,
                   "seconds": round(time.perf_counter() - t0, 3)}
        del inputs, samples
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    lines = []
    for r in readings(args.workload, args.seeds, args.control_seeds):
        print(json.dumps(r), flush=True)
        lines.append(r)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
