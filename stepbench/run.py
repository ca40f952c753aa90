"""Run one cell of the port's benchmark once and print its result.

    python3 stepbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``src/repro_torch``).  The last line of standard output is the
result, one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a run under ``torch.profiler`` and the session's tracer.  The run
exits with another code than 0, and prints no result, where the card or
the port is missing, or where a module of JAX or of the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(ROOT / "build" / "stepbench_cache" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str) -> int:
    print(f"stepbench: {message}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from stepbench import manifest
    try:
        bench = manifest.benchmark(ROOT)
        cell = manifest.cell(bench, args.workload)
    except (manifest.ManifestError, OSError, ValueError) as e:
        return fail(str(e))

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is visible")
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"the cell needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the port is not in this checkout ({ROOT / 'src' / 'repro_torch'})")
    sys.path.insert(0, str(ROOT / "src"))

    from stepbench.runner import run_cell
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      root=ROOT, device="cuda", t0=T0)

    found = forbidden_modules()
    if found:
        return fail("modules of JAX or the JAX package were loaded: " + ", ".join(found))
    print("job walls (s): " + " ".join(f"{w:.4f}" for w in result.job_walls),
          file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
