"""Multi-pod dry run on the port: prove the distribution config is coherent,
no hardware.

Port of :mod:`repro.launch.dryrun`.  For one (arch × shape × mesh) cell the
full-depth compile becomes one step of the cell on ``device="meta"`` over
the production mesh: 16 × 16 = 256 positions as threads (2 × 16 × 16 for
``--mesh multi``), each allocating nothing.  The step's ops and collectives
are counted as they run (:func:`repro_torch.launch.roofline.extract_metrics`)
and turned into a :class:`~repro_torch.launch.roofline.RooflineRecord` on
the H100's constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
        --shape train_4k --mesh single --out experiments/dryrun

The CLI, the dtype policy (bf16, remat "full" for train), ``FSDP_ARCHS``,
the skip files of cells ``cell_runnable`` refuses and the record paths are
``repro``'s.  Torch counts every layer it runs, so ``repro``'s scan-body
probes are not needed: ``--no-probes`` (``probes=False``) is accepted and
does nothing.  Nothing here sets ``XLA_FLAGS`` or imports JAX.
"""

import argparse
import json
import os
import sys
import time

from repro_torch.configs import ARCHS, SHAPES, cell_runnable, get_arch
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.roofline import analyse, extract_metrics, save_record
from repro_torch.launch.steps import build_cell

# archs whose params don't fit TP-only at bf16: shard d_model dims over "data"
FSDP_ARCHS = {"deepseek-v3-671b", "qwen2-72b", "llama-3.2-vision-90b"}


def run_cell(arch: str, shape_name: str, mesh_name: str, *, variant: str = "baseline",
             out_dir: str = "experiments/dryrun", fsdp=None,
             overrides=None, probes: bool = True, verbose: bool = True):
    """The cell's :class:`RooflineRecord` (``None`` for a skipped cell, whose
    reason goes to a ``.skip.json``), saved under ``out_dir``.  ``probes``
    is accepted for ``repro``'s signature and does nothing."""
    del probes
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_runnable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "variant": variant, "skipped": True, "reason": reason}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}__{variant}.skip.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"SKIP {arch} × {shape_name}: {reason}")
        return None

    # production dtype policy: bf16 params/compute; remat for train
    cfg = cfg.replace(dtype="bfloat16",
                      remat="full" if shape.kind == "train" else "none")
    if fsdp is None:
        fsdp = arch in FSDP_ARCHS
    if overrides:
        cfg = cfg.replace(**overrides)

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device="meta")
    n_dev = mesh.size
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] positions={n_dev} fsdp={fsdp} "
              f"variant={variant}", flush=True)

    # the full-depth step on meta: the coherence proof and the counts
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, fsdp=fsdp, device="meta")
    metrics = extract_metrics(cell)
    t_step = time.time() - t0
    if verbose:
        print(f"  meta step {t_step:.1f}s; per position: params "
              f"{cell.local_bytes['params'] / 2**30:.2f} GiB, optimizer "
              f"{cell.local_bytes['opt'] / 2**30:.2f} GiB, batch "
              f"{cell.local_bytes['batch'] / 2**30:.3f} GiB", flush=True)

    rec = analyse(cfg, shape, mesh_name, n_dev, metrics, t_step,
                  cell.param_count, variant=variant, note=metrics["note"])
    if rec.peak_bytes > HBM_BYTES:
        rec.note += (f"; peak {rec.peak_bytes / 2**30:.1f} GiB > the H100's 80 GB HBM at "
                     f"{n_dev} cards — needs more cards / further sharding (reported honestly)")
    path = save_record(rec, out_dir)
    if verbose:
        print(f"  flops/dev={rec.hlo_flops:.3e} bytes/dev={rec.hlo_bytes:.3e} "
              f"coll/dev={rec.collective_bytes:.3e}", flush=True)
        print(" ", rec.summary(), flush=True)
        print(f"  -> {path}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for repro's CLI; the port counts every layer, no probes run")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (e.g. moe_impl=ep)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    run_cell(args.arch, args.shape, args.mesh, variant=args.variant,
             out_dir=args.out, fsdp=fsdp, overrides=overrides or None,
             probes=not args.no_probes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
