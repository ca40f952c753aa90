"""The peak device memory of a 4 x 2048 prefill at each depth cut of an arch,
on the card: the numbers a whole-layer cut that fits one card is picked by.

For each ``--layers`` value: the arch at its published widths cut to that
many layers in ``--dtype``, built from the seed, a warm-up forward on 4 x 256
tokens, then the prefill on 4 x 2048 tokens (the flash kernel once a layer)
and the logits' finiteness check, as ``chip_smoke.py`` phase 7 runs them;
printed: the parameters, the peak allocated, and what the card has left
beside it (its total memory less the peak).  Each model is freed before the
next.

    python3 scripts/torch_depth_cut.py --arch qwen2-72b --dtype float32 --layers 14 15 16
"""

import argparse
import gc
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import card_info  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import InitStream  # noqa: E402

BATCH, PREFILL, WARM = 4, 2048, 256


def peak_at(arch: str, dtype: str, n_layers: int) -> tuple:
    """(parameters, peak bytes) of the cut's prefill; raises on no fit."""
    cfg = get_arch(arch).replace(n_layers=n_layers, dtype=dtype, attention_impl="pallas")
    model = build_model(cfg, generator=0)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_prefill_step(model)
    tokens = InitStream(0).draw((BATCH, PREFILL), kind="integers", high=cfg.vocab,
                                dtype=torch.int32, device="cuda")
    step({"tokens": tokens[:, :WARM]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = step({"tokens": tokens})
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} at {n_layers} layers: logits not finite")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del logits, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return n_params, peak


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--layers", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    total = torch.cuda.get_device_properties(0).total_memory
    print("card:", card_info(), f"; total memory {total / 1e9:.3f} GB")
    for n in args.layers:
        try:
            n_params, peak = peak_at(args.arch, args.dtype, n)
        except torch.cuda.OutOfMemoryError:
            n_params = None
        if n_params is None:                    # the error's frames are gone here
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{args.arch} {args.dtype} {n} layers: out of memory")
            continue
        print(f"{args.arch} {args.dtype} {n} of {get_arch(args.arch).n_layers} layers: "
              f"{n_params} parameters; prefill {BATCH}x{PREFILL} peak {peak / 1e9:.3f} GB "
              f"({peak / 2**30:.3f} GiB), {(total - peak) / 1e9:.3f} GB of the card left")
    return 0


if __name__ == "__main__":
    sys.exit(main())
