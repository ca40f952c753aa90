"""How far bf16 serving lies from fp32 as a model gets deeper.

Builds an arch at its full width in bf16 from seed 0, cut to each depth of
``--layers`` (in whole superblocks for a hybrid), and on one batch of
``--seq`` random tokens prints, over the logits of every position:

- the bf16 forward against ``--seq`` bf16 decode steps (max |dlogit| over
  max |logit|, and the error's rms over the logits' rms);
- the bf16 decode against the fp32 decode of the same bf16 weights (the
  fp32 build from the same seed rounded to bf16), likewise;
- the fp32 forward against the fp32 decode, for scale.

The forward runs the arch's plain algorithms (blocked attention, chunked
SSD).  ``--device cpu`` runs it here; the default is the card.

    python3 scripts/torch_bf16_depth.py --arch mamba2-2.7b --layers 2 4 16 --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def logits(model, tokens):
    """The forward's logits and the decode steps' over ``tokens`` (B, T), fp32."""
    with torch.no_grad():
        full = make_prefill_step(model)({"tokens": tokens}).float()
        cache = model.init_cache(tokens.shape[0], tokens.shape[1])
        steps = []
        for pos in range(tokens.shape[1]):
            out, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
            steps.append(out[:, 0].float())
    return full, torch.stack(steps, dim=1)


def gaps(a, b) -> str:
    err = a - b
    return (f"max {float(err.abs().max() / b.abs().max()):.3e}, rms "
            f"{float(err.square().mean().sqrt() / b.square().mean().sqrt()):.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 16])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    for n_layers in args.layers:
        cfg = get_arch(args.arch).replace(dtype="bfloat16", n_layers=n_layers)
        tokens = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, size=(args.batch, args.seq)), dtype=torch.int32, device=device)
        bf16 = build_model(cfg, device=device, generator=0)
        held = {n: p.dtype for n, p in bf16.named_parameters()}
        full16, steps16 = logits(bf16, tokens)
        del bf16
        f32 = build_model(cfg.replace(dtype="float32"), device=device, generator=0)
        with torch.no_grad():
            for n, p in f32.named_parameters():
                if held[n] == torch.bfloat16:
                    p.copy_(p.to(torch.bfloat16))
        full32, steps32 = logits(f32, tokens)
        del f32
        print(f"{args.arch} at {n_layers} layers, {args.batch} x {args.seq} tokens on "
              f"{device.type}: bf16 forward vs bf16 decode {gaps(full16, steps16)}; bf16 decode "
              f"vs fp32 decode of the same weights {gaps(steps16, steps32)}; fp32 forward vs "
              f"fp32 decode {gaps(full32, steps32)}", flush=True)


if __name__ == "__main__":
    main()
