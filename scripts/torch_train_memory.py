"""Where a train step's device memory goes, stage by stage, on the card.

Runs the stages of ``repro_torch.launch.steps.make_train_step`` one by one
(forward, backward, clip, optimizer update, in-place apply) on an arch at
its full width (qwen3-1.7b unless ``--arch`` names another; ``--layers``
cuts the depth, in whole superblocks for a hybrid), batches of 8 x 128 from
``LMDataPipeline``, and prints for each stage the memory allocated after it
and the peak during it, in GiB and in units of the parameters' bytes; then
the peak of ``make_train_step`` itself over the same steps.

    python3 scripts/torch_train_memory.py [--arch zamba2-2.7b] [--layers 28] [--steps 3]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import card_info  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LMDataPipeline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, clip_by_global_norm, warmup_cosine  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_unflatten  # noqa: E402

GIB = 2 ** 30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--layers", type=int, default=None, help="default: the arch's own")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", card_info())
    cfg = get_arch(args.arch)
    cfg = cfg.replace(n_layers=args.layers or cfg.n_layers)
    model = build_model(cfg, generator=0)
    model.requires_grad_(True)
    params = model.param_tree()
    unit = sum(p.numel() * p.element_size() for p in params.values())
    print(f"{args.arch}, {cfg.n_layers} layers: parameters {unit / GIB:.3f} GiB")
    opt = adamw(lr=warmup_cosine(3e-4, 1, args.steps))
    state = opt.init(params)
    pipe = LMDataPipeline(8, 128, cfg.vocab, prefetch=False)

    def mark(stage: str) -> None:
        torch.cuda.synchronize()
        now, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        print(f"  {stage:8s}: after {now / GIB:7.3f} GiB ({now / unit:5.2f} x params), "
              f"peak during {peak / GIB:7.3f} GiB ({peak / unit:5.2f} x params)")
        torch.cuda.reset_peak_memory_stats()

    for s in range(args.steps):
        step, batch = pipe.next()
        print(f"step {step}")
        torch.cuda.reset_peak_memory_stats()
        leaves = tree_leaves(params)
        loss, _ = model.loss_fn(batch)
        mark("forward")
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        del loss
        mark("backward")
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, 1.0)
            mark("clip")
            updates, state = opt.update(grads, state, params, step)
            del grads
            mark("update")
            for p, u in zip(leaves, tree_leaves(updates)):
                p.add_(u.to(p.dtype))
            del updates
            mark("apply")

    step_fn = make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.steps):
        step, batch = pipe.next()
        params, state, loss, _ = step_fn(params, state, batch, step)
        float(loss)
    peak = torch.cuda.max_memory_allocated()
    print(f"make_train_step, {args.steps} steps: peak {peak / GIB:.3f} GiB "
          f"({peak / unit:.2f} x params)")


if __name__ == "__main__":
    main()
