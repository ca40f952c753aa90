"""End to end on the PyTorch port: train a ~100M-param LM.

The port's trainer (train step, prefetching pipeline, async checkpoints,
restart-exact resume) on the card by default.  The config is a
~100M-parameter dense transformer (qwen3-family blocks); the default step
count is short — pass ``--steps 300`` for a real run.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 5
"""

import argparse
import tempfile

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import train

# ~100M params: 12 × (d512 swiglu-2048 blocks, 8 heads) + 32k vocab embed/head
LM100M = ArchConfig(
    name="lm-100m", family="dense",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
    d_ff=2048, vocab=32000, head_dim=64, qk_norm=True,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from / checkpoint into this directory "
                         "(default: a temporary one)")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    # register the 100M config under the trainer's lookup
    configs.ARCHS[LM100M.name] = LM100M

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        losses = train(LM100M.name, smoke=False, steps=args.steps, batch=args.batch,
                       seq=args.seq, ckpt_dir=ckpt_dir, ckpt_every=25, device=args.device)
    print(f"[train_lm] {LM100M.name}: loss {losses[0]:.3f} → {losses[-1]:.3f} "
          f"over {len(losses)} steps (resume-capable via --ckpt-dir)")


if __name__ == "__main__":
    main()
