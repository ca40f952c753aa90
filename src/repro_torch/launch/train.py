"""The trainer (port of :mod:`repro.launch.train`): arch config → model
→ train step → prefetching synthetic pipeline → async checkpointing, with an
automatic restore on restart.  Runs on the card unless ``device="cpu"`` is
passed.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --full \
        --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt

``data`` and ``model_axis`` make a mesh of positions as threads on the one
device (``make_host_mesh``), registered for the EP MoE
(``set_mesh_axis_sizes``), and the model routes its tokens in ``data``
groups, as ``repro``'s trainer does.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.pipeline import LMDataPipeline
from repro_torch.device import resolve_device
from repro_torch.ft import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.build import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.tree import tree_leaves


def batch_for(cfg, shape, pipeline_step_batch):
    """The token pipeline's batch as the arch family's input dict, as
    ``repro``'s: the audio family's frames (B, T, frame_dim) are drawn from
    ``np.random.default_rng(tokens[0, 0])`` and its labels taken ``% vocab``;
    the vlm adds ``vision_embeds`` (B, vision_tokens, vision_dim or d_model)
    drawn from ``default_rng(0)``; the other families take the batch as it
    is.  The draws are float32, on the tokens' device."""
    b = dict(pipeline_step_batch)
    tokens = b["tokens"]
    if cfg.family == "audio":
        rngk = np.random.default_rng(int(tokens[0, 0]))
        B, T = tokens.shape
        frames = rngk.normal(size=(B, T, cfg.frame_dim)).astype(np.float32)
        b = {"frames": torch.from_numpy(frames).to(tokens.device),
             "labels": (b["labels"] % cfg.vocab).to(torch.int32)}
    elif cfg.family == "vlm":
        rngk = np.random.default_rng(0)
        shape = (tokens.shape[0], cfg.vision_tokens, cfg.vision_dim or cfg.d_model)
        b["vision_embeds"] = torch.from_numpy(
            rngk.normal(size=shape).astype(np.float32)).to(tokens.device)
    return b


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: str | None = None,
          ckpt_every: int = 20, data: int = 1, model_axis: int = 1,
          log_every: int = 10, seed: int = 0, total_steps: int | None = None,
          device=None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint, if any) and return the losses of the steps run.
    Each log line gives the step's own seconds and the mean so far."""
    device = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    mesh = make_host_mesh(data=data, model=model_axis, device=device)
    sh.set_mesh_axis_sizes(mesh)
    # the weights from the seed alone, the same on any device, as repro's
    # model.init(PRNGKey(seed))
    model = build_model(cfg, device=device, generator=seed, data_groups=data)
    # total_steps fixes the LR schedule independent of this invocation's
    # horizon, so checkpoint-resume reproduces the uninterrupted run exactly
    total = total_steps or steps
    opt = adamw(lr=warmup_cosine(lr, max(1, total // 20), total))

    params = model.param_tree()
    opt_state = opt.init(params)
    start_step = 0

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (saved, opt_state), _extra, start_step = restore_checkpoint(
            ckpt_dir, (params, opt_state), device=device)
        with torch.no_grad():
            for p, s in zip(tree_leaves(params), tree_leaves(saved)):
                p.copy_(s)
        del saved
        start_step += 1
        print(f"[train] restored checkpoint, resuming at step {start_step}")

    step_fn = make_train_step(model, opt)
    pipe = LMDataPipeline(batch, seq, cfg.vocab, seed=seed, start_step=start_step,
                          device=device)
    losses = []
    t0 = t_step = time.time()
    try:
        for _ in range(start_step, steps):
            step, raw = pipe.next()
            b = batch_for(cfg, None, raw)
            params, opt_state, loss, metrics = step_fn(params, opt_state, b, step)
            losses.append(float(loss))          # waits for the step to finish
            now = time.time()
            if ckpt and step > 0 and step % ckpt_every == 0:
                ckpt.save(step, (params, opt_state), extra={"loss": losses[-1]})
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {losses[-1]:8.4f} "
                      f"({now - t_step:.3f}s this step, "
                      f"{(now - t0) / len(losses):.3f}s/step)", flush=True)
            t_step = time.time()
        if ckpt:
            ckpt.save(steps - 1, (params, opt_state))
            ckpt.wait()
    finally:
        pipe.close()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    losses = train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                   seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, data=args.data,
                   model_axis=args.model_axis, device=args.device)
    print(f"[train] first loss {losses[0]:.4f} → last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
