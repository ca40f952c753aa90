"""Serving loop: batched prefill + autoregressive decode with KV/SSM caches.

Port of :mod:`repro.launch.serve`, with the same schedule: the prompt is
prefilled by repeated decode steps (cache-exact), then ``gen`` greedy decode
steps follow.  Serves every family ``build_model`` builds that decodes
(dense, moe with GQA or MLA, ssm, hybrid, and vlm, which takes no vision
input: its cross caches stay the zeros ``init_cache`` makes, as in
``repro``); the encoder-only audio family exits.  Runs on the card unless
``device="cpu"`` is passed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --batch 4 --prompt-len 32 --gen 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.build import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, smoke: bool = True, batch: int = 4, prompt_len: int = 32,
          gen: int = 32, seed: int = 0, greedy: bool = True, device=None):
    """Greedy-decoded tokens (batch, gen) for random prompts made from
    ``seed``, on a model of ``arch`` with random weights from ``seed``."""
    device = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch has no decode path")
    model = build_model(cfg, device=device, generator=seed)      # the same on any device

    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(batch, prompt_len)),
                              dtype=torch.int32, device=device)
    max_len = prompt_len + gen
    cache = model.init_cache(batch, max_len)
    decode = make_decode_step(model)

    # prefill via repeated decode (cache-exact; the fused prefill is the
    # optimized path — see launch/steps.py make_prefill_step)
    t0 = time.time()
    logits = None
    for pos in range(prompt_len):
        logits, cache = decode({"cache": cache, "tokens": prompts[:, pos:pos + 1], "pos": pos})
    _sync(device)
    t_prefill = time.time() - t0

    out_tokens = []
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    t1 = time.time()
    for i in range(gen):
        out_tokens.append(tok.cpu().numpy())
        logits, cache = decode({"cache": cache, "tokens": tok, "pos": prompt_len + i})
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    _sync(device)
    t_decode = time.time() - t1

    toks = np.concatenate(out_tokens, axis=1)
    tok_s = batch * gen / t_decode if t_decode > 0 else float("inf")
    print(f"[serve] prefill {prompt_len} toks in {t_prefill:.2f}s; "
          f"decode {gen} steps × batch {batch}: {t_decode:.2f}s = {tok_s:.1f} tok/s")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
