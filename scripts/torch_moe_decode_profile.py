"""Where a decode step of an MoE model spends the card's time.

Builds an arch of the moe family at its full widths in fp32, its depth cut
in whole layers as ``chip_smoke.py`` phase 7 runs it (moonshot-v1-16b-a3b at
24 of 48 layers, deepseek-v3-671b at 4 of 61), fills a KV cache by decode
steps at batch 4, then traces ``--steps`` more decode steps with
``torch.profiler`` (CPU and CUDA activity) and prints: the host wall of a
step, the device-busy time a step (the union of the kernels' intervals) and
its share of the wall, the device time a step of ``aten::bmm`` (the gather
path's three expert GEMMs, every expert on its C slots, and the attention's
small batched products), and the
top ops by device time.  Also the bytes of the weights a step reads and that
read's time at 3.35 TB/s, and the host's µs a call (no profiler, 200 calls
after a warm-up) of one MoE layer at the decode shape and of the dispatch's
buffer write as it is made (``index_put(accumulate=True)``) beside the same
write without accumulation.

    python3 scripts/torch_moe_decode_profile.py [--arch deepseek-v3-671b] [--layers 4]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import card_info  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.ffn import MoE, capacity  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
LAYERS = {"moonshot-v1-16b-a3b": 24, "deepseek-v3-671b": 4}
BATCH, WARM = 4, 32


def busy_us(events) -> float:
    """The union of the device kernels' intervals, in µs."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def host_us(fn, reps: int = 200) -> float:
    """µs of host time a call: ``reps`` calls queued back to back."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def layer_host_costs(model) -> None:
    """One MoE layer of ``model`` at the decode shape (BATCH tokens, one
    group, capacity E / k), and its buffer write with and without
    accumulation, in host µs a call."""
    layer = next(m for m in model.modules() if isinstance(m, MoE))
    cfg = model.moe_cfg._replace(capacity_factor=model.moe_cfg.n_experts / model.moe_cfg.top_k)
    E, k, D = cfg.n_experts, cfg.top_k, cfg.d_model
    C = capacity(cfg, BATCH)
    x = torch.randn(BATCH, 1, D, device="cuda")
    g = torch.zeros(1, BATCH * k, dtype=torch.long, device="cuda")
    e = torch.randint(0, E, (1, BATCH * k), device="cuda")
    p = torch.randint(0, C, (1, BATCH * k), device="cuda")
    v = torch.randn(1, BATCH * k, D, device="cuda")
    buf = torch.zeros(1, E, C, D, device="cuda")
    print(f"host us a call at the decode shape ({BATCH} tokens, E {E}, k {k}, C {C}): one MoE "
          f"layer {host_us(lambda: layer(x, cfg)):.1f}; its buffer write index_put(accumulate="
          f"True) {host_us(lambda: buf.index_put((g, e, p), v, accumulate=True)):.1f}, without "
          f"accumulation {host_us(lambda: buf.index_put((g, e, p), v)):.1f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b", choices=sorted(LAYERS))
    ap.add_argument("--layers", type=int, default=None, help="default: chip_smoke's cut")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_info(), flush=True)
    cfg = get_arch(args.arch).replace(n_layers=args.layers or LAYERS[args.arch])
    model = build_model(cfg, generator=0)
    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if not n.startswith("mtp.") and n != "embed.table")
    tokens = torch.randint(0, cfg.vocab, (BATCH, WARM + args.steps), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    cache = model.init_cache(BATCH, WARM + args.steps)
    with torch.no_grad():
        for pos in range(WARM):
            _, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for pos in range(WARM, WARM + args.steps):
                _, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
    events = prof.events()
    busy = busy_us(events) / 1e3 / args.steps
    bmm = sum(e.device_time_total for e in prof.key_averages()
              if e.key in ("aten::bmm",)) / 1e3 / args.steps
    print(f"{args.arch} at {cfg.n_layers} layers, batch {BATCH}: a decode step's wall "
          f"{wall * 1e3:.3f} ms, the device busy {busy:.3f} ms ({busy / (wall * 1e3):.1%}); "
          f"aten::bmm (the expert GEMMs, batched over experts, and the attention's scores and "
          f"readout) {bmm:.3f} ms a step; weights "
          f"read a step {weights / 1e9:.2f} GB, {weights / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          "3.35 TB/s", flush=True)
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=15), flush=True)
    with torch.no_grad():
        layer_host_costs(model)


if __name__ == "__main__":
    main()
