"""Serve an LM on the PyTorch port with batched requests: prefill + decode
with KV (and, for mamba2 and zamba2, SSM) caches.

The DSM-cache analogy in action: the KV cache is the device-local replica
the paper's DSM cache kept per node — written through at every decode step,
never invalidated because the owner is the only writer.  On the card by
default.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b --device cpu
"""

import argparse

from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    toks = serve(args.arch, smoke=True, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print(f"[serve_lm] generated {toks.shape[0]}×{toks.shape[1]} tokens; "
          f"first request: {toks[0][:10].tolist()}")


if __name__ == "__main__":
    main()
