#!/usr/bin/env python
"""torch_step_top — a live terminal view over a port session's metrics.

The port's counterpart of ``scripts/step_top.py``: one screen refreshed in
place showing ops/s per store verb, per-shard lock-wait quantiles, tier
occupancy, accumulator round latency and the watchdog's anomaly tail, for a
``repro_torch`` session.  The frame is :func:`repro_torch.obs.top.render`,
the same text as the JAX script's for the same snapshots.

Usage::

    PYTHONPATH=src python scripts/torch_step_top.py --demo            # the card
    PYTHONPATH=src python scripts/torch_step_top.py --demo --once --device cpu
    PYTHONPATH=src python scripts/torch_step_top.py --demo --frames 10 --interval 0.5
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.session import Session
from repro_torch.obs.top import CLEAR, render


def _demo_session(device=None):
    """A self-driving session for ``--demo``: background threads hammer a
    small sharded store on ``device`` so every panel has live numbers."""
    sess = Session(shards=4, record=True, device=device)
    refs = [sess.new_array(f"demo{i}", (2048,)) for i in range(16)]
    stop = threading.Event()

    def churn(seed: int) -> None:
        i = seed
        while not stop.is_set():
            ref = refs[i % len(refs)]
            if i % 3 == 0:
                ref.set(torch.full((2048,), float(i), device=sess.device))
            else:
                ref.get()
            i += 1
            time.sleep(0.002)

    workers = [threading.Thread(target=churn, args=(k,), daemon=True)
               for k in range(4)]
    for w in workers:
        w.start()
    return sess, stop, workers


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--demo", action="store_true",
                    help="drive a synthetic workload session to watch")
    ap.add_argument("--device", default=None,
                    help="where the demo session lives (default: the card)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh interval in seconds")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="print a single frame and exit")
    ap.add_argument("--no-clear", action="store_true",
                    help="append frames instead of redrawing in place")
    args = ap.parse_args(argv)

    if not args.demo:
        ap.error("only --demo mode ships: torch_step_top needs an in-process "
                 "session (pass --demo, or call repro_torch.obs.top.render in "
                 "your driver)")
    sess, stop, workers = _demo_session(args.device)
    watchdog = sess.watchdog(interval_s=0.25).start()
    prev = None
    t_prev = time.perf_counter()
    frames = 1 if args.once else args.frames
    n = 0
    try:
        while True:
            time.sleep(0.25 if prev is None else args.interval)
            cur, t_cur = sess.metrics(), time.perf_counter()
            frame = render(cur, prev, t_cur - t_prev, watchdog.anomalies)
            if not args.no_clear and not args.once:
                sys.stdout.write(CLEAR)
            sys.stdout.write(frame + "\n")
            sys.stdout.flush()
            prev, t_prev = cur, t_cur
            n += 1
            if frames and n >= frames:
                break
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        pass
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=2)
        watchdog.stop()
        sess.recorder.close()
    if watchdog.errors:
        raise RuntimeError(f"the watchdog's polls failed: {watchdog.errors[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
