"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the cell's inputs on the device from the seed and runs one
whole job, which builds every kernel and warms every shape the window
uses.  The window is a closed loop of one client: jobs run back to back,
each ended by a synchronise, until their walls add up to ``seconds``.
Between two jobs, outside their walls, the harness collects the reference
cycles a finished job's ``Session`` leaves, so that one job's tensors are
not still held while the next runs.  After the window the program's state
is freed and a sample of the window's job outputs, drawn from the seed, is
judged against the plain reference.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from stepbench import devtrace, manifest

SAMPLES = 2            # job outputs judged a run
WAIT_S = 60.0          # a job may end this long after the window's close


@dataclass
class Sample:
    job_seed: int
    output: Any


@dataclass
class Observation:
    """What a metric reader reads: the run's counts and clocks, and in a
    traced run the program's spans and the device trace."""
    cfg: dict
    traffic: dict
    roofline: ModuleType
    setup_s: float
    jobs: int = 0
    iters: int = 0
    job_walls: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    wire_elements: int = 0
    n_threads: int = 0
    spans: List[tuple] = field(default_factory=list)   # (cat, name, seconds)
    device: Optional[devtrace.DeviceTrace] = None

    @property
    def window_s(self) -> float:
        """The window's jobs' walls, added."""
        return sum(self.job_walls)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Dict[str, Any]]
    device: Dict[str, Any]
    checks: Dict[str, Dict[str, float]]
    breakdown: Optional[Dict[str, list]] = None
    job_walls: List[float] = field(default_factory=list)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks           # the numbers compared come last
        return out


def job_seed(seed: int, index: int) -> int:
    """The seed of job ``index`` of a run (-1: the warm-up job)."""
    return (int(seed) * 1_000_003 + index + 1) % (1 << 63)


def worst(readings: List[dict], name: str) -> float:
    """The largest reading of ``name`` over the samples (NaN if none)."""
    values = [float(r[name]) for r in readings if name in r]
    if not values or any(math.isnan(v) for v in values):
        return float("nan")
    return max(values)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_session(cfg: dict, device: torch.device, trace: bool):
    from repro_torch.core import Session
    s = cfg["session"]
    return Session(backend=s["backend"], n_nodes=int(s["n_nodes"]),
                   threads_per_node=int(s["threads_per_node"]), device=device,
                   trace=True if trace else None)


def _read_session(sess, obs: Observation) -> None:
    obs.wire_elements += int(sess.wire_traffic())
    trc = sess.tracer
    if trc.enabled:
        obs.spans.extend((e["cat"], e["name"], e["dur"] / 1e6) for e in trc.spans()
                         if e.get("ph") == "X")
        trc.disable()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path, device: str = "cuda", t0: Optional[float] = None,
             overrides: Optional[dict] = None) -> Result:
    """Run cell ``workload`` once.  ``overrides`` replaces top-level groups
    of the configuration (the tests' small sizes on the CPU)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    bench = manifest.benchmark(root)
    cell = manifest.cell(bench, workload)
    cfg = {**manifest.config(bench, root, cell["config"]), **(overrides or {})}
    traffic = manifest.traffic(cell["traffic"])
    app = manifest.module("apps", cfg["app"])
    # the configuration's float32 products are float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(dev).manual_seed(int(seed))
    inputs = manifest.module("generators", cfg["generator"]).make(cfg, gen, dev)
    sess = make_session(cfg, dev, trace)
    app.run_job(inputs, cfg, traffic, sess, job_seed(seed, -1))
    sync(dev)
    if sess.tracer.enabled:
        sess.tracer.disable()
    del sess
    gc.collect()
    gc.freeze()          # later collections scan only what the window makes
    obs = Observation(cfg, traffic, manifest.module("roofline", cell["config"]),
                      setup_s=time.perf_counter() - t0,
                      n_threads=int(cfg["session"]["n_nodes"])
                      * int(cfg["session"]["threads_per_node"]))

    picker = random.Random(int(seed))
    samples: List[Sample] = []
    attempted = failed = 0
    prof = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if trace:
        prof = torch.profiler.profile(activities=devtrace.activities())
        prof.start()
    tw0 = time.perf_counter()
    while obs.window_s < seconds:
        start = time.perf_counter()
        index = attempted
        attempted += 1
        sess = None
        try:
            sess = make_session(cfg, dev, trace)
            out = app.run_job(inputs, cfg, traffic, sess, job_seed(seed, index))
            sync(dev)
        except Exception:
            failed += 1
            traceback.print_exc(file=sys.stderr)
            sync(dev)
            out = None
        obs.job_walls.append(time.perf_counter() - start)
        if out is not None:
            obs.jobs += 1
            obs.iters += int(traffic["iters"])
            # a reservoir of SAMPLES outputs, drawn from the seed
            if len(samples) < SAMPLES:
                samples.append(Sample(job_seed(seed, index), out))
            else:
                slot = picker.randrange(obs.jobs)
                if slot < SAMPLES:
                    samples[slot] = Sample(job_seed(seed, index), out)
        if sess is not None:
            _read_session(sess, obs)
        del sess, out
        gc.collect()
        if time.perf_counter() - tw0 > seconds + WAIT_S:
            break
    trace_window_s = time.perf_counter() - tw0
    if dev.type == "cuda":
        obs.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if prof is not None:
        prof.stop()
        obs.device = devtrace.summarize(prof.events(), trace_window_s)
        del prof

    gc.collect()
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = cfg["limits"]
    readings = app.readings(inputs, cfg, traffic, samples) if samples else []
    checks = {name: {"value": worst(readings, name), "limit": float(limit)}
              for name, limit in limits.items()}
    correct = (failed == 0 and bool(samples)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, section, workload):
        value = manifest.module("metrics", m["name"]).read(obs)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": obs.peak_bytes}
    breakdown = None
    if obs.device is not None:
        device_info["busy_s"] = obs.device.busy_s
        device_info["window_s"] = obs.device.window_s
        breakdown = {"device_ops": [list(x) for x in obs.device.device_ops],
                     "idle_gaps": [list(x) for x in obs.device.idle_gaps]}
    return Result(correct, attempted, failed, metrics, device_info, checks, breakdown,
                  obs.job_walls)
