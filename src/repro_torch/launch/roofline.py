"""Roofline terms of one cell's step on the port (NVIDIA H100 constants).

Port of :mod:`repro.launch.roofline`.  Per (arch × shape × mesh) cell:
    compute term    = flops_per_device / PEAK_FLOPS_BF16
    memory term     = bytes_per_device / HBM_BW
    collective term = collective_bytes_per_device / ICI_LINK_BW (NVLink)

Nothing is compiled, so :func:`extract_metrics` takes a run of the cell's
step (``Cell.step``) in place of XLA's cost and memory analysis: every aten
op the step dispatches is counted by :class:`OpCounter` (flops by
``torch.utils.flop_counter``'s formulas, 2·m·n·k for a matmul; bytes as
each op's inputs plus outputs, which is what XLA's "bytes accessed" sums;
views move nothing), the collectives by the mesh's recorder
(:func:`repro_torch.core.compat.record_collectives`).  Ops run inside mesh
positions (the EP layers) are counted per position, their sum over the
positions; the rest of the step is the global program, whose counts are
divided by the device count — XLA's per-device partitioned counts,
approximated by an even split (a record's ``note`` says so).  MODEL_FLOPS
uses the 6·N·D (train) / 2·N·D (inference) convention with MoE
active-param scaling, plus the causal-attention term, as ``repro``'s.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.compat import in_positions, record_collectives
from repro_torch.launch.mesh import HBM_BW, ICI_LINK_BW, PEAK_FLOPS_BF16


# ---------------------------------------------------------------------------
# "useful" model FLOPs
# ---------------------------------------------------------------------------


def active_param_count(cfg: ArchConfig, total_params: int, moe_params: int) -> float:
    """Params touched per token: scale routed experts by top_k/E."""
    if cfg.n_experts:
        return (total_params - moe_params) + moe_params * cfg.top_k / cfg.n_experts
    return float(total_params)


def matmul_param_count(cfg: ArchConfig) -> tuple[float, float]:
    """(total matmul params excl. embed-lookup, routed-expert matmul params).

    Analytic (independent of init) so the roofline doesn't need live trees.
    """
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd = cfg.head_dim_actual
    H, KH = cfg.n_heads, cfg.n_kv_heads

    attn = 0.0
    if cfg.attn_kind == "gqa":
        attn = D * hd * (H + 2 * KH) + H * hd * D
    elif cfg.attn_kind == "mla":
        attn = (D * cfg.q_lora_rank + cfg.q_lora_rank * H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + D * cfg.kv_lora_rank + D * cfg.qk_rope_dim
                + cfg.kv_lora_rank * H * (cfg.qk_nope_dim + cfg.v_head_dim)
                + H * cfg.v_head_dim * D)

    def ffn_params(width):
        return (3 if cfg.ffn_kind == "swiglu" else 2) * D * width

    moe_routed = 0.0
    if cfg.family in ("ssm", "hybrid"):
        ssm_dproj = 2 * (cfg.ssm_expand * D) + 2 * cfg.ssm_groups * cfg.ssm_state * 2  # rough
        d_inner = cfg.ssm_expand * D
        n_heads_ssm = d_inner // cfg.ssm_head_dim
        mamba = D * (2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + n_heads_ssm) + d_inner * D
        if cfg.family == "hybrid":
            n_super = L // cfg.hybrid_period
            shared = attn + ffn_params(cfg.d_ff)
            total = L * mamba + n_super * shared + D * V  # shared block *computes* n_super times
        else:
            total = L * mamba + D * V
        return total, 0.0

    if cfg.n_experts:
        n_dense = cfg.first_dense_layers
        n_moe = L - n_dense
        moe_routed = n_moe * cfg.n_experts * 3 * D * cfg.d_ff_expert
        shared = n_moe * cfg.n_shared_experts * 3 * D * cfg.d_ff_expert
        router = n_moe * D * cfg.n_experts
        dense = n_dense * ffn_params(cfg.d_ff_dense or cfg.d_ff)
        total = L * attn + moe_routed + shared + router + dense + D * V
        if cfg.mtp:
            total += 2 * D * D + attn + ffn_params(cfg.d_ff_dense or cfg.d_ff)
        return total, moe_routed

    if cfg.family == "vlm":
        total = L * (attn + ffn_params(cfg.d_ff)) + D * V
        if cfg.vision_dim and cfg.vision_dim != D:
            total += cfg.vision_dim * D
        return total, 0.0

    total = L * (attn + ffn_params(cfg.d_ff)) + D * V
    if cfg.family == "audio":
        total += cfg.frame_dim * D
    return total, 0.0


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Ideal (causal-aware) model FLOPs for this cell, whole batch, all devices."""
    total, routed = matmul_param_count(cfg)
    n_active = active_param_count(cfg, total, routed)
    B, T = shape.global_batch, shape.seq_len
    # per-head score/readout widths (MLA keys are nope+rope, values v_head_dim)
    if cfg.attn_kind == "mla":
        dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dk = dv = cfg.head_dim_actual
    kv_width = dk + dv
    L_attn = cfg.n_layers if cfg.family not in ("ssm", "hybrid") else (
        cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid" else 0)

    if shape.kind == "train":
        flops = 6.0 * n_active * B * T
        # causal attention fwd+bwd: 3 × 2·(dk+dv)·T·S·H, halved for causality
        flops += 3.0 * L_attn * B * T * T * cfg.n_heads * kv_width
        if cfg.family in ("ssm", "hybrid"):
            d_inner = cfg.ssm_expand * cfg.d_model
            flops += 3 * 2.0 * cfg.n_layers * B * T * cfg.ssm_chunk * d_inner  # SSD intra-chunk
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * n_active * B * T
        flops += 1.0 * L_attn * B * T * T * cfg.n_heads * kv_width  # causal fwd
        return flops
    # decode: one token per sequence, full-cache attention reads
    flops = 2.0 * n_active * B
    flops += 2.0 * L_attn * B * T * cfg.n_heads * kv_width
    return flops


# ---------------------------------------------------------------------------
# counting a step's ops
# ---------------------------------------------------------------------------

# factory ops write nothing a program reads; a scalar read back to the host
# (a step's int input) is not the program's device work
_NO_BYTES = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
             "_local_scalar_dense"}


def _tensor_bytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


class OpCounter:
    """Flops and bytes of the aten ops run under :meth:`counting`, split
    into the global program's (``flops``, ``bytes``) and the mesh
    positions' (``position_flops``, ``position_bytes``, summed over the
    positions)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.flops = self.bytes = 0
        self.position_flops = self.position_bytes = 0

    def add(self, flops: int, nbytes: int, inside: bool) -> None:
        with self._lock:
            if inside:
                self.position_flops += flops
                self.position_bytes += nbytes
            else:
                self.flops += flops
                self.bytes += nbytes

    def mode(self, inside: bool = False) -> "_CountMode":
        return _CountMode(self, inside)


class _CountMode(TorchDispatchMode):
    """A thread's dispatch mode adding each op it sees to an
    :class:`OpCounter` (dispatch modes are per thread, so each mesh
    position enters one of its own)."""

    def __init__(self, counter: OpCounter, inside: bool):
        super().__init__()
        self.counter, self.inside = counter, inside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if not func.is_view and packet.__name__ not in _NO_BYTES:
            nbytes = _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)
        self.counter.add(flops, nbytes, self.inside)
        return out


def count_step(cell, *args):
    """Run ``cell.step(*args)`` (``cell.args`` by default) with every op
    counted, in the calling thread and in every mesh position it starts,
    and every collective recorded: ``(out, OpCounter, CollectiveRecorder)``."""
    counter = OpCounter()
    args = args or cell.args
    with record_collectives() as recorder, \
            in_positions(lambda: counter.mode(inside=True)), counter.mode():
        out = cell.step(*args)
    return out, counter, recorder


# ---------------------------------------------------------------------------
# record
# ---------------------------------------------------------------------------


@dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # raw per-device numbers
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_by_op: dict
    # memory analysis (per device)
    arg_bytes: float
    out_bytes: float
    temp_bytes: float
    peak_bytes: float
    # derived
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float
    param_count: int
    compile_s: float      # repro's name; here the meta step's wall seconds
    variant: str = "baseline"
    note: str = ""

    def summary(self) -> str:
        return (f"{self.arch:>24s} {self.shape:<12s} {self.mesh:<6s} "
                f"C={self.compute_s*1e3:9.3f}ms M={self.memory_s*1e3:9.3f}ms "
                f"X={self.collective_s*1e3:9.3f}ms -> {self.bottleneck:<10s} "
                f"useful={self.useful_ratio:6.3f} peak={self.peak_bytes/2**30:7.2f}GiB")


def extract_metrics(cell) -> dict:
    """Per-device flops / bytes / collective stats / memory of one run of
    ``cell``'s step: the H100 counterpart of XLA's cost and memory analysis
    (``repro``'s ``extract_metrics(compiled)``).  ``arg_bytes``,
    ``out_bytes`` and ``alias_bytes`` are a position's bytes under the
    cell's specs; ``temp_bytes`` is the card's peak allocation above what
    the step's inputs held (``torch.cuda.max_memory_allocated``), 0 on a
    meta cell, which allocates nothing.  ``note`` says how the numbers were
    taken."""
    n_dev = cell.mesh.size
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
        held = torch.cuda.memory_allocated(cell.device)
    _, counter, recorder = count_step(cell)
    temp = 0.0
    if on_card:
        torch.cuda.synchronize(cell.device)
        temp = float(torch.cuda.max_memory_allocated(cell.device) - held)
    coll = recorder.mean(n_dev)
    local = cell.local_bytes
    notes = [f"flops/bytes: the global program's counts / {n_dev} devices + the mesh "
             f"positions' mean (aten ops counted on {cell.device.type})",
             "collectives: the mesh's explicit ones (EP), mean per position"]
    notes.append("temp: the card's peak above the inputs (the whole model on one card)"
                 if on_card else "temp: 0 (meta allocates nothing)")
    return {
        "flops": counter.flops / n_dev + counter.position_flops / n_dev,
        "bytes": counter.bytes / n_dev + counter.position_bytes / n_dev,
        "coll_bytes": coll.total_bytes,
        "coll_wire_bytes": coll.total_wire_bytes,
        "coll_by_op": dict(coll.bytes_by_op),
        "coll_counts": dict(coll.count_by_op),
        "arg_bytes": float(local["params"] + local["opt"] + local["batch"]),
        "out_bytes": float(local["out"]),
        "temp_bytes": temp,
        "alias_bytes": float(local["alias"]),
        "note": "; ".join(notes),
    }


def analyse(cfg: ArchConfig, shape: ShapeSpec, mesh_name: str, n_devices: int,
            metrics: dict, compile_s: float, param_count: int,
            variant: str = "baseline", note: str = "") -> RooflineRecord:
    flops = metrics["flops"]
    nbytes = metrics["bytes"]
    arg_b, out_b = metrics["arg_bytes"], metrics["out_bytes"]
    tmp_b, alias_b = metrics["temp_bytes"], metrics["alias_bytes"]
    peak = arg_b + out_b + tmp_b - alias_b

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    coll_s = metrics["coll_bytes"] / ICI_LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = (mf / n_devices) / flops if flops else 0.0
    return RooflineRecord(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        hlo_flops=flops, hlo_bytes=nbytes,
        collective_bytes=metrics["coll_bytes"], collective_by_op=metrics["coll_by_op"],
        arg_bytes=arg_b, out_bytes=out_b, temp_bytes=tmp_b, peak_bytes=peak,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck, model_flops_total=mf, useful_ratio=useful,
        param_count=param_count, compile_s=compile_s, variant=variant, note=note,
    )


def save_record(rec: RooflineRecord, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec.arch}__{rec.shape}__{rec.mesh}__{rec.variant}.json")
    with open(path, "w") as f:
        json.dump(asdict(rec), f, indent=1)
    return path


def load_records(out_dir: str):
    recs = []
    if not os.path.isdir(out_dir):
        return recs
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                recs.append(RooflineRecord(**json.load(f)))
    return recs
