"""Parse collective traffic out of compiled HLO text.

A copy of :mod:`repro.utils.hlo` (pure Python; the port imports nothing of
``repro``).  The port compiles no HLO: its mesh collectives fill the same
:class:`CollectiveStats` under the same per-op rules as they run
(:func:`repro_torch.core.compat.record_collectives`), and the parser stays
for HLO text written by the JAX package.

The roofline's collective term is not exposed by ``compiled.cost_analysis()``,
so we parse ``compiled.as_text()`` (the post-SPMD-partitioning per-device
program) and sum the **operand sizes** of every collective op:

    all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute
    (+ their async ``-start`` forms; ``-done`` ops only consume handles).

Post-optimization HLO prints operands *without* type annotations, so operand
sizes are derived from the printed **output** shape(s) via op semantics
(group size ``g`` parsed from ``replica_groups``):

    all-reduce          operand = output
    all-gather          operand = output / g
    reduce-scatter      operand = output × g
    all-to-all          operand = output
    collective-permute  operand = output

We also keep a ring-model *wire bytes* estimate per op (all-reduce moves
2·(g-1)/g·size per device; gather/scatter (g-1)/g of the full buffer), since
that is closer to what the ICI links actually carry.

Shapes appearing in annotations such as ``replica_groups=[8,8]<=[64]`` cannot
match the shape regex (no dtype prefix), so the LHS scan is safe.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 0.5, "u4": 0.5,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVE_OPS = (
    "all-reduce-start",
    "all-gather-start",
    "reduce-scatter-start",
    "all-to-all-start",
    "collective-permute-start",
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_CANONICAL = {
    "all-reduce-start": "all-reduce",
    "all-gather-start": "all-gather",
    "reduce-scatter-start": "reduce-scatter",
    "all-to-all-start": "all-to-all",
    "collective-permute-start": "collective-permute",
}

_OP_RE = re.compile(
    r"=\s*[^=]*?\b(" + "|".join(re.escape(o) for o in _COLLECTIVE_OPS) + r")\("
)
_SHAPE_RE = re.compile(r"\b(pred|[sufc](?:8|16|32|64|128|4)[a-z0-9]*|bf16)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _shape_bytes(dtype: str, dims: str) -> float:
    if dtype not in _DTYPE_BYTES:
        return 0.0
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return max(1, int(m.group(2)))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return max(1, len(m.group(1).split(",")))
    return 1


@dataclass
class CollectiveStats:
    """Per-device collective traffic summed from an HLO module."""

    bytes_by_op: Dict[str, float] = field(default_factory=dict)     # operand bytes
    wire_bytes_by_op: Dict[str, float] = field(default_factory=dict)  # ring estimate
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes_by_op.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_op.values()))

    def scale(self, op_factor: float) -> "CollectiveStats":
        return CollectiveStats(
            {k: v * op_factor for k, v in self.bytes_by_op.items()},
            {k: v * op_factor for k, v in self.wire_bytes_by_op.items()},
            dict(self.count_by_op),
        )

    def summary(self) -> str:
        lines = [
            f"collective traffic (per device): operand {self.total_bytes/1e6:.2f} MB, "
            f"wire≈{self.total_wire_bytes/1e6:.2f} MB, {self.total_count} ops"
        ]
        for op in sorted(self.bytes_by_op, key=lambda o: -self.bytes_by_op[o]):
            lines.append(
                f"  {op:<20s} {self.count_by_op[op]:>4d} ops  "
                f"{self.bytes_by_op[op]/1e6:>12.2f} MB (wire≈{self.wire_bytes_by_op[op]/1e6:.2f})"
            )
        return "\n".join(lines)


def collective_bytes_from_hlo(hlo_text: str) -> CollectiveStats:
    """Sum per-device operand bytes of every collective op in an HLO dump."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        op = _CANONICAL.get(m.group(1), m.group(1))
        lhs = line[: m.start(1)]
        out_bytes = sum(_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(lhs))
        if m.group(1).endswith("-start") and out_bytes:
            out_bytes /= 2.0  # async start prints (operand, output) tuples
        g = _group_size(line)
        if op == "all-gather":
            operand = out_bytes / g
            wire = out_bytes * (g - 1) / g
        elif op == "reduce-scatter":
            operand = out_bytes * g
            wire = operand * (g - 1) / g
        elif op == "all-reduce":
            operand = out_bytes
            wire = 2.0 * out_bytes * (g - 1) / g
        elif op == "all-to-all":
            operand = out_bytes
            wire = out_bytes * (g - 1) / g
        else:  # collective-permute
            operand = out_bytes
            wire = out_bytes
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0.0) + operand
        stats.wire_bytes_by_op[op] = stats.wire_bytes_by_op.get(op, 0.0) + wire
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
    return stats
